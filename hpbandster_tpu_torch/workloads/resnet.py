"""ResNet-18 sweep workload: a ResNet-18-shaped network (stem, 4 stages of
2 basic blocks, average pool, linear head) trained for every config at
once.

Ported from ``hpbandster_tpu/workloads/resnet.py``. GroupNorm, not
BatchNorm: per-image statistics, so one lane's normalisation never sees
another lane's activations. On lane-stacked channels ``[B, n * C, H, W]``
the lanes' GroupNorm is one ``F.group_norm`` with ``n * groups`` groups
(population variance, eps 1e-5); the convolutions and the head are the CNN
workload's (bfloat16 operands and outputs, ``SAME`` padding); residual adds
and norms stay float32. Every config starts from the same weights (no
``init_scale``); the fourth knob is label smoothing. Budget = SGD steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from hpbandster_tpu_torch.ops.fused import tree_map
from hpbandster_tpu_torch.space import ConfigurationSpace, UniformFloatHyperparameter
from hpbandster_tpu_torch.workloads.cnn import (
    CNNConfig,
    _bf16_head,
    _conv,
    _he_normal,
    _pool_lanes,
    make_image_dataset,
)
from hpbandster_tpu_torch.workloads.mlp import _xent
from hpbandster_tpu_torch.workloads.train import (
    momentum_sgd_train,
    pow10,
    workload_inputs,
)

__all__ = [
    "ResNetConfig",
    "resnet_space",
    "decode_resnet_hparams",
    "draw_resnet_unit_params",
    "init_resnet_params",
    "resnet_forward",
    "make_resnet_eval_fn",
]


class ResNetConfig(NamedTuple):
    image_size: int = 32
    channels: int = 3
    width: int = 64          # stem width; stages are (w, 2w, 4w, 8w)
    n_classes: int = 10
    n_train: int = 512
    n_val: int = 256
    batch_size: int = 128
    groups: int = 8          # GroupNorm groups (must divide every stage width)
    label_noise: float = 0.05
    image_noise: float = 2.0


def resnet_space(seed=None) -> ConfigurationSpace:
    """lr (log), momentum, weight decay (log), label smoothing."""
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameter(UniformFloatHyperparameter("lr", 1e-4, 1.0, log=True))
    cs.add_hyperparameter(UniformFloatHyperparameter("momentum", 0.0, 0.99))
    cs.add_hyperparameter(
        UniformFloatHyperparameter("weight_decay", 1e-7, 1e-2, log=True)
    )
    cs.add_hyperparameter(
        UniformFloatHyperparameter("label_smoothing", 0.0, 0.2)
    )
    return cs


def decode_resnet_hparams(vectors: torch.Tensor):
    """Unit-cube vectors ``f32[n, 4]`` -> ``(lr, momentum, weight_decay,
    label_smoothing)``, each ``f32[n]``."""
    lr = pow10(-4.0, 4.0, vectors[:, 0])
    momentum = 0.99 * vectors[:, 1]
    wd = pow10(-7.0, 5.0, vectors[:, 2])
    ls = 0.2 * vectors[:, 3]
    return lr, momentum, wd, ls


def _group_norm(x, gamma, beta, groups):
    """GroupNorm of each image, per lane: ``x`` ``[B, n * C, H, W]``,
    ``gamma``/``beta`` ``[n, C]``; ``groups`` groups per lane."""
    n = gamma.shape[0]
    return F.group_norm(x, n * groups, gamma.reshape(-1), beta.reshape(-1), eps=1e-5)


def _block_params(generator, c_in, c_out):
    dev = generator.device
    p = {
        "conv1": _he_normal(generator, (c_out, c_in, 3, 3), 9 * c_in),
        "g1": torch.ones(c_out, device=dev),
        "be1": torch.zeros(c_out, device=dev),
        "conv2": _he_normal(generator, (c_out, c_out, 3, 3), 9 * c_out),
        # the last norm's scale starts at zero: each block starts as identity
        "g2": torch.zeros(c_out, device=dev),
        "be2": torch.zeros(c_out, device=dev),
    }
    if c_in != c_out:
        p["proj"] = _he_normal(generator, (c_out, c_in, 1, 1), c_in)
    return p


def draw_resnet_unit_params(generator: torch.Generator, cfg: ResNetConfig) -> dict:
    """The shared initial weights (conv kernels OIHW)."""
    w, dev = cfg.width, generator.device
    params = {
        "stem": _he_normal(generator, (w, cfg.channels, 3, 3), 9 * cfg.channels),
        "g0": torch.ones(w, device=dev),
        "be0": torch.zeros(w, device=dev),
        "wh": _he_normal(generator, (8 * w, cfg.n_classes), 8 * w),
        "bh": torch.zeros(cfg.n_classes, device=dev),
    }
    c_in = w
    for si, c_out in enumerate([w, 2 * w, 4 * w, 8 * w]):
        for bi in range(2):
            params[f"s{si}b{bi}"] = _block_params(generator, c_in, c_out)
            c_in = c_out
    return params


def init_resnet_params(unit: dict, n: int) -> dict:
    """``n`` lanes, every one the shared initial weights."""
    return tree_map(lambda t: t.unsqueeze(0).expand(n, *t.shape).contiguous(), unit)


def _basic_block(x, p, groups, stride):
    h = _conv(x, p["conv1"], stride=stride)
    h = F.relu(_group_norm(h, p["g1"], p["be1"], groups))
    h = _conv(h, p["conv2"])
    h = _group_norm(h, p["g2"], p["be2"], groups)
    if "proj" in p:
        x = _conv(x, p["proj"], stride=stride)
    elif stride != 1:
        x = x[:, :, ::stride, ::stride]
    return F.relu(h + x)


def resnet_forward(params: dict, x: torch.Tensor, groups: int = 8) -> torch.Tensor:
    """``x`` ``[B, C, H, W]`` float32 -> logits ``[n, B, n_classes]``."""
    n = params["stem"].shape[0]
    h = _conv(x, params["stem"])
    h = F.relu(_group_norm(h, params["g0"], params["be0"], groups))
    for si in range(4):
        for bi in range(2):
            stride = 2 if (si > 0 and bi == 0) else 1
            h = _basic_block(h, params[f"s{si}b{bi}"], groups, stride)
    return _bf16_head(_pool_lanes(h, n), params["wh"], params["bh"])


def _smoothed_xent(logits, labels, smoothing):
    """Label-smoothed cross-entropy per lane; ``smoothing`` ``f32[n]``."""
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.reshape(1, -1, 1).expand(logits.shape[0], -1, 1)
    nll = -logp.gather(-1, idx).squeeze(-1).mean(-1)
    uniform = -logp.mean(dim=(-2, -1))
    return (1.0 - smoothing) * nll + smoothing * uniform


def _data_cfg(cfg: ResNetConfig) -> CNNConfig:
    return CNNConfig(image_size=cfg.image_size, channels=cfg.channels,
                     n_classes=cfg.n_classes, n_train=cfg.n_train, n_val=cfg.n_val,
                     batch_size=cfg.batch_size, label_noise=cfg.label_noise,
                     image_noise=cfg.image_noise)


def make_resnet_eval_fn(cfg: ResNetConfig = ResNetConfig(), data_seed: int = 0,
                        device=None, data=None, init: Optional[dict] = None):
    """``eval_fn(vectors f32[n, 4], budget) -> f32[n]`` validation
    cross-entropy (unsmoothed) after ``budget`` SGD steps on the
    label-smoothed loss. The dataset is the CNN workload's."""
    _, (train, (x_v, y_v)), unit = workload_inputs(
        device, data_seed, data, init, lambda g: make_image_dataset(g, _data_cfg(cfg)),
        lambda g: draw_resnet_unit_params(g, cfg))

    def eval_fn(vectors: torch.Tensor, budget) -> torch.Tensor:
        lr, momentum, wd, ls = decode_resnet_hparams(vectors)

        def loss_fn(p, xb, yb):
            return _smoothed_xent(resnet_forward(p, xb, cfg.groups), yb, ls)

        params = momentum_sgd_train(init_resnet_params(unit, vectors.shape[0]), lr,
                                    momentum, wd, train, budget, loss_fn,
                                    cfg.batch_size, cfg.n_train)
        with torch.no_grad():
            return _xent(resnet_forward(params, x_v, cfg.groups), y_v)

    return eval_fn
