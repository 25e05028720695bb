"""MLP hyperparameter-search workload: every config is a full MLP training
run, and the whole config batch trains at once.

Ported from ``hpbandster_tpu/workloads/mlp.py``. Parameters for all configs
stack on a leading config axis (``[n, ...]`` leaves), so the dense layers
are batched matrix products over the lanes; the dataset is shared. Budget =
number of SGD steps (:func:`~hpbandster_tpu_torch.workloads.train.budget_steps`).

The dataset is drawn from a ``torch.Generator`` on the device seeded with
``data_seed`` and the unit-scale initial weights from one seeded with
``data_seed + 1`` (the reference's ``key(data_seed)`` and
``key(data_seed + 1)``; the streams differ). ``data=`` and ``init=`` take
them from elsewhere, e.g. the reference's arrays through
``hpbandster_tpu_torch.convert``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hpbandster_tpu_torch.workloads.train import (
    decode_sgd_hparams,
    lane_scaled,
    momentum_sgd_steps,
    momentum_sgd_train,
    sgd_space,
    workload_inputs,
)

__all__ = [
    "MLPConfig",
    "mlp_space",
    "decode_mlp_hparams",
    "draw_mlp_unit_params",
    "init_mlp_params",
    "mlp_forward",
    "make_synthetic_dataset",
    "make_mlp_eval_fn",
    "sgd_train_step_batch",
    "batched_sgd_train_step",
]


class MLPConfig(NamedTuple):
    d_in: int = 16
    width: int = 64
    n_classes: int = 8
    n_train: int = 512
    n_val: int = 256
    batch_size: int = 128


#: lr (log), momentum, weight decay (log), init scale (log)
mlp_space = sgd_space
#: unit-cube vectors ``f32[n, 4]`` -> ``(lr, momentum, weight_decay,
#: init_scale)``, each ``f32[n]``
decode_mlp_hparams = decode_sgd_hparams


def draw_mlp_unit_params(generator: torch.Generator, cfg: MLPConfig) -> dict:
    """The initial weights at ``init_scale = 1`` (He-scaled normals, zero
    biases), drawn from ``generator`` on its device."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    s1 = (2.0 / cfg.d_in) ** 0.5
    s2 = (2.0 / cfg.width) ** 0.5
    return {
        "w1": s1 * normal(cfg.d_in, cfg.width),
        "b1": torch.zeros(cfg.width, device=dev),
        "w2": s2 * normal(cfg.width, cfg.width),
        "b2": torch.zeros(cfg.width, device=dev),
        "w3": s2 * normal(cfg.width, cfg.n_classes),
        "b3": torch.zeros(cfg.n_classes, device=dev),
    }


def init_mlp_params(unit: dict, init_scale: torch.Tensor) -> dict:
    """One lane per config: ``init_scale[i] * unit`` (``f32[n]`` scales)."""
    return lane_scaled(unit, init_scale)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` per lane: ``x`` ``[B, d]`` (shared) or ``[n, B, d]``,
    ``w`` ``[n, d, e]``, ``b`` ``[n, e]`` -> ``[n, B, e]``."""
    if x.dim() == 2:
        x = x.unsqueeze(0).expand(w.shape[0], *x.shape)
    return torch.bmm(x, w) + b.unsqueeze(1)


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x`` ``[B, d_in]`` -> logits ``[n, B, n_classes]``, one row block per
    lane."""
    h = torch.tanh(_dense(x, params["w1"], params["b1"]))
    h = torch.tanh(_dense(h, params["w2"], params["b2"]))
    return _dense(h, params["w3"], params["b3"])


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy per lane: logits ``[n, B, C]``, labels ``[B]``
    -> ``f32[n]``."""
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.reshape(1, -1, 1).expand(logits.shape[0], -1, 1)
    return -logp.gather(-1, idx).squeeze(-1).mean(-1)


def make_synthetic_dataset(generator: torch.Generator, cfg: MLPConfig):
    """Gaussian class blobs, learnable but overlapping: ``((x_train,
    y_train), (x_val, y_val))`` with float32 inputs and int64 labels."""
    dev = generator.device
    centers = 2.0 * torch.randn((cfg.n_classes, cfg.d_in), generator=generator, device=dev)

    def draw(n):
        labels = torch.randint(0, cfg.n_classes, (n,), generator=generator, device=dev)
        x = centers[labels] + 1.5 * torch.randn((n, cfg.d_in), generator=generator, device=dev)
        return x, labels

    train = draw(cfg.n_train)
    val = draw(cfg.n_val)
    return train, val


def make_mlp_eval_fn(cfg: MLPConfig = MLPConfig(), data_seed: int = 0, device=None,
                     data=None, init: Optional[dict] = None):
    """``eval_fn(vectors f32[n, 4], budget) -> f32[n]`` validation losses
    after ``budget`` SGD steps. The dataset and the initial weights are
    fixed, so the objective is deterministic per config."""
    _, (train, (x_v, y_v)), unit = workload_inputs(
        device, data_seed, data, init,
        lambda g: make_synthetic_dataset(g, cfg), lambda g: draw_mlp_unit_params(g, cfg))

    def loss_fn(p, xb, yb):
        return _xent(mlp_forward(p, xb), yb)

    def eval_fn(vectors: torch.Tensor, budget) -> torch.Tensor:
        lr, momentum, wd, scale = decode_mlp_hparams(vectors)
        params = momentum_sgd_train(init_mlp_params(unit, scale), lr, momentum, wd,
                                    train, budget, loss_fn, cfg.batch_size, cfg.n_train)
        with torch.no_grad():
            return _xent(mlp_forward(params, x_v), y_v)

    return eval_fn


def sgd_train_step_batch(params_batch, velocity_batch, x, y, lrs, momenta, wds):
    """One momentum-SGD step for a whole batch of models on the shared
    ``(x, y)``: returns ``(params, velocity, losses f32[n])``, the losses
    after the step."""
    def loss_fn(p, xb, yb):
        return _xent(mlp_forward(p, xb), yb)

    params, velocity = momentum_sgd_steps(
        params_batch, velocity_batch, lrs, momenta, wds, (x, y), 1, 0, loss_fn,
        x.shape[0], x.shape[0])
    with torch.no_grad():
        return params, velocity, loss_fn(params, x, y)


#: the reference jits ``sgd_train_step_batch`` with its state donated; in
#: eager PyTorch the two are one function
batched_sgd_train_step = sgd_train_step_batch
