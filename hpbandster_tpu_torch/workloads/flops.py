"""Analytic FLOP counts of the training workloads, and the card's peak.

Ported from ``hpbandster_tpu/workloads/flops.py``. The counts follow the
standard model-FLOPs bookkeeping: matrix products and convolutions only,
2 FLOPs per multiply-accumulate, a training step charged 3x its forward
pass (the forward, then the input and the weight gradients); elementwise
ops, norms, pooling and the optimizer update are left out.

``peak_bf16_flops`` replaces the reference's TPU table with the port's
own: dense bfloat16 tensor-core peaks from NVIDIA's data sheets, keyed by
the name ``torch.cuda.get_device_name`` reports. A card it does not know
returns None, and then no share of peak is reported.
"""

from __future__ import annotations

from typing import Optional

import torch

from hpbandster_tpu_torch.workloads.cnn import CNNConfig
from hpbandster_tpu_torch.workloads.mlp import MLPConfig
from hpbandster_tpu_torch.workloads.resnet import ResNetConfig
from hpbandster_tpu_torch.workloads.teacher import TeacherConfig, _student_cfg
from hpbandster_tpu_torch.workloads.transformer import TransformerConfig

__all__ = [
    "mlp_forward_flops",
    "mlp_step_flops",
    "teacher_step_flops",
    "teacher_epoch_flops",
    "cnn_forward_flops",
    "cnn_step_flops",
    "resnet_forward_flops",
    "resnet_step_flops",
    "transformer_forward_flops",
    "transformer_step_flops",
    "peak_bf16_flops",
    "sweep_training_flops",
]

#: dense bfloat16 peak FLOP/s by device-name prefix: the H100 SXM
#: (reported as "NVIDIA H100 80GB HBM3"), 989.4 TFLOP/s at 700 W
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def peak_bf16_flops(device) -> Optional[float]:
    """Peak dense bfloat16 FLOP/s of one card, or None if unknown.
    ``device`` is a CUDA ``torch.device`` (its name is read) or a device
    name as ``torch.cuda.get_device_name`` gives it."""
    if isinstance(device, torch.device):
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    else:
        name = str(device)
    for prefix, peak in _PEAK_BF16.items():
        if name.startswith(prefix):
            return peak
    return None


def _dense(batch: int, d_in: int, d_out: int) -> float:
    return 2.0 * batch * d_in * d_out


def _conv(batch: int, h_out: int, w_out: int, kh: int, kw: int,
          c_in: int, c_out: int) -> float:
    return 2.0 * batch * h_out * w_out * kh * kw * c_in * c_out


def mlp_forward_flops(cfg: MLPConfig, batch: int) -> float:
    """One forward pass of ``mlp_forward`` for one config (3 dense layers)."""
    return (
        _dense(batch, cfg.d_in, cfg.width)
        + _dense(batch, cfg.width, cfg.width)
        + _dense(batch, cfg.width, cfg.n_classes)
    )


def mlp_step_flops(cfg: MLPConfig) -> float:
    """One momentum-SGD minibatch step for ONE config (3x forward)."""
    batch = min(cfg.batch_size, cfg.n_train)
    return 3.0 * mlp_forward_flops(cfg, batch)


def teacher_step_flops(cfg: TeacherConfig = TeacherConfig()) -> float:
    """One student SGD step (the teacher's labelling is a one-time dataset
    cost)."""
    return mlp_step_flops(_student_cfg(cfg))


def teacher_epoch_flops(cfg: TeacherConfig = TeacherConfig()) -> float:
    """The teacher workload's budget unit is the EPOCH."""
    steps_per_epoch = max(cfg.n_train // cfg.batch_size, 1)
    return steps_per_epoch * teacher_step_flops(cfg)


def cnn_forward_flops(cfg: CNNConfig, batch: int) -> float:
    """One forward pass of ``cnn_forward``: 3 convs (stride 1, 2, 2, SAME
    padding) and the head."""
    s = cfg.image_size
    w = cfg.width
    s2 = (s + 1) // 2
    s4 = (s2 + 1) // 2
    return (
        _conv(batch, s, s, 3, 3, cfg.channels, w)
        + _conv(batch, s2, s2, 3, 3, w, 2 * w)
        + _conv(batch, s4, s4, 3, 3, 2 * w, 2 * w)
        + _dense(batch, 2 * w, cfg.n_classes)
    )


def cnn_step_flops(cfg: CNNConfig = CNNConfig()) -> float:
    batch = min(cfg.batch_size, cfg.n_train)
    return 3.0 * cnn_forward_flops(cfg, batch)


def resnet_forward_flops(cfg: ResNetConfig, batch: int) -> float:
    """One forward pass of ``resnet_forward``: stem, 4 stages x 2 basic
    blocks (3x3 + 3x3, a 1x1 projection on the widening block) and the
    head."""
    s = cfg.image_size
    w = cfg.width
    total = _conv(batch, s, s, 3, 3, cfg.channels, w)
    c_in, h = w, s
    for si, c_out in enumerate([w, 2 * w, 4 * w, 8 * w]):
        for bi in range(2):
            stride = 2 if (si > 0 and bi == 0) else 1
            h_out = (h + stride - 1) // stride
            total += _conv(batch, h_out, h_out, 3, 3, c_in, c_out)
            total += _conv(batch, h_out, h_out, 3, 3, c_out, c_out)
            if c_in != c_out:
                total += _conv(batch, h_out, h_out, 1, 1, c_in, c_out)
            c_in, h = c_out, h_out
    return total + _dense(batch, 8 * w, cfg.n_classes)


def resnet_step_flops(cfg: ResNetConfig = ResNetConfig()) -> float:
    batch = min(cfg.batch_size, cfg.n_train)
    return 3.0 * resnet_forward_flops(cfg, batch)


def transformer_forward_flops(cfg: TransformerConfig, batch: int) -> float:
    """One forward pass of ``transformer_forward`` over a batch: per layer
    the 4 projections, attention scores and mixing (2 T x T products across
    heads) and the 2-layer MLP; then the vocabulary head. Embedding lookups
    are gathers, not counted."""
    t = cfg.seq_len - 1
    d = cfg.d_model
    per_layer = (
        4 * _dense(t, d, d)
        + 2 * 2.0 * t * t * d
        + _dense(t, d, cfg.d_ff)
        + _dense(t, cfg.d_ff, d)
    )
    head = _dense(t, d, cfg.vocab + 1)
    return batch * (cfg.n_layers * per_layer + head)


def transformer_step_flops(cfg: TransformerConfig = TransformerConfig()) -> float:
    batch = min(cfg.batch_size, cfg.n_train)
    return 3.0 * transformer_forward_flops(cfg, batch)


def sweep_training_flops(result, step_flops: float,
                         steps_per_budget_unit: float = 1.0,
                         include_failed: bool = False) -> float:
    """Total model FLOPs a sweep's TRAINING executed:
    ``step_flops * steps_per_budget_unit * sum(budgets)`` over the finished
    runs (every run at budget ``b`` trains from scratch; the validation
    forward is left out). ``include_failed=True`` counts crashed (NaN-loss)
    runs too: on the fused tier their steps ran on the device."""
    total_units = sum(
        r.budget for r in result.get_all_runs()
        if include_failed or r.loss is not None
    )
    return step_flops * steps_per_budget_unit * float(total_units)
