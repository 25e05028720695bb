"""Teacher-student classification workload: a fixed, procedurally made
problem whose labels come from a hidden "teacher" MLP.

Ported from ``hpbandster_tpu/workloads/teacher.py``. Inputs are normal;
labels are the argmax of a random one-hidden-layer teacher; a fraction
``label_noise`` of the TRAIN labels (only) is flipped to a random class, so
overfitting the train split costs validation accuracy. The student is the
MLP workload's network; budget = EPOCHS, i.e. ``budget * steps_per_epoch``
SGD steps, truncated as the reference truncates its float32 product. The
HPO loss is the validation error rate ``1 - accuracy``.

The reference's calibration (seed 0, default config, budget 27 epochs,
its own data): chance is 0.25, the best of 12 random draws reaches about
0.92 validation accuracy; ``TARGET_VAL_ACCURACY = 0.90``. The port draws
other data from its seeds; its sweeps report against the same target.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.workloads.mlp import (
    MLPConfig,
    decode_mlp_hparams,
    draw_mlp_unit_params,
    init_mlp_params,
    mlp_forward,
    _xent,
)
from hpbandster_tpu_torch.workloads.train import (
    make_generator,
    momentum_sgd_train,
    sgd_space,
    workload_inputs,
)

__all__ = [
    "TeacherConfig",
    "TARGET_VAL_ACCURACY",
    "teacher_space",
    "make_teacher_dataset",
    "make_teacher_eval_fn",
    "make_teacher_accuracy_fn",
    "teacher_steps",
]

#: the reference's documented target for a small sweep's incumbent
TARGET_VAL_ACCURACY = 0.90


class TeacherConfig(NamedTuple):
    d_in: int = 12
    n_classes: int = 4
    teacher_width: int = 8
    #: fraction of training labels flipped to a random class
    label_noise: float = 0.05
    n_train: int = 4096
    n_val: int = 1024
    student_width: int = 64
    batch_size: int = 128


#: the same four knobs as ``mlp_space``; the decode twin is
#: ``decode_mlp_hparams``
teacher_space = sgd_space


def make_teacher_dataset(data_seed: int, cfg: TeacherConfig = TeacherConfig(),
                         device=None):
    """``((x_train, y_train), (x_val, y_val))``: inputs ~ N(0, I), labels
    the teacher's argmax, ``label_noise`` of the train labels flipped
    uniformly. Drawn from a generator on ``device`` seeded with
    ``data_seed`` (``None`` means CUDA)."""
    return _teacher_data(make_generator(resolve_device(device), data_seed), cfg)


def _teacher_data(generator: torch.Generator, cfg: TeacherConfig):
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    # teacher: one hidden layer; the 1.8 gain keeps class margins crisp
    # enough that the Bayes error is about label_noise
    w1 = 1.8 * normal(cfg.d_in, cfg.teacher_width) / cfg.d_in**0.5
    w2 = 1.8 * normal(cfg.teacher_width, cfg.n_classes) / cfg.teacher_width**0.5

    def label(x):
        return torch.argmax(torch.tanh(x @ w1) @ w2, dim=-1)

    x_tr = normal(cfg.n_train, cfg.d_in)
    x_va = normal(cfg.n_val, cfg.d_in)
    y_tr, y_va = label(x_tr), label(x_va)
    flip = torch.rand((cfg.n_train,), generator=generator, device=dev) < cfg.label_noise
    y_rand = torch.randint(0, cfg.n_classes, (cfg.n_train,), generator=generator, device=dev)
    y_tr = torch.where(flip, y_rand, y_tr)
    return (x_tr, y_tr), (x_va, y_va)


def _student_cfg(cfg: TeacherConfig) -> MLPConfig:
    return MLPConfig(d_in=cfg.d_in, width=cfg.student_width, n_classes=cfg.n_classes,
                     n_train=cfg.n_train, n_val=cfg.n_val, batch_size=cfg.batch_size)


def teacher_steps(budget_epochs, cfg: TeacherConfig = TeacherConfig()) -> np.float32:
    """The student's step budget for ``budget_epochs``: the reference's
    float32 product ``budget * steps_per_epoch``, which its loop truncates."""
    steps_per_epoch = max(cfg.n_train // cfg.batch_size, 1)
    return np.float32(budget_epochs) * np.float32(steps_per_epoch)


def _inputs(cfg, data_seed, device, data, init):
    return workload_inputs(
        device, data_seed, data, init, lambda g: _teacher_data(g, cfg),
        lambda g: draw_mlp_unit_params(g, _student_cfg(cfg)))


def _train_student(vectors, budget_epochs, train, cfg: TeacherConfig, unit):
    lr, momentum, wd, scale = decode_mlp_hparams(vectors)

    def loss_fn(p, xb, yb):
        return _xent(mlp_forward(p, xb), yb)

    return momentum_sgd_train(init_mlp_params(unit, scale), lr, momentum, wd, train,
                              teacher_steps(budget_epochs, cfg), loss_fn,
                              cfg.batch_size, cfg.n_train)


def _accuracy(params, x, y) -> torch.Tensor:
    with torch.no_grad():
        pred = torch.argmax(mlp_forward(params, x), dim=-1)
        return (pred == y).to(torch.float32).mean(-1)


def make_teacher_eval_fn(cfg: TeacherConfig = TeacherConfig(), data_seed: int = 0,
                         device=None, data=None, init: Optional[dict] = None):
    """``eval_fn(vectors f32[n, 4], budget_epochs) -> f32[n]`` validation
    error rates."""
    _, (train, (x_v, y_v)), unit = _inputs(cfg, data_seed, device, data, init)

    def eval_fn(vectors: torch.Tensor, budget) -> torch.Tensor:
        params = _train_student(vectors, budget, train, cfg, unit)
        return 1.0 - _accuracy(params, x_v, y_v)

    return eval_fn


def make_teacher_accuracy_fn(cfg: TeacherConfig = TeacherConfig(), data_seed: int = 0,
                             device=None, data=None, init: Optional[dict] = None):
    """``acc_fn(vectors, budget_epochs) -> (train_acc f32[n], val_acc
    f32[n])``, the analysis twin of :func:`make_teacher_eval_fn`."""
    _, (train, val), unit = _inputs(cfg, data_seed, device, data, init)

    def acc_fn(vectors: torch.Tensor, budget):
        params = _train_student(vectors, budget, train, cfg, unit)
        return tuple(_accuracy(params, x, y) for x, y in (train, val))

    return acc_fn
