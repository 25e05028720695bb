"""Hartmann-6 with its budget noise term, on unit vectors, in any dtype.

Frozen copy of ``hpbandster_tpu_torch/workloads/toys.py::hartmann6`` (the
objective of Dixon and Szegő, 1978, as HPOlib states it, plus the port's
decaying deterministic noise ``0.5 sin(31 sum x) / sqrt(budget)``).
"""

from __future__ import annotations

import math

import torch

ALPHA = (1.0, 1.2, 3.0, 3.2)
A = (
    (10, 3, 17, 3.5, 1.7, 8),
    (0.05, 10, 17, 0.1, 8, 14),
    (3, 3.5, 1.7, 10, 17, 8),
    (17, 8, 0.05, 10, 0.1, 14),
)
P = (
    (1312, 1696, 5569, 124, 8283, 5886),
    (2329, 4135, 8307, 3736, 1004, 9991),
    (2348, 1451, 3522, 2883, 3047, 6650),
    (4047, 8828, 8732, 5743, 1091, 381),
)


def hartmann6(vectors: torch.Tensor, budgets: torch.Tensor) -> torch.Tensor:
    """Losses of ``vectors [n, 6]`` at ``budgets [n]``, computed in the
    dtype of ``vectors`` (float64 for the reference, bfloat16 for the
    control)."""
    dt, dev = vectors.dtype, vectors.device
    a = torch.tensor(A, dtype=dt, device=dev)
    p = torch.tensor(P, dtype=dt, device=dev) * 1e-4
    alpha = torch.tensor(ALPHA, dtype=dt, device=dev)
    inner = (a[None] * torch.square(vectors[:, None, :] - p[None])).sum(-1)
    val = -(alpha[None] * torch.exp(-inner)).sum(-1)
    b = budgets.to(dt)
    noise = 0.5 * torch.sin(31.0 * vectors.sum(-1)) / torch.sqrt(b + 1e-9)
    return val + noise


def objective_scale() -> float:
    """The size of a Hartmann-6 loss (its global minimum's magnitude), the
    scale against which a loss gap is read."""
    return math.fabs(-3.32237)
