"""Counting Ones on unit vectors, with its budget as a number of draws.

The BOHB paper's mixed-space benchmark (Falkner, Klein and Hutter, ICML
2018, section 5.1): 16 binary dims, then 16 continuous dims in [0, 1];
the loss is minus the sum of the binary values and of each continuous
dim's mean of ``budget`` Bernoulli(x) draws. Frozen copy of
``hpbandster_tpu_torch/workloads/toys.py::counting_ones``: the paper drew
from numpy's generator; here, as in the port, each draw's uniform is a
counter hash of the value's float32 bits, its dim, the draw's index and
the budget, so the loss is a pure function of (vector, budget) and this
file reproduces the program's draws exactly.
"""

from __future__ import annotations

import torch

N_BINARY = 16
_MASK32 = 0xFFFFFFFF


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _MASK32
    h = h ^ (h >> 15)
    h = (h * 0x68E31DA5) & _MASK32
    return h ^ (h >> 16)


def uniforms(x32: torch.Tensor, draws: int) -> torch.Tensor:
    """``float64[n, m, draws]``: the uniforms behind the draws of the
    continuous values ``x32 float32[n, m]`` (top 24 bits of the hash, over
    2**24)."""
    bits = x32.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    dims = torch.arange(x32.shape[1], dtype=torch.int64)
    h = _mix32(_mix32(_mix32(bits) ^ dims) ^ int(draws))
    h = _mix32(h[..., None] ^ torch.arange(int(draws), dtype=torch.int64))
    return (h >> 8).to(torch.float64) / float(1 << 24)


def means(vectors: torch.Tensor, draws: int) -> torch.Tensor:
    """Each continuous dim's share of ``draws`` draws that came up one
    (``u < x`` with x as float32), in the dtype of ``vectors``."""
    x32 = vectors[:, N_BINARY:].to(torch.float32)
    ones = uniforms(x32, draws) < x32.to(torch.float64)[..., None]
    return ones.to(vectors.dtype).sum(-1) / draws


def counting_ones(vectors: torch.Tensor, budgets: torch.Tensor) -> torch.Tensor:
    """Losses of ``vectors [n, 32]`` at ``budgets [n]``, summed in the
    dtype of ``vectors`` (float64 for the reference, bfloat16 for the
    control; a lower dtype also rounds the values the hash reads)."""
    vectors = vectors.cpu()
    budgets = budgets.cpu().to(torch.float64)
    out = torch.empty(vectors.shape[0], dtype=vectors.dtype)
    for b in torch.unique(budgets).tolist():
        at = budgets == b
        v = vectors[at]
        out[at] = -(v[:, :N_BINARY].sum(-1) + means(v, max(int(round(b)), 1)).sum(-1))
    return out

