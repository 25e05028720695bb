"""The yardstick of a kernel's roofline share: the card's published peaks
and the operations and bytes each kernel's work needs.

Peaks: NVIDIA's data sheet for the H100 SXM at its full 700 W (dense,
without sparsity): 67 TFLOP/s in float32 outside the tensor cores, 3.35
TB/s of HBM3.

``kde_score_cost`` is a frozen copy of
``hpbandster_tpu_torch/ops/cuda_kde.py::kde_score_cost``: per live
(candidate, row) pair 4 float32 operations a dimension and 3 for the
log-sum-exp update; bytes for the candidates, both sides' rows, masks and
bandwidths, the vartypes and cards, and the scores, each read or written
once.
"""

from __future__ import annotations

from typing import Dict, Iterable, NamedTuple

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


class KernelCost(NamedTuple):
    flops: int
    bytes_accessed: int


def kde_score_cost(s: int, d: int, n_good: int, n_bad: int,
                   live_good: int, live_bad: int) -> KernelCost:
    pairs = s * (live_good + live_bad)
    n = n_good + n_bad
    return KernelCost(pairs * (4 * d + 3), 4 * (s * d + n * d + n + 4 * d + s))


def least_seconds(cost: KernelCost) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the HBM peak."""
    return max(cost.flops / F32_FLOPS, cost.bytes_accessed / HBM_BYTES_PER_S)


def kde_score_least_seconds(launches: Iterable[Dict[str, int]]) -> float:
    return sum(least_seconds(kde_score_cost(
        l["s"], l["d"], l["n_good"], l["n_bad"], l["live_good"], l["live_bad"]))
        for l in launches)
