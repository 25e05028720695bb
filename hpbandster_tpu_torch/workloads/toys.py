"""Synthetic HPO objectives: Branin (2-D), Hartmann-6 (6-D) and Counting
Ones (16 binary + 16 continuous dims).

Ported from ``hpbandster_tpu/workloads/toys.py`` as batched torch functions
``f(vectors f32[n, d], budget) -> f32[n]`` on the unit hypercube
(:func:`branin`, :func:`hartmann6`), with the reference's per-vector forms
(``branin_from_vector``, ``hartmann6_from_vector``: one ``f32[d]`` vector
-> a 0-dim loss) and its host-side ``branin_dict``. Budget enters as a
decaying deterministic noise term, so lower fidelities are noisier.

:func:`counting_ones` is the mixed-space benchmark of the BOHB paper
(Falkner, Klein and Hutter, ICML 2018, section 5.1), which the JAX package
does not have: the budget is the number of Bernoulli draws behind each
continuous dim's mean, drawn from a counter hash so that the loss is a
pure function of the vector and the budget.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from hpbandster_tpu_torch.space import (
    CategoricalHyperparameter,
    ConfigurationSpace,
    UniformFloatHyperparameter,
)

__all__ = [
    "branin_space",
    "branin",
    "branin_from_vector",
    "branin_dict",
    "BRANIN_OPT",
    "hartmann6_space",
    "hartmann6",
    "hartmann6_from_vector",
    "HARTMANN6_OPT",
    "COUNTING_ONES_DIMS",
    "counting_ones_space",
    "counting_ones_uniforms",
    "counting_ones",
]

BRANIN_OPT = 0.397887
HARTMANN6_OPT = -3.32237


def branin_space(seed=None) -> ConfigurationSpace:
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameter(UniformFloatHyperparameter("x", -5.0, 10.0))
    cs.add_hyperparameter(UniformFloatHyperparameter("y", 0.0, 15.0))
    return cs


def branin(vectors: torch.Tensor, budget: float) -> torch.Tensor:
    """Branin on the unit-square codec; global minimum ~0.3979."""
    x = vectors[:, 0] * 15.0 - 5.0
    y = vectors[:, 1] * 15.0
    b, c = 5.1 / (4 * math.pi**2), 5.0 / math.pi
    t = 1.0 / (8 * math.pi)
    val = (y - b * x**2 + c * x - 6.0) ** 2 + 10.0 * (1 - t) * torch.cos(x) + 10.0
    noise = 5.0 * torch.sin(13.7 * x + 7.3 * y) / math.sqrt(budget + 1e-9)
    return val + noise


def branin_from_vector(vec: torch.Tensor, budget: float) -> torch.Tensor:
    """Branin of one unit-square vector ``f32[2]`` (a 0-dim tensor)."""
    return branin(vec[None], budget)[0]


def branin_dict(config, budget) -> float:
    """Host-side Branin of a configuration dict (``x``, ``y`` in the space's
    own units), for ``Worker.compute``-style evaluation."""
    x, y = config["x"], config["y"]
    val = (
        (y - 5.1 / (4 * np.pi**2) * x**2 + 5.0 / np.pi * x - 6.0) ** 2
        + 10 * (1 - 1 / (8 * np.pi)) * np.cos(x)
        + 10
    )
    noise = 5.0 * np.sin(13.7 * x + 7.3 * y) / np.sqrt(budget + 1e-9)
    return float(val + noise)


def hartmann6_space(seed=None) -> ConfigurationSpace:
    cs = ConfigurationSpace(seed=seed)
    for i in range(6):
        cs.add_hyperparameter(UniformFloatHyperparameter(f"x{i}", 0.0, 1.0))
    return cs


_H6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2], np.float32)
_H6_A = np.array(
    [
        [10, 3, 17, 3.5, 1.7, 8],
        [0.05, 10, 17, 0.1, 8, 14],
        [3, 3.5, 1.7, 10, 17, 8],
        [17, 8, 0.05, 10, 0.1, 14],
    ],
    np.float32,
)
_H6_P = 1e-4 * np.array(
    [
        [1312, 1696, 5569, 124, 8283, 5886],
        [2329, 4135, 8307, 3736, 1004, 9991],
        [2348, 1451, 3522, 2883, 3047, 6650],
        [4047, 8828, 8732, 5743, 1091, 381],
    ],
    np.float32,
)


@functools.lru_cache(maxsize=None)
def _hartmann6_constants(dev: torch.device):
    """Hartmann-6's constants on ``dev``, uploaded on the first call there:
    an upload from host memory synchronises, and a CUDA graph cannot
    capture it."""
    return tuple(torch.as_tensor(x, device=dev) for x in (_H6_A, _H6_P, _H6_ALPHA))


def hartmann6(vectors: torch.Tensor, budget: float) -> torch.Tensor:
    """Hartmann-6 on [0,1]^6; global minimum ~-3.3224."""
    a, p, alpha = _hartmann6_constants(vectors.device)
    inner = (a[None] * torch.square(vectors[:, None, :] - p[None])).sum(-1)
    val = -(alpha[None] * torch.exp(-inner)).sum(-1)
    noise = 0.5 * torch.sin(31.0 * vectors.sum(-1)) / math.sqrt(budget + 1e-9)
    return val + noise


def hartmann6_from_vector(vec: torch.Tensor, budget: float) -> torch.Tensor:
    """Hartmann-6 of one vector ``f32[6]`` (a 0-dim tensor)."""
    return hartmann6(vec[None], budget)[0]


#: Counting Ones' binary (categorical) and continuous dims, in that order
COUNTING_ONES_DIMS = (16, 16)

_MASK32 = 0xFFFFFFFF


def counting_ones_space(seed=None) -> ConfigurationSpace:
    """``c0..c15``, each a choice of (0, 1), then ``x0..x15`` in [0, 1]."""
    n_cat, n_cont = COUNTING_ONES_DIMS
    cs = ConfigurationSpace(seed=seed)
    for i in range(n_cat):
        cs.add_hyperparameter(CategoricalHyperparameter(f"c{i}", (0, 1)))
    for i in range(n_cont):
        cs.add_hyperparameter(UniformFloatHyperparameter(f"x{i}", 0.0, 1.0))
    return cs


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A fixed 32-bit integer mix of ``h`` (int64 holding values below
    2**32). Each multiplier is below 2**31, so no product leaves int64."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _MASK32
    h = h ^ (h >> 15)
    h = (h * 0x68E31DA5) & _MASK32
    return h ^ (h >> 16)


def counting_ones_uniforms(x: torch.Tensor, draws: int) -> torch.Tensor:
    """The uniforms behind ``draws`` Bernoulli draws of every continuous
    value ``x f32[n, m]``: ``f32[n, m, draws]``, each the top 24 bits of
    the mix of the value's float32 bits, its dim, the draw's index and the
    budget, over 2**24 (exact in float32)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    dims = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    h = _mix32(_mix32(_mix32(bits) ^ dims) ^ int(draws))
    k = torch.arange(int(draws), dtype=torch.int64, device=x.device)
    h = _mix32(h[..., None] ^ k)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def counting_ones(vectors: torch.Tensor, budget: float) -> torch.Tensor:
    """Counting Ones on ``f32[n, 32]``: minus the sum of the 16 binary
    values and of each continuous dim's mean of ``budget`` Bernoulli(x)
    draws (a draw is ``u < x`` in float32); the minimum is -32."""
    n_cat, _ = COUNTING_ONES_DIMS
    draws = max(int(round(float(budget))), 1)
    x = vectors[:, n_cat:].to(torch.float32)
    ones = (counting_ones_uniforms(x, draws) < x[..., None]).to(torch.float32)
    means = ones.sum(-1) / float(draws)
    return -(vectors[:, :n_cat].to(torch.float32).sum(-1) + means.sum(-1))
