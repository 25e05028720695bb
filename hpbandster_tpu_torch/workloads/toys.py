"""Synthetic HPO objectives: Branin (2-D) and Hartmann-6 (6-D).

Ported from ``hpbandster_tpu/workloads/toys.py`` as batched torch functions
``f(vectors f32[n, d], budget) -> f32[n]`` on the unit hypercube
(:func:`branin`, :func:`hartmann6`), with the reference's per-vector forms
(``branin_from_vector``, ``hartmann6_from_vector``: one ``f32[d]`` vector
-> a 0-dim loss) and its host-side ``branin_dict``. Budget enters as a
decaying deterministic noise term, so lower fidelities are noisier.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from hpbandster_tpu_torch.space import ConfigurationSpace, UniformFloatHyperparameter

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
