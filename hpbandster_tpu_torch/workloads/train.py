"""Momentum-SGD training shared by the batched workloads.

Ported from ``hpbandster_tpu/workloads/train.py`` (``momentum_sgd_train``),
batched over a leading config axis: every parameter leaf is ``[n, ...]``,
one lane per config, and ``lr``, ``momentum`` and ``wd`` are ``f32[n]``.
Where the reference ``vmap``s a per-config loop, the port trains all lanes
in one loop: the per-lane losses ``f32[n]`` are differentiated with a
vector of ones as the output gradient, which is each lane's own gradient
exactly (no parameter is shared across lanes, and no op reduces across
them), so a diverged lane (NaN) leaves every other lane unchanged.

The loop is capture-safe: the step count and the minibatch offsets are
Python integers, and nothing reads a value back from the device, so a
CUDA graph can record a whole training run, backward passes included.

Also here: the four-knob search space and its decoder that the MLP, CNN,
teacher and transformer workloads share (each module exports it under the
reference's name).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.obs.runtime import UniformSteps
from hpbandster_tpu_torch.ops.fused import tree_leaves, tree_map
from hpbandster_tpu_torch.space import ConfigurationSpace, UniformFloatHyperparameter

__all__ = [
    "budget_steps",
    "momentum_sgd_steps",
    "momentum_sgd_train",
    "sgd_space",
    "decode_sgd_hparams",
    "pow10",
    "lane_scaled",
    "make_generator",
    "workload_inputs",
]


def sgd_space(seed=None) -> ConfigurationSpace:
    """lr (log), momentum, weight decay (log), init scale (log)."""
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameter(UniformFloatHyperparameter("lr", 1e-4, 1.0, log=True))
    cs.add_hyperparameter(UniformFloatHyperparameter("momentum", 0.0, 0.99))
    cs.add_hyperparameter(
        UniformFloatHyperparameter("weight_decay", 1e-7, 1e-2, log=True)
    )
    cs.add_hyperparameter(
        UniformFloatHyperparameter("init_scale", 0.1, 10.0, log=True)
    )
    return cs


def pow10(lo: float, span: float, v: torch.Tensor) -> torch.Tensor:
    """``10 ** (lo + span * v)`` in float32, as the reference's decoders
    compute it: the exponent rounded once (XLA contracts ``lo + span * v``
    into one fused multiply-add), the power correctly rounded (computed in
    float64, rounded once), so the CPU and the card give the same bits."""
    e = (lo + span * v.double()).float()
    return torch.pow(10.0, e.double()).float()


def decode_sgd_hparams(vectors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Unit-cube vectors ``f32[n, 4]`` -> ``(lr, momentum, weight_decay,
    init_scale)``, each ``f32[n]``; mirrors :func:`sgd_space`'s codec."""
    lr = pow10(-4.0, 4.0, vectors[:, 0])
    momentum = 0.99 * vectors[:, 1]
    wd = pow10(-7.0, 5.0, vectors[:, 2])
    init_scale = pow10(-1.0, 2.0, vectors[:, 3])
    return lr, momentum, wd, init_scale


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``: the port's
    counterpart of the reference's ``jax.random.key(seed)``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def workload_inputs(device, data_seed: int, data, init, make_data, draw_unit):
    """The resolved device (``None`` means CUDA, and raises without it), the
    dataset and the unit-scale initial weights of a workload: the dataset
    ``make_data(generator)`` from a generator seeded with ``data_seed``, the
    weights ``draw_unit(generator)`` from one seeded with ``data_seed + 1``,
    where ``data`` / ``init`` are None; given ones are moved to the device."""
    dev = resolve_device(device)
    if data is None:
        data = make_data(make_generator(dev, data_seed))
    if init is None:
        init = draw_unit(make_generator(dev, data_seed + 1))
    return dev, tree_map(lambda t: t.to(dev), data), tree_map(lambda t: t.to(dev), init)


def lane_scaled(unit: Dict, scale: torch.Tensor, keep=()) -> Dict:
    """Per-lane parameters from the unit-scale tree ``unit`` (nested dicts
    of ``[...]`` leaves): ``scale[i] * leaf`` for lane ``i`` (``[n, ...]``
    leaves; the reference's initialisers are linear in ``init_scale``),
    except leaves whose key is in ``keep``, which every lane takes as they
    are."""
    n = scale.shape[0]

    def walk(tree):
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                out[key] = walk(leaf)
                continue
            lanes = leaf.unsqueeze(0).expand(n, *leaf.shape)
            out[key] = (lanes.contiguous() if key in keep
                        else _lane_view(scale, leaf.dim() + 1) * lanes)
        return out

    return walk(unit)


def _lane_view(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``f32[n]`` shaped to broadcast against ``[n, ...]`` of ``ndim`` dims."""
    return x.reshape((x.shape[0],) + (1,) * (ndim - 1))


def _rebuild(tree, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def budget_steps(budget) -> int:
    """The reference's step count: it compares its counter with
    ``budget.astype(int32)`` on a float32 budget, so truncate the float32
    value (``26.999999999999996`` is ``27.0`` in float32)."""
    return int(np.float32(budget))


LossFn = Callable[[Dict, torch.Tensor, torch.Tensor], torch.Tensor]


def momentum_sgd_steps(params, velocity, lr, momentum, wd, train, n_steps: int,
                       step0: int, loss_fn: LossFn, batch_size: int, n_train: int):
    """``n_steps`` momentum-SGD steps from step ``step0`` of the minibatch
    cycle. ``loss_fn(params, xb, yb) -> f32[n]`` gives each lane's loss on
    the minibatch. Returns ``(params, velocity)``."""
    x_tr, y_tr = train
    batch_size = min(int(batch_size), int(n_train))
    n_batches = max(int(n_train) // batch_size, 1)
    p = [t.detach() for t in tree_leaves(params)]
    v = [t.detach() for t in tree_leaves(velocity)]
    lr_, mom_, wd_ = ([_lane_view(h, t.dim()) for t in p] for h in (lr, momentum, wd))
    # every step dispatches the same ops on the same shapes: a cost count
    # takes the first step's for the rest
    steps = UniformSteps()
    for step in range(step0, step0 + int(n_steps)):
        start = (step % n_batches) * batch_size
        with steps.step():
            xb, yb = x_tr[start:start + batch_size], y_tr[start:start + batch_size]
            p = [t.requires_grad_(True) for t in p]
            with torch.enable_grad():
                losses = loss_fn(_rebuild(params, p), xb, yb)
                grads = torch.autograd.grad(losses, p, torch.ones_like(losses))
            with torch.no_grad():
                v = [m * vi + g + w * pi for m, vi, g, w, pi in zip(mom_, v, grads, wd_, p)]
                p = [pi - l * vi for pi, l, vi in zip(p, lr_, v)]
    return _rebuild(params, p), _rebuild(velocity, v)


def momentum_sgd_train(params, lr, momentum, wd, train, budget, loss_fn: LossFn,
                       batch_size: int, n_train: int):
    """Train ``params`` (``[n, ...]`` leaves) with momentum SGD for
    ``budget_steps(budget)`` steps from zero velocity; minibatches cycle
    through ``train = (x, y)``. ``batch_size`` is clamped to the dataset
    size, as in the reference."""
    velocity = tree_map(torch.zeros_like, params)
    params, _ = momentum_sgd_steps(params, velocity, lr, momentum, wd, train,
                                   budget_steps(budget), 0, loss_fn, batch_size,
                                   n_train)
    return params
