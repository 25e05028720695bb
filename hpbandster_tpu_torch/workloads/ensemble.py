"""Batched SGD ensembles: real-model training under the fused sweep with
warm continuation.

Ported from ``hpbandster_tpu/workloads/ensemble.py``: the
:class:`~hpbandster_tpu_torch.ops.fused.StatefulEval` that trains a whole
rung of MLPs at once. Parameters and momentum buffers for every config
stack on a leading config axis; budget = CUMULATIVE SGD step count,
consumed incrementally: a rung trains ``steps(budget) - steps(prev_budget)``
fresh steps, cycling minibatches from the offset ``steps(prev_budget)``.
The bracket gathers the surviving lanes by the rung's promoted indices, so
a promoted config continues from its own weights, and its state equals an
uninterrupted run of the same cumulative step count
(:func:`make_uninterrupted_train_fn`).

No op reduces across lanes (see ``workloads/train.py``), so a diverged
lane's NaN stays in its lane, and its NaN loss ranks behind every real
loss. On a mesh the fused bracket splits the lanes over the config axis
and gathers them back between rungs (``ops.fused.fused_sh_bracket(mesh=)``);
:func:`shard_ensemble_state` places a state for a mesh by hand.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hpbandster_tpu_torch.ops.fused import StatefulEval, _shard_state, tree_map
from hpbandster_tpu_torch.workloads.mlp import (
    MLPConfig,
    _xent,
    decode_mlp_hparams,
    draw_mlp_unit_params,
    init_mlp_params,
    make_synthetic_dataset,
    mlp_forward,
)
from hpbandster_tpu_torch.workloads.train import momentum_sgd_steps, workload_inputs

__all__ = [
    "EnsembleState",
    "ensemble_lane_bytes",
    "make_mlp_ensemble",
    "make_uninterrupted_train_fn",
    "shard_ensemble_state",
]


class EnsembleState(NamedTuple):
    """Live training state of a whole rung: every leaf carries a leading
    config axis (lane ``i`` belongs to config row ``i``)."""

    params: dict
    velocity: dict


def _steps(budget) -> int:
    """Budget -> cumulative SGD step count. Round, not truncate: a rung
    trains ``steps(b_s) - steps(b_{s-1})`` fresh steps, and 26.999999
    means 27 (``workloads/train.py`` truncates, as its reference does)."""
    return int(round(float(budget)))


def ensemble_lane_bytes(cfg: MLPConfig = MLPConfig()) -> int:
    """Device bytes ONE lane of ensemble state occupies (float32 params and
    the same-shape momentum buffer): a rung of ``n`` configs holds ``n``
    times this, plus the shared dataset."""
    n_params = (
        cfg.d_in * cfg.width + cfg.width
        + cfg.width * cfg.width + cfg.width
        + cfg.width * cfg.n_classes + cfg.n_classes
    )
    return 2 * 4 * n_params


def shard_ensemble_state(state, mesh, axis: str = "config"):
    """An ensemble state placed for a mesh: every leaf through
    ``ops.fused.shard_rows`` (its rows on the mesh's home device, from
    where a sharded rung splits them per shard). Identity on values, the
    contract ``shard_rows`` keeps for loss batches. The fused bracket does
    this between rungs; call it only when driving ``step_fn`` by hand on a
    mesh."""
    return _shard_state(state, mesh, axis)


def make_mlp_ensemble(cfg: MLPConfig = MLPConfig(), data_seed: int = 0, device=None,
                      data=None, init: Optional[dict] = None) -> StatefulEval:
    """The batched-SGD MLP ensemble as a :class:`StatefulEval`.

    ``init_fn(vectors f32[n, 4])`` makes fresh lanes (each config's
    ``init_scale`` times the shared unit-scale weights, zero velocity);
    ``step_fn(state, vectors, budget, prev_budget)`` advances each lane
    from ``prev_budget`` to ``budget`` cumulative steps and returns
    ``(state, validation losses f32[n])``. The dataset and the initial
    weights are fixed (``data_seed``, or ``data=`` / ``init=``), so a lane's
    trajectory is a function of its config vector and step count alone."""
    _, (train, (x_val, y_val)), unit = workload_inputs(
        device, data_seed, data, init,
        lambda g: make_synthetic_dataset(g, cfg), lambda g: draw_mlp_unit_params(g, cfg))

    def loss_fn(p, xb, yb):
        return _xent(mlp_forward(p, xb), yb)

    def init_fn(vectors: torch.Tensor) -> EnsembleState:
        params = init_mlp_params(unit, decode_mlp_hparams(vectors)[3])
        return EnsembleState(params, tree_map(torch.zeros_like, params))

    def step_fn(state: EnsembleState, vectors: torch.Tensor, budget, prev_budget):
        n_new = _steps(budget) - _steps(prev_budget)
        if n_new < 0:
            raise ValueError(
                f"budget ladder must be non-decreasing: {prev_budget} -> {budget}"
            )
        lr, momentum, wd, _ = decode_mlp_hparams(vectors)
        params, velocity = momentum_sgd_steps(
            state.params, state.velocity, lr, momentum, wd, train, n_new,
            _steps(prev_budget), loss_fn, cfg.batch_size, cfg.n_train)
        with torch.no_grad():
            losses = _xent(mlp_forward(params, x_val), y_val)
        return EnsembleState(params, velocity), losses

    return StatefulEval(init_fn=init_fn, step_fn=step_fn)


def make_uninterrupted_train_fn(cfg: MLPConfig = MLPConfig(), data_seed: int = 0,
                                device=None, data=None, init: Optional[dict] = None):
    """The trainer the warm continuation is held against: ``fn(vectors
    f32[n, 4], n_steps) -> (EnsembleState, losses f32[n])``, a fresh
    ensemble trained straight to ``n_steps`` cumulative steps in one
    segment. A promoted lane's state at the end of the rung ladder equals
    this function's at the same cumulative step count."""
    se = make_mlp_ensemble(cfg, data_seed, device, data, init)

    def uninterrupted_train(vectors: torch.Tensor, n_steps: int):
        return se.step_fn(se.init_fn(vectors), vectors, float(n_steps), 0.0)

    return uninterrupted_train
