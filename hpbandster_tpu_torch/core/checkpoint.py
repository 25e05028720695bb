"""Mid-run optimizer checkpoints: a Master-driven optimizer resumes
mid-bracket, a chunked ``FusedBOHB`` run from its last chunk boundary.

Ported from ``hpbandster_tpu/core/checkpoint.py``: the Master half
(``master_state_dict``, ``restore_master_state``, ``save_checkpoint``,
``load_checkpoint``: every bracket's ``Datum`` bookkeeping, the stage
pointers and the config generator's state, with in-flight configs rolled
back to QUEUED) and the fused half (``_datum_state``, ``_iteration_state``,
``_restore_iteration``, ``_check_iteration_shape``, ``_rank_fn_name``,
``fused_state_dict``, ``restore_fused_state``, ``_atomic_pickle``,
``save_fused_checkpoint``, ``load_fused_checkpoint``). The format, its
version, keys and guards are the reference's, and the pickle holds only
Python and numpy values. A fused checkpoint written by the reference's
``FusedBOHB`` loads here and the other way round. A Master checkpoint of
``BOHB`` or ``H2BO`` does not cross: the reference's holds its generator's
jax key, the port's a ``torch.Generator`` state, and each side's
``BOHBKDE.set_state`` refuses the other's. The port scores candidates in the reference's Pallas form (flat
candidate draw, ``diff**2 < 0.25`` match test), so it writes
``use_pallas: True`` and refuses a checkpoint written with
``use_pallas=False``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np

from hpbandster_tpu_torch.core.iteration import Datum, Status

__all__ = [
    "master_state_dict",
    "restore_master_state",
    "save_checkpoint",
    "load_checkpoint",
    "fused_state_dict",
    "restore_fused_state",
    "save_fused_checkpoint",
    "load_fused_checkpoint",
]

_FORMAT_VERSION = 1


def _datum_state(d: Datum) -> Dict[str, Any]:
    status = d.status
    if status == Status.RUNNING:  # re-run interrupted evaluations on resume
        status = Status.QUEUED
    return {
        "config": d.config,
        "config_info": d.config_info,
        "results": d.results,
        "time_stamps": d.time_stamps,
        "exceptions": d.exceptions,
        "infos": d.infos,
        "status": int(status),
        "budget": d.budget,
    }


def _iteration_state(it) -> Dict[str, Any]:
    return {
        "HPB_iter": it.HPB_iter,
        "num_configs": list(it.num_configs),
        "budgets": list(it.budgets),
        "stage": it.stage,
        "actual_num_configs": list(it.actual_num_configs),
        "is_finished": it.is_finished,
        "data": {cid: _datum_state(d) for cid, d in it.data.items()},
    }


def _restore_iteration(it, it_state: Dict[str, Any]) -> None:
    it.stage = it_state["stage"]
    it.actual_num_configs = list(it_state["actual_num_configs"])
    it.is_finished = it_state["is_finished"]
    it.num_running = 0
    it.data = {}
    for cid, ds in it_state["data"].items():
        d = Datum(
            config=ds["config"],
            config_info=ds["config_info"],
            results=ds["results"],
            time_stamps=ds["time_stamps"],
            exceptions=ds["exceptions"],
            status=Status(ds["status"]),
            budget=ds["budget"],
        )
        d.infos = dict(ds.get("infos", {}))
        it.data[tuple(cid)] = d


def _check_iteration_shape(it, it_state: Dict[str, Any]) -> None:
    if list(it.num_configs) != it_state["num_configs"] or [
        float(b) for b in it.budgets
    ] != it_state["budgets"]:
        raise ValueError(
            f"iteration {it_state['HPB_iter']} shape mismatch: checkpoint "
            f"{it_state['num_configs']}@{it_state['budgets']} vs "
            f"{list(it.num_configs)}@{list(it.budgets)} — was the "
            "optimizer constructed with different eta/budget settings?"
        )


def master_state_dict(master) -> Dict[str, Any]:
    """Snapshot a Master (under its own lock) into a picklable dict."""
    with master.thread_cond:
        state = {
            "format_version": _FORMAT_VERSION,
            "config": dict(master.config),
            "time_ref": master.time_ref,
            "iterations": [_iteration_state(it) for it in master.iterations],
        }
        if hasattr(master.config_generator, "get_state"):
            state["config_generator"] = master.config_generator.get_state()
    return state


def restore_master_state(master, state: Dict[str, Any]) -> None:
    """Rehydrate a freshly constructed Master from :func:`master_state_dict`.

    The Master must have the same bracket arithmetic (eta, budgets): the
    iterations are rebuilt by ``get_next_iteration`` and their shapes
    checked against the snapshot.
    """
    if state.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {state.get('format_version')}")
    if state.get("kind") == "fused":
        raise ValueError("fused-tier checkpoint (use FusedBOHB.load_checkpoint)")
    with master.thread_cond:
        if master.iterations:
            raise RuntimeError("can only restore into a fresh Master")
        master.config.update(state["config"])
        master.time_ref = state["time_ref"]
        if "config_generator" in state and hasattr(
            master.config_generator, "set_state"
        ):
            master.config_generator.set_state(state["config_generator"])
        for it_state in state["iterations"]:
            it = master.get_next_iteration(
                it_state["HPB_iter"], {"result_logger": master.result_logger}
            )
            _check_iteration_shape(it, it_state)
            _restore_iteration(it, it_state)
            master.iterations.append(it)


def _rank_fn_name(fn) -> Any:
    """Stable identity of a promotion-rank callable: ``__qualname__`` where
    it has one, else its type's (never ``repr``, which embeds an
    address)."""
    if fn is None:
        return None
    name = getattr(fn, "__qualname__", None)
    return name if name is not None else type(fn).__qualname__


def fused_state_dict(opt) -> Dict[str, Any]:
    """Snapshot a fused optimizer at a chunk boundary: the replayed bracket
    bookkeeping, the warm observations (the device model's whole memory),
    the bracket rotation and the numpy RNG state, so a resumed run draws the
    chunk seeds an uninterrupted run would have drawn."""
    return {
        "format_version": _FORMAT_VERSION,
        "kind": "fused",
        "optimizer_class": type(opt).__name__,
        "promotion_rank_fn": _rank_fn_name(opt.promotion_rank_fn),
        "use_pallas": True,
        "config": dict(opt.config),
        "iterations": [_iteration_state(it) for it in opt.iterations],
        "warm_v": {b: np.asarray(v) for b, v in opt._warm_v.items()},
        "warm_l": {b: np.asarray(l) for b, l in opt._warm_l.items()},
        "rng_state": opt.rng.bit_generator.state,
        "total_evaluated": opt.total_evaluated,
        "run_stats": list(opt.run_stats),
    }


def restore_fused_state(opt, state: Dict[str, Any]) -> None:
    """Rehydrate a freshly constructed fused optimizer from
    :func:`fused_state_dict`; its next ``run()`` continues with the
    remaining brackets. Constructor settings must match (checked), and
    nothing is changed unless every check passes."""
    from hpbandster_tpu_torch.core.successive_halving import SuccessiveHalving

    if state.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {state.get('format_version')}"
        )
    if state.get("kind") != "fused":
        raise ValueError("not a fused-tier checkpoint")
    if opt.iterations:
        raise RuntimeError("can only restore into a fresh optimizer")
    # checkpoints older than these keys skip the class/semantics guard, as
    # in the reference
    if "optimizer_class" in state:
        if state["optimizer_class"] != type(opt).__name__:
            raise ValueError(
                f"checkpoint was written by {state['optimizer_class']}, "
                f"restoring into {type(opt).__name__} — promotion semantics "
                "would silently change; construct the matching class"
            )
        mine_rank = _rank_fn_name(opt.promotion_rank_fn)
        if state["promotion_rank_fn"] != mine_rank:
            raise ValueError(
                f"checkpoint promotion_rank_fn {state['promotion_rank_fn']!r} "
                f"!= optimizer's {mine_rank!r} — resume requires identical "
                "promotion semantics"
            )
        if not state["use_pallas"]:
            raise ValueError(
                "checkpoint used use_pallas=False (the XLA scorer's draws); "
                "the port scores in the Pallas form and cannot continue it"
            )
    # the KDE knobs must match too, or the resumed run silently diverges
    ckpt_knobs = {k: v for k, v in state["config"].items() if k != "time_ref"}
    mine = {k: v for k, v in opt.config.items() if k != "time_ref"}
    if ckpt_knobs != mine:
        diff = sorted(
            k for k in set(ckpt_knobs) | set(mine)
            if ckpt_knobs.get(k) != mine.get(k)
        )
        raise ValueError(
            f"checkpoint optimizer settings differ from constructor settings "
            f"in {diff} — resume requires identical knobs"
        )

    def no_sampler(budget):
        raise RuntimeError("restored fused brackets must not sample configs")

    # build and validate everything before touching the optimizer, so a
    # mismatch leaves it untouched (and retryable with the right file)
    restored = []
    for it_state in state["iterations"]:
        plan = opt._plan(it_state["HPB_iter"])
        it = SuccessiveHalving(
            HPB_iter=it_state["HPB_iter"],
            num_configs=list(plan.num_configs),
            budgets=list(plan.budgets),
            config_sampler=no_sampler,
            result_logger=opt.result_logger,
        )
        _check_iteration_shape(it, it_state)
        _restore_iteration(it, it_state)
        restored.append(it)
    opt.config.update(state["config"])
    opt.iterations.extend(restored)
    opt._warm_v = {float(b): v for b, v in state["warm_v"].items()}
    opt._warm_l = {float(b): l for b, l in state["warm_l"].items()}
    opt.rng.bit_generator.state = state["rng_state"]
    opt.total_evaluated = int(state["total_evaluated"])
    # resumed chunks continue the chunk numbering and keep the timing trail
    opt.run_stats = list(state.get("run_stats", []))


def _atomic_pickle(state: Dict[str, Any], path: str) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(state, fh)
    os.replace(tmp, path)  # atomic: a crash mid-write never corrupts


def save_checkpoint(master, path: str) -> None:
    _atomic_pickle(master_state_dict(master), path)


def load_checkpoint(master, path: str) -> None:
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    restore_master_state(master, state)


def save_fused_checkpoint(opt, path: str) -> None:
    _atomic_pickle(fused_state_dict(opt), path)


def load_fused_checkpoint(opt, path: str) -> None:
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    restore_fused_state(opt, state)
