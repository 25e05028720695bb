"""The multi-process tier and the sharded 100k-1M configuration tier.

Ported from ``hpbandster_tpu/parallel/multihost.py``: ``initialize_multihost``,
``is_primary_host``, ``MultiHostBatchedExecutor`` (with
``run_sharded_sweep``), ``publish_device_balance``, ``run_sharded_fused_sweep``
and its program cache ``_SHARDED_FN_CACHE``.

* :func:`initialize_multihost` joins a ``torch.distributed`` group (NCCL for
  CUDA, gloo for the CPU); a mesh built over the group's ranks
  (``parallel.mesh.config_mesh``) then makes the same ``VmapBackend``,
  ``FusedBOHB`` and sweep code run across processes.
* :class:`MultiHostBatchedExecutor` is the SPMD driver pattern: every rank
  runs the same Master loop with the same seeds, every sharded evaluation
  gathers each shard's losses to every rank, and only rank 0 talks to
  result loggers. There is no coordination protocol beyond the gathers.
* :func:`run_sharded_fused_sweep` runs one deep bracket of ``2^17`` to
  ``2^20`` configurations, sampled per shard on the device, and fetches only
  the incumbent.

The elastic worker pool (dynamic join and leave) stays on the host tier
(``dispatcher.py``): a mesh's membership is fixed for a run.
"""

from __future__ import annotations

import datetime
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hpbandster_tpu_torch.parallel.batched_executor import BatchedExecutor
from hpbandster_tpu_torch.utils.lru import LRUCache

#: process-wide sharded-sweep cache: one built (on a card, captured) sweep
#: per (objective, chunk schedule, space, mesh, knobs), bounded as
#: ``FusedBOHB``'s sweep cache is: 16 entries, and the device memory their
#: graphs pin (``optimizers.fused_bohb._SWEEP_CACHE_MEMORY_SHARE`` of the card)
_SHARDED_FN_CACHE: LRUCache = LRUCache(maxsize=16)

#: how long a rendezvous or a collective may wait for the other ranks
DEFAULT_TIMEOUT_S = 120.0

__all__ = [
    "initialize_multihost",
    "MultiHostBatchedExecutor",
    "is_primary_host",
    "run_sharded_fused_sweep",
    "publish_device_balance",
]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> int:
    """Join the process group; returns this process's rank.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous (give
    every rank the same); ``backend`` defaults to ``nccl`` where CUDA is
    available, ``gloo`` otherwise. With NCCL each rank takes the card
    ``process_id % device_count`` as its current device (one rank per
    card). Every wait is bounded by ``timeout_s``. Safe to call when
    already initialized (returns the rank) and in single-process mode (no
    coordinator and at most one process: returns 0 and joins nothing); a
    coordinator with ``num_processes=1`` joins a one-rank group."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is None and (num_processes is None or num_processes <= 1):
        return 0
    if coordinator_address is None:
        raise ValueError("a group of several processes needs a coordinator_address")
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def is_primary_host() -> bool:
    """Whether this process is rank 0 (or runs alone)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


class MultiHostBatchedExecutor(BatchedExecutor):
    """BatchedExecutor for SPMD multi-process runs.

    Every rank must construct the identical optimizer (same seeds and
    settings) over a backend whose mesh spans the group, and call
    ``run()``: the Master's control flow is deterministic, so all ranks
    issue the same evaluations in the same order. Side effects (result
    logging, checkpoints) belong to rank 0 alone.
    """

    def __init__(self, backend, configspace, **kwargs):
        super().__init__(backend, configspace, **kwargs)
        #: gate side effects on this: pass a result_logger or checkpoint
        #: path to the Master only where it is True
        self.primary = is_primary_host()

    def run_sharded_sweep(self, n_configs: int, **kwargs) -> Dict[str, Any]:
        """One sharded fused sweep over the whole mesh
        (:func:`run_sharded_fused_sweep`, on the backend's objective unless
        ``eval_fn=`` is given). Every rank calls it with identical
        arguments; the returned incumbent is identical on every rank."""
        eval_fn = kwargs.pop("eval_fn", None) or self.backend.eval_fn
        kwargs.setdefault("mesh", getattr(self.backend, "mesh", None))
        return run_sharded_fused_sweep(eval_fn, self.configspace, n_configs=n_configs, **kwargs)


def publish_device_balance(
    mesh,
    axis: str,
    per_shard_configs: List[int],
    per_shard_pad: List[int],
) -> Optional[float]:
    """Publish per-shard config counts and the compute-balance gauges.

    ``per_shard_configs[s]`` is the number of real config rows shard ``s``
    evaluated in the sweep, ``per_shard_pad[s]`` its padding rows
    (evaluated, never reported). The gauges are ``sweep.device.<s>.configs``
    and ``.pad_rows``, keyed by shard index (a device repeated in the mesh
    still gives each shard its own gauges), for the shards this process
    computes; the Prometheus renderer turns them into the
    ``sweep_device_*{device=}`` family and the fleet collector derives
    ``fleet.device_compute_skew`` from them. Returns the mesh-wide shard
    skew, ``(max - min) / max`` over ``per_shard_configs`` (the same on
    every rank, which also publishes it as ``sweep.balance_skew``), or None
    where it is not measurable."""
    from hpbandster_tpu_torch.obs.metrics import get_metrics
    from hpbandster_tpu_torch.parallel.mesh import batch_sharding, shard_count

    n_shards = shard_count(mesh, axis)
    if len(per_shard_configs) != n_shards:
        raise ValueError(
            f"{len(per_shard_configs)} shard counts for a {n_shards}-shard '{axis}' axis")
    if axis not in mesh.axis_names:
        return None
    reg = get_metrics()
    for s in batch_sharding(mesh, axis).owned():
        reg.gauge(f"sweep.device.{s}.configs").set(float(per_shard_configs[s]))
        reg.gauge(f"sweep.device.{s}.pad_rows").set(float(per_shard_pad[s]))
    hi = max(per_shard_configs) if per_shard_configs else 0
    skew = None if hi <= 0 else (hi - min(per_shard_configs)) / hi
    if skew is not None:
        reg.gauge("sweep.balance_skew").set(round(float(skew), 6))
    return skew


def run_sharded_fused_sweep(
    eval_fn,
    configspace,
    *,
    n_configs: int,
    n_brackets: int = 1,
    min_budget: float = 1.0,
    max_budget: float = 9.0,
    eta: float = 3.0,
    seed: int = 0,
    mesh=None,
    axis: str = "config",
    model: bool = False,
    num_samples: int = 64,
    chunk_brackets: Optional[int] = None,
    publish_gauges: bool = True,
    resident: bool = False,
    device_metrics: Optional[bool] = None,
    stateful_eval=None,
    program_name: Optional[str] = None,
) -> Dict[str, Any]:
    """Mesh-sharded fused successive halving at 100k-1M configurations.

    One deep bracket of ``n_configs`` (stage counts mesh-aligned,
    :func:`~hpbandster_tpu_torch.ops.bracket.mesh_aligned_plan`) repeated
    ``n_brackets`` times as one sharded sweep per chunk shape: per-shard
    sampling on the device (no candidate bytes cross the host link), every
    stage evaluated over the mesh's ``axis`` with the rung ranking on the
    home device, and an incumbent-only payload: the winning vector and loss
    are all that is fetched. Without ``mesh`` the sweep runs over
    ``parallel.mesh.config_mesh()`` (every visible card, or the group's
    ranks). ``model=True`` turns the BOHB KDE on (with ``chunk_brackets``
    the observation state threads from chunk to chunk on the device); the
    default is HyperBand mode, random proposals, where a KDE fit over the
    full observation set would dominate at 1M configurations.

    ``resident=True`` runs the repeated bracket as the resident sweep
    (``ops/sweep.py``; on one card a captured CUDA graph replayed once per
    bracket): one call and one incumbent fetch however many brackets run.
    It replaces ``chunk_brackets`` (passing both is an error).
    ``device_metrics`` (default ``HPB_DEVICE_METRICS``) accumulates the
    metrics plane on the device; it rides the incumbent's fetch, a size set
    by the schedule, so the host link's bill stays flat in the config count
    with telemetry on. The decoded record is published as gauges,
    journaled as ``device_telemetry`` and returned under
    ``"device_telemetry"``. The sweep's transfer gauges
    (``sweep.transfer_bytes.{h2d,d2h}``, ``sweep.host_syncs``) are published
    and returned, and the incumbent is journaled as a ``sweep_incumbent``
    record.

    ``stateful_eval`` (exclusive with ``eval_fn``; pass ``eval_fn=None``)
    runs the sweep over a warm-continuation ensemble
    (``ops.fused.StatefulEval``). ``program_name`` labels the captured
    program in the capture ledger (``make_fused_sweep_fn(program_name=)``),
    so a caller finds its own row in ``obs.profile.roofline_report``.

    Returns a stats dict (incumbent, per-shard balance, chunk timings).
    Multi-process: call on every rank with identical arguments over a mesh
    spanning the group; the returned incumbent is identical on all ranks.
    """
    from hpbandster_tpu_torch.obs.audit import emit_sweep_incumbent
    from hpbandster_tpu_torch.obs.device_metrics import (
        decode_device_metrics,
        device_metrics_default,
        emit_device_telemetry,
        publish_device_metrics,
    )
    from hpbandster_tpu_torch.obs.runtime import (
        note_transfer,
        publish_sweep_transfers,
        transfer_counters,
    )
    from hpbandster_tpu_torch.ops.bracket import mesh_aligned_plan
    from hpbandster_tpu_torch.ops.kde import _moments_fit_requested
    from hpbandster_tpu_torch.ops.sweep import (
        build_space_codec,
        codec_tables,
        make_fused_sweep_fn,
        plan_additions,
        pow2_capacities,
    )
    from hpbandster_tpu_torch.optimizers.fused_bohb import _cache_byte_bound, _pinned_reserved
    from hpbandster_tpu_torch.parallel.mesh import config_mesh, mesh_device, shard_count

    if resident and chunk_brackets is not None:
        raise ValueError(
            "resident=True replaces chunking (one resident sweep for the whole "
            "schedule): drop chunk_brackets")
    if mesh is None:
        mesh = config_mesh()
    device = mesh_device(mesh)
    n_shards = shard_count(mesh, axis)
    plan = mesh_aligned_plan(n_configs, min_budget, max_budget, eta, n_shards)
    plans = [plan] * max(int(n_brackets), 1)
    codec = build_space_codec(configspace)
    rng = np.random.default_rng(seed)
    chunk = len(plans) if (chunk_brackets is None or resident) else max(int(chunk_brackets), 1)
    dynamic = resident or chunk_brackets is not None
    use_dm = device_metrics_default() if device_metrics is None else bool(device_metrics)
    tables = codec_tables(codec, device)
    sweep_kwargs: Dict[str, Any] = dict(
        device=device,
        tables=tables,
        num_samples=num_samples,
        mesh=mesh,
        axis=axis,
        shard_sampling=True,
        incumbent_only=True,
        # HyperBand mode: an unreachable gate keeps the KDE out of the
        # sweep entirely (any_trainable is False)
        min_points_in_model=None if model else 2**30,
    )
    # one capacity map for the whole schedule (pow2, floor 256): every chunk
    # shares buffer shapes, so the run is one sweep and the threaded state
    # never re-uploads
    caps = pow2_capacities(plan_additions(plans)) if dynamic else None

    link0 = transfer_counters()
    fns: Dict[int, Any] = {}
    chunks: List[Dict[str, Any]] = []
    best: Optional[Dict[str, Any]] = None
    per_bracket_all: List[float] = []
    dm_parts: List[Any] = []
    dm_execute_s = 0.0
    state = None
    remaining = list(plans)
    bracket_base = 0
    while remaining:
        chunk_plans, remaining = remaining[:chunk], remaining[chunk:]
        if len(chunk_plans) not in fns:
            # process-wide reuse: repeats of the same objective, schedule,
            # mesh and knobs build (and on a card capture) once
            cache_key = (
                (eval_fn, stateful_eval),
                tuple((p.num_configs, p.budgets) for p in chunk_plans),
                codec.signature, mesh, axis, bool(model), int(num_samples),
                dynamic, bool(resident),
                None if caps is None else tuple(sorted(caps.items())),
                # a sweep bakes in the fit path it was built with
                _moments_fit_requested(),
                # telemetry adds outputs to the sweep
                use_dm,
                program_name,
            )
            cached = _SHARDED_FN_CACHE.get(cache_key)
            if cached is None:
                reserved0 = _pinned_reserved(device)
                cached = make_fused_sweep_fn(
                    eval_fn, chunk_plans, codec,
                    dynamic_counts=dynamic,
                    capacities=caps,
                    # resident runs the whole schedule in one call: there is
                    # no next chunk to thread state into
                    return_state=dynamic and not resident,
                    resident=resident,
                    device_metrics=use_dm,
                    stateful_eval=stateful_eval,
                    program_name=program_name,
                    **sweep_kwargs,
                )
                prepare = getattr(cached, "prepare", None)
                if prepare is not None:
                    prepare()  # on a card: the capture, charged to the build
                _SHARDED_FN_CACHE.put(cache_key, cached,
                                      nbytes=max(_pinned_reserved(device) - reserved0, 0),
                                      max_bytes=_cache_byte_bound(device))
            fns[len(chunk_plans)] = cached
        fn = fns[len(chunk_plans)]
        sweep_seed = int(np.uint32(rng.integers(2**32, dtype=np.uint32)))
        # the previous chunk's device state, or none: a sweep given no warm
        # inputs starts from empty buffers it makes on the device, so nothing
        # goes up (the reference streams zeroed slices for a first chunk)
        args = () if state is None else state
        t0 = time.perf_counter()
        out = fn(sweep_seed, *args)
        dm_dev = None
        if dynamic and not resident:
            if use_dm:
                inc, dm_dev, state = out
            else:
                inc, state = out
        elif use_dm:
            inc, dm_dev = out
        else:
            inc = out
        inc_host = [t.cpu().numpy() for t in inc]
        dm_host = None if dm_dev is None else type(dm_dev)(*(t.cpu().numpy() for t in dm_dev))
        execute_s = time.perf_counter() - t0
        dm_leaves = [] if dm_host is None else list(dm_host)
        if dm_host is not None:
            dm_parts.append((dm_host, [(p.num_configs, p.budgets) for p in chunk_plans]))
            dm_execute_s += execute_s
        note_transfer("d2h", sum(a.nbytes for a in inc_host + dm_leaves),
                      buffers=len(inc_host) + len(dm_leaves))
        vector, loss_a, bracket, per_bracket = inc_host
        loss = float(loss_a)
        cand = {
            "vector": np.asarray(vector, np.float32).tolist(),
            "loss": loss,
            "bracket": bracket_base + int(bracket),
        }
        per_bracket_all.extend(float(x) for x in per_bracket)
        # NaN = every candidate crashed; it never beats a real incumbent
        if best is None or (not np.isnan(loss) and (
                best["loss"] is None or np.isnan(best["loss"]) or loss < best["loss"])):
            best = cand
        chunks.append({
            "brackets": len(chunk_plans),
            "execute_fetch_s": round(execute_s, 4),
            # 0: the seed seeds the device's generators from the host, and
            # the warm state is made (or kept) on the device
            "warm_upload_bytes": 0,
        })
        bracket_base += len(chunk_plans)

    # every stage splits its mesh-aligned rows evenly, so each shard owns
    # sum(widths) / S rows per bracket; each row is a real sampled config
    # (the alignment surplus over the pure eta ladder is extra exploration,
    # reported apart), so no shard has padding rows
    pure = [max(int(n_configs * float(eta) ** (-j)), 1) for j in range(len(plan.num_configs))]
    per_shard_rows = sum(plan.num_configs) // n_shards * len(plans)
    surplus_total = (sum(plan.num_configs) - sum(pure)) * len(plans)
    per_shard_configs = [per_shard_rows] * n_shards
    skew = None
    if publish_gauges:
        skew = publish_device_balance(mesh, axis, per_shard_configs, [0] * n_shards)

    link = publish_sweep_transfers(link0)
    host_syncs = link["transfers_h2d"] + link["transfers_d2h"]
    decoded_dm = None
    if dm_parts:
        decoded_dm = decode_device_metrics(dm_parts, execute_s=dm_execute_s)
        publish_device_metrics(decoded_dm)
        emit_device_telemetry(decoded_dm)
    evaluations = int(sum(sum(p.num_configs) for p in plans))
    if best is not None:
        emit_sweep_incumbent(
            vector=best["vector"], loss=best["loss"], bracket=best["bracket"],
            per_bracket_loss=per_bracket_all, evaluations=evaluations,
            n_configs=int(n_configs), d2h_bytes=link["transfer_bytes_d2h"],
            h2d_bytes=link["transfer_bytes_h2d"], host_syncs=host_syncs,
        )
    return {
        "incumbent": best,
        "evaluations": evaluations,
        "requested_configs": int(n_configs),
        "aligned_stage_counts": list(plan.num_configs),
        "budgets": list(plan.budgets),
        "n_brackets": len(plans),
        "n_devices": int(mesh.size),
        "n_shards": n_shards,
        "per_device_configs": per_shard_configs,
        # rows evaluated beyond the pure eta ladder for the mesh alignment
        # (whole schedule, all shards), already inside per_device_configs
        # and evaluations
        "alignment_surplus_rows": int(surplus_total),
        "balance_skew": 0.0 if skew is None else round(float(skew), 6),
        "chunks": chunks,
        "execute_fetch_s": round(sum(c["execute_fetch_s"] for c in chunks), 4),
        "resident": bool(resident),
        "device_telemetry": decoded_dm,
        "per_bracket_loss": per_bracket_all,
        # the host link's bill for this sweep (transfer ledger deltas)
        "h2d_bytes": int(link["transfer_bytes_h2d"]),
        "d2h_bytes": int(link["transfer_bytes_d2h"]),
        "host_syncs": int(host_syncs),
    }
