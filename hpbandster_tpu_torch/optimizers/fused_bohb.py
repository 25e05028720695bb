"""FusedBOHB: the whole-sweep optimizer driver, on PyTorch.

Ported from ``hpbandster_tpu/optimizers/fused_bohb.py``: ``FusedBOHB``
(``__init__`` with conditions, forbidden clauses, ``previous_result=`` and
the ``stateful_eval=`` seam, ``_plan``, the chunked ``run`` on the static
and dynamic-count tiers and its ``resident=`` tier, the device-metrics
plane, ``run_incumbent``, ``save_checkpoint``/``load_checkpoint``,
``_accumulate_obs``, ``_replay_bracket``), ``_ReplayIteration`` and the
subclasses ``FusedHyperBand``, ``FusedH2BO`` and ``FusedRandomSearch``. The
sweep runs on the device (``ops/sweep.py``; the resident tier's rounds as
CUDA graphs on a card); after each chunk the host replays its brackets
into the standard ``SuccessiveHalving`` / ``Datum`` / ``Result``
bookkeeping, so analysis code sees the structures the reference produces.

Each chunk journals one ``sweep_chunk`` record, each replayed bracket its
``bracket_created``, ``config_sampled``, job and promotion records, a
checkpoint ``checkpoint_written``, and ``run_incumbent`` its
``sweep_incumbent`` payload (``hpbandster_tpu_torch.obs``); the decoded
device telemetry is published as gauges and journaled as one
``device_telemetry`` record per call. Every emit runs on the host between
device calls, never inside a captured graph. Each chunk's upload and fetch
count in the transfer ledger (``obs/runtime.py``), and every ``run()`` and
``run_incumbent`` publishes its host-link bill as the
``sweep.transfer_bytes.*`` and ``sweep.host_syncs`` gauges.

Built sweeps are cached process-wide (``_SWEEP_CACHE``, the counterpart of
the reference's ``_SWEEP_EXE_CACHE``), keyed by objective, schedule, space,
knobs and device: on a card a hit replays the captured graph with new
seeds and warm inputs, so a chunk or ``run()`` call of a known shape pays
no capture. The host replays chunk k into the bookkeeping while chunk k+1
runs on the device (``run_stats`` ``replay_overlap_s``); with
``checkpoint_path`` the replay runs in turn. The cache is bounded by its
entry count (16, the reference's) and by the device memory its graphs pin
(``_SWEEP_CACHE_MEMORY_SHARE`` of the card).

``run()`` marks its host phases with the flight recorder's spans
(``obs/timeline.py``), at the reference's sites: ``sweep_planning`` and
``sweep_setup`` (admission), per chunk ``chunk_staging`` and
``telemetry_fetch`` (transfer), ``compile_lookup`` (compile),
``chunk_accounting`` and ``obs_fold`` (promotion), and ``bracket_replay``
(promotion) where a replay runs in turn. The replay that overlaps the next
chunk is no span on the bus, so the journal stays the reference's: its
time is ``replay_overlap_s``. With ``obs.use_profiler_annotations()`` it is
an ``hpb.bracket_replay`` profiler range like the others, and
profiler-only ranges (``obs.annotate``) mark each chunk's launch
(``hpb.chunk_launch``) and the host's wait for its outputs
(``hpb.chunk_fetch``), and each replayed bracket's stage-0 decode
(``hpb.replay_decode``) and its stage writes and promotions
(``hpb.replay_stages``). The replay writes a bracket a stage at a time:
one column-wise decode of its configurations
(``ConfigurationSpace.from_vectors``), then each stage's rows in one pass
(``_ReplayIteration.record_stage``), counted by the ``fused.replay_rows``
and ``fused.replay_stages`` counters.

With ``mesh=`` (``parallel/mesh.py``) every chunk's sweep evaluates its
stages over the mesh's config axis (a mesh alone places rows: the results
are the unmeshed run's for an objective that treats rows independently),
and a dynamic chunk whose warm buffers must be uploaded streams them shard
slice by shard slice (``_stream_warm_args``), so no full-capacity buffer is
built on the host. On a mesh over several processes every rank constructs
the same optimizer and calls ``run()`` (the SPMD driver contract of
``parallel/multihost.py``); pass a ``result_logger`` on rank 0 only.
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.convert import dynamic_obs_from_numpy, warm_obs_from_numpy
from hpbandster_tpu_torch.core.checkpoint import (
    load_fused_checkpoint,
    save_fused_checkpoint,
)
from hpbandster_tpu_torch.core.iteration import Status
from hpbandster_tpu_torch.core.job import Job
from hpbandster_tpu_torch.core.result import Result
from hpbandster_tpu_torch.core.successive_halving import SuccessiveHalving
from hpbandster_tpu_torch.core.warmstart import WarmStartIteration
from hpbandster_tpu_torch.device import resolve_device, upload
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
from hpbandster_tpu_torch.obs.timeline import (
    ADMISSION,
    COMPILE,
    PROMOTION,
    TRANSFER,
    phase_span,
)
from hpbandster_tpu_torch.obs.trace import current_trace, new_trace, use_trace
from hpbandster_tpu_torch.ops.bracket import (
    BracketPlan,
    budget_ladder,
    hyperband_bracket,
    max_sh_iterations,
    power_law_extrapolate,
)
from hpbandster_tpu_torch.ops.fused import StatefulEval, _unpack_stages
from hpbandster_tpu_torch.ops.kde import _moments_fit_requested
from hpbandster_tpu_torch.ops.sweep import (
    build_space_codec,
    codec_tables,
    compile_active_mask,
    compile_forbidden_mask,
    make_fused_sweep_fn,
    plan_additions,
    pow2_capacities,
    resident_rotation,
    unstack_resident_outputs,
)
from hpbandster_tpu_torch.parallel.mesh import (
    Mesh,
    is_multiprocess_mesh,
    mesh_device,
    shard_count,
)
from hpbandster_tpu_torch.space import ConfigurationSpace
from hpbandster_tpu_torch.utils.lru import LRUCache
from hpbandster_tpu_torch.utils.profiling import trace

__all__ = ["FusedBOHB", "FusedHyperBand", "FusedH2BO", "FusedRandomSearch"]

#: process-wide built-sweep cache (the reference's ``_SWEEP_EXE_CACHE``
#: policy): one build, and on a card one capture, per (objective, schedule,
#: space, knobs, device). Values are sweep callables: a hit replays with
#: new seeds and warm inputs, and calls on one entry from several threads
#: take turns. Entries hold their graphs and memory pools until evicted,
#: so besides its entry count the cache is bounded by the bytes they pin.
_SWEEP_CACHE: LRUCache = LRUCache(maxsize=16)

#: the share of a card's memory the cached sweeps may pin in all (the
#: reference caches executables alone; a cached CUDA graph keeps its memory
#: pool, several GB for a CNN sweep). The rest stays free for the sweeps
#: that run. Counted over every card the process uses.
_SWEEP_CACHE_MEMORY_SHARE = 0.5


def _pinned_reserved(device: torch.device) -> int:
    """The card's reserved bytes that something still holds: the caching
    allocator's free blocks are returned first (0 on the CPU). Holds the
    capture lock: emptying the allocator's cache while any thread captures
    a graph is illegal."""
    if device.type != "cuda":
        return 0
    from hpbandster_tpu_torch.ops.graphs import CAPTURE_LOCK

    with CAPTURE_LOCK:
        # emptying the allocator's cache while a capture runs is illegal, so
        # the device-wide wait of its cudaFree happens under the lock
        torch.cuda.empty_cache()  # graftlint: disable=lock-blocking — must exclude captures
        return int(torch.cuda.memory_reserved(device))


def _cache_byte_bound(device: torch.device) -> Optional[int]:
    """The sweep cache's byte bound on ``device`` (None on the CPU)."""
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return int(_SWEEP_CACHE_MEMORY_SHARE * total)


def _publish_telemetry(decoded: Dict[str, Any], trace) -> None:
    """One decoded device-telemetry record to the bus: the gauges, the
    ``device_telemetry`` journal record under the sweep's trace, and one
    ``kde_refit`` event for the fits that happened on the device, which the
    host model's own refit events never see."""
    publish_device_metrics(decoded)
    with use_trace(trace):
        emit_device_telemetry(decoded)
        fits = decoded.get("model_fits")
        if isinstance(fits, (int, float)) and fits > 0 and obs.get_bus().active:
            obs.emit(obs.KDE_REFIT, source="device", fits=int(fits))


def _nbytes(out) -> int:
    """Bytes of a fetched output: numpy arrays in a (nested) tuple."""
    if isinstance(out, np.ndarray):
        return int(out.nbytes)
    if isinstance(out, (tuple, list)):
        return sum(_nbytes(x) for x in out)
    return 0


def _fetch(out):
    """A sweep's device output on the host as numpy: a named tuple (or a
    tuple or list of them) of tensors, the same structure back."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    if hasattr(out, "_fields"):
        return type(out)(*(_fetch(x) for x in out))
    return type(out)(_fetch(x) for x in out)


def _warm_slice(src: Optional[np.ndarray], lo: int, hi: int, tail: tuple,
                fill: float) -> np.ndarray:
    """Rows ``lo:hi`` of a warm buffer on the host: ``src``'s rows where it
    has them, ``fill`` beyond (the streamed upload's one allocation)."""
    buf = np.full((hi - lo,) + tail, fill, np.float32)
    if src is not None and lo < len(src):
        take = src[lo:min(hi, len(src))]
        buf[:len(take)] = take
    return buf


class _ReplayIteration(SuccessiveHalving):
    """SuccessiveHalving whose promotion decisions replay the device's.

    The sweep already decided every promotion on the device; the host
    bookkeeping records those decisions verbatim."""

    promotion_rule = "fused_replay"

    def __init__(self, *args, promotion_sets: List[set], **kwargs):
        super().__init__(*args, **kwargs)
        self._promotion_sets = promotion_sets

    def _advance_to_next_stage(self, config_ids, losses) -> np.ndarray:
        promoted = self._promotion_sets[self.stage]
        return np.array([cid[2] in promoted for cid in config_ids], bool)

    def promotion_cost(self, config_id, budget):
        """Only a cost the evaluation reported: a row's stamps share the
        stage's one clock read, so its wall span measures nothing."""
        return self.reported_cost(config_id, budget)

    def record_stage(self, ids, losses, job_info: Dict[str, Any],
                     working_directory: str) -> int:
        """Record the current stage's device results, ``ids[k]`` (a config's
        index in the bracket) scoring ``losses[k]``, in one pass; returns the
        rows written.

        Each queued row, in ``self.data`` order, ends as ``get_next_run`` and
        ``register_result`` would leave it job by job: ``results`` (None for
        NaN), ``exceptions``, its own ``dict(job_info)`` in ``infos`` (a NaN
        row has none), its own ``time_stamps`` and status ``REVIEW``, with
        its ``job_finished`` / ``job_failed`` record and, with a
        ``result_logger``, its ``Job``. The clock is read once: the stage
        ran in one device program, which ``sweep_chunk`` times. Raises
        ``RuntimeError`` unless ``ids`` are exactly the queued rows and
        number ``num_configs[stage]``, the checks ``register_result`` makes
        job by job."""
        budget = self.budgets[self.stage]
        queued = [(cid, d) for cid, d in self.data.items() if d.status == Status.QUEUED]
        loss_of = dict(zip(np.asarray(ids).tolist(), np.asarray(losses).tolist()))
        if (len(queued) != self.num_configs[self.stage] or len(ids) != len(queued)
                or len(loss_of) != len(queued)
                or any(d.budget != budget or cid[2] not in loss_of for cid, d in queued)):
            raise RuntimeError(
                f"iteration {self.HPB_iter} stage {self.stage}: the device's "
                f"{len(ids)} results are not the {len(queued)} rows queued at "
                f"budget {budget} (the stage holds {self.num_configs[self.stage]})"
            )
        wall, mono = time.time(), time.monotonic()
        emit = obs.get_bus().active
        logger = self.result_logger
        for cid, d in queued:
            loss = loss_of[cid[2]]
            d.time_stamps[budget] = {"submitted": wall, "started": wall, "finished": wall}
            # only NaN means crashed; a genuine +/-inf loss (a diverged run)
            # is a valid maximally-bad result
            if loss != loss:
                info, exception = None, f"non-finite loss {loss!r} at budget {budget}"
                d.results[budget] = None
            else:
                info, exception = dict(job_info), None
                d.results[budget] = loss
                d.infos[budget] = info
            d.exceptions[budget] = exception
            d.status = Status.REVIEW
            if emit:
                # the loss-carrying result record; no run_s, since the
                # evaluation ran inside a device chunk
                obs.emit(
                    obs.JOB_FAILED if exception is not None else obs.JOB_FINISHED,
                    config_id=list(cid), budget=budget,
                    loss=loss if math.isfinite(loss) else None,
                )
            if logger is not None:
                job = Job(cid, config=d.config, budget=budget,
                          working_directory=working_directory)
                job.timestamps = dict(d.time_stamps[budget])
                job.mono = {"submitted": mono, "started": mono, "finished": mono}
                job.result = None if info is None else {"loss": loss, "info": info}
                job.exception = exception
                logger(job)
        return len(queued)


class FusedBOHB:
    """BOHB whose whole sweep runs on the device (or over a mesh's config
    axis: ``mesh``, ``axis``).

    ``eval_fn(vectors f32[n, d], budget) -> f32[n]`` evaluates a batch of
    unit-hypercube configuration vectors at a Python-float budget.
    ``device=None`` means ``cuda`` and raises where CUDA is absent; pass
    ``device="cpu"`` to run the plain PyTorch path on the CPU. In place of
    ``eval_fn``, ``stateful_eval`` (an ``ops.fused.StatefulEval``) trains
    each bracket's configs with warm continuation across its rungs.
    ``previous_result`` (a ``Result``) warm-starts the model with its
    observations, which ride into every later ``Result`` under negative
    iteration ids.

    A space with conditions compiles them to an activity mask on the device
    (inactive dims are 0 for ``eval_fn`` and NaN in the observations); one
    with forbidden clauses redraws forbidden proposals on the device and
    clamps what is still forbidden to a valid fallback configuration drawn
    from the seed. Condition forms without a device representation raise
    ``ValueError`` (``ops.sweep.compile_active_mask``).
    """

    def __init__(
        self,
        configspace: Optional[ConfigurationSpace] = None,
        eval_fn=None,
        run_id: str = "fused",
        eta: float = 3,
        min_budget: float = 0.01,
        max_budget: float = 1,
        min_points_in_model: Optional[int] = None,
        top_n_percent: int = 15,
        num_samples: int = 64,
        random_fraction: float = 1 / 3,
        bandwidth_factor: float = 3.0,
        min_bandwidth: float = 1e-3,
        seed: Optional[int] = None,
        mesh=None,
        axis: str = "config",
        result_logger=None,
        working_directory: str = ".",
        logger: Optional[logging.Logger] = None,
        previous_result: Optional[Result] = None,
        device=None,
        stateful_eval: Optional[StatefulEval] = None,
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh (config_mesh(...)), "
                            f"not {type(mesh).__name__}")
        self.mesh = mesh
        self.axis = axis
        # a mesh's home device holds the rows between stages and the state
        self.device = resolve_device(
            device if mesh is None or device is not None else mesh_device(mesh))
        if configspace is None:
            raise ValueError("you have to provide a valid ConfigurationSpace object")
        if eval_fn is None and stateful_eval is None:
            raise ValueError(
                "FusedBOHB needs a batched eval_fn(vectors f32[n, d], budget) -> "
                "f32[n], or a StatefulEval (ops.fused.StatefulEval)"
            )
        if eval_fn is not None and stateful_eval is not None:
            raise ValueError(
                "eval_fn and stateful_eval are exclusive: one evaluation seam "
                "per optimizer"
            )
        self.configspace = configspace
        self.codec = build_space_codec(configspace)
        #: the codec's constants on the device, uploaded once here for the
        #: masks and every chunk's sweep
        self.codec_tables = codec_tables(self.codec, self.device)
        self.active_mask_fn = (
            compile_active_mask(configspace, self.codec_tables)
            if configspace.get_conditions() else None
        )
        #: the conditions and forbidden clauses as they key the sweep cache
        self._conditions_sig = tuple(repr(c) for c in configspace.get_conditions())
        self._forbiddens_sig = ()
        self.forbidden_fn = self._fallback_vector = None
        if configspace.get_forbiddens():
            self.forbidden_fn = compile_forbidden_mask(configspace, self.codec_tables)
            # deterministic in the optimizer's seed, not the space's RNG
            fb_rng = np.random.default_rng(0xFB if seed is None else int(seed) ^ 0xFB)
            fb = configspace.to_vector(configspace.sample_configuration(rng=fb_rng))
            fb = np.nan_to_num(np.asarray(fb, np.float32), nan=0.0)
            self._fallback_vector = torch.as_tensor(fb, device=self.device)
            self._forbiddens_sig = tuple(
                repr(c) for c in configspace.get_forbiddens()) + (fb.tobytes(),)
        d = int(self.codec.kind.shape[0])
        # fail fast on an objective of the wrong shape, before the sweep
        probe_v = torch.full((2, d), 0.5, dtype=torch.float32, device=self.device)
        if stateful_eval is not None:
            # one init -> step round trip on two lanes
            try:
                _, probe = stateful_eval.step_fn(
                    stateful_eval.init_fn(probe_v), probe_v, float(min_budget), 0.0
                )
            except Exception as e:
                raise ValueError(
                    f"stateful_eval failed on f32[2, {d}] vectors (init_fn + "
                    f"step_fn): {type(e).__name__}: {e}"
                ) from e
            if tuple(getattr(probe, "shape", ())) != (2,):
                raise ValueError(
                    "stateful_eval.step_fn must return per-lane losses f32[n], "
                    f"got shape {tuple(getattr(probe, 'shape', ()))}"
                )
        else:
            probe = eval_fn(probe_v, float(min_budget))
            if tuple(getattr(probe, "shape", ())) != (2,):
                raise ValueError(
                    "eval_fn must return one loss per row: f32[n] for f32[n, "
                    f"{d}] vectors, got shape {tuple(getattr(probe, 'shape', ()))}"
                )
        self.eval_fn = eval_fn
        self.stateful_eval = stateful_eval
        self.run_id = run_id
        self.eta = float(eta)
        self.min_budget = float(min_budget)
        self.max_budget = float(max_budget)
        self.min_points_in_model = min_points_in_model
        self.top_n_percent = int(top_n_percent)
        self.num_samples = int(num_samples)
        self.random_fraction = float(random_fraction)
        self.bandwidth_factor = float(bandwidth_factor)
        self.min_bandwidth = float(min_bandwidth)
        self.result_logger = result_logger
        self.working_directory = working_directory
        self.logger = logger or logging.getLogger("hpbandster_tpu_torch.fused_bohb")
        self.rng = np.random.default_rng(seed)

        self.max_SH_iter = max_sh_iterations(min_budget, max_budget, eta)
        self.budgets = budget_ladder(min_budget, max_budget, eta)
        self.iterations: List[SuccessiveHalving] = []
        self.config: Dict[str, Any] = {
            "time_ref": None,
            "eta": self.eta,
            "min_budget": self.min_budget,
            "max_budget": self.max_budget,
            "budgets": list(self.budgets),
            "max_SH_iter": self.max_SH_iter,
            "min_points_in_model": min_points_in_model,
            "top_n_percent": top_n_percent,
            "num_samples": num_samples,
            "random_fraction": random_fraction,
            "bandwidth_factor": bandwidth_factor,
            "min_bandwidth": min_bandwidth,
        }
        self.total_evaluated = 0
        #: one row per device chunk: chunk index, brackets, evaluations,
        #: execute+fetch seconds, tier and warm-upload bytes
        self.run_stats: List[Dict[str, Any]] = []
        #: on-device promotion scorer; None is the plain top-k by loss (the
        #: checkpoint records it, as the reference's does)
        self.promotion_rank_fn = None
        #: observations of earlier chunks and run() calls, fed to later ones
        #: as warm data
        self._warm_v: Dict[float, np.ndarray] = {}
        self._warm_l: Dict[float, np.ndarray] = {}
        self.warmstart_iteration: List[Any] = []
        #: the decoded device telemetry of the last run with the metrics
        #: plane on (``obs.device_metrics.decode_device_metrics``)
        self.last_device_telemetry: Optional[Dict[str, Any]] = None
        if previous_result is not None:
            self._ingest_previous_result(previous_result)

    def _ingest_previous_result(self, previous_result: Result) -> None:
        """Seed the warm observations with a previous run's (config,
        budget, loss) data; crashed runs enter as +inf, inactive dims of a
        conditional space as NaN."""
        per_budget_v: Dict[float, List[np.ndarray]] = {}
        per_budget_l: Dict[float, List[float]] = {}
        id2conf = previous_result.get_id2config_mapping()
        for run in previous_result.get_all_runs(only_largest_budget=False):
            cfg = id2conf[run.config_id]["config"]
            vec = self.configspace.to_vector(cfg).astype(np.float32)
            if self.active_mask_fn is None:
                # condition-free: the fit does not impute, so NaNs (from a
                # foreign result) must not reach it
                vec = np.nan_to_num(vec, nan=0.0)
            b = float(run.budget)
            loss = np.inf if run.loss is None else float(run.loss)
            per_budget_v.setdefault(b, []).append(vec)
            per_budget_l.setdefault(b, []).append(loss)
        for b in per_budget_v:
            self._warm_v[b] = np.stack(per_budget_v[b])
            self._warm_l[b] = np.asarray(per_budget_l[b], np.float32)

        class _NoOpGenerator:
            def new_result(self, job, update_model=True):
                pass

        self.warmstart_iteration = [
            WarmStartIteration(previous_result, _NoOpGenerator())
        ]

    def _plan(self, iteration: int):
        """Bracket shape for global iteration ``iteration``."""
        return hyperband_bracket(
            iteration, self.min_budget, self.max_budget, self.eta
        )

    def run(
        self,
        n_iterations: int = 1,
        min_n_workers: int = 1,
        profile_dir: Optional[str] = None,
        chunk_brackets: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        dynamic_counts: Optional[bool] = None,
        resident: bool = False,
        device_metrics: Optional[bool] = None,
    ) -> Result:
        """Run the remaining brackets up to ``n_iterations`` (a total that
        counts earlier ``run()`` calls, which feed this one as warm data) on
        the device, then replay them into a ``Result``.

        ``chunk_brackets=None`` runs the remaining schedule as one sweep.
        ``chunk_brackets=K`` runs it in chunks of K brackets, each chunk
        taking all earlier observations as warm data: results stream into
        ``self.iterations`` (and the ``result_logger``) chunk by chunk, and a
        chunk that fails leaves every completed chunk in place. The host
        bookkeeping is pipelined: chunk k's replay into the ``Result``
        structures runs while chunk k+1 runs on the device (``run_stats``
        records it as ``replay_overlap_s``), so streamed lines lag one
        chunk. Built sweeps come from the process-wide cache: a chunk whose
        shape was built before (in this run or an earlier one) reports
        ``compile_cache_hit`` and a ``build_compile_s`` of 0.0.

        ``profile_dir`` writes a ``torch.profiler`` trace of each chunk
        there (``utils/profiling.py``).

        ``checkpoint_path`` writes a checkpoint after every chunk, with the
        chunk replayed first (the replay then runs in turn); a fresh
        optimizer with the same settings resumes from it with
        :meth:`load_checkpoint` and completes with the results of an
        uninterrupted run.

        ``dynamic_counts=None`` takes the tier from ``chunk_brackets``: set,
        the dynamic-count tier (counts on the device over pow2-bucketed
        buffers, ``ops/sweep.py``; on a card each chunk one captured CUDA
        graph, reused while the chunk's shape and capacities repeat); unset,
        the static tier. True or False forces either. The two tiers draw
        from the same proposal distribution but are distinct consumers of
        random numbers. Between dynamic chunks the observation state stays
        on the device while the buffer capacities are unchanged, and is
        uploaded from the host's copy when they grow.

        ``resident=True`` runs the schedule as the resident sweep: the
        HyperBand rotation's round of brackets, on a card one captured CUDA
        graph replayed once per round (``ops/sweep.py``), then the partial
        last round; one fetch at the end. Its ``Result`` equals the
        unrolled dynamic tier's (``dynamic_counts=True``) on the same seed.
        It replaces chunking and needs the dynamic-count tier.

        ``run_stats`` rows carry the reference's fields (``build_compile_s``
        is build + capture + instantiate seconds on a cache miss) and, on a
        card, the graph's ``graph_capture_s``, ``graph_instantiate_s`` and
        this call's replays' device milliseconds (``graph_replay_ms``).

        ``device_metrics`` turns the device metrics plane on: per-rung loss
        histograms, crash, evaluation and promotion counts, refit flags and
        per-bracket bests accumulate on the device, and every chunk's are
        decoded at the end of the run into one record,
        :attr:`last_device_telemetry`. ``None`` follows
        ``HPB_DEVICE_METRICS=1``; off otherwise.
        """
        del min_n_workers  # API symmetry with Master.run; no worker pool here
        first = len(self.iterations)
        # planning is the sweep's admission work: the schedule's geometry,
        # before anything boards the device
        with phase_span("sweep_planning", ADMISSION):
            plans = [self._plan(i) for i in range(first, int(n_iterations))]
        # everything between planning and the first chunk (tier policy,
        # trace, transfer baseline) is still admission work on the timeline
        with phase_span("sweep_setup", ADMISSION):
            if resident and chunk_brackets is not None:
                raise ValueError(
                    "resident=True replaces chunking (the whole schedule is one "
                    "resident sweep): drop chunk_brackets"
                )
            if resident and dynamic_counts is False:
                raise ValueError(
                    "resident=True requires the dynamic-count tier (the rounds "
                    "carry the counts on the device): drop dynamic_counts=False"
                )
            use_dm = (device_metrics_default() if device_metrics is None
                      else bool(device_metrics))
            if self.config["time_ref"] is None:
                self.config["time_ref"] = time.time()
            chunk = len(plans) if chunk_brackets is None else max(int(chunk_brackets), 1)
            # only the caller's knobs choose the tier, never how many brackets
            # remain: a run cut after its first chunk and a longer uninterrupted
            # run must execute identical first chunks for a resume to match
            dynamic = resident or (
                (chunk_brackets is not None)
                if dynamic_counts is None else bool(dynamic_counts)
            )
            d = int(self.codec.kind.shape[0])
            done = first
            #: device observation state returned by the previous dynamic chunk
            #: and the capacities it was built for
            dev_state = dev_caps = None
            #: each chunk's fetched metrics and plans, decoded together at the end
            dm_parts: List[Any] = []
            dm_execute_s = 0.0
            # one trace for this call's whole sweep: every chunk record and the
            # telemetry record share it (an active trace, a serving layer's, wins)
            sweep_trace = current_trace() or new_trace(self.run_id)
            link0 = transfer_counters() if plans else None
            #: the previous chunk's deferred replay into the bookkeeping: it
            #: runs while the next chunk runs on the device
            pending_replay = None
            overlap_s = None

        def flush_replay():
            """Run the deferred replay once. The slot is cleared first, so a
            replay that fails never runs half of its brackets again."""
            nonlocal pending_replay, overlap_s
            if pending_replay is None:
                return
            job, pending_replay = pending_replay, None
            t_r = time.perf_counter()
            # a profiler range only: the journal records no pipelined replay
            with obs.annotate("bracket_replay"):
                job()
            overlap_s = time.perf_counter() - t_r

        while plans:
            chunk_plans, plans = plans[:chunk], plans[chunk:]
            seed = int(np.uint32(self.rng.integers(2**32, dtype=np.uint32)))
            overlap_s = None
            try:
                # the staging window: the warm fold, padding and upload, the
                # host cost of putting this chunk's inputs on the device
                with phase_span("chunk_staging", TRANSFER):
                    warm_counts = {b: len(l) for b, l in self._warm_l.items()}
                    run_caps = None
                    slice_bytes = 0
                    if dynamic:
                        # past-only capacities: warm counts at this boundary
                        # plus this chunk's additions, pow2-bucketed, so two
                        # runs that agree on history agree on every chunk's
                        # buffer shapes
                        run_caps = dict(warm_counts)
                        for b, k in plan_additions(chunk_plans).items():
                            run_caps[b] = run_caps.get(b, 0) + k
                        run_caps = pow2_capacities(run_caps)
                        if dev_state is not None and run_caps == dev_caps:
                            warm, upload_bytes = dev_state, 0
                        elif self._can_stream_warm(run_caps):
                            # a sharded mesh: the warm buffers go up shard
                            # slice by shard slice, never whole on the host
                            warm, upload_bytes, slice_bytes = self._stream_warm_args(
                                run_caps, d)
                            dev_state = None  # stale shapes: never reuse
                        else:
                            warm, upload_bytes = self._dynamic_warm(run_caps, d)
                            dev_state = None  # stale shapes: never reuse
                    else:
                        warm = warm_obs_from_numpy(self._warm_v, self._warm_l, self.device)
                        upload_bytes = sum(
                            v.nbytes + self._warm_l[b].nbytes
                            for b, v in self._warm_v.items()
                        )
                    if upload_bytes:
                        note_transfer("h2d", upload_bytes)
                with trace(profile_dir), use_trace(sweep_trace):
                    # a miss: the build and capture; a hit: the lookup
                    with phase_span("compile_lookup", COMPILE):
                        sweep, compile_s, cache_hit = self._sweep_built(
                            chunk_plans, dynamic=dynamic, caps=run_caps,
                            resident=resident, device_metrics=use_dm,
                        )
                    t0 = time.perf_counter()
                    # (outputs[, metrics][, state]): a bare result when neither
                    with obs.annotate("chunk_launch"):
                        parts = sweep(seed, *warm)
                    if not (dynamic or use_dm):
                        parts = (parts,)
                    if dynamic:
                        *parts, new_state = parts
                    # pipelining: the previous chunk's bookkeeping replays
                    # here, while this chunk runs on the device
                    flush_replay()
                    with obs.annotate("chunk_fetch"):
                        outputs = _fetch(parts[0])
                    if use_dm:
                        # the outputs are on the host, so this is the
                        # telemetry's own fetch
                        with phase_span("telemetry_fetch", TRANSFER):
                            dm_parts.append((_fetch(parts[1]), chunk_plans))
                    execute_s = time.perf_counter() - t0
                    if dynamic:
                        dev_state, dev_caps = new_state, run_caps
                d2h_bytes = _nbytes(outputs) + (_nbytes(dm_parts[-1][0]) if use_dm else 0)
                note_transfer("d2h", d2h_bytes)
                if resident:
                    outputs = unstack_resident_outputs(
                        outputs, resident_rotation(chunk_plans)[1]
                    )
            finally:
                # a failure above must still land the completed previous
                # chunk in self.iterations: its observations are already in
                # the warm data, so a retry must not run it again. A replay
                # failing here must not mask the error already raised.
                in_flight = sys.exc_info()[1] is not None
                try:
                    flush_replay()
                except Exception:
                    if not in_flight:
                        raise
                    self.logger.exception(
                        "deferred replay of the previous chunk failed while a "
                        "later chunk was already failing; its results are "
                        "missing from this Result")
            # the chunk's run_stats row, its sweep_chunk record and the
            # per-job attribution are host bookkeeping: promotion work
            with phase_span("chunk_accounting", PROMOTION):
                stat = {
                    "chunk_index": len(self.run_stats),
                    "brackets": list(range(done, done + len(chunk_plans))),
                    "evaluations": int(sum(sum(p.num_configs) for p in chunk_plans)),
                    "build_compile_s": compile_s,
                    "compile_cache_hit": cache_hit,
                    "execute_fetch_s": execute_s,
                    "dynamic_counts": dynamic,
                    # 0 when the previous chunk's device state carried them
                    "warm_upload_bytes": int(upload_bytes),
                }
                if slice_bytes:
                    # the streamed upload's largest host slice
                    stat["warm_stream_slice_bytes"] = int(slice_bytes)
                if overlap_s is not None:
                    # the previous chunk's replay, run inside this chunk's window
                    stat["replay_overlap_s"] = overlap_s
                graph = getattr(sweep, "graph", None)  # a wrapped sweep may not carry it
                if graph is not None:
                    replays = resident_rotation(chunk_plans)[1] if resident else 1
                    stat.update(graph_capture_s=graph.capture_s,
                                graph_instantiate_s=graph.instantiate_s,
                                graph_replay_ms=graph.replay_ms()[-replays:])
                if use_dm:
                    dm_execute_s += execute_s
                self.run_stats.append(stat)
                with use_trace(sweep_trace):
                    obs.emit(
                        "sweep_chunk",
                        duration_s=execute_s,
                        compile_s=compile_s,
                        compile_cache_hit=cache_hit,
                        evaluations=stat["evaluations"],
                        brackets=stat["brackets"],
                        seq=stat["chunk_index"],
                        h2d_bytes=int(upload_bytes),
                        d2h_bytes=d2h_bytes,
                    )
                job_info = {
                    "fused_chunk": stat["chunk_index"],
                    "chunk_compile_s": compile_s,
                    "chunk_compile_cache_hit": cache_hit,
                    "chunk_execute_s": execute_s,
                    "chunk_evaluations": stat["evaluations"],
                }
            staged = []
            # the observation fold is successive-halving bookkeeping
            with phase_span("obs_fold", PROMOTION):
                for b_i, (plan, out) in enumerate(zip(chunk_plans, outputs), start=done):
                    stages = _unpack_stages(
                        (out.idx_packed, out.loss_packed), plan.num_configs
                    )
                    staged.append((b_i, plan, out, stages))
                    # folded now: the next chunk takes them as warm data
                    self._accumulate_obs(plan, out, stages)

            def replay_now(staged=staged, job_info=job_info):
                for b_i, plan, out, stages in staged:
                    self._replay_bracket(b_i, plan, out, stages, job_info)

            done += len(chunk_plans)
            if checkpoint_path is not None:
                # a checkpoint holds replayed bookkeeping, so the replay
                # runs in turn; its content never depends on when it runs
                with phase_span("bracket_replay", PROMOTION):
                    replay_now()
                self.save_checkpoint(checkpoint_path)
            else:
                pending_replay = replay_now
        if pending_replay is not None:
            # the last chunk's replay has no successor to hide behind
            with phase_span("bracket_replay", PROMOTION):
                pending_replay()
        if link0 is not None:
            publish_sweep_transfers(link0)
        if dm_parts:
            self.last_device_telemetry = decode_device_metrics(
                dm_parts, execute_s=dm_execute_s
            )
            _publish_telemetry(self.last_device_telemetry, sweep_trace)
        self._write_timings_sidecar()
        return Result(list(self.iterations) + self.warmstart_iteration, self.config)

    def run_incumbent(
        self,
        n_iterations: int = 1,
        profile_dir: Optional[str] = None,
        resident: bool = True,
        device_metrics: Optional[bool] = None,
    ) -> Dict[str, Any]:
        """The incumbent-only sweep: brackets ``0 .. n_iterations - 1`` as
        one dynamic-count sweep (the resident tier unless ``resident=False``)
        whose only output is the best final-stage configuration, with the
        optimizer's warm observations as its warm data. No per-config
        ``Result`` bookkeeping, and :attr:`iterations` does not advance: a
        one-shot query, not a resumable run. The sweep comes from the
        process-wide cache, as :meth:`run`'s chunks do; ``profile_dir``
        writes a ``torch.profiler`` trace of it.

        Returns ``incumbent`` (``vector``, ``loss``, ``bracket``,
        ``per_bracket_loss``), ``evaluations``, ``build_compile_s``,
        ``compile_cache_hit``, ``execute_fetch_s`` and ``transfers``: the
        transfer ledger's delta over this call (``transfer_bytes_h2d``,
        ``transfer_bytes_d2h``, ``transfers_h2d``, ``transfers_d2h``), also
        published as the ``sweep.*`` gauges. ``device_metrics`` (default:
        ``HPB_DEVICE_METRICS``) adds ``device_telemetry``, the decoded
        record, also kept as :attr:`last_device_telemetry`.
        """
        if is_multiprocess_mesh(self.mesh):
            raise ValueError(
                "run_incumbent drives single-process meshes; use "
                "parallel.multihost.run_sharded_fused_sweep(resident=True) for the "
                "multi-process tier")
        plans = [self._plan(i) for i in range(int(n_iterations))]
        if not plans:
            raise ValueError("run_incumbent needs n_iterations >= 1")
        use_dm = (device_metrics_default() if device_metrics is None
                  else bool(device_metrics))
        d = int(self.codec.kind.shape[0])
        # the chunked tier's capacity policy
        run_caps = {float(b): len(l) for b, l in self._warm_l.items()}
        for b, k in plan_additions(plans).items():
            run_caps[b] = run_caps.get(b, 0) + k
        run_caps = pow2_capacities(run_caps)
        seed = int(np.uint32(self.rng.integers(2**32, dtype=np.uint32)))
        link0 = transfer_counters()
        warm, upload_bytes = self._dynamic_warm(run_caps, d)
        note_transfer("h2d", upload_bytes)
        with trace(profile_dir):
            sweep, compile_s, cache_hit = self._sweep_built(
                plans, dynamic=True, caps=run_caps, resident=resident,
                incumbent_only=True, device_metrics=use_dm,
            )
            t0 = time.perf_counter()
            raw = sweep(seed, *warm)
            inc, dm = (raw if use_dm else (raw, None))
            inc = _fetch(inc)
            dm = None if dm is None else _fetch(dm)
            execute_s = time.perf_counter() - t0
        fetched = list(inc) + ([] if dm is None else list(dm))
        note_transfer("d2h", sum(a.nbytes for a in fetched), buffers=len(fetched))
        transfers = publish_sweep_transfers(link0)
        out: Dict[str, Any] = {
            "incumbent": {
                "vector": [float(x) for x in inc.vector],
                "loss": float(inc.loss),
                "bracket": int(inc.bracket),
                "per_bracket_loss": [float(x) for x in inc.per_bracket_loss],
            },
            "evaluations": int(sum(sum(p.num_configs) for p in plans)),
            "build_compile_s": compile_s,
            "compile_cache_hit": cache_hit,
            "execute_fetch_s": execute_s,
            "transfers": transfers,
        }
        inc_trace = current_trace() or new_trace(self.run_id)
        with use_trace(inc_trace):
            # the resident sweep is one chunk
            obs.emit(
                "sweep_chunk",
                duration_s=execute_s,
                compile_s=compile_s,
                compile_cache_hit=cache_hit,
                evaluations=out["evaluations"],
                brackets=list(range(len(plans))),
                seq=0,
            )
            obs.emit_sweep_incumbent(
                vector=out["incumbent"]["vector"],
                loss=out["incumbent"]["loss"],
                bracket=out["incumbent"]["bracket"],
                per_bracket_loss=out["incumbent"]["per_bracket_loss"],
                evaluations=out["evaluations"],
                d2h_bytes=transfers["transfer_bytes_d2h"],
                h2d_bytes=transfers["transfer_bytes_h2d"],
                host_syncs=transfers["transfers_h2d"] + transfers["transfers_d2h"],
            )
        if dm is not None:
            self.last_device_telemetry = decode_device_metrics(
                dm, plans=plans, execute_s=execute_s
            )
            _publish_telemetry(self.last_device_telemetry, inc_trace)
            out["device_telemetry"] = self.last_device_telemetry
        return out

    #: internal: build the dynamic tiers eagerly on a card (no CUDA graph),
    #: the captured programs' twin in the card's checks; keys the cache
    _eager_sweeps = False

    def _sweep_fn(self, plans, **modes):
        """``make_fused_sweep_fn`` over ``plans`` with this optimizer's
        settings and the given tier and modes."""
        return make_fused_sweep_fn(
            self.eval_fn, plans, self.codec,
            device=self.device,
            tables=self.codec_tables,
            mesh=self.mesh,
            axis=self.axis,
            num_samples=self.num_samples,
            random_fraction=self.random_fraction,
            top_n_percent=self.top_n_percent,
            min_points_in_model=self.min_points_in_model,
            bandwidth_factor=self.bandwidth_factor,
            min_bandwidth=self.min_bandwidth,
            rank_fn=self.promotion_rank_fn,
            active_mask_fn=self.active_mask_fn,
            forbidden_fn=self.forbidden_fn,
            fallback_vector=self._fallback_vector,
            stateful_eval=self.stateful_eval,
            _eager=self._eager_sweeps,
            **modes,
        )

    def _sweep_key(self, plans, dynamic=False, caps=None, resident=False,
                   incumbent_only=False, device_metrics=False):
        """The sweep cache's key: the reference's ``_sweep_key``, with the
        device and the eager switch."""
        if dynamic:
            # counts are device inputs, so only the capacities (shapes) key
            # the sweep; "state" marks the return_state sweep run() builds.
            # The resolved HPB_PALLAS_KDE_FIT flag keys too: a graph bakes
            # in the fit path it was captured with
            obs_term = ("dynamic", "state", tuple(sorted(caps.items())),
                        bool(resident), bool(incumbent_only), _moments_fit_requested())
        else:
            obs_term = tuple(sorted((b, len(l)) for b, l in self._warm_l.items()))
        return (
            (self.eval_fn, self.stateful_eval),
            tuple((tuple(p.num_configs), tuple(p.budgets)) for p in plans),
            self.codec.signature,
            self.num_samples,
            self.random_fraction,
            self.top_n_percent,
            self.min_points_in_model,
            self.bandwidth_factor,
            self.min_bandwidth,
            self.mesh,
            self.axis,
            obs_term,
            self.promotion_rank_fn,
            self._conditions_sig,
            self._forbiddens_sig,
            bool(device_metrics),
            self.device,
            self._eager_sweeps,
        )

    def _sweep_built(self, plans, dynamic=False, caps=None, resident=False,
                     incumbent_only=False, device_metrics=False):
        """The built sweep for ``plans`` from the cache, and what building
        it cost: ``(sweep, build_capture_s, cache_hit)``. A miss builds the
        sweep and, on a card, captures its graph here, so the capture is
        charged to ``build_capture_s`` (build + capture + instantiate
        seconds) and never to the chunk's execute time; a hit costs 0.0.

        A miss records what the new entry pins on the card (the reserved
        bytes its build and capture added) and the cache evicts its oldest
        entries until all of them fit in ``_SWEEP_CACHE_MEMORY_SHARE`` of
        the card. A build that runs out of device memory empties the cache,
        returns the freed memory to the card and tries once more."""
        key = self._sweep_key(plans, dynamic=dynamic, caps=caps, resident=resident,
                              incumbent_only=incumbent_only,
                              device_metrics=device_metrics)
        hit = _SWEEP_CACHE.get(key)
        if hit is not None:
            return hit, 0.0, True
        t0 = time.perf_counter()
        build = dict(
            warm_counts={b: len(l) for b, l in self._warm_l.items()},
            dynamic_counts=dynamic, capacities=caps,
            return_state=dynamic and not incumbent_only, resident=resident,
            incumbent_only=incumbent_only, device_metrics=device_metrics,
        )
        reserved0 = _pinned_reserved(self.device)
        try:
            sweep = self._prepared_sweep(plans, build)
        except torch.cuda.OutOfMemoryError:
            # retried outside the handler, so the failed build's frames
            # (and its graph's memory pool) are gone before the retry
            sweep = None
        if sweep is None:
            self.logger.warning("building a sweep ran out of device memory: "
                                "emptying the sweep cache and retrying once")
            _SWEEP_CACHE.clear()
            reserved0 = _pinned_reserved(self.device)
            sweep = self._prepared_sweep(plans, build)
        build_s = time.perf_counter() - t0
        pinned = max(_pinned_reserved(self.device) - reserved0, 0)
        _SWEEP_CACHE.put(key, sweep, nbytes=pinned,
                         max_bytes=_cache_byte_bound(self.device))
        return sweep, build_s, False

    def _prepared_sweep(self, plans, build: Dict[str, Any]):
        """A new sweep for ``plans``, captured where it captures."""
        sweep = self._sweep_fn(plans, **build)
        prepare = getattr(sweep, "prepare", None)  # a wrapped sweep may not carry it
        if prepare is not None:
            prepare()
        return sweep

    def _dynamic_warm(self, run_caps: Dict[float, int], d: int):
        """The host fold of the warm observations as the dynamic tier's
        full-capacity inputs on the device: ``((warm_v, warm_l, warm_n),
        bytes uploaded)``. Pads are (0-vector, +inf loss),
        exactly what the device appends leave in a threaded state."""
        warm_v_pad, warm_l_pad, warm_n = {}, {}, {}
        for b, cap in run_caps.items():
            v = self._warm_v.get(b)
            n = 0 if v is None else len(v)
            buf_v = np.zeros((cap, d), np.float32)
            buf_l = np.full(cap, np.inf, np.float32)
            if n:
                buf_v[:n] = v
                buf_l[:n] = self._warm_l[b]
            warm_v_pad[b], warm_l_pad[b], warm_n[b] = buf_v, buf_l, n
        nbytes = sum(
            warm_v_pad[b].nbytes + warm_l_pad[b].nbytes + 4 for b in run_caps
        )
        warm = dynamic_obs_from_numpy(warm_v_pad, warm_l_pad, warm_n, self.device)
        return warm, nbytes

    def _can_stream_warm(self, run_caps: Dict[float, int]) -> bool:
        """Streamed per-shard warm uploads apply on single-process meshes of
        several shards whose capacities split evenly; anything else takes
        the whole-buffer path (:meth:`_dynamic_warm`)."""
        if self.mesh is None or is_multiprocess_mesh(self.mesh):
            return False
        n_shards = shard_count(self.mesh, self.axis)
        return n_shards > 1 and all(cap % n_shards == 0 for cap in run_caps.values())

    def _stream_warm_args(self, run_caps: Dict[float, int], d: int):
        """The dynamic tier's warm inputs for a mesh run, built shard slice
        by shard slice: each budget's full-capacity buffers are made on the
        device, and each shard's ``capacity / shard count`` rows are filled
        on the host (:func:`_warm_slice`) and uploaded on their own, so the
        host holds one slice at a time, never a full buffer (at the 1M
        scale the one place a chunked run would otherwise build O(configs)
        host memory in one piece). Returns ``((warm_v, warm_l, warm_n),
        bytes uploaded, the largest slice's host bytes)``."""
        n_shards = shard_count(self.mesh, self.axis)
        warm_v, warm_l, warm_n = {}, {}, {}
        nbytes = largest = 0
        for b, cap in run_caps.items():
            if cap % n_shards:
                raise ValueError(
                    f"streamed warm upload needs capacities divisible by the "
                    f"{n_shards}-way '{self.axis}' axis, got {cap} for budget {b} "
                    "(gate with _can_stream_warm)")
            src_v, src_l = self._warm_v.get(b), self._warm_l.get(b)
            per = cap // n_shards
            buf_v = torch.empty((cap, d), dtype=torch.float32, device=self.device)
            buf_l = torch.empty((cap,), dtype=torch.float32, device=self.device)
            for lo in range(0, cap, per):
                part_v = _warm_slice(src_v, lo, lo + per, (d,), 0.0)
                part_l = _warm_slice(src_l, lo, lo + per, (), np.inf)
                up_v, up_l = upload(self.device, part_v, part_l)
                buf_v[lo:lo + per].copy_(up_v)
                buf_l[lo:lo + per].copy_(up_l)
                largest = max(largest, part_v.nbytes + part_l.nbytes)
            warm_v[b], warm_l[b] = buf_v, buf_l
            n = 0 if src_v is None else len(src_v)
            warm_n[b] = torch.full((), n, dtype=torch.int32, device=self.device)
            nbytes += cap * d * 4 + cap * 4 + 4
        return (warm_v, warm_l, warm_n), nbytes, largest

    def _write_timings_sidecar(self) -> None:
        """Write ``run_stats`` as ``fused_timings.json`` beside the result
        logger's files (when it has them). Entries merge with what is on
        disk: a second optimizer on the same logger, or a run resumed from
        a checkpoint, appends, and entries already there verbatim are not
        written twice."""
        results_fn = getattr(self.result_logger, "results_fn", None)
        if not results_fn:
            return
        path = os.path.join(os.path.dirname(results_fn), "fused_timings.json")
        existing: List[Dict[str, Any]] = []
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    existing = json.load(fh)
            except (OSError, ValueError):
                existing = []
        merged = existing + [s for s in self.run_stats if s not in existing]
        with open(path, "w") as fh:
            json.dump(merged, fh, indent=1)

    def save_checkpoint(self, path: str) -> None:
        """Write the fused-tier checkpoint (``core/checkpoint.py``): warm
        observations, bracket rotation, RNG state and replayed bookkeeping
        at the last chunk boundary."""
        t0 = time.monotonic()
        save_fused_checkpoint(self, path)
        obs.emit(obs.CHECKPOINT_WRITTEN, path=path,
                 duration_s=round(time.monotonic() - t0, 6))

    def load_checkpoint(self, path: str) -> None:
        """Restore into a freshly constructed optimizer (same constructor
        settings; bracket shapes are checked). The next ``run()`` continues
        with the remaining brackets and reproduces an uninterrupted run.
        Reads the reference's fused checkpoints too."""
        load_fused_checkpoint(self, path)

    def _accumulate_obs(self, plan, out, stages) -> None:
        """Fold one bracket's (vector, loss) observations into the warm
        buffers, in the order the device appends them, so later chunks and
        run() calls see them."""
        vectors = np.asarray(out.vectors)
        for (idx_s, losses_s), budget in zip(stages, plan.budgets):
            b = float(budget)
            vecs = vectors[np.asarray(idx_s)]
            losses = np.where(
                np.isnan(losses_s), np.inf, losses_s
            ).astype(np.float32)
            if b in self._warm_v:
                self._warm_v[b] = np.concatenate([self._warm_v[b], vecs])
                self._warm_l[b] = np.concatenate([self._warm_l[b], losses])
            else:
                self._warm_v[b] = vecs.astype(np.float32)
                self._warm_l[b] = losses

    def _replay_bracket(
        self, b_i: int, plan, out, stages, job_info: Optional[Dict] = None
    ) -> None:
        vectors = np.asarray(out.vectors)
        mb_mask = np.asarray(out.model_based)
        promotion_sets = [set(int(i) for i in idx) for idx, _ in stages[1:]]
        promotion_sets.append(set())

        def no_sampler(budget):  # replay adds every config explicitly
            raise RuntimeError("fused replay must not sample fresh configs")

        # the replayed bracket announces its plan, as the Master's do; its
        # config_sampled and promotion records come from the bookkeeping
        obs.emit_bracket_created(
            b_i, plan.num_configs, plan.budgets,
            eta=self.eta, random_fraction=self.random_fraction,
        )
        it = _ReplayIteration(
            HPB_iter=b_i,
            num_configs=list(plan.num_configs),
            budgets=list(plan.budgets),
            config_sampler=no_sampler,
            promotion_sets=promotion_sets,
            result_logger=self.result_logger,
        )
        self.iterations.append(it)

        with obs.annotate("replay_decode"):
            n0 = plan.num_configs[0]
            configs = self.configspace.from_vectors(vectors[:n0])
            for cfg, mb in zip(configs, mb_mask[:n0].tolist()):
                it.add_configuration(
                    dict(cfg),
                    {
                        "model_based_pick": bool(mb),
                        "sample_reason": "fused_sweep",
                        "fused_sweep": True,
                    },
                )

        with obs.annotate("replay_stages"):
            metrics = obs.get_metrics()
            for idx, losses in stages:
                rows = it.record_stage(idx, losses, job_info or {}, self.working_directory)
                self.total_evaluated += rows
                metrics.counter("fused.replay_rows").inc(rows)
                metrics.counter("fused.replay_stages").inc()
                it.process_results()

    def shutdown(self, shutdown_workers: bool = False) -> None:
        """API symmetry with Master; nothing to tear down."""


class FusedHyperBand(FusedBOHB):
    """HyperBand on the fused path: the same bracket schedule with purely
    random proposals. ``min_points_in_model`` is out of reach, so no model
    gate opens and no KDE math runs."""

    def __init__(self, *args, **kwargs):
        kwargs["random_fraction"] = 1.0
        kwargs["min_points_in_model"] = 2**30
        super().__init__(*args, **kwargs)


class FusedH2BO(FusedBOHB):
    """H2BO on the fused path: promotions rank by each config's power-law
    learning curve extrapolated to the bracket's final budget
    (``ops.bracket.power_law_extrapolate``) instead of its current loss;
    proposals are BOHB's."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.promotion_rank_fn = power_law_extrapolate


class FusedRandomSearch(FusedHyperBand):
    """Random search on the fused path: one-stage brackets sized like the
    matching HyperBand bracket's first stage, every run at ``max_budget``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # every run is at max_budget, so the Result's HB_config does not
        # advertise the unused ladder
        self.config["budgets"] = [self.max_budget]

    def _plan(self, iteration: int):
        base = hyperband_bracket(iteration, self.min_budget, self.max_budget, self.eta)
        return BracketPlan(num_configs=(base.num_configs[0],), budgets=(self.max_budget,))
