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
device calls, never inside a captured graph.

Not ported yet: meshes and multiprocess runs, streamed warm uploads and the
pipelined replay of chunks.
"""

from __future__ import annotations

import logging
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
from hpbandster_tpu_torch.core.job import Job
from hpbandster_tpu_torch.core.result import Result
from hpbandster_tpu_torch.core.successive_halving import SuccessiveHalving
from hpbandster_tpu_torch.core.warmstart import WarmStartIteration
from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.obs.device_metrics import (
    decode_device_metrics,
    device_metrics_default,
    emit_device_telemetry,
    publish_device_metrics,
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
from hpbandster_tpu_torch.space import ConfigurationSpace

__all__ = ["FusedBOHB", "FusedHyperBand", "FusedH2BO", "FusedRandomSearch"]


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


class FusedBOHB:
    """BOHB whose whole sweep runs on one device.

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
        result_logger=None,
        working_directory: str = ".",
        logger: Optional[logging.Logger] = None,
        previous_result: Optional[Result] = None,
        device=None,
        stateful_eval: Optional[StatefulEval] = None,
    ):
        self.device = resolve_device(device)
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
        self.forbidden_fn = self._fallback_vector = None
        if configspace.get_forbiddens():
            self.forbidden_fn = compile_forbidden_mask(configspace, self.codec_tables)
            # deterministic in the optimizer's seed, not the space's RNG
            fb_rng = np.random.default_rng(0xFB if seed is None else int(seed) ^ 0xFB)
            fb = configspace.to_vector(configspace.sample_configuration(rng=fb_rng))
            self._fallback_vector = torch.as_tensor(
                np.nan_to_num(np.asarray(fb, np.float32), nan=0.0), device=self.device
            )
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
        replays each chunk right after it, before the next one starts.

        ``checkpoint_path`` writes a checkpoint after every chunk; a fresh
        optimizer with the same settings resumes from it with
        :meth:`load_checkpoint` and completes with the results of an
        uninterrupted run.

        ``dynamic_counts=None`` takes the tier from ``chunk_brackets``: set,
        the dynamic-count tier (counts on the device over pow2-bucketed
        buffers, ``ops/sweep.py``); unset, the static tier. True or False
        forces either. The two tiers draw from the same proposal
        distribution but are distinct consumers of random numbers. Between
        dynamic chunks the observation state stays on the device while the
        buffer capacities are unchanged, and is uploaded from the host's
        copy when they grow.

        ``resident=True`` runs the schedule as the resident sweep: the
        HyperBand rotation's round of brackets, on a card one captured CUDA
        graph replayed once per round (``ops/sweep.py``), then the partial
        last round; one fetch at the end. Its ``Result`` equals the
        unrolled dynamic tier's (``dynamic_counts=True``) on the same seed.
        It replaces chunking and needs the dynamic-count tier. On a card its
        ``run_stats`` row adds the graph's capture and instantiate seconds
        and each replay's device milliseconds.

        ``device_metrics`` turns the device metrics plane on: per-rung loss
        histograms, crash, evaluation and promotion counts, refit flags and
        per-bracket bests accumulate on the device, and every chunk's are
        decoded at the end of the run into one record,
        :attr:`last_device_telemetry`. ``None`` follows
        ``HPB_DEVICE_METRICS=1``; off otherwise.
        """
        del min_n_workers  # API symmetry with Master.run; no worker pool here
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
        first = len(self.iterations)
        plans = [self._plan(i) for i in range(first, int(n_iterations))]
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
        while plans:
            chunk_plans, plans = plans[:chunk], plans[chunk:]
            seed = int(np.uint32(self.rng.integers(2**32, dtype=np.uint32)))
            warm_counts = {b: len(l) for b, l in self._warm_l.items()}
            run_caps = None
            if dynamic:
                # past-only capacities: warm counts at this boundary plus
                # this chunk's additions, pow2-bucketed, so two runs that
                # agree on history agree on every chunk's buffer shapes
                run_caps = dict(warm_counts)
                for b, k in plan_additions(chunk_plans).items():
                    run_caps[b] = run_caps.get(b, 0) + k
                run_caps = pow2_capacities(run_caps)
                if dev_state is not None and run_caps == dev_caps:
                    warm, upload_bytes = dev_state, 0
                else:
                    warm, upload_bytes, _ = self._dynamic_warm(run_caps, d)
            else:
                warm = warm_obs_from_numpy(self._warm_v, self._warm_l, self.device)
                upload_bytes = sum(
                    v.nbytes + self._warm_l[b].nbytes for b, v in self._warm_v.items()
                )
            sweep = self._sweep_fn(
                chunk_plans, warm_counts=warm_counts, dynamic_counts=dynamic,
                capacities=run_caps, return_state=dynamic, resident=resident,
                device_metrics=use_dm,
            )
            t0 = time.perf_counter()
            # (outputs[, metrics][, state]): a bare result when neither
            parts = sweep(seed, *warm)
            if not (dynamic or use_dm):
                parts = (parts,)
            if dynamic:
                *parts, dev_state = parts
                dev_caps = run_caps
            outputs = _fetch(parts[0])
            if use_dm:
                dm_parts.append((_fetch(parts[1]), chunk_plans))
            execute_s = time.perf_counter() - t0
            if resident:
                outputs = unstack_resident_outputs(
                    outputs, resident_rotation(chunk_plans)[1]
                )
            stat = {
                "chunk_index": len(self.run_stats),
                "brackets": list(range(done, done + len(chunk_plans))),
                "evaluations": int(sum(sum(p.num_configs) for p in chunk_plans)),
                "execute_fetch_s": execute_s,
                "dynamic_counts": dynamic,
                # 0 when the previous chunk's device state carried them
                "warm_upload_bytes": int(upload_bytes),
            }
            graph = getattr(sweep, "graph", None)  # a wrapped sweep may not carry it
            if graph is not None:
                stat.update(graph_capture_s=graph.capture_s,
                            graph_instantiate_s=graph.instantiate_s,
                            graph_replay_ms=graph.replay_ms())
            dm_execute_s += execute_s
            self.run_stats.append(stat)
            with use_trace(sweep_trace):
                obs.emit(
                    "sweep_chunk",
                    duration_s=stat["execute_fetch_s"],
                    # a graph's capture and instantiation; an eager sweep
                    # compiles nothing
                    compile_s=(graph.capture_s + graph.instantiate_s
                               if graph is not None else 0.0),
                    compile_cache_hit=False,
                    evaluations=stat["evaluations"],
                    brackets=stat["brackets"],
                    seq=stat["chunk_index"],
                    h2d_bytes=int(upload_bytes),
                    d2h_bytes=_nbytes(outputs) + (
                        _nbytes(dm_parts[-1][0]) if use_dm else 0),
                )
            job_info = {
                "fused_chunk": stat["chunk_index"],
                "chunk_execute_s": execute_s,
                "chunk_evaluations": stat["evaluations"],
            }
            staged = []
            for b_i, (plan, out) in enumerate(zip(chunk_plans, outputs), start=done):
                stages = _unpack_stages(
                    (out.idx_packed, out.loss_packed), plan.num_configs
                )
                staged.append((b_i, plan, out, stages))
                self._accumulate_obs(plan, out, stages)
            for b_i, plan, out, stages in staged:
                self._replay_bracket(b_i, plan, out, stages, job_info)
            done += len(chunk_plans)
            if checkpoint_path is not None:
                self.save_checkpoint(checkpoint_path)
        if dm_parts:
            self.last_device_telemetry = decode_device_metrics(
                dm_parts, execute_s=dm_execute_s
            )
            _publish_telemetry(self.last_device_telemetry, sweep_trace)
        return Result(list(self.iterations) + self.warmstart_iteration, self.config)

    def run_incumbent(
        self,
        n_iterations: int = 1,
        resident: bool = True,
        device_metrics: Optional[bool] = None,
    ) -> Dict[str, Any]:
        """The incumbent-only sweep: brackets ``0 .. n_iterations - 1`` as
        one dynamic-count sweep (the resident tier unless ``resident=False``)
        whose only output is the best final-stage configuration, with the
        optimizer's warm observations as its warm data. No per-config
        ``Result`` bookkeeping, and :attr:`iterations` does not advance: a
        one-shot query, not a resumable run.

        Returns ``incumbent`` (``vector``, ``loss``, ``bracket``,
        ``per_bracket_loss``), ``evaluations``, ``execute_fetch_s`` and
        ``transfers``: the bytes and tensors this call moved each way
        (``transfer_bytes_h2d``, ``transfer_bytes_d2h``, ``transfers_h2d``,
        ``transfers_d2h``). ``device_metrics`` (default:
        ``HPB_DEVICE_METRICS``) adds ``device_telemetry``, the decoded
        record, also kept as :attr:`last_device_telemetry`.
        """
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
        warm, upload_bytes, uploads = self._dynamic_warm(run_caps, d)
        sweep = self._sweep_fn(
            plans, dynamic_counts=True, capacities=run_caps, resident=resident,
            incumbent_only=True, device_metrics=use_dm,
        )
        t0 = time.perf_counter()
        raw = sweep(seed, *warm)
        inc, dm = (raw if use_dm else (raw, None))
        inc = _fetch(inc)
        dm = None if dm is None else _fetch(dm)
        execute_s = time.perf_counter() - t0
        fetched = list(inc) + ([] if dm is None else list(dm))
        out: Dict[str, Any] = {
            "incumbent": {
                "vector": [float(x) for x in inc.vector],
                "loss": float(inc.loss),
                "bracket": int(inc.bracket),
                "per_bracket_loss": [float(x) for x in inc.per_bracket_loss],
            },
            "evaluations": int(sum(sum(p.num_configs) for p in plans)),
            "execute_fetch_s": execute_s,
            "transfers": {
                "transfer_bytes_h2d": int(upload_bytes),
                "transfer_bytes_d2h": int(sum(a.nbytes for a in fetched)),
                "transfers_h2d": int(uploads),
                "transfers_d2h": len(fetched),
            },
        }
        transfers = out["transfers"]
        inc_trace = current_trace() or new_trace(self.run_id)
        with use_trace(inc_trace):
            # the resident sweep is one chunk
            obs.emit(
                "sweep_chunk",
                duration_s=execute_s,
                compile_s=0.0,
                compile_cache_hit=False,
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

    def _sweep_fn(self, plans, **modes):
        """``make_fused_sweep_fn`` over ``plans`` with this optimizer's
        settings and the given tier and modes."""
        return make_fused_sweep_fn(
            self.eval_fn, plans, self.codec,
            device=self.device,
            tables=self.codec_tables,
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
            **modes,
        )

    def _dynamic_warm(self, run_caps: Dict[float, int], d: int):
        """The host fold of the warm observations as the dynamic tier's
        full-capacity inputs on the device: ``((warm_v, warm_l, warm_n),
        bytes uploaded, tensors uploaded)``. Pads are (0-vector, +inf loss),
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
        return warm, nbytes, 3 * len(run_caps)

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

        for i in range(plan.num_configs[0]):
            cfg = dict(self.configspace.from_vector(vectors[i]))
            it.add_configuration(
                cfg,
                {
                    "model_based_pick": bool(mb_mask[i]),
                    "sample_reason": "fused_sweep",
                    "fused_sweep": True,
                },
            )

        loss_of = [dict(zip(map(int, idx), map(float, losses))) for idx, losses in stages]
        stage_no = 0
        while True:
            nr = it.get_next_run()
            if nr is None:
                if not it.process_results():
                    break
                stage_no += 1
                continue
            config_id, cfg, budget = nr
            job = Job(
                config_id,
                config=cfg,
                budget=budget,
                working_directory=self.working_directory,
            )
            job.time_it("submitted")
            job.time_it("started")
            loss = loss_of[stage_no][config_id[2]]
            # only NaN means crashed; a genuine +/-inf loss (a diverged run)
            # is a valid maximally-bad result
            if not np.isnan(loss):
                job.result = {"loss": loss, "info": dict(job_info or {})}
            else:
                job.result = None
                job.exception = f"non-finite loss {loss!r} at budget {budget}"
            job.time_it("finished")
            # the loss-carrying result record; no run_s, since the
            # evaluation ran inside a device chunk (sweep_chunk times it)
            obs.emit(
                obs.JOB_FAILED if job.exception is not None else obs.JOB_FINISHED,
                config_id=list(config_id), budget=budget,
                loss=float(loss) if np.isfinite(loss) else None,
            )
            if self.result_logger is not None:
                self.result_logger(job)
            it.register_result(job)
            self.total_evaluated += 1

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
