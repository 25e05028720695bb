"""FusedBOHB: the whole-sweep optimizer driver, on PyTorch.

Ported from ``hpbandster_tpu/optimizers/fused_bohb.py``: ``FusedBOHB``
(``__init__`` with ``previous_result=``, ``_plan``, the chunked ``run`` on
the static and dynamic-count tiers, ``save_checkpoint``/``load_checkpoint``,
``_accumulate_obs``, ``_replay_bracket``) and ``_ReplayIteration``. The sweep
runs on the device (``ops/sweep.py``); after each chunk the host replays its
brackets into the standard ``SuccessiveHalving`` / ``Datum`` / ``Result``
bookkeeping, so analysis code sees the structures the reference produces.

Not ported yet: the resident tier, meshes and multiprocess runs, streamed
warm uploads, stateful evaluation, conditional spaces and forbidden
clauses, the device-metrics plane and the observability events.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

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
from hpbandster_tpu_torch.ops.bracket import (
    budget_ladder,
    hyperband_bracket,
    max_sh_iterations,
)
from hpbandster_tpu_torch.ops.fused import _unpack_stages
from hpbandster_tpu_torch.ops.sweep import (
    build_space_codec,
    make_fused_sweep_fn,
    plan_additions,
    pow2_capacities,
)
from hpbandster_tpu_torch.space import ConfigurationSpace

__all__ = ["FusedBOHB"]


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
    ``device="cpu"`` to run the plain PyTorch path on the CPU.
    ``previous_result`` (a ``Result``) warm-starts the model with its
    observations, which ride into every later ``Result`` under negative
    iteration ids.
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
    ):
        self.device = resolve_device(device)
        if configspace is None:
            raise ValueError("you have to provide a valid ConfigurationSpace object")
        if eval_fn is None:
            raise ValueError(
                "FusedBOHB needs a batched eval_fn(vectors f32[n, d], budget) -> f32[n]"
            )
        if configspace.get_conditions() or configspace.get_forbiddens():
            raise NotImplementedError(
                "conditional spaces and forbidden clauses are not ported to "
                "the PyTorch sweep yet"
            )
        self.configspace = configspace
        self.codec = build_space_codec(configspace)
        d = int(self.codec.kind.shape[0])
        # fail fast on an objective of the wrong shape, before the sweep
        probe = eval_fn(
            torch.full((2, d), 0.5, dtype=torch.float32, device=self.device),
            float(min_budget),
        )
        if tuple(getattr(probe, "shape", ())) != (2,):
            raise ValueError(
                "eval_fn must return one loss per row: f32[n] for f32[n, "
                f"{d}] vectors, got shape {tuple(getattr(probe, 'shape', ()))}"
            )
        self.eval_fn = eval_fn
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
        if previous_result is not None:
            self._ingest_previous_result(previous_result)

    def _ingest_previous_result(self, previous_result: Result) -> None:
        """Seed the warm observations with a previous run's (config,
        budget, loss) data; crashed runs enter as +inf."""
        per_budget_v: Dict[float, List[np.ndarray]] = {}
        per_budget_l: Dict[float, List[float]] = {}
        id2conf = previous_result.get_id2config_mapping()
        for run in previous_result.get_all_runs(only_largest_budget=False):
            cfg = id2conf[run.config_id]["config"]
            # the device fit does not impute, so NaNs (inactive dims of a
            # foreign result) must not reach it
            vec = np.nan_to_num(
                self.configspace.to_vector(cfg).astype(np.float32), nan=0.0
            )
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
        copy when they grow. ``resident`` is not ported yet and raises.
        """
        del min_n_workers  # API symmetry with Master.run; no worker pool here
        if resident:
            raise NotImplementedError(
                "resident is not ported to the PyTorch FusedBOHB yet"
            )
        first = len(self.iterations)
        plans = [self._plan(i) for i in range(first, int(n_iterations))]
        if self.config["time_ref"] is None:
            self.config["time_ref"] = time.time()
        chunk = len(plans) if chunk_brackets is None else max(int(chunk_brackets), 1)
        # only the caller's knobs choose the tier, never how many brackets
        # remain: a run cut after its first chunk and a longer uninterrupted
        # run must execute identical first chunks for a resume to match
        dynamic = (
            (chunk_brackets is not None)
            if dynamic_counts is None else bool(dynamic_counts)
        )
        d = int(self.codec.kind.shape[0])
        done = first
        #: device observation state returned by the previous dynamic chunk
        #: and the capacities it was built for
        dev_state = dev_caps = None
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
                    warm, upload_bytes = self._dynamic_warm(run_caps, d)
            else:
                warm = warm_obs_from_numpy(self._warm_v, self._warm_l, self.device)
                upload_bytes = sum(
                    v.nbytes + self._warm_l[b].nbytes for b, v in self._warm_v.items()
                )
            sweep = make_fused_sweep_fn(
                self.eval_fn, chunk_plans, self.codec,
                device=self.device,
                num_samples=self.num_samples,
                random_fraction=self.random_fraction,
                top_n_percent=self.top_n_percent,
                min_points_in_model=self.min_points_in_model,
                bandwidth_factor=self.bandwidth_factor,
                min_bandwidth=self.min_bandwidth,
                warm_counts=warm_counts,
                dynamic_counts=dynamic,
                capacities=run_caps,
                return_state=dynamic,
            )
            t0 = time.perf_counter()
            raw = sweep(seed, *warm)
            if dynamic:
                raw, dev_state = raw
                dev_caps = run_caps
            outputs = [type(o)(*(t.cpu().numpy() for t in o)) for o in raw]
            execute_s = time.perf_counter() - t0
            stat = {
                "chunk_index": len(self.run_stats),
                "brackets": list(range(done, done + len(chunk_plans))),
                "evaluations": int(sum(sum(p.num_configs) for p in chunk_plans)),
                "execute_fetch_s": execute_s,
                "dynamic_counts": dynamic,
                # 0 when the previous chunk's device state carried them
                "warm_upload_bytes": int(upload_bytes),
            }
            self.run_stats.append(stat)
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
        return Result(list(self.iterations) + self.warmstart_iteration, self.config)

    def _dynamic_warm(self, run_caps: Dict[float, int], d: int):
        """The host fold of the warm observations as the dynamic tier's
        full-capacity inputs on the device: ``((warm_v, warm_l, warm_n),
        bytes uploaded)``. Pads are (0-vector, +inf loss), exactly what the
        device appends leave in a threaded state."""
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
        return dynamic_obs_from_numpy(warm_v_pad, warm_l_pad, warm_n, self.device), nbytes

    def save_checkpoint(self, path: str) -> None:
        """Write the fused-tier checkpoint (``core/checkpoint.py``): warm
        observations, bracket rotation, RNG state and replayed bookkeeping
        at the last chunk boundary."""
        save_fused_checkpoint(self, path)

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
            if self.result_logger is not None:
                self.result_logger(job)
            it.register_result(job)
            self.total_evaluated += 1

    def shutdown(self, shutdown_workers: bool = False) -> None:
        """API symmetry with Master; nothing to tear down."""
