"""FusedBOHB: the whole-sweep optimizer driver, on PyTorch.

Ported from ``hpbandster_tpu/optimizers/fused_bohb.py``: ``FusedBOHB``
(``__init__``, ``_plan``, the unchunked static-tier ``run``,
``_accumulate_obs``, ``_replay_bracket``) and ``_ReplayIteration``. The sweep
runs on the device (``ops/sweep.py``); afterwards the host replays every
bracket into the standard ``SuccessiveHalving`` / ``Datum`` / ``Result``
bookkeeping, so analysis code sees the structures the reference produces.

Not ported yet: chunked and checkpointed runs, the dynamic-count and
resident tiers, meshes, stateful evaluation, warm start from a previous
``Result``, conditional spaces and forbidden clauses, and the
observability events.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hpbandster_tpu_torch.convert import warm_obs_from_numpy
from hpbandster_tpu_torch.core.job import Job
from hpbandster_tpu_torch.core.result import Result
from hpbandster_tpu_torch.core.successive_halving import SuccessiveHalving
from hpbandster_tpu_torch.device import resolve_device
from hpbandster_tpu_torch.ops.bracket import (
    budget_ladder,
    hyperband_bracket,
    max_sh_iterations,
)
from hpbandster_tpu_torch.ops.fused import _unpack_stages
from hpbandster_tpu_torch.ops.sweep import build_space_codec, make_fused_sweep_fn
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
        #: one row per run() call: brackets, evaluations, sweep seconds
        self.run_stats: List[Dict[str, Any]] = []
        #: observations of earlier run() calls, fed to later ones as warm data
        self._warm_v: Dict[float, np.ndarray] = {}
        self._warm_l: Dict[float, np.ndarray] = {}

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
        counts earlier ``run()`` calls, which feed this one as warm data) as
        one static-tier sweep on the device, then replay them into a
        ``Result``.

        ``chunk_brackets``, ``checkpoint_path``, ``dynamic_counts=True`` and
        ``resident`` select tiers that are not ported yet and raise.
        """
        del min_n_workers  # API symmetry with Master.run; no worker pool here
        for name, on in (
            ("chunk_brackets", chunk_brackets is not None),
            ("checkpoint_path", checkpoint_path is not None),
            ("dynamic_counts", bool(dynamic_counts)),
            ("resident", resident),
        ):
            if on:
                raise NotImplementedError(
                    f"{name} is not ported to the PyTorch FusedBOHB yet "
                    "(unchunked static tier only)"
                )
        first = len(self.iterations)
        plans = [self._plan(i) for i in range(first, int(n_iterations))]
        if self.config["time_ref"] is None:
            self.config["time_ref"] = time.time()
        if plans:
            seed = int(np.uint32(self.rng.integers(2**32, dtype=np.uint32)))
            warm_counts = {b: len(l) for b, l in self._warm_l.items()}
            sweep = make_fused_sweep_fn(
                self.eval_fn, plans, self.codec,
                device=self.device,
                num_samples=self.num_samples,
                random_fraction=self.random_fraction,
                top_n_percent=self.top_n_percent,
                min_points_in_model=self.min_points_in_model,
                bandwidth_factor=self.bandwidth_factor,
                min_bandwidth=self.min_bandwidth,
                warm_counts=warm_counts,
            )
            warm_v, warm_l = warm_obs_from_numpy(
                self._warm_v, self._warm_l, self.device
            )
            t0 = time.perf_counter()
            outputs = [
                type(o)(*(t.cpu().numpy() for t in o))
                for o in sweep(seed, warm_v, warm_l)
            ]
            sweep_s = time.perf_counter() - t0
            self.run_stats.append({
                "brackets": list(range(first, first + len(plans))),
                "evaluations": int(sum(sum(p.num_configs) for p in plans)),
                "sweep_s": sweep_s,
            })
            staged = []
            for b_i, (plan, out) in enumerate(zip(plans, outputs), start=first):
                stages = _unpack_stages(
                    (out.idx_packed, out.loss_packed), plan.num_configs
                )
                staged.append((b_i, plan, out, stages))
                self._accumulate_obs(plan, out, stages)
            for b_i, plan, out, stages in staged:
                self._replay_bracket(b_i, plan, out, stages)
        return Result(list(self.iterations), self.config)

    def _accumulate_obs(self, plan, out, stages) -> None:
        """Fold one bracket's (vector, loss) observations into the warm
        buffers so a later run()'s device model sees them."""
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

    def _replay_bracket(self, b_i: int, plan, out, stages) -> None:
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
                job.result = {"loss": loss, "info": {}}
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
