"""BOHB config generator: the KDE-guided proposal model, on PyTorch.

Ported from ``hpbandster_tpu/models/bohb_kde.py``. The semantics are the
reference's:

* per-budget good/bad KDE pair, split at ``top_n_percent`` (default 15);
* a model trains once a budget has ``min_points_in_model + 2``
  observations (at least ``dim + 1`` points);
* proposals use the largest budget with a trained model;
* ``random_fraction`` of proposals stay purely random;
* candidates are sampled around good points, best of ``num_samples`` by
  ``l(x)/g(x)``;
* crashed runs count as maximally bad; conditional (NaN) dims are imputed
  before the fit.

The host half is the reference's, draw for draw on ``self.rng``: the
float64 numpy fit, the split arithmetic, the imputation, the
``random_fraction`` coin, the random configurations and the proposal seeds.
The device half runs on ``device`` (``None`` means ``cuda``): the fitted
pair is uploaded once per refit, a wave's candidates come from a
``torch.Generator`` seeded with the same ``self.rng.integers(2**32)`` draw
the reference turns into a jax seed, and every candidate is scored by
``ops.cuda_kde.score_candidates`` (``kde_score.cu`` on a card, one launch a
wave). ``use_pallas`` selects the candidate layout (flat, or per proposal)
and whether ``lg_score`` is recorded, as in the reference; both score the
same way. The one-at-a-time ``get_config`` draws from its own generator,
seeded from ``seed``, as the reference's draws from a jax key chain that
never touches ``self.rng``.

Each refit, on the host or in-trace, emits a ``kde_refit`` event and
advances the ``kde.refits`` counter (``hpbandster_tpu_torch.obs``). With
``obs.use_profiler_annotations()`` a host fit is the ``hpb.kde_fit``
profiler range and a proposal with its fetch (an in-trace refit's
included) ``hpb.kde_propose``, so the fit's device work and the
proposal's can be told apart in a trace.

On a CUDA device a failed model-based proposal raises; the reference's
fallback to a random configuration is kept for CPU tensors only.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.job import Job
from hpbandster_tpu_torch.device import resolve_device, upload
from hpbandster_tpu_torch.models.base import base_config_generator
from hpbandster_tpu_torch.ops import cuda_kde
from hpbandster_tpu_torch.ops import kde as kde_ops
from hpbandster_tpu_torch.ops.kde import KDE, SeededDraws
from hpbandster_tpu_torch.space import ConfigurationSpace

__all__ = ["BOHBKDE"]


def _pow2_capacity(n: int, minimum: int = 8) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class BOHBKDE(base_config_generator):
    def __init__(
        self,
        configspace: ConfigurationSpace,
        min_points_in_model: Optional[int] = None,
        top_n_percent: int = 15,
        num_samples: int = 64,
        random_fraction: float = 1 / 3,
        bandwidth_factor: float = 3.0,
        min_bandwidth: float = 1e-3,
        seed: Optional[int] = None,
        proposal_batch_size: int = 128,
        use_pallas: Optional[bool] = None,
        in_trace_refit: Optional[bool] = None,
        device=None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.configspace = configspace
        self.device = resolve_device(device)
        # in-trace refit: the KDE fit and the proposal run over the raw
        # observation buffers on the device, with no fitted model on the
        # host (None -> env HPB_IN_TRACE_REFIT=1). Bandwidths compute in
        # float32 on the device and the conditional imputation draws from
        # its own seed, a distinct stream from the host fit's rng.choice
        if in_trace_refit is None:
            in_trace_refit = os.environ.get("HPB_IN_TRACE_REFIT", "") == "1"
        self.in_trace_refit = bool(in_trace_refit)
        # the flat candidate layout (None -> env HPB_USE_PALLAS=1), taken
        # only on a card, as the reference takes it only where Pallas runs
        if use_pallas is None:
            use_pallas = os.environ.get("HPB_USE_PALLAS", "") == "1"
        self.use_pallas = bool(use_pallas) and self.device.type == "cuda"
        # every stage's proposals run at this batch size (sliced down to
        # what is needed), so the scorer sees a few shapes only
        self.proposal_batch_size = int(proposal_batch_size)
        self.top_n_percent = int(top_n_percent)
        self.num_samples = int(num_samples)
        self.random_fraction = float(random_fraction)
        self.bandwidth_factor = float(bandwidth_factor)
        self.min_bandwidth = float(min_bandwidth)

        d = configspace.dim
        if min_points_in_model is None:
            min_points_in_model = d + 1
        if min_points_in_model < d + 1:
            self.logger.warning(
                "min_points_in_model raised to dim+1 = %d", d + 1
            )
            min_points_in_model = d + 1
        self.min_points_in_model = int(min_points_in_model)

        # host copies for the numpy bookkeeping, device copies for the
        # proposals, each converted once
        self.vartypes = np.asarray(configspace.vartypes())
        self.cards = np.asarray(configspace.cardinalities())
        self._vartypes_dev = torch.as_tensor(self.vartypes, device=self.device)
        self._cards_dev = torch.as_tensor(self.cards, device=self.device)

        self.rng = np.random.default_rng(seed)
        #: the candidate and imputation draws; a test swaps in the
        #: reference's own
        self.draws = SeededDraws(self.device, seed if seed is not None else 0)

        #: budget -> list of observation vectors (may contain NaNs)
        self.configs: Dict[float, List[np.ndarray]] = {}
        #: budget -> list of losses (inf for crashed)
        self.losses: Dict[float, List[float]] = {}
        #: budget -> (good KDE, bad KDE) as host (numpy) arrays
        self.kde_models: Dict[float, Tuple[KDE, KDE]] = {}
        #: budget -> the pair on the device; dropped on refit, so each model
        #: version is uploaded once
        self._device_kdes: Dict[float, Tuple[KDE, KDE]] = {}
        #: budgets with recorded but unfitted observations: a burst delivery
        #: (``new_result(update_model=False)``, the batched executor's wave)
        #: defers the refit to the next proposal, which fits over exactly
        #: the observations an eager refit would have seen
        self._dirty_budgets: set = set()

    # -------------------------------------------------------------- plumbing
    def _refit_dirty(self) -> None:
        for budget in sorted(self._dirty_budgets):
            self._fit_kde_pair(budget)
        self._dirty_budgets.clear()

    def _trained_split(self, n: int) -> Optional[Tuple[int, int]]:
        """The split arithmetic as a pure gate: ``(n_good, n_bad)`` when a
        model can exist at ``n`` observations, else None."""
        if n < self.min_points_in_model + 2:
            return None
        n_good = max(self.min_points_in_model, (self.top_n_percent * n) // 100)
        n_bad = max(
            self.min_points_in_model, ((100 - self.top_n_percent) * n) // 100
        )
        d = len(self.vartypes)
        if n_good <= d or n_bad <= d:
            return None
        return n_good, n_bad

    def largest_budget_with_model(self) -> Optional[float]:
        if self.in_trace_refit:
            # gated by counts alone: the fit happens at proposal time
            trained = [
                b for b, ls in self.losses.items()
                if self._trained_split(len(ls)) is not None
            ]
            return max(trained) if trained else None
        self._refit_dirty()
        if not self.kde_models:
            return None
        return max(self.kde_models.keys())

    def _device_kde_pair(self, budget: float) -> Tuple[KDE, KDE]:
        """The pair for ``budget`` on the device, uploaded at most once per
        refit, in one copy that does not synchronise."""
        pair = self._device_kdes.get(budget)
        if pair is None:
            good, bad = self.kde_models[budget]
            t = upload(self.device, *good, *bad)
            pair = (KDE(*t[:3]), KDE(*t[3:]))
            self._device_kdes[budget] = pair
        return pair

    def impute_conditional_data(self, array: np.ndarray) -> np.ndarray:
        """Replace NaN (inactive) dims: borrow the value from a random other
        observation that has the dim active, else draw uniformly."""
        array = np.array(array, dtype=np.float64, copy=True)
        n, d = array.shape
        cards = np.asarray(self.cards)
        for j in range(d):
            nan_rows = np.isnan(array[:, j])
            if not nan_rows.any():
                continue
            donors = array[~nan_rows, j]
            for i in np.where(nan_rows)[0]:
                if donors.size:
                    array[i, j] = self.rng.choice(donors)
                elif cards[j] > 0:
                    array[i, j] = float(self.rng.integers(cards[j]))
                else:
                    array[i, j] = self.rng.uniform()
        return array

    def _fit_kde_pair(self, budget: float) -> None:
        with obs.annotate("kde_fit"):
            train_configs = np.asarray(self.configs[budget])
            train_losses = np.asarray(self.losses[budget])
            n = len(train_losses)
            if n < self.min_points_in_model + 2:
                return

            # n_good = max(min_points, top_n% of n); n_bad = max(min_points,
            # (100 - top_n)% of n)
            n_good = max(self.min_points_in_model, (self.top_n_percent * n) // 100)
            n_bad = max(self.min_points_in_model, ((100 - self.top_n_percent) * n) // 100)
            idx = np.argsort(train_losses, kind="stable")

            t0 = time.monotonic()
            good = self.impute_conditional_data(train_configs[idx[:n_good]])
            bad = self.impute_conditional_data(train_configs[idx[-n_bad:]])
            if good.shape[0] <= good.shape[1] or bad.shape[0] <= bad.shape[1]:
                return

            self.kde_models[budget] = (self._make_kde(good), self._make_kde(bad))
            self._device_kdes.pop(budget, None)
            obs.emit(
                obs.KDE_REFIT,
                budget=budget, n_obs=n, n_good=n_good, n_bad=n_bad,
                duration_s=round(time.monotonic() - t0, 6),
            )
            obs.get_metrics().counter("kde.refits").inc()

    def _make_kde(self, data: np.ndarray) -> KDE:
        """The host fit in float64 numpy, padded to a power of two of at
        least 64 rows, so the scorer's input shapes change only at each
        doubling."""
        n, d = data.shape
        cap = _pow2_capacity(n, minimum=64)
        padded = np.zeros((cap, d), np.float32)
        padded[:n] = data
        mask = np.zeros(cap, np.float32)
        mask[:n] = 1.0
        # normal-reference rule with statsmodels' constant 1.06
        sigma = data.std(axis=0)
        bw = 1.06 * sigma * n ** (-1.0 / (4.0 + d))
        cards = np.asarray(self.cards, np.float64)
        cap_discrete = np.where(
            cards > 0, (np.maximum(cards, 2) - 1.0) / np.maximum(cards, 2), np.inf
        )
        bw = np.clip(bw, self.min_bandwidth, cap_discrete).astype(np.float32)
        return KDE(padded, mask, bw)

    def _refit_propose_device(
        self, budget: float, n: int
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The in-trace refit and ``n`` proposals: the raw observation
        buffers go up (a power of two of at least 64 rows), the fit, the
        scoring and the selection run on the device, and the ``n`` vectors
        (and scores, on the per-proposal layout) come back in one fetch."""
        t0 = time.monotonic()
        vecs = np.asarray(self.configs[budget], np.float64)
        losses = np.asarray(self.losses[budget], np.float32)
        n_obs = len(losses)
        n_good, n_bad = self._trained_split(n_obs)
        conditional = bool(self.configspace.get_conditions())
        if not conditional:
            # condition-free spaces carry no NaNs; scrub so a foreign NaN
            # cannot poison the mask-weighted fit
            vecs = np.nan_to_num(vecs, nan=0.0)
        cap = _pow2_capacity(n_obs, minimum=64)
        buf_v = np.zeros((cap, vecs.shape[1]), np.float32)
        buf_v[:n_obs] = vecs
        buf_l = np.full(cap, np.inf, np.float32)
        buf_l[:n_obs] = np.where(np.isnan(losses), np.inf, losses)
        seed = int(self.rng.integers(2**32, dtype=np.uint32))
        impute_seed = (
            int(self.rng.integers(2**32, dtype=np.uint32)) if conditional else None
        )
        obs_v, obs_l = upload(self.device, buf_v, buf_l)
        args = (seed, obs_v, obs_l, n_obs, n_good, n_bad, self._vartypes_dev,
                self._cards_dev, n, self.num_samples, self.bandwidth_factor,
                self.min_bandwidth)
        if self.use_pallas:
            out = cuda_kde.refit_propose_batch_seeded(
                *args, min_bandwidth_fit=self.min_bandwidth,
                impute_seed=impute_seed, draws=self.draws)
            fetched = out.cpu().numpy(), None
        else:
            vecs_d, scores_d = kde_ops.refit_propose_batch_seeded(
                *args, impute_seed=impute_seed, draws=self.draws)
            fetched = self._fetch_scored(vecs_d, scores_d)
        # the refit happened on the device: the journal still sees it
        obs.emit(
            obs.KDE_REFIT,
            budget=budget, n_obs=n_obs, n_good=n_good, n_bad=n_bad,
            duration_s=round(time.monotonic() - t0, 6), in_trace=True,
        )
        obs.get_metrics().counter("kde.refits").inc()
        return fetched

    @staticmethod
    def _fetch_scored(vecs: torch.Tensor, scores: torch.Tensor):
        """Proposals and scores on the host in one transfer."""
        out = torch.cat([vecs, scores[:, None]], dim=1).cpu().numpy()
        return out[:, :-1], out[:, -1]

    # ----------------------------------------------------------- checkpoint
    def get_state(self) -> Dict[str, Any]:
        """Picklable snapshot: observations and both random streams; the
        KDEs refit on restore."""
        return {
            "configs": {b: [np.asarray(v) for v in vs] for b, vs in self.configs.items()},
            "losses": {b: list(ls) for b, ls in self.losses.items()},
            "np_rng": self.rng.bit_generator.state,
            "torch_generator": self.draws.trickle.get_state().numpy(),
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        if "torch_generator" not in state:
            raise ValueError(
                "not a checkpoint of this package's BOHBKDE: its one-at-a-time "
                "proposal stream is a jax key ('jax_key'), which a "
                "torch.Generator cannot continue"
            )
        self.configs = {
            float(b): [np.asarray(v) for v in vs] for b, vs in state["configs"].items()
        }
        self.losses = {float(b): list(ls) for b, ls in state["losses"].items()}
        self.rng = np.random.default_rng()
        self.rng.bit_generator.state = state["np_rng"]
        self.draws.trickle.set_state(torch.from_numpy(np.asarray(state["torch_generator"])))
        self.kde_models.clear()
        self._device_kdes.clear()
        self._dirty_budgets.clear()
        if not self.in_trace_refit:  # in-trace mode refits at proposal time
            for budget in self.configs:
                self._fit_kde_pair(budget)

    # ------------------------------------------------------------- interface
    def new_result(self, job: Job, update_model: bool = True) -> None:
        super().new_result(job, update_model=update_model)
        budget = float(job.kwargs["budget"])
        # crashed or invalid runs register as maximally bad
        loss = job.loss
        if np.isnan(loss):
            loss = float("inf")
        vec = self.configspace.to_vector(job.kwargs["config"])
        self.configs.setdefault(budget, []).append(vec)
        self.losses.setdefault(budget, []).append(loss)
        if self.in_trace_refit:
            return  # the next proposal fits over these observations
        if update_model:
            self._fit_kde_pair(budget)
            self._dirty_budgets.discard(budget)
        else:
            # burst or warm-start delivery: record now, fit at the next
            # proposal
            self._dirty_budgets.add(budget)

    def _model_pick_info(
        self, best_budget: float, lg_score: Optional[float]
    ) -> Dict[str, Any]:
        """The decision record a model-based pick carries in its
        ``config_info``."""
        info: Dict[str, Any] = {
            "model_based_pick": True,
            "sample_reason": "model",
            "model_budget": best_budget,
            "n_points_in_model": len(self.losses.get(best_budget, ())),
            "bandwidth_factor": self.bandwidth_factor,
        }
        if lg_score is not None:
            info["lg_score"] = round(float(lg_score), 6)
        return info

    def _model_picks(self, best_budget: float, n: int) -> List[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """``n`` model-based picks as ``(config, info)``: one seed from
        ``self.rng`` (two with the in-trace imputation), one scorer launch,
        one fetch."""
        n_pad = _pow2_capacity(n, minimum=self.proposal_batch_size)
        with obs.annotate("kde_propose"):
            if self.in_trace_refit:
                vecs, scores = self._refit_propose_device(best_budget, n_pad)
            else:
                good, bad = self._device_kde_pair(best_budget)
                seed = int(self.rng.integers(2**32, dtype=np.uint32))
                args = (seed, good, bad, self._vartypes_dev, self._cards_dev, n_pad,
                        self.num_samples, self.bandwidth_factor, self.min_bandwidth)
                if self.use_pallas:
                    # the flat layout returns vectors only: no lg_score
                    vecs = cuda_kde.propose_batch_seeded(
                        *args, draws=self.draws).cpu().numpy()
                    scores = None
                else:
                    vecs, scores = self._fetch_scored(
                        *kde_ops.propose_batch_seeded_scored(*args, draws=self.draws))
        return [
            (dict(self.configspace.from_vector(vecs[k])),
             self._model_pick_info(best_budget, None if scores is None else scores[k]))
            for k in range(n)
        ]

    def get_config(self, budget: float) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        best_budget = self.largest_budget_with_model()
        if best_budget is None or self.rng.uniform() < self.random_fraction:
            cfg = self.configspace.sample_configuration(rng=self.rng)
            return dict(cfg), {
                "model_based_pick": False,
                # random because the model gate never opened, or the
                # exploration coin
                "sample_reason": (
                    "no_model" if best_budget is None else "random_fraction"
                ),
            }
        try:
            with obs.annotate("kde_propose"):
                if self.in_trace_refit:
                    # one proposal of the in-trace refit (its own shape)
                    vecs, scores = self._refit_propose_device(best_budget, 1)
                else:
                    good, bad = self._device_kde_pair(best_budget)
                    vecs, scores = self._fetch_scored(*kde_ops.propose_batch_seeded_scored(
                        None, good, bad, self._vartypes_dev, self._cards_dev, 1,
                        self.num_samples, self.bandwidth_factor, self.min_bandwidth,
                        draws=self.draws))
            return dict(self.configspace.from_vector(vecs[0])), self._model_pick_info(
                best_budget, None if scores is None else scores[0])
        except Exception as e:
            if self.device.type == "cuda":
                raise  # no silent fallback on the card
            self.logger.warning("model-based proposal failed (%s); sampling", e)
            cfg = self.configspace.sample_configuration(rng=self.rng)
            return dict(cfg), {
                "model_based_pick": False,
                "sample_reason": "model_failure",
            }

    def get_config_batch(
        self, budget: float, n: int
    ) -> List[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """A whole stage of proposals: the model-based picks in one scorer
        launch; the random_fraction interleave per config, as the
        reference's."""
        best_budget = self.largest_budget_with_model()
        if best_budget is None:
            return [
                (dict(c), {"model_based_pick": False, "sample_reason": "no_model"})
                for c in self.configspace.sample_configuration(n, rng=self.rng)
            ]
        use_model = self.rng.uniform(size=n) >= self.random_fraction
        n_model = int(use_model.sum())
        picks = iter(self._model_picks(best_budget, n_model) if n_model else ())
        out: List[Optional[Tuple[Dict[str, Any], Dict[str, Any]]]] = [
            next(picks) if m else None for m in use_model
        ]
        for i in range(n):
            if out[i] is None:
                cfg = self.configspace.sample_configuration(rng=self.rng)
                out[i] = (
                    dict(cfg),
                    {"model_based_pick": False, "sample_reason": "random_fraction"},
                )
        return out  # type: ignore[return-value]
