"""Run/Result containers, streaming JSONL logging, and offline reload.

Format-compatible with the reference's ``core/result.py`` (SURVEY.md §2
"Result / logging" row and §3.5 call stack):

* ``configs.json`` — one JSON array per line: ``[config_id, config, config_info]``
* ``results.json`` — one JSON array per line:
  ``[config_id, budget, time_stamps, result, exception]``

so existing HpBandSter analysis scripts can consume this framework's logs
unchanged, and vice versa (``logged_results_to_HBS_result``).

Ported from ``hpbandster_tpu/core/result.py``: host bookkeeping, no jax.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from hpbandster_tpu_torch.core.iteration import Datum, Status
from hpbandster_tpu_torch.core.job import ConfigId, Job

__all__ = [
    "Run",
    "Result",
    "json_result_logger",
    "logged_results_to_HBS_result",
    "extract_HBS_learning_curves",
]


class Run:
    """One (config_id, budget) evaluation, as surfaced by analysis code.

    Field names match the reference's ``Run`` (SURVEY.md §3.5): config_id,
    budget, loss, info, time_stamps, error_logs.
    """

    def __init__(
        self,
        config_id: ConfigId,
        budget: float,
        loss: Optional[float],
        info: Any,
        time_stamps: Dict[str, float],
        error_logs: Optional[str],
    ):
        self.config_id = tuple(config_id)
        self.budget = budget
        self.loss = loss
        self.info = info
        self.time_stamps = time_stamps
        self.error_logs = error_logs

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Run(id={self.config_id}, budget={self.budget}, loss={self.loss})"
        )

    def __getitem__(self, k: str) -> Any:
        """Dict-style access kept for reference-script compatibility."""
        return getattr(self, k)


def extract_HBS_learning_curves(runs: List[Run]) -> List[List[Tuple[float, float]]]:
    """Learning-curve extractor matching the reference helper: one curve —
    the (budget, loss) sequence sorted by budget — per config."""
    sr = sorted(runs, key=lambda r: r.budget)
    lc = [(r.budget, r.loss) for r in sr if r.loss is not None]
    return [lc] if lc else []


class Result:
    """All data from one optimizer run, plus the analysis helpers.

    Constructed from the list of finished iteration objects and the
    HB_config dict (eta/budgets/time_ref...), exactly like the reference.
    """

    def __init__(self, HB_iteration_data: List[Any], HB_config: Dict[str, Any]):
        # merge every iteration's {config_id: Datum} into one mapping
        self.data: Dict[ConfigId, Datum] = {}
        for it in HB_iteration_data:
            source = it.data if hasattr(it, "data") else it
            for cid, datum in source.items():
                self.data[tuple(cid)] = datum
        self.HB_config = dict(HB_config)

    # ------------------------------------------------------------- mappings
    def get_id2config_mapping(self) -> Dict[ConfigId, Dict[str, Any]]:
        return {
            cid: {"config": copy.deepcopy(d.config),
                  "config_info": copy.deepcopy(d.config_info)}
            for cid, d in self.data.items()
        }

    def get_runs_by_id(self, config_id: ConfigId) -> List[Run]:
        d = self.data[tuple(config_id)]
        runs = []
        for budget in sorted(d.results.keys()):
            err = d.exceptions.get(budget)
            res = d.results[budget]
            info = getattr(d, "infos", {}).get(budget)
            runs.append(
                Run(
                    config_id=tuple(config_id),
                    budget=budget,
                    loss=res,
                    info=info,
                    time_stamps=d.time_stamps.get(budget, {}),
                    error_logs=err,
                )
            )
        return runs

    def get_all_runs(self, only_largest_budget: bool = False) -> List[Run]:
        """Every recorded run; with ``only_largest_budget`` keep only each
        config's largest-budget run (reference semantics, §3.5)."""
        all_runs: List[Run] = []
        for cid in self.data.keys():
            runs = self.get_runs_by_id(cid)
            if not runs:
                continue
            if only_largest_budget:
                all_runs.append(runs[-1])
            else:
                all_runs.extend(runs)
        return all_runs

    # ------------------------------------------------------------ incumbents
    def get_incumbent_id(self) -> Optional[ConfigId]:
        """Config with the lowest loss among runs on the largest budget."""
        max_budget = self.HB_config.get("max_budget")
        if max_budget is None:
            budgets = [b for d in self.data.values() for b in d.results.keys()]
            if not budgets:
                return None
            max_budget = max(budgets)
        best, best_id = np.inf, None
        for cid, d in self.data.items():
            loss = d.results.get(max_budget)
            if loss is not None and loss < best:
                best, best_id = loss, cid
        return best_id

    def get_incumbent_trajectory(
        self,
        all_budgets: bool = True,
        bigger_is_better: bool = True,
        non_decreasing_budget: bool = True,
    ) -> Dict[str, List[Any]]:
        """Anytime best-loss curve over wall-clock, reference-compatible.

        * ``all_budgets``: consider runs at every budget, not just the largest.
        * ``bigger_is_better``: a run at a strictly larger budget replaces the
          incumbent even if its loss is worse (trust high-fidelity more).
        * ``non_decreasing_budget``: never let the incumbent budget shrink.
        """
        all_runs = self.get_all_runs(only_largest_budget=not all_budgets)
        if not all_budgets:
            all_runs = [
                r for r in all_runs if r.budget == self.HB_config.get("max_budget", r.budget)
            ]
        all_runs.sort(key=lambda r: r.time_stamps.get("finished", 0.0))

        return_dict: Dict[str, List[Any]] = {
            "config_ids": [], "times_finished": [], "budgets": [], "losses": [],
        }
        current_incumbent = float("inf")
        incumbent_budget = -float("inf")
        for r in all_runs:
            if r.loss is None:
                continue
            new_incumbent = False
            if bigger_is_better and r.budget > incumbent_budget:
                new_incumbent = True
            if r.loss < current_incumbent:
                new_incumbent = True
            if non_decreasing_budget and r.budget < incumbent_budget:
                new_incumbent = False
            if new_incumbent:
                current_incumbent = r.loss
                incumbent_budget = r.budget
                return_dict["config_ids"].append(r.config_id)
                return_dict["times_finished"].append(
                    r.time_stamps.get("finished", 0.0)
                )
                return_dict["budgets"].append(r.budget)
                return_dict["losses"].append(r.loss)
        return return_dict

    # --------------------------------------------------------------- exports
    def get_pandas_dataframe(
        self, budgets: Optional[List[float]] = None, loss_fn=lambda r: r.loss
    ):
        """One row per run: config values + budget + loss (+ info scalars)."""
        import pandas as pd

        all_runs = self.get_all_runs(only_largest_budget=False)
        if budgets is not None:
            all_runs = [r for r in all_runs if r.budget in budgets]
        id2conf = self.get_id2config_mapping()
        rows, losses = [], []
        for r in all_runs:
            row = dict(id2conf[r.config_id]["config"])
            row["budget"] = r.budget
            rows.append(row)
            losses.append(loss_fn(r))
        df_x = pd.DataFrame(rows)
        df_y = pd.DataFrame({"loss": losses})
        return df_x, df_y

    def get_fANOVA_data(
        self,
        config_space,
        budgets: Optional[List[float]] = None,
        loss_fn=lambda r: r.loss,
        failed_loss: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray, Any]:
        """(X, y, config_space) arrays for fANOVA-style importance analysis.

        X uses the unit-hypercube codec, NaN-imputed with each dim's default
        value so conditional spaces stay rectangular.
        """
        all_runs = self.get_all_runs(only_largest_budget=False)
        if budgets is None:
            budgets = sorted({r.budget for r in all_runs})
        all_runs = [r for r in all_runs if r.budget in budgets]
        id2conf = self.get_id2config_mapping()

        hps = config_space.get_hyperparameters()
        defaults = np.array(
            [hp.to_unit(hp.default_value) for hp in hps], dtype=np.float64
        )
        X, y = [], []
        for r in all_runs:
            if r.loss is None and failed_loss is None:
                continue
            vec = config_space.to_vector(id2conf[r.config_id]["config"])
            vec = np.where(np.isnan(vec), defaults, vec)
            X.append(vec)
            y.append(failed_loss if r.loss is None else loss_fn(r))
        return np.asarray(X), np.asarray(y), config_space

    def get_learning_curves(
        self, lc_extractor=extract_HBS_learning_curves, config_ids=None
    ) -> Dict[ConfigId, List[List[Tuple[float, float]]]]:
        config_ids = config_ids or list(self.data.keys())
        return {
            tuple(cid): lc_extractor(self.get_runs_by_id(cid)) for cid in config_ids
        }

    def num_iterations(self) -> int:
        return len({cid[0] for cid in self.data.keys()}) if self.data else 0

    # ------------------------------------------------------------------ misc
    def __getstate__(self):
        return {"data": self.data, "HB_config": self.HB_config}

    def __setstate__(self, state):
        self.data = state["data"]
        self.HB_config = state["HB_config"]


class json_result_logger:
    """Streaming JSONL logger, byte-format-compatible with the reference.

    Writes ``configs.json`` (one line per new configuration) and
    ``results.json`` (one line per finished run) into ``directory``;
    refuses to clobber prior logs unless ``overwrite=True`` — both behaviors
    from the reference (SURVEY.md §5 "Checkpoint / resume").
    """

    def __init__(self, directory: str, overwrite: bool = False):
        os.makedirs(directory, exist_ok=True)
        self.config_fn = os.path.join(directory, "configs.json")
        self.results_fn = os.path.join(directory, "results.json")
        for fn in (self.config_fn, self.results_fn):
            if os.path.exists(fn):
                if overwrite:
                    os.remove(fn)
                else:
                    raise FileExistsError(
                        f"{fn} exists; pass overwrite=True to replace it"
                    )
            with open(fn, "a"):
                pass
        self.config_ids: set = set()

    def new_config(
        self, config_id: ConfigId, config: Dict[str, Any], config_info: Dict[str, Any]
    ) -> None:
        if tuple(config_id) in self.config_ids:
            return
        self.config_ids.add(tuple(config_id))
        with open(self.config_fn, "a") as fh:
            fh.write(json.dumps([list(config_id), config, config_info]))
            fh.write("\n")

    def __call__(self, job: Job) -> None:
        if tuple(job.id) not in self.config_ids:
            # happens for jobs injected via previous_result warm-starts
            self.new_config(job.id, job.kwargs.get("config", {}), {})
        with open(self.results_fn, "a") as fh:
            fh.write(
                json.dumps(
                    [
                        list(job.id),
                        job.kwargs.get("budget"),
                        job.timestamps,
                        job.result,
                        job.exception,
                    ]
                )
            )
            fh.write("\n")


def logged_results_to_HBS_result(directory: str) -> Result:
    """Rebuild a :class:`Result` from ``configs.json`` + ``results.json``.

    Accepts logs written by this framework or by the reference (same format).
    """
    data: Dict[ConfigId, Datum] = {}
    budget_set: set = set()
    time_ref = float("inf")

    with open(os.path.join(directory, "configs.json")) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            if len(entry) == 3:
                config_id, config, config_info = entry
            else:  # very old two-element format
                config_id, config = entry
                config_info = "N/A"
            data[tuple(config_id)] = Datum(
                config=config,
                config_info=config_info if isinstance(config_info, dict) else {},
            )

    with open(os.path.join(directory, "results.json")) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            config_id, budget, time_stamps, result, exception = json.loads(line)
            cid = tuple(config_id)
            if cid not in data:
                data[cid] = Datum(config={}, config_info={})
            d = data[cid]
            d.time_stamps[budget] = time_stamps
            d.results[budget] = None if result is None else result.get("loss")
            if result is not None and "info" in result:
                d.infos[budget] = result["info"]
            d.exceptions[budget] = exception
            d.budget = budget
            d.status = Status.REVIEW
            budget_set.add(budget)
            if time_stamps:
                time_ref = min(time_ref, time_stamps.get("submitted", time_ref))

    budgets = sorted(budget_set)
    HB_config = {
        "time_ref": 0.0 if time_ref == float("inf") else time_ref,
        "budgets": budgets,
        "max_budget": budgets[-1] if budgets else None,
        "min_budget": budgets[0] if budgets else None,
    }
    return Result([data], HB_config)
