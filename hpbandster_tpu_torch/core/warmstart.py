"""Warm-start support: replay a previous Result into a fresh optimizer.

Ported from ``hpbandster_tpu/core/warmstart.py``: host bookkeeping, no jax.
Passing ``previous_result=`` to an optimizer replays every logged (config,
budget, loss) into its model, and the replayed data is carried into the
final Result under fresh negative iteration indices, so ids never collide
with live brackets.
"""

from __future__ import annotations

from typing import Any, Dict

from hpbandster_tpu_torch.core.iteration import Datum, Status
from hpbandster_tpu_torch.core.job import Job

__all__ = ["WarmStartIteration"]


class WarmStartIteration:
    """A finished pseudo-iteration wrapping a previous run's data."""

    is_finished = True

    def __init__(self, result, config_generator):
        self.data: Dict[Any, Datum] = {}
        id2conf = result.get_id2config_mapping()
        # re-key EVERY old iteration (live >= 0 and previously warmed < 0)
        # onto fresh negative indices, descending by old index: chained warm
        # starts then never collide with the new run's live brackets
        # (-1 - old would map an old -1 back to 0, shadowing live data)
        remap = {
            old: -1 - rank
            for rank, old in enumerate(
                sorted({cid[0] for cid in id2conf}, reverse=True)
            )
        }
        for old_id, conf in id2conf.items():
            runs = result.get_runs_by_id(old_id)
            if not runs:
                continue
            new_id = (remap[old_id[0]], old_id[1], old_id[2])
            datum = Datum(
                config=conf["config"],
                config_info=conf["config_info"],
                status=Status.COMPLETED,
            )
            for r in runs:
                datum.results[r.budget] = r.loss
                datum.time_stamps[r.budget] = r.time_stamps
                datum.exceptions[r.budget] = r.error_logs
                datum.budget = r.budget

                job = Job(new_id, config=conf["config"], budget=r.budget)
                job.result = None if r.loss is None else {"loss": r.loss, "info": r.info}
                job.exception = r.error_logs
                config_generator.new_result(job, update_model=(r is runs[-1]))
            self.data[new_id] = datum

    # the optimizer only ever touches finished iterations through these:
    def get_next_run(self):
        return None

    def process_results(self) -> bool:
        return False
