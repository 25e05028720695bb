"""Learning-curve early stopping: terminate configs that cannot win.

Ported from ``hpbandster_tpu/promote/earlystop.py``.

The promotion mask starts as the synchronous top-k (the paper's rule),
then the ``models/learning_curves.py`` power-law extrapolation removes
configs whose PREDICTED final-budget loss cannot reach the current cut —
a rung rank good enough to survive does not save a curve that has
flattened above the incumbent.

Distinct from H2BO's ``lc_extrapolation`` rule (which RE-RANKS by the
extrapolation and still promotes exactly k): this rule keeps the loss
ranking and only STOPS hopeless work, so a rung may promote fewer than
k configs and the saved budget goes to fresh samples. The "current cut"
is the best final-budget loss observed so far — across the whole sweep
when the optimizer provides :meth:`cut_fn` (``BOHB(promotion_rule=
"lc_earlystop")`` wires its own incumbent), otherwise within this
bracket — plus a safety ``margin``: extrapolations are noisy at low
fidelity, and killing a config is irreversible while promoting a loser
merely wastes one rung.

Audit: the per-candidate predictions ride ``promotion_decision.scores``
(the decision ranked-and-cut by them), so the replay harness can re-score
journals under this rule from the recorded curves.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from hpbandster_tpu_torch.core.iteration import BaseIteration
from hpbandster_tpu_torch.core.job import ConfigId
from hpbandster_tpu_torch.models.learning_curves import PowerLawModel
from hpbandster_tpu_torch.ops.bracket import sh_promotion_mask_np

__all__ = ["LCEarlyStopIteration"]


class LCEarlyStopIteration(BaseIteration):
    """Top-k promotion minus configs extrapolated to miss the cut."""

    promotion_rule = "lc_earlystop"
    #: optimizer hint (BOHB.get_next_iteration): pass a sweep-wide
    #: incumbent reader as ``cut_fn`` so iteration N benefits from
    #: iteration N-1's final-budget results
    wants_cut_fn = True

    def __init__(
        self,
        *args,
        lc_model=None,
        cut_fn: Optional[Callable[[float], Optional[float]]] = None,
        margin: float = 0.0,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.lc_model = lc_model or PowerLawModel()
        self.cut_fn = cut_fn
        self.margin = float(margin)

    def _curve(self, config_id: ConfigId):
        return [
            (b, v)
            for b, v in sorted(self.data[config_id].results.items())
            if v is not None
        ]

    def _current_cut(self, target: float) -> Optional[float]:
        if self.cut_fn is not None:
            cut = self.cut_fn(target)
            if cut is not None:
                return float(cut)
        finals = [
            d.results.get(target)
            for d in self.data.values()
            if d.results.get(target) is not None
        ]
        return min(finals) if finals else None

    def _advance_to_next_stage(
        self, config_ids: List[ConfigId], losses: np.ndarray
    ) -> np.ndarray:
        k = self.num_configs[self.stage + 1]
        mask = sh_promotion_mask_np(losses, k)
        target = self.budgets[-1]
        preds = np.array(
            [
                self.lc_model.predict(self._curve(cid), target)
                for cid in config_ids
            ],
            dtype=np.float64,
        )
        # crashed configs (NaN raw loss) stay NaN: never promoted anyway
        preds = np.where(np.isnan(losses), np.nan, preds)
        self.last_promotion_scores = [
            None if np.isnan(p) else float(p) for p in preds
        ]
        cut = self._current_cut(target)
        if cut is not None:
            hopeless = np.isfinite(preds) & (preds > cut + self.margin)
            mask = mask & ~hopeless
        return mask
