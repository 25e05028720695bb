"""Learning-curve models for budget-extrapolation optimizers.

Reference counterpart: ``hpbandster/learning_curve_models/`` backing the
experimental H2BO optimizer (SURVEY.md §2, tagged [LOW] — the exact upstream
API is unverified, so this module keeps a minimal, documented surface: fit
per-config (budget, loss) curves, predict loss at a target budget).

Models are small closed-form fits (last-value carry-forward and a power-law
``loss ≈ a * budget^(-b) + c``), vectorized with numpy — curve counts are
small and fits run host-side between stages.

Ported from ``hpbandster_tpu/models/learning_curves.py`` unchanged: host
numpy, no jax.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["LastValueModel", "PowerLawModel", "clean_curve"]

Curve = Sequence[Tuple[float, float]]  # [(budget, loss), ...]


def clean_curve(curve: Curve) -> List[Tuple[float, float]]:
    """Budget-sorted curve with non-finite points dropped.

    The models' shared degenerate-input contract (the early-stopping
    promotion rule feeds curves straight from crash-NaN-masked bracket
    state): NaN/inf losses and budgets are not observations — they are
    crash markers — so they never enter a fit. Duplicate budgets keep
    their relative order (stable sort on budget only): the later record
    of a re-evaluated rung stays the later point.
    """
    pts = [
        (float(b), float(v))
        for b, v in curve
        if np.isfinite(b) and np.isfinite(v)
    ]
    pts.sort(key=lambda p: p[0])
    return pts


class LastValueModel:
    """Predicts the most recent observation — the no-extrapolation baseline."""

    def fit(self, curves: List[Curve]) -> "LastValueModel":
        return self

    def predict(self, curve: Curve, target_budget: float) -> float:
        pts = clean_curve(curve)
        if not pts:
            return float("nan")
        return pts[-1][1]


class PowerLawModel:
    """Per-curve power-law extrapolation ``loss(b) ≈ a * b^(-k) + c``.

    Fit by log-linear regression on differences from the running minimum;
    degenerate curves (fewer than 3 points, non-decreasing) fall back to
    last-value.

    ``floor`` is a LOWER BOUND on the asymptote clamp ``ymin - c``: the
    effective offset is ``max(floor, |ymin| * 1e-5)``, scale-aware so the
    float32 device twin (``ops.bracket.power_law_extrapolate``) can represent
    the identical quantity — passing a tinier floor cannot tighten it.
    """

    def __init__(self, floor: float = None):
        self._user_floor = floor is not None
        self.floor = 1e-6 if floor is None else float(floor)
        self._warned_floor_override = False

    def fit(self, curves: List[Curve]) -> "PowerLawModel":
        return self

    def predict(self, curve: Curve, target_budget: float) -> float:
        pts = clean_curve(curve)
        if len(pts) < 3:
            return LastValueModel().predict(pts, target_budget)
        b = np.array([p[0] for p in pts], dtype=np.float64)
        y = np.array([p[1] for p in pts], dtype=np.float64)
        # asymptote estimate from the last three points: on a geometric
        # budget ladder the residuals (y - c) of a power law form a geometric
        # sequence, so c = (y0*y2 - y1^2) / (y0 + y2 - 2*y1) exactly
        y0, y1, y2 = y[-3], y[-2], y[-1]
        denom = y0 + y2 - 2 * y1
        c_est = (y0 * y2 - y1 * y1) / denom if abs(denom) > 1e-12 else -np.inf
        # scale-aware floor so the device (f32) twin in ops.bracket can
        # represent the same offset: ymin - 1e-12 is a no-op in f32
        floor = max(self.floor, abs(y.min()) * 1e-5)
        # only a USER-chosen floor being overridden merits a warning — the
        # default floor is below the scale bound on every ordinary loss scale
        if (
            self._user_floor
            and floor > self.floor
            and not self._warned_floor_override
        ):
            self._warned_floor_override = True
            logging.getLogger("hpbandster_tpu_torch.learning_curves").warning(
                "PowerLawModel floor %.3g raised to scale-aware bound %.3g "
                "(|ymin|*1e-5) for f32 device parity", self.floor, floor
            )
        c = min(c_est, y.min() - floor) if np.isfinite(c_est) else y.min() - floor
        resid = y - c
        if (resid <= 0).any() or (np.diff(y) > 0).all():
            return LastValueModel().predict(curve, target_budget)
        try:
            slope, intercept = np.polyfit(np.log(b), np.log(resid), 1)
        except (np.linalg.LinAlgError, ValueError):
            return LastValueModel().predict(curve, target_budget)
        if slope > 0:  # diverging fit — don't trust it
            return LastValueModel().predict(curve, target_budget)
        pred = c + np.exp(intercept + slope * np.log(target_budget))
        return float(pred)
