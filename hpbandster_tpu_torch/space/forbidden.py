"""Forbidden clauses — configurations that must never be sampled.

Minimal parity with ConfigSpace's forbidden-clause surface (SURVEY.md §2:
"typed hyperparameters, conditions, forbiddens"): equality clauses, membership
clauses, and AND-conjunctions of them. Sampling rejects forbidden draws.

Ported from ``hpbandster_tpu/space/forbidden.py``: a numpy-only copy, so the
PyTorch package never imports the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

__all__ = [
    "ForbiddenClause",
    "ForbiddenEqualsClause",
    "ForbiddenInClause",
    "ForbiddenAndConjunction",
]


class ForbiddenClause:
    def is_forbidden(self, values: Dict[str, Any]) -> bool:
        raise NotImplementedError

    def __repr__(self) -> str:
        # by value, so equal clauses of two spaces key a cache alike
        # (FusedBOHB's sweep cache keys forbidden spaces by their reprs)
        fields = ", ".join(f"{k}={v!r}" for k, v in vars(self).items())
        return f"{type(self).__name__}({fields})"


class ForbiddenEqualsClause(ForbiddenClause):
    def __init__(self, hyperparameter, value: Any):
        self.name = getattr(hyperparameter, "name", hyperparameter)
        self.value = value

    def is_forbidden(self, values: Dict[str, Any]) -> bool:
        return self.name in values and values[self.name] == self.value


class ForbiddenInClause(ForbiddenClause):
    def __init__(self, hyperparameter, values: Sequence[Any]):
        self.name = getattr(hyperparameter, "name", hyperparameter)
        self.values = list(values)

    def is_forbidden(self, values: Dict[str, Any]) -> bool:
        return self.name in values and any(values[self.name] == v for v in self.values)


class ForbiddenAndConjunction(ForbiddenClause):
    def __init__(self, *components: ForbiddenClause):
        if len(components) < 2:
            raise ValueError("conjunction needs at least two components")
        self.components = list(components)

    def is_forbidden(self, values: Dict[str, Any]) -> bool:
        return all(c.is_forbidden(values) for c in self.components)
