"""Activation conditions between hyperparameters.

Covers the condition surface the reference's search spaces use through the
external ConfigSpace library (SURVEY.md §2 "Config / flag system"):
equals / not-equals / in / greater-than / less-than, with multiple conditions
on one child combining conjunctively (AND), plus explicit And/Or conjunctions.

A child hyperparameter is *active* in a configuration iff its condition
evaluates true on the parent values; inactive children are absent from the
config dict and NaN in the vector representation.

Ported from ``hpbandster_tpu/space/conditions.py``: a numpy-only copy, so the
PyTorch package never imports the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

__all__ = [
    "Condition",
    "EqualsCondition",
    "NotEqualsCondition",
    "InCondition",
    "GreaterThanCondition",
    "LessThanCondition",
    "AndConjunction",
    "OrConjunction",
]


class Condition:
    """Base: a predicate over a (partial) configuration dict."""

    #: name of the hyperparameter gated by this condition
    child_name: str

    def parents(self) -> List[str]:
        """Names of hyperparameters this condition reads."""
        raise NotImplementedError

    def evaluate(self, values: Dict[str, Any]) -> bool:
        """True iff the child should be active.

        ``values`` maps hyperparameter name -> value for *active* parents;
        a parent that is itself inactive (absent) makes the condition false.
        """
        raise NotImplementedError


class _BinaryCondition(Condition):
    def __init__(self, child, parent, value: Any):
        # accept either Hyperparameter objects or names
        self.child_name = getattr(child, "name", child)
        self.parent_name = getattr(parent, "name", parent)
        self.value = value
        if self.child_name == self.parent_name:
            raise ValueError("a hyperparameter cannot condition on itself")

    def parents(self) -> List[str]:
        return [self.parent_name]

    def _test(self, parent_value: Any) -> bool:
        raise NotImplementedError

    def evaluate(self, values: Dict[str, Any]) -> bool:
        if self.parent_name not in values:
            return False
        return self._test(values[self.parent_name])

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"{type(self).__name__}({self.child_name!r} | "
            f"{self.parent_name!r}, {self.value!r})"
        )


class EqualsCondition(_BinaryCondition):
    def _test(self, parent_value: Any) -> bool:
        return parent_value == self.value


class NotEqualsCondition(_BinaryCondition):
    def _test(self, parent_value: Any) -> bool:
        return parent_value != self.value


class InCondition(_BinaryCondition):
    def __init__(self, child, parent, values: Sequence[Any]):
        super().__init__(child, parent, list(values))

    def _test(self, parent_value: Any) -> bool:
        return any(parent_value == v for v in self.value)


class GreaterThanCondition(_BinaryCondition):
    def _test(self, parent_value: Any) -> bool:
        return parent_value > self.value


class LessThanCondition(_BinaryCondition):
    def _test(self, parent_value: Any) -> bool:
        return parent_value < self.value


class _Conjunction(Condition):
    def __init__(self, *components: Condition):
        if len(components) < 2:
            raise ValueError("conjunction needs at least two components")
        children = {c.child_name for c in components}
        if len(children) != 1:
            raise ValueError(
                f"all conjunction components must share one child, got {children}"
            )
        self.components = list(components)
        self.child_name = components[0].child_name

    def parents(self) -> List[str]:
        out: List[str] = []
        for c in self.components:
            for p in c.parents():
                if p not in out:
                    out.append(p)
        return out


class AndConjunction(_Conjunction):
    def evaluate(self, values: Dict[str, Any]) -> bool:
        return all(c.evaluate(values) for c in self.components)


class OrConjunction(_Conjunction):
    def evaluate(self, values: Dict[str, Any]) -> bool:
        return any(c.evaluate(values) for c in self.components)
