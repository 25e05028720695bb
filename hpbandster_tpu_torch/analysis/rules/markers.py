"""pytest-marker — heavy port tests missing the ``slow`` marker.

Ported from ``hpbandster_tpu/analysis/rules/markers.py``. The fast lane
(``pytest -m 'not slow'``, the tier-1 gate) must stay under control: one
unmarked multi-rank test or hundred-bracket sweep quietly adds minutes for
every future PR. This rule encodes the repo's marking policy
(``pytest.ini``) as the reference's thresholds, calibrated so every
fast-lane port test today sits under them:

* spawns ranks in the test's own process (``torch.multiprocessing.spawn``,
  ``torch.distributed.init_process_group``) — the counterpart of
  ``jax.pmap``; ranks the test starts as subprocesses are judged by their
  own limits;
* passes ``n_iterations=N`` with ``N >= 16`` (a bracket per iteration —
  each a full SH ladder);
* passes ``max_budget=B`` with ``B >= 243`` (the eta=3 ladder grows a rung:
  heavier sweeps, longer training loops);
* a ``for _ in range(N>=64)`` loop whose body captures a CUDA graph or
  calls ``torch.compile``.

Only files named ``test_*.py`` are inspected. A ``slow`` marker on the
function, its class, or the module-level ``pytestmark`` clears it.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from hpbandster_tpu_torch.analysis.core import Finding, Rule, SourceModule, register
from hpbandster_tpu_torch.analysis.rules._util import dotted_name

_N_ITERATIONS_MAX = 16
_MAX_BUDGET_MAX = 243
_RANGE_LOOP_MAX = 64
#: calls that capture or compile a program: matched on the last dotted
#: part, or on the whole name where the last part is common
_CAPTURING = {"CUDAGraph", "RoundGraph", "make_graphed_callables"}
_CAPTURING_DOTTED = ("torch.compile", "cuda.graph")


def _has_slow_marker(decorators: List[ast.expr]) -> bool:
    for dec in decorators:
        node = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(node) or ""
        if name.endswith("mark.slow") or name == "slow":
            return True
    return False


def _pytestmark_is_slow(body: List[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "pytestmark" for t in stmt.targets
        ):
            for node in ast.walk(stmt.value):
                if (dotted_name(node) or "").endswith("mark.slow"):
                    return True
    return False


def _const_number(node: ast.expr) -> Optional[float]:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return float(node.value)
    return None


@register
class PytestMarkerRule(Rule):
    name = "pytest-marker"
    description = (
        "test spawns ranks, captures in a long loop or exceeds "
        "iteration/budget thresholds but lacks @pytest.mark.slow"
    )

    def check(self, module: SourceModule) -> List[Finding]:
        if not os.path.basename(module.path).startswith("test_"):
            return []
        if _pytestmark_is_slow(module.tree.body):
            return []
        findings: List[Finding] = []
        for node in module.tree.body:
            if isinstance(node, ast.ClassDef):
                if _has_slow_marker(node.decorator_list) or _pytestmark_is_slow(node.body):
                    continue
                for sub in node.body:
                    self._check_test(module, sub, findings)
            else:
                self._check_test(module, node, findings)
        return findings

    def _check_test(
        self, module: SourceModule, node: ast.stmt, findings: List[Finding]
    ) -> None:
        if not isinstance(node, ast.FunctionDef) or not node.name.startswith("test"):
            return
        if _has_slow_marker(node.decorator_list):
            return
        reason = self._slow_reason(module, node)
        if reason is not None:
            findings.append(
                self.finding(
                    module, node,
                    f"test {node.name!r} {reason} but has no @pytest.mark.slow — "
                    "mark it (or shrink it under the fast-lane thresholds)",
                )
            )

    def _slow_reason(
        self, module: SourceModule, fn: ast.FunctionDef
    ) -> Optional[str]:
        for node in module.subtree(fn):
            if isinstance(node, ast.Call):
                callee = dotted_name(node.func) or ""
                if callee.endswith(("multiprocessing.spawn", "mp.spawn")) or (
                    callee.rsplit(".", 1)[-1] == "init_process_group"
                ):
                    return f"spawns ranks ({callee})"
                for kw in node.keywords:
                    val = _const_number(kw.value) if kw.arg else None
                    if kw.arg == "n_iterations" and val is not None and val >= _N_ITERATIONS_MAX:
                        return f"runs n_iterations={int(val)} (>= {_N_ITERATIONS_MAX} brackets)"
                    if kw.arg == "max_budget" and val is not None and val >= _MAX_BUDGET_MAX:
                        return f"uses max_budget={val:g} (>= {_MAX_BUDGET_MAX})"
            if isinstance(node, (ast.For, ast.AsyncFor)):
                n = self._range_bound(node.iter)
                if n is not None and n >= _RANGE_LOOP_MAX and self._body_captures(node):
                    return f"captures or compiles inside a range({int(n)}) loop"
        return None

    @staticmethod
    def _range_bound(iter_expr: ast.expr) -> Optional[float]:
        if (
            isinstance(iter_expr, ast.Call)
            and isinstance(iter_expr.func, ast.Name)
            and iter_expr.func.id == "range"
            and iter_expr.args
        ):
            stop = iter_expr.args[1] if len(iter_expr.args) >= 2 else iter_expr.args[0]
            return _const_number(stop)
        return None

    @staticmethod
    def _body_captures(loop: ast.stmt) -> bool:
        for node in ast.walk(loop):
            if isinstance(node, ast.Call):
                callee = dotted_name(node.func) or ""
                if callee.rsplit(".", 1)[-1] in _CAPTURING or callee.endswith(
                    _CAPTURING_DOTTED
                ):
                    return True
        return False
