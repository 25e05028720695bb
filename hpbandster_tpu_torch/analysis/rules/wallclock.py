"""wallclock-duration — durations computed from the wall clock.

Ported from ``hpbandster_tpu/analysis/rules/wallclock.py``, unchanged but for
the imports.

``time.time()`` answers *when*; ``time.monotonic()`` answers *how long*.
Subtracting wall-clock readings measures NTP slews, DST steps, and VM
clock corrections along with the thing being timed — a watchdog built on
``time.time() - started`` fires early (or never) the day the host's
clock steps, which in this fleet means a healthy worker self-shutting
mid-rung or a checkpoint cadence silently stalling. The repo's contract
(docs/observability.md, ``core.job.Job``'s wall/mono twin stamps) is
explicit: wall-clock values are *timestamps* for humans and cross-host
journal ordering, monotonic values are for arithmetic.

Flagged — a ``-`` (subtraction) expression where either operand is

* a direct ``time.time()`` call (``time.time() - self._t0``,
  ``now - time.time()``), or
* a local name bound to ``time.time()`` earlier in the same function
  (``t0 = time.time(); ...; dt = end - t0``).

Not flagged: storing/emitting wall timestamps verbatim (``{"t_wall":
time.time()}``), monotonic arithmetic, and cross-*process* wall math on
journaled timestamps — monotonic clocks do not compare across hosts, so
those sites stay legal but deserve a suppression explaining exactly
that.
"""

from __future__ import annotations

import ast
from typing import List, Set

from hpbandster_tpu_torch.analysis.core import Finding, Rule, SourceModule, register
from hpbandster_tpu_torch.analysis.rules._util import import_map_for

_WALL_CALLS = {"time.time", "datetime.datetime.now", "datetime.datetime.utcnow"}


def _is_wall_call(node: ast.AST, imports) -> bool:
    return (
        isinstance(node, ast.Call)
        and not node.args and not node.keywords
        and (imports.resolve(node.func) or "") in _WALL_CALLS
    )


def _wall_names(nodes, imports) -> Set[str]:
    """Local names assigned directly from a wall-clock call anywhere in
    the node list (flow-insensitive on purpose: a name that EVER holds a
    wall timestamp should never sit in duration arithmetic)."""
    names: Set[str] = set()
    for node in nodes:
        if isinstance(node, ast.Assign) and _is_wall_call(node.value, imports):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
    return names


def _outer_functions(tree: ast.AST):
    """(outermost functions, module-level non-function nodes).

    One pass, no re-walking: each outermost function's subtree is walked
    exactly once by the caller — the old per-``iter_functions``-entry
    walk re-traversed every nested closure once per nesting level, which
    made this rule the scan's hot spot as the tree grew.
    """
    outers: List[ast.AST] = []
    module_nodes: List[ast.AST] = [tree]

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                outers.append(child)
            else:
                module_nodes.append(child)
                visit(child)

    visit(tree)
    return outers, module_nodes


@register
class WallclockDurationRule(Rule):
    name = "wallclock-duration"
    description = (
        "duration computed by subtracting wall-clock time.time() readings "
        "— clock steps corrupt the interval; use time.monotonic()"
    )

    def check(self, module: SourceModule) -> List[Finding]:
        if "time" not in module.text:
            return []
        imports = import_map_for(module)
        findings: List[Finding] = []

        def scan(nodes, wall_names: Set[str]) -> None:
            def is_wall(operand: ast.AST) -> bool:
                if _is_wall_call(operand, imports):
                    return True
                return (
                    isinstance(operand, ast.Name) and operand.id in wall_names
                )

            for node in nodes:
                if not isinstance(node, ast.BinOp) or not isinstance(
                    node.op, ast.Sub
                ):
                    continue
                if is_wall(node.left) or is_wall(node.right):
                    findings.append(
                        self.finding(
                            module, node,
                            "wall-clock subtraction measures clock steps, "
                            "not elapsed time: take the operands from "
                            "time.monotonic() (keep time.time() only as a "
                            "verbatim timestamp; suppress with "
                            "justification for cross-process wall math)",
                        )
                    )

        # nested closures share their outermost function's (superset)
        # wall-name pool — the same verdicts the old outer-first
        # iter_functions walk produced, at one traversal per subtree
        outers, module_nodes = _outer_functions(module.tree)
        for fn in outers:
            nodes = list(module.subtree(fn))
            scan(nodes, _wall_names(nodes, imports))
        # module level: direct calls only (module-scope assignments of
        # wall stamps subtracted later are overwhelmingly cross-run
        # timestamps, not durations)
        scan(module_nodes, set())
        return findings
