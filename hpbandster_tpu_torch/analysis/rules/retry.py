"""retry-backoff — retry loops whose failure path can never exit.

Ported from ``hpbandster_tpu/analysis/rules/retry.py``, unchanged but for
the imports.

The elastic fleet retries *everywhere* — result delivery, requeues,
nameserver bootstrap — and the repo's contract (docs/fault_tolerance.md
"Retry and backoff knobs") is that every retry is **bounded**: a capped
attempt count (``for attempt in range(n)``) or a monotonic deadline
(``while time.monotonic() < deadline``). An unbounded retry turns a
permanently-dead peer into a thread spinning forever — worse than a
crash, because the heartbeat collector sees a live process and the
anomaly detector sees nothing at all.

Flagged — a constant-true loop (``while True:`` / ``while 1:``) that

* contains a ``try`` with at least one ``except`` handler (it retries
  something that fails), and
* whose *failure region* — except handlers, ``else``/``finally`` blocks,
  and every statement outside the ``try`` body — contains no ``raise``,
  ``return``, or loop-level ``break``: once the attempt fails, nothing
  can ever stop the loop.

The ``try`` **body** is the attempt itself — its ``break``/``return`` is
the *success* exit and proves nothing about failure, so exits there do
not clear the loop. Bounded idioms are never flagged: ``for attempt in
range(n)`` (bounded by construction), a non-constant loop condition
(deadline or flag), a handler that re-raises after a cap check, or a
counter check after the ``try`` that raises/breaks. Nested ``def``/
``class`` bodies are opaque (their ``return`` exits the callee, not the
loop); ``break`` inside a nested loop exits that loop only.

A deliberate forever-server (an accept loop that must outlive any
failure) takes a suppression naming that intent::

    while True:  # graftlint: disable=retry-backoff — accept loop, lives as long as the process
"""

from __future__ import annotations

import ast
from typing import List

from hpbandster_tpu_torch.analysis.core import Finding, Rule, SourceModule, register


def _is_constant_true(test: ast.expr) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value) is True


class _FailureRegionScan:
    """One walk of a constant-true loop body, classifying regions.

    ``has_handler`` — some ``try`` in the loop catches (it's a retry
    loop); ``can_exit`` — the failure region holds an exit (the retry is
    bounded). Tracked context: ``in_attempt`` (inside a ``try`` body —
    the attempt, where exits are the success path) and ``loop_depth``
    (``break`` only exits the flagged loop at depth 0).
    """

    def __init__(self) -> None:
        self.has_handler = False
        self.can_exit = False

    def scan(self, stmts, in_attempt: bool = False, loop_depth: int = 0) -> None:
        for stmt in stmts:
            if isinstance(
                stmt,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                continue  # opaque: exits there leave the callee, not the loop
            if isinstance(stmt, ast.Try):
                if stmt.handlers:
                    self.has_handler = True
                # everything under an attempt stays attempt: a raise in a
                # nested handler is still caught by the outer try
                self.scan(stmt.body, True, loop_depth)
                for h in stmt.handlers:
                    self.scan(h.body, in_attempt, loop_depth)
                self.scan(stmt.orelse, in_attempt, loop_depth)
                self.scan(stmt.finalbody, in_attempt, loop_depth)
                continue
            if isinstance(stmt, (ast.Raise, ast.Return)):
                if not in_attempt:
                    self.can_exit = True
                continue
            if isinstance(stmt, ast.Break):
                if not in_attempt and loop_depth == 0:
                    self.can_exit = True
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self.scan(stmt.body, in_attempt, loop_depth + 1)
                self.scan(stmt.orelse, in_attempt, loop_depth)
                continue
            if isinstance(stmt, (ast.If,)):
                self.scan(stmt.body, in_attempt, loop_depth)
                self.scan(stmt.orelse, in_attempt, loop_depth)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                self.scan(stmt.body, in_attempt, loop_depth)
                continue
            if isinstance(stmt, ast.Match):
                for case in stmt.cases:
                    self.scan(case.body, in_attempt, loop_depth)
                continue
            # simple statements (Expr, Assign, AugAssign, Pass, Continue,
            # Delete, Global, ...) neither exit nor nest


@register
class RetryBackoffRule(Rule):
    name = "retry-backoff"
    description = (
        "unbounded retry loop: a while-True retry whose failure path has "
        "no attempt cap, deadline, raise, return, or break — a dead peer "
        "spins this thread forever"
    )

    def check(self, module: SourceModule) -> List[Finding]:
        findings: List[Finding] = []
        for node in module.walk():
            if not isinstance(node, ast.While):
                continue
            if not _is_constant_true(node.test):
                continue
            scan = _FailureRegionScan()
            scan.scan(node.body)
            if scan.has_handler and not scan.can_exit:
                findings.append(
                    self.finding(
                        module, node,
                        "constant-true retry loop whose failure path can "
                        "never exit: cap the attempts (for attempt in "
                        "range(n)), loop on a monotonic deadline, or "
                        "re-raise after a budget check (suppress with "
                        "justification for deliberate forever-servers)",
                    )
                )
        return findings
