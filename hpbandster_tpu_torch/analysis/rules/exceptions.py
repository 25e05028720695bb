"""swallowed-exception — over-broad handlers that drop the error on the floor.

Ported from ``hpbandster_tpu/analysis/rules/exceptions.py``, unchanged but for
the imports.

A bare ``except:`` or ``except Exception:`` whose body neither re-raises,
nor logs, nor even *looks at* the exception turns a dead worker, a
truncated RPC frame, or a crashed wave into silence. In this codebase the
contract is explicit (see ``parallel/rpc.py``): exceptions are marshalled,
logged, or re-queued — never ignored.

Flagged: handlers catching ``Exception``/``BaseException`` (bare, named,
or inside a tuple) whose body contains none of

* a ``raise``,
* a call to anything that smells like reporting (``log``/``warn``/
  ``error``/``exception``/``print``/``fail``/``format_exc``/``crash``…),
* a use of the bound exception name (``except Exception as e`` whose body
  reads ``e`` is *handling* it — marshalling counts).

Narrow handlers (``except (CommunicationError, RPCError):``) are never
flagged: naming the failure mode is the point.
"""

from __future__ import annotations

import ast
from typing import List

from hpbandster_tpu_torch.analysis.core import Finding, Rule, SourceModule, register
from hpbandster_tpu_torch.analysis.rules._util import ImportMap, dotted_name, import_map_for

_BROAD = {"Exception", "BaseException", "builtins.Exception", "builtins.BaseException"}
#: exact tokens (whole callee tail, or one of its _-separated words) that
#: count as reporting — substring matching would let `close_dialog` or
#: `catalog` masquerade as logging
_REPORTING_TOKENS = {
    "log",
    "warn",
    "warning",
    "error",
    "exception",
    "critical",
    "fatal",
    "print",
    "pprint",
    "info",
    "debug",
    "fail",
    "failed",
    "format_exc",
    "print_exc",
    "crash",
    "report",
    "traceback",
}


def _is_broad(handler: ast.ExceptHandler, imports: ImportMap) -> bool:
    if handler.type is None:
        return True
    types = (
        handler.type.elts if isinstance(handler.type, ast.Tuple) else [handler.type]
    )
    return any((imports.resolve(t) or "") in _BROAD for t in types)


def _handles(module: SourceModule, handler: ast.ExceptHandler) -> bool:
    exc_name = handler.name
    for node in module.subtree(handler):
        if isinstance(node, ast.Raise):
            return True
        if exc_name and isinstance(node, ast.Name) and node.id == exc_name:
            return True
        if isinstance(node, ast.Call):
            callee = dotted_name(node.func) or ""
            tail = callee.rsplit(".", 1)[-1].lower()
            if tail in _REPORTING_TOKENS or any(
                part in _REPORTING_TOKENS for part in tail.split("_")
            ):
                return True
    return False


@register
class SwallowedExceptionRule(Rule):
    name = "swallowed-exception"
    description = (
        "bare/over-broad except that neither re-raises, logs, nor uses the "
        "exception — the error vanishes"
    )

    def check(self, module: SourceModule) -> List[Finding]:
        if "except" not in module.text:
            return []
        imports = import_map_for(module)
        findings: List[Finding] = []
        for node in module.walk():
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node, imports) or _handles(module, node):
                continue
            caught = "bare except" if node.type is None else (
                f"except {ast.unparse(node.type)}"
            )
            findings.append(
                self.finding(
                    module, node,
                    f"{caught} swallows the error: re-raise, log it, or narrow "
                    "the exception type (suppress with justification if "
                    "best-effort silence is genuinely intended)",
                )
            )
        return findings
