"""capture-in-loop — a CUDA graph captured, or a program compiled, in a
per-iteration position.

The torch counterpart of the reference's ``jit-in-loop``
(``hpbandster_tpu/analysis/rules/jit_loop.py``). A capture is the port's
compile: ``torch.cuda.CUDAGraph()``, ``RoundGraph(...)``,
``torch.cuda.graph(...)`` and ``torch.cuda.make_graphed_callables(...)``
each record a program and pin a memory pool for it (4-5 GB for a CNN
sweep's graph on the H100), and ``torch.compile(...)`` builds a wrapper
with an empty cache. Made inside a loop body, every iteration captures
afresh and pins another pool — the storm ``optimizers/fused_bohb.py``'s
sweep cache exists to prevent. The fix is hoisting the capture out of the
loop or caching the program (``_SWEEP_CACHE``, ``StaticProgram``).

Flagged in the reference rule's per-iteration positions — a loop
body/``orelse``, a ``while`` test, a comprehension's element/``if``s/2nd+
generator iterables. Not flagged: a ``for`` statement's iterable and a
comprehension's first iterable (evaluated once), calls inside a ``def``
nested in the loop (judged where it runs), and REPLAYING a captured graph
in a loop — that is the supported hot path.
"""

from __future__ import annotations

import ast
from typing import List, Set

from hpbandster_tpu_torch.analysis.core import Finding, Rule, SourceModule, register
from hpbandster_tpu_torch.analysis.rules._util import ImportMap, import_map_for

#: constructors that capture or compile (resolved dotted names)
_CAPTURING = {
    "torch.cuda.CUDAGraph",
    "torch.cuda.graph",
    "torch.cuda.graphs.graph",
    "torch.cuda.make_graphed_callables",
    "torch.compile",
}
#: matched on the last dotted part, wherever it is imported from
_CAPTURING_NAMES = {"RoundGraph"}

_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _capturing_callee(node: ast.Call, imports: ImportMap) -> str:
    resolved = imports.resolve(node.func) or ""
    if resolved in _CAPTURING or resolved.rsplit(".", 1)[-1] in _CAPTURING_NAMES:
        return resolved
    if resolved in ("functools.partial", "partial"):
        for arg in node.args:
            inner = imports.resolve(arg) or ""
            if inner in _CAPTURING:
                return inner
    return ""


def _walk_skipping_defs(root: ast.AST):
    if isinstance(root, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


@register
class CaptureInLoopRule(Rule):
    name = "capture-in-loop"
    description = (
        "CUDAGraph()/RoundGraph(...)/torch.cuda.graph(...)/torch.compile(...) "
        "inside a loop or comprehension body — every iteration captures "
        "afresh and pins a new memory pool; hoist or cache the program"
    )

    def check(self, module: SourceModule) -> List[Finding]:
        if not any(t in module.text for t in (
            "CUDAGraph", "RoundGraph", "cuda.graph", "graphed_callables", "compile(",
            "import graph",
        )):
            return []
        imports = import_map_for(module)
        findings: List[Finding] = []
        flagged: Set[int] = set()
        for node in module.walk():
            if isinstance(node, _LOOPS):
                bodies = list(node.body) + list(node.orelse)
                if isinstance(node, ast.While):
                    bodies.append(node.test)
            elif isinstance(node, _COMPREHENSIONS):
                bodies = (
                    [node.key, node.value] if isinstance(node, ast.DictComp)
                    else [node.elt]
                )
                for gi, gen in enumerate(node.generators):
                    bodies.extend(gen.ifs)
                    if gi > 0:
                        bodies.append(gen.iter)
            else:
                continue
            for body in bodies:
                for sub in _walk_skipping_defs(body):
                    if not isinstance(sub, ast.Call) or id(sub) in flagged:
                        continue
                    wrapper = _capturing_callee(sub, imports)
                    if not wrapper:
                        continue
                    flagged.add(id(sub))
                    where = "comprehension" if isinstance(node, _COMPREHENSIONS) else "loop"
                    findings.append(self.finding(
                        module, sub,
                        f"{wrapper}(...) inside a {where} body captures or "
                        "compiles afresh every iteration, each pinning its own "
                        "memory pool — hoist it out of the loop or reuse a "
                        "cached program",
                    ))
        return findings
