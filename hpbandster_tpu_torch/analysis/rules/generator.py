"""generator-seeding — ``torch.Generator`` hygiene in library code.

The torch counterpart of the reference's ``prng-reuse``
(``hpbandster_tpu/analysis/rules/prng.py``). The port draws from explicit
``torch.Generator`` objects seeded from the run's ``seed``: that is what
makes a same-seed run reproduce draw for draw, and what a CUDA graph
replays (``ops/graphs.py`` registers the draws' generators with the graph;
the process default generator is registered with none). Four failure
modes, all silent — the KDE still fits, on draws nobody can reproduce:

1. **unseeded draw** — a sampler (``torch.rand/randn/randint/randperm/
   multinomial/bernoulli/normal/poisson`` and their ``_like`` forms, or the
   in-place ``.uniform_/.normal_/.random_/.exponential_/.bernoulli_/
   .cauchy_/.log_normal_/.geometric_``) without ``generator=``: it draws
   from the process default, which no ``seed`` reproduces and no graph
   registers;
2. **loop-invariant re-seed** — ``g.manual_seed(s)`` inside a loop with a
   seed that uses nothing the loop binds: every iteration redraws the
   same numbers;
3. **twin seeds** — two generators seeded with the same expression in
   one function: their streams are identical (seed shards with
   ``ops.sweep.shard_seed(seed, s)``);
4. **global seeding** — ``torch.manual_seed(...)`` in library code reseeds
   every caller's default stream.

Test files (``test_*.py``, ``conftest.py``) are exempt: a test may seed
the process. The sanctioned idioms stay quiet: ``shard_seed(seed, s)`` per
shard, and ``GeneratorDraws.reseed`` / a ``.reseed(seed)`` method, which
seeds each generator of a draw source once.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Set

from hpbandster_tpu_torch.analysis.core import Finding, Rule, SourceModule, register
from hpbandster_tpu_torch.analysis.rules._util import ImportMap, import_map_for

_SAMPLERS = {
    "rand", "randn", "randint", "randperm", "multinomial", "bernoulli",
    "normal", "poisson", "rand_like", "randn_like", "randint_like",
}
_INPLACE_SAMPLERS = {
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_", "cauchy_",
    "log_normal_", "geometric_",
}
_LOOPS = (ast.For, ast.AsyncFor, ast.While)
#: sound prefilter: every flaggable call spells one of these
_PROBE = re.compile(
    r"\b(?:" + "|".join(sorted(_SAMPLERS | _INPLACE_SAMPLERS)) + r"|manual_seed)\s*\("
)


def _is_test_file(path: str) -> bool:
    base = os.path.basename(path)
    return base.startswith("test_") or base == "conftest.py"


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg in ("generator", None) for kw in node.keywords)


def _bound_in(loop: ast.AST) -> Set[str]:
    """Names a loop binds per iteration: its target and its body's stores."""
    names: Set[str] = set()
    roots = [loop.target] if isinstance(loop, (ast.For, ast.AsyncFor)) else []
    roots += list(loop.body)
    for root in roots:
        for n in ast.walk(root):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                names.add(n.id)
    return names


@register
class GeneratorSeedingRule(Rule):
    name = "generator-seeding"
    description = (
        "torch sampler without generator= (the unregistered process default), "
        "a generator re-seeded in a loop with a loop-invariant seed, two "
        "generators seeded alike, or torch.manual_seed in library code"
    )

    def check(self, module: SourceModule) -> List[Finding]:
        if _is_test_file(module.path) or not _PROBE.search(module.text):
            return []
        imports = import_map_for(module)
        findings: List[Finding] = []
        for node in module.walk():
            if isinstance(node, ast.Call):
                findings.extend(self._check_call(module, imports, node))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._check_seeds(module, node))
        return findings

    def _check_call(self, module: SourceModule, imports: ImportMap, node: ast.Call) -> List[Finding]:
        resolved = imports.resolve(node.func) or ""
        if resolved == "torch.manual_seed":
            return [self.finding(
                module, node,
                "torch.manual_seed(...) in library code reseeds the process's "
                "default stream under every caller — seed a torch.Generator "
                "and pass it",
            )]
        if _has_generator(node):
            return []
        if resolved.startswith("torch.") and resolved.count(".") == 1 and (
            resolved.rsplit(".", 1)[-1] in _SAMPLERS
        ):
            what = f"{resolved}(...)"
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _INPLACE_SAMPLERS
            and not resolved.startswith(("numpy.", "np.", "random."))
        ):
            what = f".{node.func.attr}(...)"
        else:
            return []
        return [self.finding(
            module, node,
            f"{what} without generator= draws from the process default "
            "generator, which no seed reproduces and no CUDA graph registers — "
            "pass a seeded torch.Generator",
        )]

    def _check_seeds(self, module: SourceModule, fn: ast.AST) -> List[Finding]:
        """Re-seeds in loops and twin seeds, within ``fn``'s own frame."""
        findings: List[Finding] = []
        seen: Dict[str, int] = {}

        def visit(node: ast.AST, loops: List[ast.AST]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
                return
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "manual_seed"
                and node.args
            ):
                seed = node.args[0]
                used = {n.id for n in ast.walk(seed) if isinstance(n, ast.Name)}
                # `torch.Generator(...).manual_seed(s)` seeds a fresh
                # generator: made per iteration, nothing is re-seeded
                fresh = isinstance(node.func.value, ast.Call)
                if loops and not fresh and not (used & _bound_in(loops[-1])):
                    findings.append(self.finding(
                        module, node,
                        f"generator re-seeded with loop-invariant "
                        f"{ast.unparse(seed)!r} inside a loop — every iteration "
                        "redraws the same numbers; seed once before the loop",
                    ))
                else:
                    key = ast.dump(seed)
                    if key in seen and not loops:
                        findings.append(self.finding(
                            module, node,
                            f"a second generator seeded with {ast.unparse(seed)!r} "
                            f"(as at line {seen[key]}) draws the same stream — "
                            "derive distinct seeds (shard_seed(seed, s))",
                        ))
                    seen.setdefault(key, node.lineno)
            inner = loops + [node] if isinstance(node, _LOOPS) else loops
            for child in ast.iter_child_nodes(node):
                # a loop's iterable runs once, outside the loop
                if isinstance(node, (ast.For, ast.AsyncFor)) and child is node.iter:
                    visit(child, loops)
                else:
                    visit(child, inner)

        for stmt in fn.body:
            visit(stmt, [])
        return findings
