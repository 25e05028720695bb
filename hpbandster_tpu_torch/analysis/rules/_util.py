"""Shared AST helpers for the rule pack: dotted-name resolution through
module import aliases, and generic node walks (ported from
``hpbandster_tpu/analysis/rules/_util.py``)."""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Set

__all__ = [
    "dotted_name",
    "ImportMap",
    "import_map_for",
    "iter_functions",
    "names_in",
]


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ImportMap:
    """Resolve local names to canonical module paths.

    ``import torch.nn.functional as F`` -> ``F`` maps to
    ``torch.nn.functional``; ``from torch import cuda`` -> ``cuda`` maps to
    ``torch.cuda``; ``from torch.cuda import graph as g`` -> ``g`` maps to
    ``torch.cuda.graph``. :meth:`resolve` canonicalizes a dotted expression
    through this table so rules can match on true module paths.
    """

    def __init__(self, tree: ast.Module, nodes: Optional[Iterable[ast.AST]] = None):
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(tree) if nodes is None else nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, expr: ast.AST) -> Optional[str]:
        name = dotted_name(expr)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        base = self.aliases.get(head, head)
        return f"{base}.{rest}" if rest else base


def import_map_for(module) -> "ImportMap":
    """Per-module ImportMap, built once and memoized on the SourceModule."""
    imports = module.cache.get("import_map")
    if imports is None:
        # reuse the memoized preorder walk when some rule already built it,
        # but don't FORCE it: for graph-context modules that are never
        # rule-scanned, a plain ast.walk is much cheaper than indexing
        nodes = module.walk() if "dfs" in module.cache else None
        imports = ImportMap(module.tree, nodes=nodes)
        module.cache["import_map"] = imports
    return imports


def iter_functions(tree: ast.AST) -> Iterator[ast.AST]:
    """All FunctionDef/AsyncFunctionDef nodes, any nesting depth."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def names_in(node: ast.AST) -> Set[str]:
    """Every bare Name id referenced anywhere inside ``node``."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
