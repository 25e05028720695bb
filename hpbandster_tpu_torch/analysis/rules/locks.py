"""lock-coverage — instance state written under a lock, touched outside it.

Ported from ``hpbandster_tpu/analysis/rules/locks.py``, unchanged but for
the imports.

The threading idiom throughout ``parallel/`` is: a class owns a
``threading.Lock``/``Condition`` attribute, and every shared-state
attribute is only touched inside ``with self._lock:`` blocks. A single
unguarded read is enough to lose a worker registration or double-dispatch
a job — and those bugs only fire under elastic churn, where no unit test
lives.

Per class, the rule:

1. identifies lock attributes — ``self.X = threading.Lock()/RLock()/
   Condition()/Semaphore(...)`` assignments (aliased imports resolved);
2. collects the *protected set*: attributes stored (``self.a = ...``,
   ``self.a[k] = ...``, ``del self.a[k]``, augmented assigns) inside a
   ``with self.<lock>`` block anywhere in the class, nested functions
   included;
3. flags any other access (read or write) of a protected attribute outside
   every ``with`` block on a lock that has guarded it — except inside
   ``__init__``/``__new__``, where the object is not yet shared.

Method-call mutations (``self.jobs.append(...)``) do not *define*
protection (too many innocently-unshared lists would be swept in), but
once an attribute is protected by a store, calls on it outside the lock
are flagged like any other read. Methods that are only ever called with
the lock already held should carry a suppression with justification —
that contract is exactly what a reviewer needs to see at the call site.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from hpbandster_tpu_torch.analysis.core import Finding, Rule, SourceModule, register
from hpbandster_tpu_torch.analysis.rules._util import ImportMap, import_map_for

_LOCK_FACTORIES = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
    "multiprocessing.Lock",
    "multiprocessing.RLock",
}


def _self_attr(node: ast.AST) -> Optional[str]:
    """'attr' for ``self.attr`` nodes, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


@register
class LockCoverageRule(Rule):
    name = "lock-coverage"
    description = (
        "attribute assigned under a lock is read/written elsewhere without "
        "holding any lock that guards it"
    )

    def check(self, module: SourceModule) -> List[Finding]:
        # sound prefilter: a lock attribute requires one of these tokens
        if not any(t in module.text for t in ("Lock", "Condition", "Semaphore")):
            return []
        imports = import_map_for(module)
        findings: List[Finding] = []
        for node in module.walk():
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(module, imports, node))
        return findings

    def _check_class(
        self, module: SourceModule, imports: ImportMap, cls: ast.ClassDef
    ) -> List[Finding]:
        # one traversal of the class body feeds every pass below (the rule
        # used to re-walk the subtree four times per class)
        cls_nodes = tuple(module.subtree(cls))
        locks = self._lock_attrs(imports, cls_nodes)
        if not locks:
            return []

        #: attr -> set of lock names it was stored under
        protected: Dict[str, Set[str]] = {}
        #: (node-id) -> set of lock names held at that node
        held_at: Dict[int, Set[str]] = {}

        init_funcs = {
            fn
            for fn in cls_nodes
            if isinstance(fn, ast.FunctionDef) and fn.name in ("__init__", "__new__")
        }
        init_nodes: Set[int] = set()
        for fn in init_funcs:
            for sub in module.subtree(fn):
                init_nodes.add(id(sub))

        def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
            held_at[id(node)] = set(held)
            if isinstance(node, (ast.With, ast.AsyncWith)):
                newly = [
                    attr
                    for item in node.items
                    if (attr := _self_attr(item.context_expr)) in locks
                ]
                for item in node.items:
                    visit(item.context_expr, held)
                inner = held + tuple(a for a in newly if a is not None)
                for stmt in node.body:
                    visit(stmt, inner)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        visit(cls, ())

        # pass 1: the protected set — stores under a held lock
        for node in cls_nodes:
            if id(node) in init_nodes:
                continue
            held = held_at.get(id(node), set())
            if not held:
                continue
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, ast.Delete):
                targets = node.targets
            for tgt in targets:
                elements = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
                for base in elements:
                    while isinstance(base, (ast.Subscript, ast.Starred)):
                        base = base.value
                    attr = _self_attr(base)
                    if attr is not None and attr not in locks:
                        protected.setdefault(attr, set()).update(held)

        if not protected:
            return []

        # pass 2: accesses outside every guarding lock
        findings: List[Finding] = []
        seen_lines: Set[Tuple[int, str]] = set()
        for node in cls_nodes:
            attr = _self_attr(node)
            if attr is None or attr not in protected or id(node) in init_nodes:
                continue
            held = held_at.get(id(node), set())
            guards = protected[attr]
            if held & guards:
                continue
            key = (node.lineno, attr)
            if key in seen_lines:
                continue
            seen_lines.add(key)
            lock_list = "/".join(f"self.{g}" for g in sorted(guards))
            findings.append(
                self.finding(
                    module, node,
                    f"'self.{attr}' is written under {lock_list} but accessed "
                    "here without holding it — either take the lock, or "
                    "suppress with a justification if the caller provably "
                    "holds it",
                )
            )
        return findings

    def _lock_attrs(
        self, imports: ImportMap, cls_nodes: Tuple[ast.AST, ...]
    ) -> Set[str]:
        locks: Set[str] = set()
        for node in cls_nodes:
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                resolved = imports.resolve(node.value.func)
                if resolved in _LOCK_FACTORIES:
                    for tgt in node.targets:
                        attr = _self_attr(tgt)
                        if attr is not None:
                            locks.add(attr)
        return locks
