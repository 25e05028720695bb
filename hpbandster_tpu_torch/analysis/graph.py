"""Whole-program call graph for graftlint's interprocedural rules.

Ported from ``hpbandster_tpu/analysis/graph.py``; the only change is
the roots the escape rule starts from (:meth:`Project.captured_roots`).

The intraprocedural rules answer "is this line wrong given this module?"
— but the bug classes that actually cost review rounds are cross-module:
a helper that calls ``.item()``, three frames below a body captured as a
CUDA graph; an RPC issued by a method whose *caller* holds the
dispatcher condition. Answering those needs one structure the per-module
rules cannot build: a project-wide call graph.

This module constructs it from the same memoized ``SourceModule`` walk
the rule pack already uses — stdlib-only, no imports executed, no torch —
so the interprocedural pass stays fast-lane material:

* :func:`load_module` — process-wide ``SourceModule`` cache keyed on
  ``(path, mtime_ns, size)``: the selfcheck's repeated full scans parse
  each file once per process, not once per scan;
* :func:`get_project` — memoized :class:`Project` over a file set: the
  per-module function tables, class/attribute types, alias tables (with
  re-export following through package ``__init__`` modules), and the
  resolved call-site list per function;
* :class:`Project` queries — ``resolve_dotted`` / ``method`` /
  ``calls`` / ``reachable`` / ``captured_roots`` / ``lock_ids`` — the
  primitives the lock-order and capture-escape rules are written against.

Resolution is deliberately *under*-approximate: an edge exists only when
the callee is provable from the AST (local name, import alias, ``self.``
method through the base-class chain, a variable or attribute whose class
is pinned by a visible constructor call, or a ``functools.partial`` over
any of those). Dynamic dispatch through stored callables resolves to
nothing — a missing edge can hide a bug (reviewers still exist) but
never invents one, which is what keeps the interprocedural rules quiet
enough to gate the tree.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from hpbandster_tpu_torch.analysis.core import SourceModule

__all__ = [
    "FunctionInfo",
    "CallSite",
    "LockDecl",
    "Project",
    "load_module",
    "get_project",
    "clear_caches",
]

#: factories whose result is a mutual-exclusion object; the bool marks
#: reentrancy (Condition() defaults to an RLock, so re-entry is legal)
_LOCK_FACTORIES: Dict[str, bool] = {
    "threading.Lock": False,
    "threading.RLock": True,
    "threading.Condition": True,
    "threading.Semaphore": False,
    "threading.BoundedSemaphore": False,
    "multiprocessing.Lock": False,
    "multiprocessing.RLock": True,
}

_MAX_BASE_DEPTH = 8  # base-class chains / re-export chains are short


@dataclasses.dataclass
class FunctionInfo:
    """One function or method, addressable by its dotted qualified name."""

    qname: str  # "pkg.mod.Class.meth" / "pkg.mod.fn" / "pkg.mod.fn.<locals>.g"
    name: str
    module: SourceModule
    module_name: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    cls_qname: Optional[str] = None  # immediate enclosing class, if a method
    #: positional parameter names in call order (posonly + args), self/cls
    #: included — callers map arguments through :meth:`positional_params`
    params: Tuple[str, ...] = ()
    kwonly: Tuple[str, ...] = ()
    has_vararg: bool = False
    has_kwarg: bool = False

    def positional_params(self, bound: bool) -> Tuple[str, ...]:
        """Parameter names positional arguments land on; ``bound`` drops
        the self/cls slot (``obj.m(x)`` style calls)."""
        if bound and self.cls_qname is not None and self.params:
            return self.params[1:]
        return self.params

    def __repr__(self) -> str:  # debugging aid, not part of the contract
        return f"FunctionInfo({self.qname})"


@dataclasses.dataclass
class CallSite:
    """One resolved call edge: ``caller`` invokes ``callee`` at ``line``."""

    caller: str
    callee: "FunctionInfo"
    node: ast.Call
    line: int
    #: True when the receiver is implicit (``self.m()`` / ``obj.m()``) so
    #: positional arguments skip the self slot
    bound: bool = False
    #: True when the edge is a ``functools.partial`` construction, not a
    #: direct invocation — the call may happen later, elsewhere
    via_partial: bool = False
    #: True for constructor edges (``C()`` -> ``C.__init__``)
    is_init: bool = False


@dataclasses.dataclass(frozen=True)
class LockDecl:
    """One mutual-exclusion object the project owns.

    ``lock_id`` is the defining scope's dotted name plus the attribute:
    ``pkg.mod.Class._lock`` for instance locks (one id per *class*, the
    granularity lock-ordering is defined at), ``pkg.mod._LOCK`` for
    module-level locks.
    """

    lock_id: str
    reentrant: bool
    path: str
    line: int


class Project:
    """The whole-program index: modules, functions, classes, call edges."""

    def __init__(self) -> None:
        self.modules: Dict[str, SourceModule] = {}  # path -> module
        self.module_names: Dict[str, str] = {}  # path -> dotted name
        self.path_by_module: Dict[str, str] = {}  # dotted name -> path
        self.functions: Dict[str, FunctionInfo] = {}
        self.fn_by_node: Dict[int, FunctionInfo] = {}
        self.methods: Dict[str, Dict[str, FunctionInfo]] = {}  # cls -> name -> fn
        self.classes: Dict[str, ast.ClassDef] = {}  # cls_qname -> node
        self.class_module: Dict[str, SourceModule] = {}
        self.class_bases: Dict[str, List[str]] = {}  # resolved base qnames
        self.attr_types: Dict[str, Dict[str, str]] = {}  # cls -> attr -> cls
        self.calls: Dict[str, List[CallSite]] = {}  # caller qname -> sites
        self.site_by_node: Dict[int, CallSite] = {}  # id(ast.Call) -> site
        self.locks: Dict[str, LockDecl] = {}  # lock_id -> decl
        #: cls_qname -> attr name -> lock_id (inherited attrs resolve
        #: through bases at query time, see :meth:`lock_for_attr`)
        self.class_locks: Dict[str, Dict[str, str]] = {}
        self.alias_tables: Dict[str, Dict[str, str]] = {}  # path -> alias map
        #: per-function node attribution, filled by the single pass-1 walk
        #: (nested defs own their nodes; absent key == none of that kind)
        self.fn_calls: Dict[str, List[ast.Call]] = {}
        self.fn_assigns: Dict[str, List[ast.Assign]] = {}
        self.fn_has_with: Set[str] = set()
        #: path -> every FunctionDef/Call node in the module (any scope) —
        #: the exact census captured-root discovery scans, so it never
        #: re-walks full trees
        self.scan_nodes: Dict[str, List[ast.AST]] = {}
        #: scratch memos for rules (summary caches live here so they share
        #: the project's lifetime, not a rule instance's)
        self.cache: Dict[str, object] = {}

    # ------------------------------------------------------------ queries
    def resolve_dotted(self, dotted: str) -> Optional[FunctionInfo]:
        """Canonical dotted name -> FunctionInfo, following re-exports
        (``pkg.obs.emit`` lands on ``pkg.obs.events.emit`` when the
        package ``__init__`` imports it)."""
        seen: Set[str] = set()
        while dotted not in self.functions:
            if dotted in seen or len(seen) > _MAX_BASE_DEPTH:
                return None
            seen.add(dotted)
            head, _, attr = dotted.rpartition(".")
            if not head:
                return None
            # ClassName.method spelled through a module alias
            if head in self.classes:
                return self.method(head, attr)
            path = self.path_by_module.get(head)
            if path is None:
                return None
            alias = self.alias_tables.get(path, {}).get(attr)
            if alias is None:
                return None
            dotted = alias
        return self.functions[dotted]

    def resolve_class(self, dotted: str) -> Optional[str]:
        """Canonical dotted name -> class qname, following re-exports."""
        seen: Set[str] = set()
        while dotted not in self.classes:
            if dotted in seen or len(seen) > _MAX_BASE_DEPTH:
                return None
            seen.add(dotted)
            head, _, attr = dotted.rpartition(".")
            if not head:
                return None
            path = self.path_by_module.get(head)
            if path is None:
                return None
            alias = self.alias_tables.get(path, {}).get(attr)
            if alias is None:
                return None
            dotted = alias
        return dotted

    def resolve_class_in(self, dotted: str, module_name: str) -> Optional[str]:
        """:meth:`resolve_class`, with a bare (undotted) name also tried
        as module-local — ``Base`` inside ``m`` resolves to ``m.Base``."""
        found = self.resolve_class(dotted)
        if found is None and "." not in dotted:
            found = self.resolve_class(f"{module_name}.{dotted}")
        return found

    def method(self, cls_qname: str, name: str, _depth: int = 0) -> Optional[FunctionInfo]:
        """Look ``name`` up on ``cls_qname``, walking the base chain."""
        found = self.methods.get(cls_qname, {}).get(name)
        if found is not None or _depth >= _MAX_BASE_DEPTH:
            return found
        for base in self.class_bases.get(cls_qname, ()):
            found = self.method(base, name, _depth + 1)
            if found is not None:
                return found
        return None

    def lock_for_attr(self, cls_qname: str, attr: str, _depth: int = 0) -> Optional[str]:
        """``self.<attr>`` inside ``cls_qname`` -> lock_id, walking bases
        so a lock declared on a base class unifies across subclasses."""
        lock = self.class_locks.get(cls_qname, {}).get(attr)
        if lock is not None or _depth >= _MAX_BASE_DEPTH:
            return lock
        for base in self.class_bases.get(cls_qname, ()):
            lock = self.lock_for_attr(base, attr, _depth + 1)
            if lock is not None:
                return lock
        return None

    def callees(self, qname: str) -> List[CallSite]:
        return self.calls.get(qname, [])

    def reachable(self, roots: Iterable[str], max_depth: int = 32) -> Set[str]:
        """Qnames reachable from ``roots`` over resolved call edges."""
        seen: Set[str] = set()
        frontier = [(q, 0) for q in roots]
        while frontier:
            qname, depth = frontier.pop()
            if qname in seen or depth > max_depth:
                continue
            seen.add(qname)
            for site in self.calls.get(qname, ()):
                frontier.append((site.callee.qname, depth + 1))
        return seen

    def captured_roots(self) -> List[Tuple[FunctionInfo, ast.AST]]:
        """Every captured body in the project as ``(owner, region)``: a
        function captured into a CUDA graph (the first argument of
        ``RoundGraph(...)`` or ``make_graphed_callables(...)``) is its own
        region; a ``with torch.cuda.graph(...)`` block is a region of the
        function holding it — the entry points of capture-escape."""
        roots = self.cache.get("captured_roots")
        if roots is None:
            from hpbandster_tpu_torch.analysis.rules.capture_purity import (
                captured_regions_for,
            )

            roots = []
            for module in self.modules.values():
                for owner, region in captured_regions_for(module):
                    info = self.fn_by_node.get(id(owner)) if owner is not None else None
                    if info is not None:
                        roots.append((info, region))
            roots.sort(key=lambda pair: (pair[0].qname, pair[1].lineno))
            self.cache["captured_roots"] = roots
        return roots  # type: ignore[return-value]

    def lock_ids(self) -> List[str]:
        return sorted(self.locks)

    def body_nodes(self, info: FunctionInfo) -> Tuple[ast.AST, ...]:
        """``info``'s executable body in preorder: the function's subtree
        minus nested function/class definitions (those execute in their
        own frames — a lock held here is not held there) but including
        lambda bodies (they usually run inline)."""
        memo: Dict[int, Tuple[ast.AST, ...]] = self.cache.setdefault("body_nodes", {})  # type: ignore[assignment]
        cached = memo.get(id(info.node))
        if cached is None:
            out: List[ast.AST] = []
            stack: List[ast.AST] = list(ast.iter_child_nodes(info.node))
            stack.reverse()
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                out.append(node)
                children = list(ast.iter_child_nodes(node))
                children.reverse()
                stack.extend(children)
            cached = tuple(out)
            memo[id(info.node)] = cached
        return cached


# ------------------------------------------------------------ module names
def _module_name_for(path: str) -> str:
    """Dotted module name by walking up through ``__init__.py`` packages;
    a file outside any package is just its stem (fixtures, tmp files)."""
    path = os.path.abspath(path)
    stem = os.path.splitext(os.path.basename(path))[0]
    parts: List[str] = [] if stem == "__init__" else [stem]
    d = os.path.dirname(path)
    for _ in range(32):
        if not os.path.isfile(os.path.join(d, "__init__.py")):
            break
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    return ".".join(reversed(parts)) or stem


def _alias_table(module: SourceModule, module_name: str) -> Dict[str, str]:
    """Local name -> canonical dotted path, relative imports resolved
    against ``module_name`` (``from . import x`` inside ``pkg.mod`` maps
    ``x`` to ``pkg.x``)."""
    table: Dict[str, str] = {}
    pkg_parts = module_name.split(".")
    # statement-level traversal only: import statements cannot nest inside
    # expressions, so skipping expression subtrees visits ~10% of the
    # nodes a full ast.walk would
    stack: List[ast.stmt] = list(module.tree.body)
    while stack:
        node = stack.pop()
        for field in ("body", "orelse", "finalbody"):
            stack.extend(getattr(node, field, ()))
        for handler in getattr(node, "handlers", ()):
            stack.extend(handler.body)
        if isinstance(node, ast.Import):
            for a in node.names:
                table[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                # pkg.sub.mod, level=1 -> pkg.sub; level=2 -> pkg
                anchor = pkg_parts[: len(pkg_parts) - node.level]
                base = ".".join(anchor + ([node.module] if node.module else []))
            if not base:
                continue
            for a in node.names:
                if a.name != "*":
                    table[a.asname or a.name] = f"{base}.{a.name}"
    return table


def _resolve_alias(table: Dict[str, str], dotted: str) -> str:
    head, _, rest = dotted.partition(".")
    base = table.get(head, head)
    return f"{base}.{rest}" if rest else base


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ----------------------------------------------------------- project build
def _index_module(project: Project, module: SourceModule) -> None:
    """Populate function/class/lock tables for one module (pass 1)."""
    module_name = project.module_names[module.path]
    aliases = project.alias_tables[module.path]

    infos: List[FunctionInfo] = []
    scan = project.scan_nodes.setdefault(module.path, [])

    # hot path of the cold scan: hand-inlined child iteration (no
    # iter_child_nodes generator stack) and exact-type dispatch — AST
    # nodes are never subclassed here, so ``type(x) is C`` is safe
    _Cls, _Fn, _AFn = ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef
    _Call, _Assign, _With, _AWith = ast.Call, ast.Assign, ast.With, ast.AsyncWith
    _AST, _list = ast.AST, list

    def visit(
        node: ast.AST,
        scope: Tuple[str, ...],
        cls: Optional[str],
        fn: Optional[str],
        fn_calls: Optional[List[ast.Call]],
        fn_assigns: Optional[List[ast.Assign]],
        in_function: bool,
        in_class: bool,
    ) -> None:
        d = node.__dict__
        for field in node._fields:
            value = d.get(field)
            for child in value if type(value) is _list else (value,):
                t = type(child)
                if t is _Cls:
                    cls_qname = ".".join(scope + (child.name,))
                    project.classes[cls_qname] = child
                    project.class_module[cls_qname] = module
                    bases: List[str] = []
                    for b in child.bases:
                        name = _dotted(b)
                        if name is not None:
                            resolved = _resolve_alias(aliases, name)
                            if "." not in resolved:
                                # bare, unaliased: a module-local base
                                resolved = f"{module_name}.{resolved}"
                            bases.append(resolved)
                    project.class_bases[cls_qname] = bases
                    visit(
                        child,
                        scope + (child.name,),
                        cls_qname,
                        fn,
                        fn_calls,
                        fn_assigns,
                        False,
                        True,
                    )
                elif t is _Fn or t is _AFn:
                    if t is _Fn:
                        scan.append(child)
                    seg = ("<locals>", child.name) if in_function else (child.name,)
                    qname = ".".join(scope + seg)
                    args = child.args
                    info = FunctionInfo(
                        qname=qname,
                        name=child.name,
                        module=module,
                        module_name=module_name,
                        node=child,
                        cls_qname=cls if in_class else None,
                        params=tuple(
                            a.arg for a in (*args.posonlyargs, *args.args)
                        ),
                        kwonly=tuple(a.arg for a in args.kwonlyargs),
                        has_vararg=args.vararg is not None,
                        has_kwarg=args.kwarg is not None,
                    )
                    project.functions[qname] = info
                    project.fn_by_node[id(child)] = info
                    infos.append(info)
                    if info.cls_qname is not None:
                        project.methods.setdefault(info.cls_qname, {})[
                            child.name
                        ] = info
                    calls: List[ast.Call] = []
                    assigns: List[ast.Assign] = []
                    project.fn_calls[qname] = calls
                    project.fn_assigns[qname] = assigns
                    visit(child, scope + seg, None, qname, calls, assigns, True, False)
                elif isinstance(child, _AST):
                    # per-function node attribution, recorded during THIS
                    # walk so pass 2 and the lock rules never re-traverse
                    if t is _Call:
                        scan.append(child)
                        if fn_calls is not None:
                            fn_calls.append(child)
                    elif fn is not None:
                        if t is _Assign:
                            fn_assigns.append(child)
                        elif t is _With or t is _AWith:
                            project.fn_has_with.add(fn)
                    visit(child, scope, cls, fn, fn_calls, fn_assigns, in_function, in_class)

    visit(module.tree, (module_name,), None, None, None, None, False, False)

    # lock declarations + self-attr constructor types, from the per-method
    # assignment lists the walk above just recorded
    for fn_info in infos:
        cls_qname = fn_info.cls_qname
        if cls_qname is None:
            continue
        for node in project.fn_assigns.get(fn_info.qname, ()):
            if not isinstance(node.value, ast.Call):
                continue
            callee = _dotted(node.value.func)
            resolved = _resolve_alias(aliases, callee) if callee else None
            for tgt in node.targets:
                if not (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    continue
                if resolved in _LOCK_FACTORIES:
                    lock_id = f"{cls_qname}.{tgt.attr}"
                    project.locks[lock_id] = LockDecl(
                        lock_id=lock_id,
                        reentrant=_condition_reentrant(node.value, aliases)
                        if resolved == "threading.Condition"
                        else _LOCK_FACTORIES[resolved],
                        path=module.path,
                        line=node.lineno,
                    )
                    project.class_locks.setdefault(cls_qname, {})[tgt.attr] = lock_id
                elif resolved is not None:
                    # remember `self.x = ClassName(...)` receiver types for
                    # pass 2 (resolved lazily — the class may live anywhere)
                    project.attr_types.setdefault(cls_qname, {}).setdefault(
                        tgt.attr, resolved
                    )

    # module-level locks: NAME = threading.Lock()
    for node in ast.iter_child_nodes(module.tree):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        callee = _dotted(node.value.func)
        resolved = _resolve_alias(aliases, callee) if callee else None
        if resolved not in _LOCK_FACTORIES:
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                lock_id = f"{module_name}.{tgt.id}"
                project.locks[lock_id] = LockDecl(
                    lock_id=lock_id,
                    reentrant=_condition_reentrant(node.value, aliases)
                    if resolved == "threading.Condition"
                    else _LOCK_FACTORIES[resolved],
                    path=module.path,
                    line=node.lineno,
                )


def _condition_reentrant(call: ast.Call, aliases: Dict[str, str]) -> bool:
    """``Condition()`` wraps an RLock (reentrant) unless explicitly handed
    a non-reentrant lock: ``Condition(threading.Lock())``."""
    if not call.args:
        return True
    arg = call.args[0]
    if isinstance(arg, ast.Call):
        inner = _dotted(arg.func)
        resolved = _resolve_alias(aliases, inner) if inner else None
        if resolved in _LOCK_FACTORIES:
            return _LOCK_FACTORIES[resolved]
    return True


def _extract_calls(project: Project, info: FunctionInfo) -> List[CallSite]:
    """Resolve every call in ``info``'s body to project functions (pass 2)."""
    module = info.module
    aliases = project.alias_tables[module.path]

    # local constructor types: `v = ClassName(...)` pins v's class
    var_types: Dict[str, str] = {}
    for node in project.fn_assigns.get(info.qname, ()):
        if (
            isinstance(node.value, ast.Call)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            callee = _dotted(node.value.func)
            if callee is not None:
                cls = project.resolve_class_in(
                    _resolve_alias(aliases, callee), info.module_name
                )
                if cls is not None:
                    var_types[node.targets[0].id] = cls

    # nested defs of this function are callable by bare name in its body
    local_defs: Dict[str, FunctionInfo] = {}
    for child in ast.iter_child_nodes(info.node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested = project.fn_by_node.get(id(child))
            if nested is not None:
                local_defs[nested.name] = nested

    # enclosing-scope locals: the factory idiom defines sibling helpers
    # next to the captured closure (`make_fused_sweep_fn` defines
    # `run_bracket` AND `round_body`; `round_body` calls `run_bracket`), so a bare
    # name also resolves against each enclosing function's locals,
    # innermost first
    enclosing_scopes: List[str] = []
    scope = info.qname
    while ".<locals>." in scope:
        scope = scope.rsplit(".<locals>.", 1)[0]
        enclosing_scopes.append(scope)

    def receiver_class(expr: ast.AST, depth: int = 0) -> Optional[str]:
        if depth > 4:
            return None
        if isinstance(expr, ast.Name):
            if expr.id in ("self", "cls") and info.cls_qname is not None:
                return info.cls_qname
            return var_types.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = receiver_class(expr.value, depth + 1)
            if base is not None:
                dotted = self_attr_type(base, expr.attr)
                if dotted is not None:
                    return dotted
            return None
        if isinstance(expr, ast.Call):
            name = _dotted(expr.func)
            if name is not None:
                return project.resolve_class_in(
                    _resolve_alias(aliases, name), info.module_name
                )
        return None

    def self_attr_type(cls_qname: str, attr: str, _depth: int = 0) -> Optional[str]:
        if _depth > _MAX_BASE_DEPTH:
            return None
        dotted = project.attr_types.get(cls_qname, {}).get(attr)
        if dotted is not None:
            # stored unresolved at index time; canonicalize through the
            # DEFINING module's aliases (bare names are module-local there)
            defining = project.class_module.get(cls_qname)
            table = project.alias_tables.get(defining.path, {}) if defining else {}
            defining_mod = (
                project.module_names.get(defining.path, "") if defining else ""
            )
            return project.resolve_class_in(
                _resolve_alias(table, dotted), defining_mod
            )
        for base in project.class_bases.get(cls_qname, ()):
            found = self_attr_type(base, attr, _depth + 1)
            if found is not None:
                return found
        return None

    def resolve_callable(func: ast.AST) -> Tuple[Optional[FunctionInfo], bool, bool]:
        """-> (callee, bound, is_init); bound means the receiver fills the
        self slot."""
        if isinstance(func, ast.Name):
            if func.id in local_defs:
                return local_defs[func.id], False, False
            for enclosing in enclosing_scopes:
                sibling = project.functions.get(
                    f"{enclosing}.<locals>.{func.id}"
                )
                if sibling is not None:
                    return sibling, False, False
            mod_level = project.functions.get(f"{info.module_name}.{func.id}")
            if mod_level is not None:
                return mod_level, False, False
            resolved = _resolve_alias(aliases, func.id)
            cls = project.resolve_class_in(resolved, info.module_name)
            if cls is not None:
                ctor = project.method(cls, "__init__")
                return ctor, True, True
            return project.resolve_dotted(resolved), False, False
        if isinstance(func, ast.Attribute):
            rcls = receiver_class(func.value)
            if rcls is not None:
                return project.method(rcls, func.attr), True, False
            name = _dotted(func)
            if name is not None:
                resolved = _resolve_alias(aliases, name)
                cls = project.resolve_class(resolved)
                if cls is not None:
                    ctor = project.method(cls, "__init__")
                    return ctor, True, True
                return project.resolve_dotted(resolved), False, False
        return None, False, False

    sites: List[CallSite] = []
    for node in project.fn_calls.get(info.qname, ()):
        callee, bound, is_init = resolve_callable(node.func)
        if callee is not None:
            sites.append(
                CallSite(
                    caller=info.qname,
                    callee=callee,
                    node=node,
                    line=node.lineno,
                    bound=bound,
                    is_init=is_init,
                )
            )
            continue
        # functools.partial(f, ...): the partial is (almost always) called
        # later — record the edge at construction, flagged via_partial
        fname = _dotted(node.func)
        if fname is not None and _resolve_alias(aliases, fname) in (
            "functools.partial",
            "partial",
        ):
            if node.args:
                target, bound, is_init = resolve_callable(node.args[0])
                if target is not None and not is_init:
                    sites.append(
                        CallSite(
                            caller=info.qname,
                            callee=target,
                            node=node,
                            line=node.lineno,
                            bound=bound,
                            via_partial=True,
                        )
                    )
    return sites


# ------------------------------------------------------------------ caches
_MODULE_CACHE: Dict[str, Tuple[Tuple[int, int], SourceModule]] = {}
_PROJECT_CACHE: Dict[Tuple[Tuple[str, int, int], ...], Project] = {}
_CACHE_LIMIT = 4096  # tmp-file churn in long pytest runs must stay bounded


def load_module(path: str) -> SourceModule:
    """Parse ``path`` into a :class:`SourceModule`, memoized process-wide
    on ``(mtime_ns, size)`` so repeated scans share one parse (and every
    per-module rule memo riding ``SourceModule.cache``)."""
    st = os.stat(path)
    key = (st.st_mtime_ns, st.st_size)
    hit = _MODULE_CACHE.get(path)
    if hit is not None and hit[0] == key:
        return hit[1]
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    module = SourceModule(path, text)
    if len(_MODULE_CACHE) >= _CACHE_LIMIT:
        _MODULE_CACHE.clear()
    _MODULE_CACHE[path] = (key, module)
    return module


def get_project(files: Sequence[str]) -> Project:
    """Build (or fetch) the :class:`Project` over ``files``. The cache key
    is the file set plus each file's ``(mtime_ns, size)``, so an edited
    file invalidates the graph while the selfcheck's repeated scans hit."""
    entries: List[Tuple[str, int, int]] = []
    for path in sorted(set(os.path.abspath(p) for p in files)):
        try:
            st = os.stat(path)
        except OSError:
            continue
        entries.append((path, st.st_mtime_ns, st.st_size))
    key = tuple(entries)
    project = _PROJECT_CACHE.get(key)
    if project is not None:
        return project

    project = Project()
    for path, _, _ in entries:
        try:
            module = load_module(path)
        except (OSError, SyntaxError, ValueError):
            continue  # the runner reports parse errors; the graph skips them
        project.modules[path] = module
        name = _module_name_for(path)
        project.module_names[path] = name
        project.path_by_module.setdefault(name, path)
        table = _alias_table(module, name)
        project.alias_tables[path] = table
        if "import_map" not in module.cache:
            # the alias table IS an import map (plus resolved relative
            # imports); seeding the per-module memo here spares every rule
            # a redundant full-tree walk per module
            from hpbandster_tpu_torch.analysis.rules._util import ImportMap

            imports = ImportMap.__new__(ImportMap)
            imports.aliases = dict(table)
            module.cache["import_map"] = imports
    for module in project.modules.values():
        _index_module(project, module)
    for info in list(project.functions.values()):
        sites = _extract_calls(project, info)
        project.calls[info.qname] = sites
        for site in sites:
            project.site_by_node[id(site.node)] = site

    if len(_PROJECT_CACHE) >= 64:
        _PROJECT_CACHE.clear()
    _PROJECT_CACHE[key] = project
    return project


def clear_caches() -> None:
    """Drop the process-wide module and project caches (perf tests use
    this to measure a genuinely cold scan)."""
    _MODULE_CACHE.clear()
    _PROJECT_CACHE.clear()
