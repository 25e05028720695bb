"""capture-host-sync — host synchronization inside a body captured as a
CUDA graph.

The torch counterpart of the reference's ``jit-host-sync``
(``hpbandster_tpu/analysis/rules/jit_purity.py``). A body the port
captures (``ops/graphs.py``'s ``RoundGraph``: the sweep's resident round
and chunk, the buckets' programs) must make no host synchronization: the
capture records kernels without running them, so ``t.item()`` inside it
either raises (``cudaErrorStreamCaptureUnsupported``) or — on the CPU,
where the same body runs eagerly round after round — passes every test and
fails only on the card. Flagged inside a captured body:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and
  ``.synchronize()``, on any receiver, and ``torch.cuda.synchronize()``;
* ``float/int/bool/complex(t)`` and ``np.asarray/np.array(t)`` of a tensor;
* a Python ``if``/``while``/conditional expression/``assert``/``and``/
  ``or`` on a tensor (its ``__bool__`` copies it to the host);
* indexing by a 0-dim tensor made by a reduction (``x[torch.argmin(y)]``
  turns the index into a Python int through ``.item()``);
* data-dependent shapes, which the host must read back:
  ``torch.nonzero``/``argwhere``/``unique``/``unique_consecutive``/
  ``masked_select`` (and their methods) and boolean-mask indexing
  (``x[x > 0]``, ``x[mask] = v``).

What is captured is found per module: the first argument of
``RoundGraph(...)`` or ``torch.cuda.make_graphed_callables(...)``, the
``body`` of ``StaticProgram(...)`` (a name, or a tuple of names, resolved
to every function of that name in the module), and the body of
``with torch.cuda.graph(...)``. A body reached only through a stored
callable (``self._body()``) is judged where it is handed over, not
followed through the store. A tensor is a name
bound to a ``torch.*`` call, to a tensor method's result, to arithmetic,
a comparison or an index over a tensor, in the body or in an enclosing
function (the closure tensors a captured round carries). Metadata stays
quiet as in the reference: ``t.shape``, ``t.dtype``, ``t.device``,
``len(t)``, ``t is None``. Helpers the body calls are followed by
``capture-escape``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from hpbandster_tpu_torch.analysis.core import Finding, Rule, SourceModule, register
from hpbandster_tpu_torch.analysis.rules._util import ImportMap, import_map_for

#: calls that capture a callable argument: name -> (position, keyword).
#: The last dotted part is matched, so ``graphs.RoundGraph`` and an
#: aliased import both count. ``StaticProgram`` (``ops/buckets.py``)
#: captures its ``body`` on a card: the buckets', megabatch's and
#: continuous lanes' programs
_CAPTURE_CALLS = {
    "RoundGraph": (0, "body"),
    "make_graphed_callables": (0, "callables"),
    "StaticProgram": (3, "body"),
}
#: context managers whose body is captured
_CAPTURE_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}

_CASTS = {"float", "int", "bool", "complex"}
_NUMPY_SINKS = {"asarray", "array", "copy", "ascontiguousarray"}
#: methods that copy to the host (or wait for the device) on any receiver
_METHOD_SINKS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_RESOLVED_SINKS = {"torch.cuda.synchronize"}
#: ops whose output shape depends on the data: the host reads it back
_DATA_SHAPE_OPS = {"nonzero", "argwhere", "unique", "unique_consecutive", "masked_select"}
#: reductions that make a 0-dim tensor when given no dim
_SCALAR_REDUCTIONS = {
    "argmin", "argmax", "sum", "max", "min", "amax", "amin", "prod", "mean",
    "count_nonzero", "any", "all",
}
#: calls that make a boolean tensor elementwise
_BOOL_OPS = {
    "isnan", "isinf", "isfinite", "isposinf", "isneginf", "logical_and",
    "logical_or", "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt",
    "ge", "isin",
}
#: tensor attributes that are metadata, not device data
_STATIC_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "requires_grad", "layout",
    "is_leaf", "names",
}
#: tensor methods whose result is a Python value, not a tensor
_HOST_METHODS = {
    "dim", "size", "numel", "nelement", "element_size", "data_ptr", "stride",
    "storage_offset", "get_device", "is_contiguous", "is_floating_point",
    "is_complex", "untyped_storage", "item", "tolist", "numpy", "__len__",
    "register_hook", "backward", "record_stream",
}
#: ``torch.*`` names that do not make a tensor
_TORCH_NON_TENSOR_PREFIXES = (
    "torch.cuda.", "torch.distributed.", "torch.backends.", "torch.jit.",
    "torch.multiprocessing.", "torch.autograd.", "torch.profiler.",
    "torch.utils.", "torch.nn.Module", "torch.optim.",
)
_TORCH_NON_TENSOR = {
    "torch.device", "torch.Generator", "torch.Size", "torch.dtype",
    "torch.finfo", "torch.iinfo", "torch.is_tensor", "torch.numel",
    "torch.get_default_dtype", "torch.no_grad", "torch.inference_mode",
    "torch.enable_grad", "torch.manual_seed", "torch.compile",
    "torch.is_floating_point", "torch.is_grad_enabled", "torch.save",
    "torch.load", "torch.use_deterministic_algorithms", "torch.set_grad_enabled",
    "torch.get_rng_state", "torch.set_rng_state", "torch.initial_seed",
    "torch.seed",
}


def _last(name: Optional[str]) -> str:
    return (name or "").rsplit(".", 1)[-1]


def _is_capture_context(expr: ast.AST, imports: ImportMap) -> bool:
    return isinstance(expr, ast.Call) and imports.resolve(expr.func) in _CAPTURE_CONTEXTS


def _capture_call_target(node: ast.Call, imports: ImportMap) -> Optional[ast.AST]:
    """The captured callable's expression when ``node`` is a capture call."""
    where = _CAPTURE_CALLS.get(_last(imports.resolve(node.func)))
    if where is None:
        return None
    position, keyword = where
    if len(node.args) > position:
        return node.args[position]
    for kw in node.keywords:
        if kw.arg == keyword:
            return kw.value
    return None


def captured_regions(
    module: SourceModule, imports: ImportMap
) -> List[Tuple[Optional[ast.AST], ast.AST]]:
    """``(owner, region)`` for every captured body in ``module``: ``region``
    is a captured function (its own owner) or a ``with torch.cuda.graph``
    block (owned by the function around it, None at module level)."""
    nodes = module.walk()
    by_name: Dict[str, List[ast.AST]] = {}
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)
    regions: Dict[int, Tuple[Optional[ast.AST], ast.AST]] = {}
    for node in nodes:
        if isinstance(node, ast.Call):
            target = _capture_call_target(node, imports)
            if target is None:
                continue
            elts = target.elts if isinstance(target, (ast.Tuple, ast.List)) else [target]
            for el in elts:
                if isinstance(el, ast.Lambda):
                    regions[id(el)] = (None, el)
                    continue
                name = el.id if isinstance(el, ast.Name) else (
                    el.attr if isinstance(el, ast.Attribute) else None)
                for fn in by_name.get(name or "", ()):
                    regions[id(fn)] = (fn, fn)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(_is_capture_context(it.context_expr, imports) for it in node.items):
                regions[id(node)] = (_enclosing_function(module, node), node)
    return sorted(regions.values(), key=lambda pair: pair[1].lineno)


def captured_regions_for(module: SourceModule) -> List[Tuple[Optional[ast.AST], ast.AST]]:
    """Per-module :func:`captured_regions`, memoized on the SourceModule."""
    regions = module.cache.get("captured_regions")
    if regions is None:
        if not any(t in module.text for t in (
            "RoundGraph", "graphed_callables", "graph(", "StaticProgram(")):
            regions = []
        else:
            regions = captured_regions(module, import_map_for(module))
        module.cache["captured_regions"] = regions
    return regions  # type: ignore[return-value]


def _parents(module: SourceModule) -> Dict[int, ast.AST]:
    parents = module.cache.get("parents")
    if parents is None:
        parents = {}
        for node in module.walk():
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
        module.cache["parents"] = parents
    return parents  # type: ignore[return-value]


def _enclosing_function(module: SourceModule, node: ast.AST) -> Optional[ast.AST]:
    parents = _parents(module)
    cur = parents.get(id(node))
    while cur is not None and not isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
        cur = parents.get(id(cur))
    return cur


def region_nodes(module: SourceModule, region: ast.AST) -> Tuple[ast.AST, ...]:
    """The nodes a captured region runs: a function's body (not its
    decorators or defaults), a lambda's body, a ``with`` block's body."""
    if isinstance(region, (ast.With, ast.AsyncWith, ast.FunctionDef, ast.AsyncFunctionDef)):
        roots: Iterable[ast.AST] = region.body
    elif isinstance(region, ast.Lambda):
        roots = [region.body]
    else:
        roots = [region]
    out: List[ast.AST] = []
    for root in roots:
        out.extend(module.subtree(root))
    return tuple(out)


class TensorFacts:
    """Which names hold tensors in a body, and the expression tests the
    sinks are judged with."""

    def __init__(self, imports: ImportMap, tensors: Set[str]):
        self.imports = imports
        self.tensors = set(tensors)
        #: names bound to a boolean tensor, and to a 0-dim reduction
        self.masks: Set[str] = set()
        self.scalars: Set[str] = set()

    # ------------------------------------------------------------ values
    def torch_call(self, node: ast.Call) -> Optional[str]:
        resolved = self.imports.resolve(node.func) or ""
        return resolved if resolved.startswith("torch.") else None

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.Call):
            resolved = self.torch_call(node)
            if resolved is not None:
                return resolved not in _TORCH_NON_TENSOR and not resolved.startswith(
                    _TORCH_NON_TENSOR_PREFIXES)
            if isinstance(node.func, ast.Attribute):
                return node.func.attr not in _HOST_METHODS and self.is_tensor(node.func.value)
            return False
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return not isinstance(node.op, ast.Not) and self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            return any(self.is_tensor(x) for x in (node.left, *node.comparators))
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        return False

    def is_mask(self, node: ast.AST) -> bool:
        """A boolean tensor made elementwise: a comparison of a tensor,
        ``~`` of a mask, a logical/isnan-style op, or a name bound to one."""
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return self.is_tensor(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        if isinstance(node, ast.Call):
            resolved = self.torch_call(node)
            if resolved is not None:
                return _last(resolved) in _BOOL_OPS
            if isinstance(node.func, ast.Attribute):
                return node.func.attr in _BOOL_OPS and self.is_tensor(node.func.value)
        return False

    def is_scalar_reduction(self, node: ast.AST) -> bool:
        """A 0-dim tensor made by a reduction over a whole tensor."""
        if isinstance(node, ast.Name):
            return node.id in self.scalars
        if not isinstance(node, ast.Call):
            return False
        if any(kw.arg in ("dim", "axis") for kw in node.keywords):
            return False
        resolved = self.torch_call(node)
        if resolved is not None:
            return _last(resolved) in _SCALAR_REDUCTIONS and len(node.args) == 1
        return (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _SCALAR_REDUCTIONS
            and not node.args
            and self.is_tensor(node.func.value)
        )

    def host_value(self, node: ast.AST) -> bool:
        """Can a cast of this expression read a tensor's value? Metadata
        (``t.shape[0]``, ``len(t)``, ``t.numel()``) shields."""
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Attribute):
            return node.attr not in _STATIC_ATTRS and self.host_value(node.value)
        if isinstance(node, ast.Subscript):
            return self.host_value(node.value)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and node.func.id == "len":
                return False
            if isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_METHODS:
                return False
            return self.is_tensor(node)
        if isinstance(node, ast.BinOp):
            return self.host_value(node.left) or self.host_value(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.host_value(node.operand)
        return False

    # ------------------------------------------------------ propagation
    def bind(self, target: ast.AST, value: ast.AST) -> bool:
        """Record what ``target = value`` binds; True when a set grew."""
        grew = False
        if isinstance(target, ast.Name):
            for flag, names in ((self.is_tensor(value), self.tensors),
                                (self.is_mask(value), self.masks),
                                (self.is_scalar_reduction(value), self.scalars)):
                if flag and target.id not in names:
                    names.add(target.id)
                    grew = True
        elif isinstance(target, (ast.Tuple, ast.List)) and self.is_tensor(value):
            # `a, b = torch.split(...)` / `x.unbind()`: every element
            for el in target.elts:
                el = el.value if isinstance(el, ast.Starred) else el
                if isinstance(el, ast.Name) and el.id not in self.tensors:
                    self.tensors.add(el.id)
                    grew = True
        return grew

    def propagate(self, nodes: Iterable[ast.AST]) -> None:
        assigns = [n for n in nodes if isinstance(n, (ast.Assign, ast.AnnAssign, ast.NamedExpr))]
        for _ in range(3):
            grew = False
            for node in assigns:
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        grew |= self.bind(tgt, node.value)
                elif node.value is not None:
                    grew |= self.bind(node.target, node.value)
            if not grew:
                break


def frame_nodes(fn: ast.AST) -> List[ast.AST]:
    """``fn``'s own frame: its body without nested definitions."""
    out: List[ast.AST] = []
    stack = list(reversed(fn.body))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        out.append(node)
        stack.extend(reversed(list(ast.iter_child_nodes(node))))
    return out


def frame_names(fn: ast.AST) -> Set[str]:
    """Parameters and names stored in ``fn``'s own frame."""
    args = fn.args
    names = {a.arg for a in (*args.posonlyargs, *args.args, *args.kwonlyargs)}
    names |= {a.arg for a in (args.vararg, args.kwarg) if a is not None}
    if isinstance(fn, ast.Lambda):
        return names
    frame = frame_nodes(fn)
    names |= {n.id for n in frame if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
    # a nonlocal/global name is the enclosing scope's binding, not a local
    return names - {n for node in frame if isinstance(node, (ast.Nonlocal, ast.Global))
                    for n in node.names}


def closure_tensors(module: SourceModule, imports: ImportMap, region: ast.AST) -> Set[str]:
    """Tensor names bound in the frames of the functions enclosing
    ``region`` (a captured closure reads them at every replay), less the
    names the region binds itself."""
    memo: Dict[int, Set[str]] = module.cache.setdefault("frame_tensors", {})  # type: ignore[assignment]
    out: Set[str] = set()
    cur = _enclosing_function(module, region)
    while cur is not None:
        found = memo.get(id(cur))
        if found is None:
            facts = TensorFacts(imports, set())
            facts.propagate(frame_nodes(cur))
            found = memo[id(cur)] = facts.tensors
        out |= found
        cur = _enclosing_function(module, cur)
    if isinstance(region, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        out -= frame_names(region)
    return out


def analyze_body(
    module: SourceModule,
    imports: ImportMap,
    region: ast.AST,
    seed: Set[str],
) -> "Tuple[Set[str], List[Tuple[ast.AST, str]]]":
    """The sink engine behind capture-host-sync, shared with
    capture-escape: starting from ``seed`` tensor names (plus the tensors of
    the enclosing functions), propagate through assignments and return
    ``(tensor_names, sinks)``; each sink is ``(node, what)``."""
    nodes = region_nodes(module, region)
    facts = TensorFacts(imports, set(seed) | closure_tensors(module, imports, region))
    facts.propagate(nodes)
    sinks: List[Tuple[ast.AST, str]] = []

    judged_tests = set()
    for node in nodes:
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if isinstance(node.test, ast.BoolOp):
                judged_tests.add(id(node.test))

    def tensor_operands(test: ast.AST) -> bool:
        if isinstance(test, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
                return False
            return facts.is_tensor(test)
        if isinstance(test, ast.BoolOp):
            return any(tensor_operands(v) for v in test.values)
        if isinstance(test, ast.UnaryOp):
            return tensor_operands(test.operand)
        return facts.is_tensor(test)

    for node in nodes:
        if isinstance(node, ast.Call):
            callee = imports.resolve(node.func) or ""
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in _CASTS
                and node.args
                and facts.host_value(node.args[0])
            ):
                sinks.append((node, f"{node.func.id}()"))
            elif callee in _RESOLVED_SINKS:
                sinks.append((node, f"{callee}()"))
            elif (
                callee.startswith(("numpy.", "np."))
                and _last(callee) in _NUMPY_SINKS
                and node.args
                and facts.host_value(node.args[0])
            ):
                sinks.append((node, f"{callee}()"))
            elif callee.startswith("torch.") and _last(callee) in _DATA_SHAPE_OPS:
                sinks.append((node, f"{callee}() (a data-dependent shape)"))
            elif isinstance(node.func, ast.Attribute) and not callee.startswith("torch."):
                attr = node.func.attr
                if attr in _METHOD_SINKS:
                    sinks.append((node, f".{attr}()"))
                elif attr in _DATA_SHAPE_OPS and facts.is_tensor(node.func.value):
                    sinks.append((node, f".{attr}() (a data-dependent shape)"))
        elif isinstance(node, ast.Subscript):
            index = node.slice
            if facts.is_scalar_reduction(index):
                sinks.append((node, "indexing by a 0-dim tensor"))
            elif facts.is_mask(index):
                sinks.append((node, "boolean-mask indexing (a data-dependent shape)"))
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if tensor_operands(node.test):
                what = (
                    "Python branch" if isinstance(node, (ast.If, ast.While))
                    else "conditional expression" if isinstance(node, ast.IfExp)
                    else "assert"
                )
                sinks.append((node, f"{what} on a tensor"))
        elif (
            isinstance(node, ast.BoolOp)
            and id(node) not in judged_tests
            and any(facts.is_tensor(v) for v in node.values)
        ):
            sinks.append((node, "and/or on a tensor"))
    return facts.tensors, sinks


def region_name(region: ast.AST) -> str:
    if isinstance(region, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return region.name
    if isinstance(region, ast.Lambda):
        return "<lambda>"
    return "torch.cuda.graph block"


@register
class CaptureHostSyncRule(Rule):
    name = "capture-host-sync"
    description = (
        "host sync (.item/.tolist/.cpu/.numpy/synchronize, float/int/bool of a "
        "tensor, a branch on a tensor, a 0-dim or boolean-mask index, "
        "nonzero/unique/masked_select) inside a body captured as a CUDA graph"
    )

    def check(self, module: SourceModule) -> List[Finding]:
        regions = captured_regions_for(module)
        if not regions:
            return []
        imports = import_map_for(module)
        findings: List[Finding] = []
        seen: Set[int] = set()
        for _owner, region in regions:
            _, sinks = analyze_body(module, imports, region, set())
            for node, what in sinks:
                if id(node) in seen:
                    continue
                seen.add(id(node))
                findings.append(self.finding(
                    module, node,
                    f"{what} inside captured body {region_name(region)!r} syncs "
                    "the host with the card: the capture raises on a card "
                    "(and passes on the CPU, where the body runs eagerly)",
                ))
        return findings
