"""lock-order / lock-blocking — interprocedural lock-discipline analysis.

Ported from ``hpbandster_tpu/analysis/rules/lockorder.py``. The blocking
sinks are the card's: a device synchronization (``torch.cuda.synchronize``,
``Event``/``Stream`` ``.synchronize()``, ``torch.cuda.empty_cache``, whose
``cudaFree`` waits for the device), a copy to the host (``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``), a blocking ``torch.distributed``
collective or ``barrier`` and a work handle's ``.wait()``. The reference's
``jax.device_get`` and ``block_until_ready`` have no place here.

The serve/dispatcher tier is a lattice of small locks (``master``,
``dispatcher``, ``serve/pool``, ``serve/frontend``, ``obs/collector``),
and its two recurring review-round bug classes are invisible to any
single-module pass:

* **ordering cycles** — thread 1 takes A then B, thread 2 takes B then A,
  where the two acquisitions live in different methods (or different
  files) connected only by a call chain. The deadlock fires under load,
  never in a unit test.
* **blocking under a lock** — an RPC, ``join()``, ``sleep``, socket op or
  device sync reached while a lock is held, usually through a
  helper the lock-holding function calls. Every waiter on that lock now
  queues behind a network timeout.

Both rules run on the whole-program call graph (``analysis/graph.py``):

1. per function, a held-set visitor records every lock acquisition
   (``with self._lock:`` on a known ``threading`` attribute, module-level
   locks included), every resolved call site, and every direct blocking
   operation, each with the ordered set of locks held at that point;
2. bounded fixpoint summaries propagate "may acquire" / "may block" facts
   over call edges (``_SUMMARY_ROUNDS`` rounds ≈ call-chain hops — the
   bounded-depth contract, see docs/static_analysis.md);
3. ``lock-order`` reports acquisition-order cycles (one finding per
   cycle, witnesses for both directions) and re-acquisition of a
   non-reentrant lock (self-deadlock) — directly or through a call chain;
   ``lock-blocking`` reports blocking operations reached while holding
   any lock, as two-location findings (call site + sink).

Sanctioned idioms stay quiet: ``cond.wait()`` while holding exactly that
condition (the wait *releases* it), re-acquiring an ``RLock``/default
``Condition``, ``str.join``/``os.path.join`` under a lock, and the
snapshot-then-call pattern (copy state under the lock, operate outside).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from hpbandster_tpu_torch.analysis.core import Finding, ProjectRule, register
from hpbandster_tpu_torch.analysis.graph import (
    CallSite,
    FunctionInfo,
    Project,
    _dotted,
    _resolve_alias,
)

#: fixpoint rounds == how many call-graph hops lock/blocking facts travel
_SUMMARY_ROUNDS = 6
#: cap per-function blocking-sink summaries (first witnesses win)
_MAX_SINKS = 8

#: torch.distributed calls that block until every rank has joined (unless
#: issued with ``async_op=True``: then the handle's ``.wait()`` blocks)
_COLLECTIVES = (
    "barrier", "monitored_barrier", "all_reduce", "all_gather",
    "all_gather_into_tensor", "all_gather_object", "all_to_all",
    "all_to_all_single", "broadcast", "broadcast_object_list", "gather",
    "gather_object", "reduce", "reduce_scatter", "reduce_scatter_tensor",
    "scatter", "scatter_object_list", "send", "recv",
)

#: module functions that block outright (canonical dotted names)
_BLOCKING_RESOLVED = {
    # the host waits for every queued kernel on the card
    "torch.cuda.synchronize": "torch.cuda.synchronize()",
    # cudaFree of the cached blocks waits for the device too
    "torch.cuda.empty_cache": "torch.cuda.empty_cache()",
    **{f"torch.distributed.{c}": f"torch.distributed.{c}()" for c in _COLLECTIVES},
    "time.sleep": "time.sleep()",
    "socket.create_connection": "socket.create_connection()",
    "select.select": "select.select()",
    "subprocess.run": "subprocess.run()",
    "subprocess.call": "subprocess.call()",
    "subprocess.check_call": "subprocess.check_call()",
    "subprocess.check_output": "subprocess.check_output()",
}

#: method names that block regardless of receiver type: a tensor's copy
#: to the host waits for the kernels that write it, ``.synchronize()`` on
#: a CUDA event or stream waits for the device
_BLOCKING_METHODS = {
    "item",
    "tolist",
    "cpu",
    "numpy",
    "synchronize",
    "recv",
    "recvfrom",
    "accept",
    "sendall",
    "communicate",
}

#: join() receivers that are string/path joins, never thread joins
_PATH_JOINS = ("os.path.join", "posixpath.join", "ntpath.join")


@dataclasses.dataclass(frozen=True)
class _BlockSink:
    """One blocking operation: ``label`` at ``path:line``; ``wait_lock``
    is set for ``.wait()`` calls whose receiver is a known lock (the
    condition-variable exemption needs it)."""

    label: str
    path: str
    line: int
    wait_lock: Optional[str] = None


@dataclasses.dataclass
class _FnFacts:
    """Per-function lock facts from one held-set traversal."""

    info: FunctionInfo
    #: lock_id -> first direct acquisition site (path, line)
    acquires: Dict[str, Tuple[str, int]] = dataclasses.field(default_factory=dict)
    #: direct ordering edges: (held, acquired, line, held_line)
    edges: List[Tuple[str, str, int, int]] = dataclasses.field(default_factory=list)
    #: direct re-acquisition of a held non-reentrant lock: (lock, line, held_line)
    reacquired: List[Tuple[str, int, int]] = dataclasses.field(default_factory=list)
    #: direct blocking ops with the held stack at that point
    blocks: List[Tuple[_BlockSink, Tuple[Tuple[str, int], ...]]] = dataclasses.field(
        default_factory=list
    )
    #: resolved call sites with the held stack at that point
    calls: List[Tuple[CallSite, Tuple[Tuple[str, int], ...]]] = dataclasses.field(
        default_factory=list
    )


class _LockIndex:
    """Project-wide lock facts + bounded-depth summaries, built once per
    Project and shared by both rules via ``project.cache``."""

    def __init__(self, project: Project):
        self.project = project
        self.facts: Dict[str, _FnFacts] = {}
        for qname, info in project.functions.items():
            self.facts[qname] = _collect_facts(project, info)
        #: qname -> lock_id -> (sink_path, sink_line) — may-acquire closure
        self.acq: Dict[str, Dict[str, Tuple[str, int]]] = {
            q: dict(f.acquires) for q, f in self.facts.items()
        }
        #: qname -> blocking sinks reachable from the function's body
        self.blk: Dict[str, List[_BlockSink]] = {
            q: [s for s, _ in f.blocks] for q, f in self.facts.items()
        }
        for _ in range(_SUMMARY_ROUNDS):
            changed = False
            for qname, facts in self.facts.items():
                acq = self.acq[qname]
                blk = self.blk[qname]
                for site, _held in facts.calls:
                    callee = site.callee.qname
                    for lock, where in self.acq.get(callee, {}).items():
                        if lock not in acq:
                            acq[lock] = where
                            changed = True
                    if len(blk) < _MAX_SINKS:
                        have = set(blk)
                        for sink in self.blk.get(callee, ()):
                            if sink not in have and len(blk) < _MAX_SINKS:
                                blk.append(sink)
                                have.add(sink)
                                changed = True
            if not changed:
                break


def _lock_index(project: Project) -> _LockIndex:
    index = project.cache.get("lockorder")
    if index is None:
        index = _LockIndex(project)
        project.cache["lockorder"] = index
    return index


def _collect_facts(project: Project, info: FunctionInfo) -> _FnFacts:
    facts = _FnFacts(info=info)
    module = info.module
    aliases = project.alias_tables.get(module.path, {})

    def lock_of(expr: ast.AST) -> Optional[str]:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id in ("self", "cls")
            and info.cls_qname is not None
        ):
            return project.lock_for_attr(info.cls_qname, expr.attr)
        name = _dotted(expr)
        if name is None:
            return None
        resolved = _resolve_alias(aliases, name)
        if resolved in project.locks:
            return resolved
        local = f"{info.module_name}.{name}"
        if local in project.locks:
            return local
        return None

    # fast path for the overwhelmingly common lock-free function: no With
    # anywhere in the body means no acquisitions, no ordering edges, and
    # an always-empty held stack — the call/sink facts the summaries need
    # fall out of the flat per-function call list pass 1 recorded instead
    # of the held-tracking recursion
    if info.qname not in project.fn_has_with:
        for node in project.fn_calls.get(info.qname, ()):
            site = project.site_by_node.get(id(node))
            if site is not None:
                facts.calls.append((site, ()))
            else:
                sink = _blocking_sink(node, aliases, lock_of)
                if sink is not None:
                    facts.blocks.append(
                        (
                            _BlockSink(sink[0], module.path, node.lineno, sink[1]),
                            (),
                        )
                    )
        return facts

    def visit(node: ast.AST, held: Tuple[Tuple[str, int], ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # separate frame: locks held here are not held there
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                visit(item.context_expr, inner)
                lid = lock_of(item.context_expr)
                if lid is None:
                    continue
                held_ids = {h for h, _ in inner}
                if lid in held_ids and not project.locks[lid].reentrant:
                    outer_line = next(ln for h, ln in inner if h == lid)
                    facts.reacquired.append((lid, node.lineno, outer_line))
                facts.acquires.setdefault(lid, (module.path, node.lineno))
                for h, h_line in inner:
                    if h != lid:
                        facts.edges.append((h, lid, node.lineno, h_line))
                inner = inner + ((lid, node.lineno),)
            for stmt in node.body:
                visit(stmt, inner)
            return
        if isinstance(node, ast.Call):
            site = project.site_by_node.get(id(node))
            if site is not None:
                facts.calls.append((site, held))
            else:
                sink = _blocking_sink(node, aliases, lock_of)
                if sink is not None:
                    facts.blocks.append(
                        (
                            _BlockSink(sink[0], module.path, node.lineno, sink[1]),
                            held,
                        )
                    )
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for child in ast.iter_child_nodes(info.node):
        visit(child, ())
    return facts


def _blocking_sink(
    node: ast.Call, aliases: Dict[str, str], lock_of
) -> Optional[Tuple[str, Optional[str]]]:
    """``(label, wait_lock)`` when ``node`` is a direct blocking call."""
    name = _dotted(node.func)
    resolved = _resolve_alias(aliases, name) if name else None
    if resolved in _BLOCKING_RESOLVED:
        if resolved.startswith("torch.distributed.") and any(
            kw.arg == "async_op"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is True
            for kw in node.keywords
        ):
            return None  # the handle's .wait() is the blocking call
        return _BLOCKING_RESOLVED[resolved], None
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    if attr in _BLOCKING_METHODS:
        return f".{attr}()", None
    if attr in ("wait", "wait_for"):
        # Condition/Event/Popen wait; the receiver lock (when known) feeds
        # the held-exactly-that-condition exemption at the report site
        return f".{attr}()", lock_of(node.func.value)
    if attr == "join":
        # thread/queue join, not str/path join: a string-literal receiver,
        # an os.path-resolved callee, or the one-iterable-argument string
        # idiom (`sep.join(parts)`) are all rope, not threads
        if isinstance(node.func.value, ast.Constant):
            return None
        if resolved is not None and resolved.endswith(_PATH_JOINS):
            return None
        if any(kw.arg == "timeout" for kw in node.keywords):
            return ".join()", None
        if len(node.args) == 1 and not (
            isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, (int, float))
        ):
            return None
        if len(node.args) > 1:
            return None
        return ".join()", None
    return None


def _held_ids(held: Sequence[Tuple[str, int]]) -> Set[str]:
    return {h for h, _ in held}


def _short(lock_id: str) -> str:
    """Human name for a lock id: Class.attr or module.NAME (last 2 parts)."""
    return ".".join(lock_id.rsplit(".", 2)[-2:])


def _wait_exempt(sink: _BlockSink, held: Sequence[Tuple[str, int]]) -> bool:
    """``cond.wait()`` while holding exactly that condition releases it —
    the canonical idiom, not a blocking bug. Holding anything *else*
    alongside still blocks those waiters."""
    if sink.wait_lock is None:
        return False
    ids = _held_ids(held)
    return sink.wait_lock in ids and len(ids) == 1


@register
class LockOrderRule(ProjectRule):
    name = "lock-order"
    description = (
        "lock acquisition-order cycle, or re-acquisition of a non-reentrant "
        "lock, across the whole-program call graph"
    )

    def check_project(self, project: Project) -> List[Finding]:
        index = _lock_index(project)
        findings: List[Finding] = []
        #: (frm, to) -> witness (path, line, sink_path, sink_line)
        edges: Dict[Tuple[str, str], Tuple[str, int, str, int]] = {}

        for qname, facts in sorted(index.facts.items()):
            path = facts.info.module.path
            for lock, line, held_line in facts.reacquired:
                findings.append(
                    Finding(
                        rule=self.name,
                        path=path,
                        line=line,
                        message=(
                            f"non-reentrant lock {_short(lock)} re-acquired while "
                            f"already held (taken at line {held_line}) — guaranteed "
                            "self-deadlock"
                        ),
                    )
                )
            for frm, to, line, _h in facts.edges:
                edges.setdefault((frm, to), (path, line, path, line))
            for site, held in facts.calls:
                if not held:
                    continue
                ids = _held_ids(held)
                callee_acq = index.acq.get(site.callee.qname, {})
                for lock, (sink_path, sink_line) in sorted(callee_acq.items()):
                    if lock in ids:
                        if not project.locks[lock].reentrant and not site.via_partial:
                            findings.append(
                                Finding(
                                    rule=self.name,
                                    path=path,
                                    line=site.line,
                                    message=(
                                        f"call into {site.callee.qname.rsplit('.', 2)[-1]!r} "
                                        f"re-acquires non-reentrant lock {_short(lock)} "
                                        "already held here — self-deadlock through the "
                                        "call chain"
                                    ),
                                    related_path=sink_path,
                                    related_line=sink_line,
                                    related_note=f"{_short(lock)} acquired again here",
                                )
                            )
                        continue
                    for h in sorted(ids):
                        edges.setdefault((h, lock), (path, site.line, sink_path, sink_line))

        # acquisition-order cycles: a pair of locks taken in both orders
        # anywhere in the program is one finding with both witnesses
        reported: Set[Tuple[str, str]] = set()
        for (a, b), (path, line, _sp, _sl) in sorted(edges.items()):
            if (b, a) not in edges or (b, a) in reported:
                continue
            reported.add((a, b))
            r_path, r_line, _, _ = edges[(b, a)]
            findings.append(
                Finding(
                    rule=self.name,
                    path=path,
                    line=line,
                    message=(
                        f"lock-order cycle: {_short(a)} -> {_short(b)} here, but "
                        f"{_short(b)} -> {_short(a)} elsewhere — two threads taking "
                        "these in opposite orders deadlock"
                    ),
                    related_path=r_path,
                    related_line=r_line,
                    related_note=f"opposite order {_short(b)} -> {_short(a)}",
                )
            )
        return findings


@register
class LockBlockingRule(ProjectRule):
    name = "lock-blocking"
    description = (
        "blocking operation (RPC/socket/sleep/join/wait, a device sync or "
        "copy to the host, a blocking collective) reached while holding a "
        "lock, directly or through the call graph"
    )

    def check_project(self, project: Project) -> List[Finding]:
        index = _lock_index(project)
        findings: List[Finding] = []
        seen: Set[Tuple[str, int, str]] = set()

        for qname, facts in sorted(index.facts.items()):
            path = facts.info.module.path
            for sink, held in facts.blocks:
                if not held or _wait_exempt(sink, held):
                    continue
                locks = "/".join(sorted(_short(h) for h in _held_ids(held)))
                key = (path, sink.line, sink.label)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(
                    Finding(
                        rule=self.name,
                        path=path,
                        line=sink.line,
                        message=(
                            f"{sink.label} while holding {locks} — every waiter "
                            "on the lock queues behind this; move it outside "
                            "the locked region (snapshot-then-call)"
                        ),
                    )
                )
            for site, held in facts.calls:
                if not held:
                    continue
                for sink in index.blk.get(site.callee.qname, ()):
                    if _wait_exempt(sink, held):
                        continue
                    if sink.wait_lock is not None and sink.wait_lock in _held_ids(held):
                        # waiting on a lock we hold releases it; other held
                        # locks were filtered by _wait_exempt above
                        if len(_held_ids(held)) == 1:
                            continue
                    locks = "/".join(sorted(_short(h) for h in _held_ids(held)))
                    key = (path, site.line, sink.label)
                    if key in seen:
                        continue
                    seen.add(key)
                    findings.append(
                        Finding(
                            rule=self.name,
                            path=path,
                            line=site.line,
                            message=(
                                f"call into {site.callee.qname.rsplit('.', 2)[-1]!r} "
                                f"reaches {sink.label} while holding {locks} — "
                                "blocking I/O under a lock stalls every waiter; "
                                "move the call outside the locked region"
                            ),
                            related_path=sink.path,
                            related_line=sink.line,
                            related_note=f"{sink.label} happens here",
                        )
                    )
                    break  # one representative sink per call site
        return findings
