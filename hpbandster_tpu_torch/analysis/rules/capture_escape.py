"""capture-escape — host syncs and obs emits reached *through* helper calls
from bodies captured as CUDA graphs.

The torch counterpart of the reference's ``trace-escape``
(``hpbandster_tpu/analysis/rules/trace_escape.py``). ``capture-host-sync``
and ``obs-emit-in-capture`` stop at the function boundary: a captured
round that calls ``run_bracket(...)`` looks clean even when a helper three
frames down calls ``.item()``. This rule walks the whole-program call
graph (``analysis/graph.py``) from every captured body and runs the same
sink engine (``capture_purity.analyze_body``) inside each callee:

* a callee's tensors are its own (names bound to ``torch.*`` calls and
  their results) plus the parameters that receive a tensor at the call
  site (positional and keyword arguments mapped onto parameter names,
  bound calls skipping the self slot);
* unlike the reference's taint-gated walk, every resolved edge is
  followed: ``.item()`` or ``torch.cuda.synchronize()`` below a capture
  syncs whatever its arguments were;
* a callee is analyzed once per distinct tensor-parameter set (the
  per-function summary cache);
* chains are followed to ``_MAX_DEPTH`` call hops below the captured body;
* callees that are themselves captured bodies are skipped — they are
  audited as their own root.

Findings are two-location: the **primary** location is the call site in
the captured body — where the capture boundary is breached and where the
fix goes — and the **related** location is the sink. Suppressions at
either location mute the finding. The obs leg needs no tensors: an event
emitted anywhere beneath a captured body fires once at capture.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from hpbandster_tpu_torch.analysis.core import Finding, ProjectRule, register
from hpbandster_tpu_torch.analysis.graph import CallSite, FunctionInfo, Project
from hpbandster_tpu_torch.analysis.rules._util import import_map_for
from hpbandster_tpu_torch.analysis.rules.capture_purity import (
    analyze_body,
    region_name,
    region_nodes,
)
from hpbandster_tpu_torch.analysis.rules.obs_emit import _OBS_PREFIX

#: call-graph hops followed below a captured body (root body = hop 0)
_MAX_DEPTH = 4


@dataclasses.dataclass(frozen=True)
class _Sink:
    """A witnessed escape inside some callee: ``what`` at ``path:line``,
    reached through ``hops`` call edges from the captured body."""

    what: str
    path: str
    line: int
    hops: int


class _EscapeIndex:
    """Per-project summary caches shared across roots and both legs."""

    def __init__(self, project: Project):
        self.project = project
        self.sync_memo: Dict[Tuple[str, FrozenSet[str]], Optional[_Sink]] = {}
        self.emit_memo: Dict[str, Optional[_Sink]] = {}
        self.captured_qnames: Set[str] = {
            info.qname for info, region in project.captured_roots() if region is info.node
        }

    def _follow(self, site: CallSite) -> bool:
        return not site.via_partial and site.callee.qname not in self.captured_qnames

    # ------------------------------------------------------------ host sync
    def sync_sink(
        self, info: FunctionInfo, tensors: FrozenSet[str], depth: int
    ) -> Optional[_Sink]:
        key = (info.qname, tensors)
        if key in self.sync_memo:
            return self.sync_memo[key]
        self.sync_memo[key] = None  # cycle guard: in-progress reads as clean
        sink = self._sync_sink_uncached(info, tensors, depth)
        self.sync_memo[key] = sink
        return sink

    def _sync_sink_uncached(
        self, info: FunctionInfo, tensors: FrozenSet[str], depth: int
    ) -> Optional[_Sink]:
        module = info.module
        names, sinks = analyze_body(module, import_map_for(module), info.node, set(tensors))
        if sinks:
            node, what = sinks[0]
            return _Sink(what, module.path, node.lineno, 1)
        if depth >= _MAX_DEPTH:
            return None
        for site in self.project.callees(info.qname):
            if not self._follow(site):
                continue
            found = self.sync_sink(
                site.callee, frozenset(_tensor_params(site, names)), depth + 1)
            if found is not None:
                return dataclasses.replace(found, hops=found.hops + 1)
        return None

    # ------------------------------------------------------------- obs emit
    def emit_sink(self, info: FunctionInfo, depth: int) -> Optional[_Sink]:
        if info.qname in self.emit_memo:
            return self.emit_memo[info.qname]
        self.emit_memo[info.qname] = None
        sink = self._emit_sink_uncached(info, depth)
        self.emit_memo[info.qname] = sink
        return sink

    def _emit_sink_uncached(self, info: FunctionInfo, depth: int) -> Optional[_Sink]:
        module = info.module
        imports = import_map_for(module)
        for node in self.project.fn_calls.get(info.qname, ()):
            resolved = imports.resolve(node.func) or ""
            if resolved.startswith(_OBS_PREFIX):
                return _Sink(ast.unparse(node.func) + "()", module.path, node.lineno, 1)
        if depth >= _MAX_DEPTH:
            return None
        for site in self.project.callees(info.qname):
            if not self._follow(site):
                continue
            callee = site.callee
            if callee.qname.startswith(_OBS_PREFIX + "."):
                return _Sink(
                    f"{callee.qname.rsplit('.', 1)[-1]}()", module.path, site.line, 1)
            found = self.emit_sink(callee, depth + 1)
            if found is not None:
                return dataclasses.replace(found, hops=found.hops + 1)
        return None


def _escape_index(project: Project) -> _EscapeIndex:
    index = project.cache.get("capture_escape")
    if index is None:
        index = _EscapeIndex(project)
        project.cache["capture_escape"] = index
    return index


def _tensor_params(site: CallSite, tensors: Set[str]) -> Set[str]:
    """Callee parameter names that receive a tensor at ``site``."""

    def is_tensor(expr: ast.AST) -> bool:
        return any(isinstance(n, ast.Name) and n.id in tensors for n in ast.walk(expr))

    callee = site.callee
    params = callee.positional_params(site.bound)
    out: Set[str] = set()
    for idx, arg in enumerate(site.node.args):
        if isinstance(arg, ast.Starred):
            if is_tensor(arg.value) and callee.has_vararg:
                out.update(params[idx:])
            continue
        if not is_tensor(arg):
            continue
        if idx < len(params):
            out.add(params[idx])
        elif callee.has_vararg:
            out.update(params[idx:])
    for kw in site.node.keywords:
        if not is_tensor(kw.value):
            continue
        if kw.arg is None:
            out.update(params)
            out.update(callee.kwonly)
        elif kw.arg in params or kw.arg in callee.kwonly or callee.has_kwarg:
            out.add(kw.arg)
    return out


@register
class CaptureEscapeRule(ProjectRule):
    name = "capture-escape"
    description = (
        "host sync or obs emission reached through helper calls (1-4 hops) "
        "from a body captured as a CUDA graph — invisible to the "
        "intraprocedural rules"
    )

    def check_project(self, project: Project) -> List[Finding]:
        index = _escape_index(project)
        findings: List[Finding] = []
        seen: Set[Tuple[str, int, str]] = set()

        for info, region in project.captured_roots():
            module = info.module
            names, _root_sinks = analyze_body(
                module, import_map_for(module), region, set()
            )  # the body's own sinks belong to capture-host-sync
            inside = {id(n) for n in region_nodes(module, region)}
            label = region_name(region)
            for site in project.callees(info.qname):
                if id(site.node) not in inside or not index._follow(site):
                    continue
                callee = site.callee
                sink = index.sync_sink(callee, frozenset(_tensor_params(site, names)), 1)
                if sink is not None and (module.path, site.line, "sync") not in seen:
                    seen.add((module.path, site.line, "sync"))
                    findings.append(Finding(
                        rule=self.name, path=module.path, line=site.line,
                        message=(
                            f"call into {callee.name!r} from captured body {label!r}: "
                            f"{sink.what} {sink.hops} call(s) down syncs the host "
                            "with the card inside the capture — hoist the host "
                            "work out of the captured body"
                        ),
                        related_path=sink.path, related_line=sink.line,
                        related_note=f"{sink.what} happens here",
                    ))
                emit = (
                    _Sink(f"{callee.name}()", module.path, site.line, 1)
                    if callee.qname.startswith(_OBS_PREFIX + ".")
                    else index.emit_sink(callee, 1)
                )
                if emit is not None and (module.path, site.line, "emit") not in seen:
                    seen.add((module.path, site.line, "emit"))
                    findings.append(Finding(
                        rule=self.name, path=module.path, line=site.line,
                        message=(
                            f"call into {callee.name!r} from captured body {label!r} "
                            f"reaches obs emission ({emit.what}) — fires once at "
                            "capture, never at replay; emit around the replay"
                        ),
                        related_path=emit.path, related_line=emit.line,
                        related_note=f"{emit.what} happens here",
                    ))
        return findings
