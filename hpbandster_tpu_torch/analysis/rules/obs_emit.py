"""obs-emit-in-capture — event emission inside a body captured as a CUDA
graph.

The torch counterpart of the reference's ``obs-emit-in-jit``
(``hpbandster_tpu/analysis/rules/obs_emit.py``). ``hpbandster_tpu_torch.obs``
emission (``emit``/``span``/``get_bus().emit``, the timeline's
``phase_span``/``mark``) is host work: it reads host clocks, takes host
locks and may write files. A capture runs the body's Python once; every
replay runs only the recorded kernels. An event emitted inside a captured
body therefore fires once, at capture, and never at replay — telemetry
that lies. The supported pattern is emitting AROUND the replay, as
``ops/graphs.py``'s ``RoundGraph.replay`` counts launches and
``FusedBOHB`` opens its phase spans around the sweep call.

Captured bodies are found as ``capture-host-sync`` finds them. Inside one
it flags:

* calls resolving through the import map into ``hpbandster_tpu_torch.obs``
  (``emit(...)``, ``span(...)``, ``obs.emit(...)``, ``phase_span(...)``,
  ``mark(...)``, aliased imports);
* ``.emit(...)``, ``.phase_span(...)`` and ``.mark(...)`` method calls —
  including on the result of ``get_bus()`` — but only in modules that
  import ``hpbandster_tpu_torch.obs`` at all, so unrelated APIs elsewhere
  stay unflagged.
"""

from __future__ import annotations

import ast
from typing import List

from hpbandster_tpu_torch.analysis.core import Finding, Rule, SourceModule, register
from hpbandster_tpu_torch.analysis.rules._util import ImportMap, import_map_for
from hpbandster_tpu_torch.analysis.rules.capture_purity import (
    captured_regions_for,
    region_name,
    region_nodes,
)

_OBS_PREFIX = "hpbandster_tpu_torch.obs"

#: emission-shaped attribute calls flagged in obs-importing modules
_EMIT_ATTRS = frozenset({"emit", "phase_span", "mark"})


def _module_imports_obs(imports: ImportMap) -> bool:
    return any(v.startswith(_OBS_PREFIX) or v == "hpbandster_tpu_torch"
               for v in imports.aliases.values())


def _resolves_to_obs(node: ast.expr, imports: ImportMap) -> bool:
    resolved = imports.resolve(node) or ""
    return resolved.startswith(_OBS_PREFIX)


@register
class ObsEmitInCaptureRule(Rule):
    name = "obs-emit-in-capture"
    description = (
        "obs event emission (emit/span/bus.emit or the timeline span API "
        "phase_span/mark) inside a body captured as a CUDA graph — fires "
        "once at capture, never at replay; emit around the replay instead"
    )

    def check(self, module: SourceModule) -> List[Finding]:
        if "obs" not in module.text:
            return []
        regions = captured_regions_for(module)
        if not regions:
            return []
        imports = import_map_for(module)
        imports_obs = _module_imports_obs(imports)
        findings: List[Finding] = []
        for _owner, region in regions:
            for node in region_nodes(module, region):
                if not isinstance(node, ast.Call):
                    continue
                if _resolves_to_obs(node.func, imports):
                    findings.append(self._flag(module, node, region, ast.unparse(node.func)))
                elif (
                    imports_obs
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _EMIT_ATTRS
                ):
                    findings.append(self._flag(module, node, region, f".{node.func.attr}()"))
        return findings

    def _flag(self, module: SourceModule, node: ast.Call, region: ast.AST, what: str) -> Finding:
        return self.finding(
            module, node,
            f"{what} inside captured body {region_name(region)!r} runs once at "
            "capture, never at replay — move the emission around the replay",
        )
