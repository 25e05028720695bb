"""capture-rebind — carried state rebound to a new tensor inside a captured
body, or a graph input bound with ``=`` before a replay.

Takes the place of the reference's ``jit-donation``
(``hpbandster_tpu/analysis/rules/donation.py``). Donation has no torch
counterpart: a CUDA graph reads and writes its buffers in place, at the
addresses the capture saw. The stance donation demanded (decide, at the
program boundary, what is updated in place) becomes the port's rule for
everything a replay carries (``ops/graphs.py``): what the body reads from
one replay to the next must be updated in place (``copy_``, ``add_``,
``index_copy_``, ``out=``). Rebinding it to a new tensor makes the
capture's first run look right, and every replay read the old address:

* inside a captured body, a name declared ``nonlocal``/``global``, an
  attribute (``self.buf``, ``state.x``) or a closure container's item
  (``bufs[k]``) that the body also READS, bound to a new tensor
  (``state = state + x``, ``self.buf = torch.where(c, self.buf, x)``).
  Inside a ``with torch.cuda.graph(...)`` block, a local of the function
  around it bound before the block counts too. A binding the body never
  reads is the static-output idiom (``holder["out"] = f(x)``, read after
  the replay) and stays quiet;
* in a function that replays a graph (``.replay()``), an attribute or a
  closure container's item bound to a new tensor before the replay
  (``inp[b] = torch.as_tensor(v)`` instead of ``inp[b].copy_(...)``):
  the graph still reads the buffer it captured.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from hpbandster_tpu_torch.analysis.core import Finding, Rule, SourceModule, register
from hpbandster_tpu_torch.analysis.rules._util import dotted_name, import_map_for
from hpbandster_tpu_torch.analysis.rules.capture_purity import (
    TensorFacts,
    frame_names,
    frame_nodes,
    captured_regions_for,
    closure_tensors,
    region_name,
    region_nodes,
)


def _target_key(tgt: ast.AST) -> Optional[str]:
    """``self.buf`` / ``bufs[...]`` -> a key comparable with reads of the
    same storage; a bare name -> the name."""
    if isinstance(tgt, ast.Subscript):
        base = dotted_name(tgt.value)
        return f"{base}[]" if base is not None else None
    return dotted_name(tgt)


def _reads(nodes) -> Set[str]:
    out: Set[str] = set()
    for node in nodes:
        if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(node.ctx, ast.Load):
            name = dotted_name(node)
            if name is not None:
                out.add(name)
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
            key = _target_key(node)
            if key is not None:
                out.add(key)
    return out


def _assignments(nodes):
    for node in nodes:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                yield node, tgt, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            yield node, node.target, node.value


@register
class CaptureRebindRule(Rule):
    name = "capture-rebind"
    description = (
        "state a captured body carries (nonlocal, self./closure attribute or "
        "item it also reads) rebound to a new tensor instead of updated in "
        "place, or a graph input bound with = before a replay instead of copy_"
    )

    def check(self, module: SourceModule) -> List[Finding]:
        findings: List[Finding] = []
        if captured_regions_for(module):
            for _owner, region in captured_regions_for(module):
                findings.extend(self._check_region(module, _owner, region))
        if ".replay(" in module.text:
            for node in module.walk():
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    findings.extend(self._check_replayer(module, node))
        return findings

    def _facts(self, module: SourceModule, region: ast.AST, nodes) -> TensorFacts:
        imports = import_map_for(module)
        facts = TensorFacts(imports, closure_tensors(module, imports, region))
        facts.propagate(nodes)
        return facts

    def _check_region(self, module: SourceModule, owner, region) -> List[Finding]:
        nodes = region_nodes(module, region)
        facts = self._facts(module, region, nodes)
        reads = _reads(nodes)
        if isinstance(region, (ast.FunctionDef, ast.AsyncFunctionDef)):
            frame = frame_names(region) - {"self", "cls"}
            carried_names = {
                n for node in nodes if isinstance(node, (ast.Nonlocal, ast.Global))
                for n in node.names
            }
        elif isinstance(region, (ast.With, ast.AsyncWith)) and owner is not None:
            frame = set()
            carried_names = {
                n.id for n in module.subtree(owner)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)
                and n.lineno < region.lineno
            }
        else:
            return []
        findings: List[Finding] = []
        for stmt, tgt, value in _assignments(nodes):
            if not facts.is_tensor(value):
                continue
            key = _target_key(tgt)
            if key is None:
                continue
            if isinstance(tgt, ast.Name):
                carried = key in carried_names
            else:
                # an attribute or item of an object the body did not make
                carried = key.split(".")[0].split("[")[0] not in frame
            if not carried or key not in reads:
                continue
            findings.append(self.finding(
                module, stmt,
                f"{key.replace('[]', '[...]')} is carried by captured body "
                f"{region_name(region)!r} and rebound to a new tensor: every "
                "replay reads the buffer the capture saw — update it in place "
                "(copy_, add_, index_copy_, out=)",
            ))
        return findings

    def _check_replayer(self, module: SourceModule, fn: ast.AST) -> List[Finding]:
        body = frame_nodes(fn)
        replays = [
            n.lineno for n in body
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "replay"
        ]
        if not replays:
            return []
        first = min(replays)
        frame = frame_names(fn) - {"self", "cls"}
        facts = self._facts(module, fn, body)
        findings: List[Finding] = []
        for stmt, tgt, value in _assignments(body):
            if stmt.lineno >= first or isinstance(tgt, ast.Name):
                continue
            key = _target_key(tgt)
            if key is None or key.split(".")[0].split("[")[0] in frame:
                continue
            if not facts.is_tensor(value):
                continue
            findings.append(self.finding(
                module, stmt,
                f"{key.replace('[]', '[...]')} is bound with = before the replay "
                f"in {fn.name!r}: the graph reads the buffer it captured — "
                "write the input into it with copy_",
            ))
        return findings
