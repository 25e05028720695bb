"""obs-reserved-fields — journal schema keys passed as ad-hoc emit kwargs.

Ported from ``hpbandster_tpu/analysis/rules/obs_reserved.py``, unchanged but for
the imports and the obs package it resolves.

The journal record schema reserves ``event``/``t_wall``/``t_mono`` (the
serializer's own columns) plus the substrate-stamped ``trace_id`` (trace
context, ``obs/trace.py``), ``tenant_id`` (tenant context, the serving
tier's identity stamp) and ``host``/``pid`` (identity static fields,
``JsonlJournal(static_fields=...)``). A call site that passes one of
these to ``emit(...)``/``span(...)`` either collides with the stamp or —
worse — fabricates it: a hand-written ``trace_id`` breaks the cross-host
join, a hand-written ``tenant_id`` mis-attributes another tenant's work,
a hand-written ``host`` lies about where the record came from.

The supported patterns are: enter a trace (``use_trace``) / a tenant
(``use_tenant``) and let ``make_event`` stamp ``trace_id``/``tenant_id``;
configure identity once (``obs.configure(identity=...)`` /
``process_identity()``) and let the journal stamp ``host``/``pid``.

A second reserved tier guards the promotion-audit vocabulary
(``obs/audit.py`` ``AUDIT_RULE_FIELDS``): ``rule``, ``rung``,
``pareto_rank`` and ``straggler_observed`` are stamped by the dedicated
audit emitters (``emit_bracket_promotion`` / ``emit_promotion_decision``)
— an ad-hoc ``emit(...)`` inventing them would collide with the
replay/regret join (a fabricated ``rule`` mis-attributes a decision to a
promotion rule that never ran). Unlike the substrate fields, these are
legal INSIDE ``hpbandster_tpu_torch/obs`` itself (the anomaly detector's
``alert`` events carry their own ``rule`` field by design), so the check
exempts the obs tree by path.

Detection mirrors ``obs-emit-in-capture``'s resolution: calls resolving
through the import map into ``hpbandster_tpu_torch.obs`` (``emit``, ``span``,
``make_event``, aliased imports), plus ``.emit(...)``/``.span(...)``
method calls in modules that import ``hpbandster_tpu_torch.obs`` at all —
flagged only when a reserved name appears among the keywords. The audit
tier only fires on the GENERIC emitters: the dedicated audit emitters
are the sanctioned channel for exactly these fields.
"""

from __future__ import annotations

import ast
from typing import List

from hpbandster_tpu_torch.analysis.core import Finding, Rule, SourceModule, register
from hpbandster_tpu_torch.analysis.rules._util import import_map_for
from hpbandster_tpu_torch.analysis.rules.obs_emit import (
    _OBS_PREFIX,
    _module_imports_obs,
    _resolves_to_obs,
)

#: journal-record keys only the substrate may write
RESERVED_FIELDS = frozenset(
    {"event", "t_wall", "t_mono", "host", "pid", "trace_id", "tenant_id"}
)

#: promotion-audit keys only the dedicated audit emitters may write
#: (mirrors obs.audit.AUDIT_RULE_FIELDS — kept literal here so the
#: analysis pass stays stdlib-only and import-free)
AUDIT_FIELDS = frozenset(
    {"rule", "rung", "pareto_rank", "straggler_observed"}
)

_EMITTING_ATTRS = ("emit", "span")

#: the generic emission entry points; the audit tier fires only on
#: these (obs.emit_promotion_decision(rule=...) is the sanctioned call)
_GENERIC_EMITTERS = frozenset({
    f"{_OBS_PREFIX}.emit",
    f"{_OBS_PREFIX}.span",
    f"{_OBS_PREFIX}.make_event",
    f"{_OBS_PREFIX}.events.emit",
    f"{_OBS_PREFIX}.events.span",
    f"{_OBS_PREFIX}.events.make_event",
})


def _in_obs_tree(module: SourceModule) -> bool:
    path = module.path.replace("\\", "/")
    return "hpbandster_tpu_torch/obs/" in path


@register
class ObsReservedFieldsRule(Rule):
    name = "obs-reserved-fields"
    description = (
        "reserved journal field (event/t_wall/t_mono/host/pid/trace_id/"
        "tenant_id) passed as an ad-hoc emit/span kwarg — these are "
        "stamped by the substrate (serializer, trace/tenant context, "
        "identity static fields); a call-site copy collides or lies"
    )

    def check(self, module: SourceModule) -> List[Finding]:
        # sound prefilter: an obs mention is required for any flaggable call
        if "obs" not in module.text:
            return []
        imports = import_map_for(module)
        imports_obs = _module_imports_obs(imports)
        in_obs = _in_obs_tree(module)
        findings: List[Finding] = []
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            bad = sorted(
                kw.arg for kw in node.keywords
                if kw.arg is not None and kw.arg in RESERVED_FIELDS
            )
            bad_audit = sorted(
                kw.arg for kw in node.keywords
                if kw.arg is not None and kw.arg in AUDIT_FIELDS
            )
            if not bad and not bad_audit:
                continue
            resolved = imports.resolve(node.func) or ""
            # generic = emit/span/make_event (module-level or aliased),
            # or a bus-object .emit/.span in an obs-importing module;
            # dedicated audit emitters (emit_promotion_decision, ...)
            # never match — their attribute name is not an emitting attr
            is_generic = resolved in _GENERIC_EMITTERS or (
                imports_obs
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _EMITTING_ATTRS
            )
            # substrate tier: ANY call resolving into obs (dedicated
            # emitters included — none takes a substrate field), plus
            # the generic bus-object calls is_generic already covers
            if bad and (_resolves_to_obs(node.func, imports) or is_generic):
                what = ast.unparse(node.func)
                findings.append(self.finding(
                    module, node,
                    f"{what}(...) passes reserved field(s) "
                    f"{', '.join(repr(b) for b in bad)} — stamped by the "
                    "substrate (use_trace / configure(identity=...)), never "
                    "by the call site",
                ))
            # audit tier: generic emit/span only, outside the obs tree
            # (obs' own alert/audit emitters legitimately own these)
            elif bad_audit and not in_obs and is_generic:
                what = ast.unparse(node.func)
                findings.append(self.finding(
                    module, node,
                    f"{what}(...) passes promotion-audit field(s) "
                    f"{', '.join(repr(b) for b in bad_audit)} — written "
                    "only by the dedicated audit emitters "
                    "(obs.emit_bracket_promotion / "
                    "obs.emit_promotion_decision); an ad-hoc copy "
                    "corrupts the replay/regret join",
                ))
        return findings
