"""Admission control + weighted deficit-fair scheduling across tenants.

Ported from ``hpbandster_tpu/serve/scheduler.py`` unchanged in its
semantics: the port keeps its own copy of this host code.

The serving tier's ordering problem: N tenants feed bracket waves into
one accelerator pool, and a whale tenant flooding the queue must not
starve the minnows. The classic answer is deficit round robin (Shreedhar
& Varghese, SIGCOMM 1995) generalized with weights: every scheduling
round credits each backlogged tenant ``quantum * weight`` units of
*deficit*, and a tenant may dispatch work while its accumulated deficit
covers the work's cost. Cost here is the natural accelerator currency —
``sum(num_configs[s] * budgets[s])`` over a bracket's stages, i.e.
configs x budget device time — so one 729-budget whale bracket weighs
exactly as much as 729 minnow singles.

Long-run guarantee (the property ``tests/test_serve.py`` pins): under
saturation every backlogged tenant's served cost share converges to
``weight_i / sum(weights)`` — no tenant below 80% of its deficit-fair
share is the acceptance bar. Short-run: work is indivisible (a bracket
dispatches whole), so a round may overshoot by at most one item per
tenant; the deficit carries the overshoot forward, which is what makes
the long-run share exact.

:class:`AdmissionController` is the other gate: per-tenant caps on
concurrent sweeps and in-flight cost, enforced BEFORE work enters the
queue, with machine-readable reject reasons (the frontend returns them
verbatim — a rejected tenant must know why).

Pure host logic, stdlib-only, deliberately lock-free: callers
(``serve/pool.py``) already serialize rounds under the pool condition.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "work_cost",
    "TenantQuota",
    "AdmissionDecision",
    "AdmissionController",
    "DeficitFairScheduler",
]


def work_cost(num_configs: Sequence[int], budgets: Sequence[float]) -> float:
    """The scheduler's currency: configs x budget summed over stages."""
    return float(sum(int(n) * float(b) for n, b in zip(num_configs, budgets)))


class TenantQuota:
    """Per-tenant admission limits + fair-share weight.

    ``max_active_sweeps`` caps concurrently RUNNING sweeps (a submit past
    it is rejected, not queued — the tenant can retry);
    ``max_inflight_cost`` caps the total cost of this tenant's queued +
    dispatched-but-undelivered work items; ``weight`` scales the tenant's
    deficit quantum (2.0 = twice the fair share of a weight-1.0 tenant).
    """

    def __init__(
        self,
        max_active_sweeps: int = 4,
        max_inflight_cost: float = 100_000.0,
        weight: float = 1.0,
    ):
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        self.max_active_sweeps = int(max_active_sweeps)
        self.max_inflight_cost = float(max_inflight_cost)
        self.weight = float(weight)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "max_active_sweeps": self.max_active_sweeps,
            "max_inflight_cost": self.max_inflight_cost,
            "weight": self.weight,
        }


class AdmissionDecision:
    """admit() verdict: truthy when admitted, else carries the reason."""

    __slots__ = ("admitted", "reason")

    def __init__(self, admitted: bool, reason: Optional[str] = None):
        self.admitted = bool(admitted)
        self.reason = reason

    def __bool__(self) -> bool:
        return self.admitted

    def __repr__(self) -> str:  # pragma: no cover
        return f"AdmissionDecision({self.admitted}, {self.reason!r})"


class AdmissionController:
    """Reject-with-reason gatekeeper in front of the tenant queues."""

    def __init__(
        self,
        default_quota: Optional[TenantQuota] = None,
        max_total_sweeps: int = 64,
    ):
        self.default_quota = default_quota or TenantQuota()
        #: pool-wide ceiling on concurrently running sweeps (all tenants)
        self.max_total_sweeps = int(max_total_sweeps)
        self._quotas: Dict[str, TenantQuota] = {}

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        self._quotas[str(tenant)] = quota

    def quota(self, tenant: str) -> TenantQuota:
        return self._quotas.get(str(tenant), self.default_quota)

    def admit_sweep(
        self,
        tenant: str,
        active_sweeps: int,
        total_active_sweeps: int,
    ) -> AdmissionDecision:
        """May this tenant start one more sweep right now?"""
        q = self.quota(tenant)
        if active_sweeps >= q.max_active_sweeps:
            return AdmissionDecision(False, (
                f"tenant {tenant!r} at max_active_sweeps="
                f"{q.max_active_sweeps} (running {active_sweeps})"
            ))
        if total_active_sweeps >= self.max_total_sweeps:
            return AdmissionDecision(False, (
                f"pool at max_total_sweeps={self.max_total_sweeps}"
            ))
        return AdmissionDecision(True)

    def admit_work(
        self, tenant: str, inflight_cost: float, item_cost: float
    ) -> AdmissionDecision:
        """May this tenant enqueue ``item_cost`` more work right now?"""
        q = self.quota(tenant)
        if inflight_cost + item_cost > q.max_inflight_cost:
            return AdmissionDecision(False, (
                f"tenant {tenant!r} over max_inflight_cost="
                f"{q.max_inflight_cost:g} (in flight {inflight_cost:g}, "
                f"submitting {item_cost:g})"
            ))
        return AdmissionDecision(True)


class DeficitFairScheduler:
    """Weighted deficit round robin over per-tenant work queues.

    ``select(queues, capacity)`` is one scheduling round: it credits every
    backlogged tenant's deficit counter and returns the work items to
    dispatch now (deterministic — same queues, same deficits, same
    selection). Items must expose a ``cost`` attribute (or ``cost`` key).
    The round:

    * credits each backlogged tenant ``capacity * weight / sum(weights)``
      when a capacity is given (the round's cost budget splits by weight
      — the form of weighted DRR that stays weight-proportional UNDER the
      cap; an absolute per-tenant quantum would let the cap equalize
      everyone), else the absolute ``quantum * weight``;
    * visits tenants in arrival order and serves each tenant's queue
      head-first WHILE its deficit covers the cost and round capacity
      remains (the deficit is debited — indivisible-work overshoot
      carries forward exactly like DRR's byte counter);
    * always selects at least one item when any queue is non-empty
      (liveness: the max-deficit head item is force-served — its tenant
      just goes deeper into debt);
    * resets an idle tenant's deficit to zero (classic DRR: no banking
      credit while you have nothing to send).
    """

    def __init__(self, quantum: float = 64.0):
        if quantum <= 0:
            raise ValueError("quantum must be positive")
        self.quantum = float(quantum)
        self._deficit: Dict[str, float] = {}
        #: fixed round-robin order: tenants in first-seen order
        self._order: Dict[str, int] = {}
        self._arrivals = itertools.count()
        #: served cost per tenant since construction (fairness gauges)
        self.served_cost: Dict[str, float] = {}

    def weight_of(self, tenant: str, weights: Mapping[str, float]) -> float:
        w = weights.get(tenant, 1.0)
        return float(w) if w and w > 0 else 1.0

    def _note_tenant(self, tenant: str) -> None:
        if tenant not in self._order:
            self._order[tenant] = next(self._arrivals)
            self._deficit.setdefault(tenant, 0.0)

    @staticmethod
    def _cost_of(item: Any) -> float:
        cost = getattr(item, "cost", None)
        if cost is None and isinstance(item, Mapping):
            cost = item.get("cost")
        return float(cost if cost is not None else 1.0)

    def select(
        self,
        queues: Mapping[str, Sequence[Any]],
        capacity: Optional[float] = None,
        weights: Optional[Mapping[str, float]] = None,
    ) -> List[Tuple[str, Any]]:
        """One round; returns ``[(tenant, item), ...]`` to dispatch now."""
        weights = weights or {}
        backlogged = [t for t, q in queues.items() if q]
        # idle tenants bank nothing (DRR): deficit resets so a tenant
        # cannot hoard credit across an idle hour and then burst past
        # everyone — fairness is over *backlogged* intervals
        for t in list(self._deficit):
            if t not in backlogged or not queues.get(t):
                self._deficit[t] = 0.0
        if not backlogged:
            return []
        total_weight = sum(self.weight_of(t, weights) for t in backlogged)
        for t in backlogged:
            self._note_tenant(t)
            w = self.weight_of(t, weights)
            credit = (
                capacity * w / total_weight
                if capacity is not None else self.quantum * w
            )
            self._deficit[t] += credit

        order = sorted(backlogged, key=lambda t: self._order[t])

        # oversized liveness: a head item costlier than the WHOLE round
        # can never pass room(), and the empty-round force-serve below
        # never fires while other tenants have serviceable work — so the
        # item would starve forever behind a stream of small items. Once
        # its tenant's deficit has banked the full cost (credits accrue
        # every backlogged round), spend one round on it exclusively —
        # the DRR overshoot, paid for in accumulated credit.
        if capacity is not None:
            oversized = [
                t for t in order
                if self._cost_of(queues[t][0]) > capacity
                and self._deficit[t] >= self._cost_of(queues[t][0])
            ]
            if oversized:
                t = max(oversized, key=lambda t: self._deficit[t])
                item = queues[t][0]
                cost = self._cost_of(item)
                self._deficit[t] -= cost
                self.served_cost[t] = self.served_cost.get(t, 0.0) + cost
                return [(t, item)]

        heads = {t: 0 for t in order}
        selected: List[Tuple[str, Any]] = []
        spent = 0.0

        def room(cost: float) -> bool:
            return capacity is None or spent + cost <= capacity

        # drain-style service (classic DRR): each tenant's turn empties
        # its deficit before the next tenant's — one-item-per-pass
        # interleaving would let a capacity cap silently equalize
        # weighted shares. A second sweep picks up capacity another
        # tenant's indivisible head item could not use.
        progressed = True
        while progressed:
            progressed = False
            for t in order:
                q = queues[t]
                while heads[t] < len(q):
                    item = q[heads[t]]
                    cost = self._cost_of(item)
                    if self._deficit[t] < cost or not room(cost):
                        break
                    heads[t] += 1
                    self._deficit[t] -= cost
                    spent += cost
                    selected.append((t, item))
                    self.served_cost[t] = (
                        self.served_cost.get(t, 0.0) + cost
                    )
                    progressed = True

        if not selected:
            # liveness: indivisible work larger than one quantum must
            # still flow — force-serve the deepest-deficit head item and
            # let its tenant carry the debt (the DRR overshoot rule)
            t = max(order, key=lambda t: self._deficit[t])
            item = queues[t][0]
            cost = self._cost_of(item)
            self._deficit[t] -= cost
            self.served_cost[t] = self.served_cost.get(t, 0.0) + cost
            selected.append((t, item))
        return selected

    def deficit_order(self, tenants: Sequence[str]) -> Dict[str, int]:
        """Rank ``tenants`` most-owed first — the per-round LANE
        allocation order of the continuous-batching tier
        (``serve/continuous.py``): when one chunk cannot board every
        selected item, the deepest-deficit tenants' items take lanes
        first and the rest ride the next chunk. Ties break by arrival
        order then name (deterministic, like ``select``). Returns
        ``{tenant: rank}`` with rank 0 the most owed."""
        uniq = sorted(
            set(tenants),
            key=lambda t: (
                -self._deficit.get(t, 0.0),
                self._order.get(t, float("inf")),
                t,
            ),
        )
        return {t: i for i, t in enumerate(uniq)}

    def forget(self, tenant: str) -> None:
        """Drop a departed tenant's round state (deficit + arrival slot)
        so a long-lived serving process does not grow scheduling entries
        for every tenant ever seen; a returning tenant is re-noted at the
        back of the arrival order with a zero deficit. ``served_cost`` is
        deliberately retained — like the per-tenant metrics counters it
        is the cumulative fairness census, still readable after the
        tenant's sweeps finish."""
        self._deficit.pop(tenant, None)
        self._order.pop(tenant, None)

    def fair_share(
        self, tenants: Sequence[str], weights: Optional[Mapping[str, float]] = None
    ) -> Dict[str, float]:
        """Each tenant's ideal cost fraction (the test's yardstick)."""
        weights = weights or {}
        total = sum(self.weight_of(t, weights) for t in tenants)
        return {
            t: self.weight_of(t, weights) / total for t in tenants
        } if total else {}
