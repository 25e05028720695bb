"""Tenant sessions: sweep specs, warm models, per-sweep drivers.

Ported from ``hpbandster_tpu/serve/session.py``: the optimizers are the
port's, built on the ``ServePool``'s device.

The tenant-facing vocabulary of the serving tier:

* :class:`SweepSpec` — one sweep submission, JSON-shaped (it crosses the
  RPC boundary verbatim): optimizer family + HyperBand knobs + bracket
  count. The pool's search space and objective are SERVER-side (a pool
  hosts one ``(space, objective)`` pair — the shape-compatibility rule
  megabatching needs, docs/serving.md); tenants parameterize the sweep,
  not the space.
* :class:`TenantSession` — one tenant's durable server-side state:
  quota, running sweeps, and the WARM MODEL — the previous sweep's
  :class:`~hpbandster_tpu_torch.core.result.Result`, replayed into the next
  sweep's config generator through the existing
  ``core/warmstart.py`` path (``previous_result=``), so a returning
  tenant's KDE resumes from everything it already paid to learn.
* :class:`TenantStore` — the session registry (thread-safe; the frontend
  and tests share it).
* :class:`TenantMaster` — drives ONE sweep: builds the optimizer with
  the tenant's identity stamp (``tenant_id=`` on ``Master``), the
  pool's executor facade, and the session's warm result; records the
  finished Result back into the session.

Everything here is host-side bookkeeping: no device work of its own.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from hpbandster_tpu_torch.serve.scheduler import TenantQuota

__all__ = ["SweepSpec", "TenantSession", "TenantStore", "TenantMaster"]

#: optimizer families a spec may name (server-side construction — the
#: tenant never ships code)
OPTIMIZERS = ("bohb", "random")


class SweepSpec:
    """One sweep submission; validates eagerly so rejects carry reasons."""

    def __init__(
        self,
        optimizer: str = "bohb",
        n_iterations: int = 1,
        eta: float = 3.0,
        min_budget: float = 1.0,
        max_budget: float = 9.0,
        num_samples: int = 32,
        random_fraction: float = 1 / 3,
        seed: Optional[int] = None,
        warm_start: bool = True,
        promotion_rule: Optional[str] = None,
    ):
        if optimizer not in OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {optimizer!r} (supported: {OPTIMIZERS})"
            )
        if int(n_iterations) < 1:
            raise ValueError("n_iterations must be >= 1")
        if not (0 < float(min_budget) <= float(max_budget)):
            raise ValueError("need 0 < min_budget <= max_budget")
        if float(eta) <= 1:
            raise ValueError("eta must be > 1")
        if promotion_rule is not None:
            # promote/__init__ is import-light by contract (no torch /
            # numpy), so eager name validation stays cheap and rejects
            # carry the full vocabulary as their reason
            from hpbandster_tpu_torch.promote import RULE_NAMES

            if promotion_rule not in RULE_NAMES:
                raise ValueError(
                    f"unknown promotion rule {promotion_rule!r} "
                    f"(supported: {RULE_NAMES})"
                )
            if optimizer != "bohb":
                raise ValueError(
                    "promotion_rule applies to the 'bohb' optimizer "
                    "(random search runs single-stage brackets: there "
                    "is nothing to promote)"
                )
        self.promotion_rule = promotion_rule
        self.optimizer = optimizer
        self.n_iterations = int(n_iterations)
        self.eta = float(eta)
        self.min_budget = float(min_budget)
        self.max_budget = float(max_budget)
        self.num_samples = int(num_samples)
        self.random_fraction = float(random_fraction)
        self.seed = seed if seed is None else int(seed)
        #: opt out of the session's warm model (a fresh-eyes sweep)
        self.warm_start = bool(warm_start)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SweepSpec":
        if not isinstance(d, dict):
            raise ValueError("sweep spec must be a JSON object")
        known = {
            "optimizer", "n_iterations", "eta", "min_budget", "max_budget",
            "num_samples", "random_fraction", "seed", "warm_start",
            "promotion_rule",
        }
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown sweep spec field(s): {sorted(unknown)}")
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "optimizer": self.optimizer,
            "n_iterations": self.n_iterations,
            "eta": self.eta,
            "min_budget": self.min_budget,
            "max_budget": self.max_budget,
            "num_samples": self.num_samples,
            "random_fraction": self.random_fraction,
            "seed": self.seed,
            "warm_start": self.warm_start,
            "promotion_rule": self.promotion_rule,
        }

    def estimated_cost(self) -> float:
        """Upper-bound configs x budget cost of one sweep under this spec
        (the admission controller's in-flight currency)."""
        from hpbandster_tpu_torch.ops.bracket import hyperband_bracket
        from hpbandster_tpu_torch.serve.scheduler import work_cost

        total = 0.0
        for i in range(self.n_iterations):
            plan = hyperband_bracket(
                i, self.min_budget, self.max_budget, self.eta
            )
            total += work_cost(plan.num_configs, plan.budgets)
        return total


class TenantSession:
    """One tenant's durable server-side state (store-owned, store-locked)."""

    def __init__(self, tenant_id: str, quota: Optional[TenantQuota] = None):
        self.tenant_id = str(tenant_id)
        self.quota = quota or TenantQuota()
        self.created_wall = time.time()
        #: sweep_id -> status dict (the frontend's sweep_status payload)
        self.sweeps: Dict[str, Dict[str, Any]] = {}
        #: the newest finished sweep's Result — the warm model the next
        #: submission resumes from (core/warmstart.py replay)
        self.warm_result: Any = None
        self.sweeps_completed = 0

    def active_sweeps(self) -> int:
        return sum(
            1 for s in self.sweeps.values()
            if s.get("state") in ("queued", "running")
        )


#: tenant-state persistence format (``TenantStore(persist_dir=)``)
_PERSIST_VERSION = 1
_persist_log = logging.getLogger("hpbandster_tpu_torch.serve")


def _tenant_filename(tenant_id: str) -> str:
    """Collision-safe on-disk name for a SELF-REPORTED tenant id: a
    sanitized readable prefix plus a hash tail (two ids that sanitize
    identically — ``a/b`` vs ``a_b`` — must not share a file)."""
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", tenant_id)[:48] or "tenant"
    digest = hashlib.sha256(tenant_id.encode("utf-8")).hexdigest()[:12]
    return f"{safe}-{digest}.pkl"


class TenantStore:
    """Thread-safe tenant registry; sessions are created on first touch.

    With ``persist_dir`` the store survives frontend restarts: each
    tenant's warm :class:`~hpbandster_tpu_torch.core.result.Result` (and its
    completed-sweep count) is written to its own file after every
    finished sweep, and a returning tenant's first touch after a restart
    reloads it — the KDE warm start the tenant paid for does not die
    with the process (docs/fault_tolerance.md "Serving tier"). A
    corrupt or unreadable file degrades to a cold start with a warning,
    never an error: persistence is a recovery aid, not a gate.
    """

    def __init__(
        self,
        default_quota: Optional[TenantQuota] = None,
        persist_dir: Optional[str] = None,
    ):
        self._lock = threading.Lock()
        self._sessions: Dict[str, TenantSession] = {}
        self.default_quota = default_quota
        self.persist_dir = persist_dir
        # disk writes serialize on their own lock (never the session
        # lock), and each tenant's last-written sweep count guards
        # against two concurrent finishes landing out of order — the
        # NEWER snapshot must win the file, whatever the thread
        # interleaving
        self._persist_lock = threading.Lock()
        self._persisted_version: Dict[str, int] = {}
        if persist_dir is not None:
            os.makedirs(persist_dir, exist_ok=True)

    def session(self, tenant_id: str) -> TenantSession:
        with self._lock:
            s = self._sessions.get(str(tenant_id))
            if s is None:
                quota = (
                    TenantQuota(**self.default_quota.to_dict())
                    if self.default_quota is not None else None
                )
                s = TenantSession(tenant_id, quota=quota)
                self._load_persisted(s)
                self._sessions[str(tenant_id)] = s
            return s

    # ---------------------------------------------------------- persistence
    def _tenant_path(self, tenant_id: str) -> Optional[str]:
        if self.persist_dir is None:
            return None
        return os.path.join(self.persist_dir, _tenant_filename(tenant_id))

    def _load_persisted(self, session: TenantSession) -> None:
        """First-touch rehydration (caller holds the store lock — read
        I/O under it is deliberate: it happens ONCE per tenant lifetime,
        and a session must never become visible half-rehydrated)."""
        path = self._tenant_path(session.tenant_id)
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path, "rb") as fh:
                state = pickle.load(fh)
            if state.get("format_version") != _PERSIST_VERSION:
                raise ValueError(
                    f"unsupported tenant-state version "
                    f"{state.get('format_version')}"
                )
            session.warm_result = state.get("warm_result")
            session.sweeps_completed = int(state.get("sweeps_completed", 0))
        except Exception as e:
            # cold start beats a bricked tenant: admission and sweeps work
            # without the warm model, so log and move on
            _persist_log.warning(
                "could not load persisted state for tenant %r from %s "
                "(%r); starting cold", session.tenant_id, path, e,
            )
            return
        from hpbandster_tpu_torch import obs

        obs.get_metrics().counter("serve.tenant_state_loads").inc()
        _persist_log.info(
            "tenant %r warm state reloaded (%d completed sweep(s))",
            session.tenant_id, session.sweeps_completed,
        )

    def _snapshot_state(self, session: TenantSession) -> Dict[str, Any]:
        """Cheap state capture (caller holds the store lock); the
        pickling and disk write happen OUTSIDE it (`_write_state`) — one
        tenant's slow disk must not stall every other tenant's
        session/admission/warm call."""
        return {
            "format_version": _PERSIST_VERSION,
            "tenant_id": session.tenant_id,
            "warm_result": session.warm_result,
            "sweeps_completed": session.sweeps_completed,
            "saved_wall": time.time(),
        }

    def _write_state(self, tenant_id: str, state: Dict[str, Any]) -> None:
        """Persist a snapshot (no store lock held). Atomic tmp+rename: a
        crash mid-write leaves the previous state, never a torn file.
        Stale snapshots are skipped: when two sweeps for one tenant
        finish concurrently, the write racing in LAST must not regress
        the file to the earlier state."""
        path = self._tenant_path(tenant_id)
        if path is None:
            return
        # the version check and the write share the persist lock: a
        # skipped-as-stale verdict is only safe if no newer write can be
        # overtaken after it — serializing writes here costs nothing the
        # session lock's callers can feel
        with self._persist_lock:
            version = int(state.get("sweeps_completed", 0))
            if version <= self._persisted_version.get(tenant_id, -1):
                return
            try:
                tmp = f"{path}.tmp"
                with open(tmp, "wb") as fh:
                    pickle.dump(state, fh)
                os.replace(tmp, path)
            except Exception as e:
                # an unwritable disk must not fail the sweep that just
                # finished — the result is still served from memory
                _persist_log.warning(
                    "could not persist tenant %r state to %s (%r)",
                    tenant_id, path, e,
                )
                return
            self._persisted_version[tenant_id] = version
        from hpbandster_tpu_torch import obs

        obs.get_metrics().counter("serve.tenant_state_saves").inc()

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._sessions)

    def register_sweep(
        self, tenant_id: str, sweep_id: str, run: Dict[str, Any]
    ) -> None:
        """Record a sweep under the store lock — census readers iterate
        ``session.sweeps`` under it, so unlocked inserts could blow up a
        concurrent iteration."""
        s = self.session(tenant_id)
        with self._lock:
            s.sweeps[sweep_id] = run

    def unregister_sweep(self, tenant_id: str, sweep_id: str) -> None:
        """Drop a reservation whose sweep never came to life (construction
        failed after admission) — the quota slot returns to the tenant."""
        with self._lock:
            s = self._sessions.get(str(tenant_id))
            if s is not None:
                s.sweeps.pop(sweep_id, None)

    def active_sweeps(self, tenant_id: str) -> int:
        with self._lock:
            s = self._sessions.get(str(tenant_id))
            return s.active_sweeps() if s is not None else 0

    def total_active_sweeps(self) -> int:
        with self._lock:
            return sum(
                s.active_sweeps() for s in self._sessions.values()
            )

    def remember_result(self, tenant_id: str, result: Any) -> None:
        """Keep ``result`` as the tenant's warm model for its next sweep
        (written through to ``persist_dir`` when the store persists)."""
        s = self.session(tenant_id)
        with self._lock:
            s.warm_result = result
            s.sweeps_completed += 1
            state = (
                self._snapshot_state(s)
                if self.persist_dir is not None else None
            )
        if state is not None:
            self._write_state(s.tenant_id, state)

    def warm(self, tenant_id: str) -> Any:
        with self._lock:
            s = self._sessions.get(str(tenant_id))
            if s is not None:
                return s.warm_result
        # persisting store: first touch after a restart rehydrates the
        # session before the read — but ONLY for tenants that actually
        # left state behind. Tenant ids are self-reported: a read probe
        # of an unknown id must not mint (and permanently register) a
        # phantom session.
        path = self._tenant_path(tenant_id)
        if path is None or not os.path.exists(path):
            return None
        s = self.session(tenant_id)
        with self._lock:
            return s.warm_result


class TenantMaster:
    """Drive ONE tenant sweep against the shared pool.

    The ``Master`` variant the serving tier needed: per-tenant iteration
    state and model, but the executor is a pool facade the tenant does
    not own — ``shutdown`` releases the facade and leaves the pool (and
    its backend, bucket programs, and other tenants) running.
    """

    def __init__(
        self,
        pool,
        tenant_id: str,
        spec: SweepSpec,
        store: Optional[TenantStore] = None,
        run_id: Optional[str] = None,
        sweep_id: Optional[str] = None,
    ):
        self.pool = pool
        self.tenant_id = str(tenant_id)
        self.spec = spec
        self.store = store
        self.sweep_id = (
            str(sweep_id) if sweep_id
            else f"{self.tenant_id}-{uuid.uuid4().hex[:8]}"
        )
        self.run_id = run_id or f"serve-{self.sweep_id}"
        previous = (
            store.warm(tenant_id)
            if (store is not None and spec.warm_start) else None
        )
        executor = pool.executor_for(tenant_id)
        common = dict(
            configspace=pool.configspace,
            executor=executor,
            run_id=self.run_id,
            tenant_id=self.tenant_id,
            eta=spec.eta,
            min_budget=spec.min_budget,
            max_budget=spec.max_budget,
            seed=spec.seed,
        )
        try:
            if spec.optimizer == "bohb":
                from hpbandster_tpu_torch.optimizers.bohb import BOHB

                # the model scores on the pool's device
                self.optimizer = BOHB(
                    num_samples=spec.num_samples,
                    random_fraction=spec.random_fraction,
                    previous_result=previous,
                    promotion_rule=spec.promotion_rule,
                    device=pool.device,
                    **common,
                )
            else:
                from hpbandster_tpu_torch.optimizers.randomsearch import RandomSearch

                self.optimizer = RandomSearch(**common)
        except Exception:
            # the facade was already minted: release it, or the pool's
            # tenant census/weights keep a phantom entry forever
            executor.shutdown()
            raise
        self.result: Any = None

    def run(self):
        """Run the sweep to completion; returns (and remembers) the
        Result. The warm model is updated even on a later submission's
        behalf — what the tenant paid to learn, the tenant keeps."""
        try:
            self.result = self.optimizer.run(
                n_iterations=self.spec.n_iterations
            )
        finally:
            self.optimizer.shutdown()
        if self.store is not None:
            self.store.remember_result(self.tenant_id, self.result)
        return self.result

    def progress(self) -> Dict[str, Any]:
        """Live sweep progress (the frontend's status poll body)."""
        executor = self.optimizer.executor
        return {
            "configs_done": getattr(executor, "total_evaluated", 0),
            "iterations": len(self.optimizer.iterations),
            "active_iterations": len(self.optimizer.active_iterations()),
        }
