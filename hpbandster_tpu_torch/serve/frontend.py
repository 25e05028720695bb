"""ServeFrontend — the tenant-facing RPC surface of the serving tier.

Ported from ``hpbandster_tpu/serve/frontend.py``, a copy over the port's
session layer and pool.

Reuses the repo's stdlib JSON-over-TCP transport (``parallel/rpc.py``):
one :class:`~hpbandster_tpu_torch.parallel.rpc.RPCServer` exposing

* ``submit_sweep(tenant, spec)`` — admission-checked sweep submission.
  Accepted: ``{"accepted": true, "sweep_id": ...}`` and a daemon thread
  drives a :class:`~hpbandster_tpu_torch.serve.session.TenantMaster` against
  the shared pool. Rejected: ``{"accepted": false, "reason": ...}`` —
  reject-with-reason is part of the API, not an RPC error (transport
  errors stay reserved for transport problems).
* ``sweep_status(tenant, sweep_id)`` — state + live progress counters.
* ``sweep_result(tenant, sweep_id)`` — the finished sweep's incumbent
  (config + loss) and evaluation census. A tenant can only see its own
  sweeps: the id namespace is checked against the caller's tenant.
* ``tenant_quota(tenant)`` — current quota + headroom (what admission
  would say right now).

With ``auth_tokens={tenant: secret}`` (or :meth:`ServeFrontend.
set_token`) the three tenant-facing RPCs above additionally require the
caller's ``token=``, validated with a constant-time compare — tenant
ids stop being self-reported. Open mode (no table) is unchanged.
Secrets never leave the frontend: not logged, not journaled, not in
metric names (docs/serving.md "Tenant authentication").
* ``pool_snapshot()`` — operator view: tenants, queues, rounds, buckets.
* the standard :class:`~hpbandster_tpu_torch.obs.health.HealthEndpoint` trio
  (``obs_snapshot`` / ``metrics_text`` / profiling), so the frontend is
  scrapeable and fleet-collectable like every other fleet process.

Every accepted sweep runs under ``use_tenant`` via the optimizer's
``tenant_id`` stamp, so its whole journal trail — config_sampled,
promotion_decision, job lifecycle — carries ``tenant_id`` and
``obs report --tenant`` can replay one tenant's story out of the shared
journal. Per-tenant gauges (``serve.tenant.<t>.quota_headroom``,
``configs_done``, ``queue_wait_s``) flow to Prometheus with a
``tenant=`` label (obs/export.py).
"""

from __future__ import annotations

import hmac
import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.obs import events as obs_events
from hpbandster_tpu_torch.serve.session import (
    SweepSpec,
    TenantMaster,
    TenantStore,
)

__all__ = ["ServeFrontend"]


class ServeFrontend:
    """Serve N tenants' sweep submissions against one :class:`ServePool`."""

    def __init__(
        self,
        pool,
        host: str = "127.0.0.1",
        port: int = 0,
        store: Optional[TenantStore] = None,
        persist_dir: Optional[str] = None,
        auth_tokens: Optional[Dict[str, str]] = None,
        logger: Optional[logging.Logger] = None,
    ):
        from hpbandster_tpu_torch.parallel.rpc import RPCServer

        self.pool = pool
        # persist_dir without an explicit store: tenant warm state (the
        # KDE each tenant paid to learn) survives frontend restarts —
        # see TenantStore and docs/fault_tolerance.md "Serving tier"
        self.store = store or TenantStore(persist_dir=persist_dir)
        # optional per-tenant shared-secret authn (docs/serving.md
        # "Tenant authentication"): with a token table configured,
        # submit_sweep / sweep_status / sweep_result require the
        # caller's token and reject-with-reason otherwise — tenant ids
        # stop being self-reported. None = open mode (the PR 8
        # behavior, unchanged). Secrets live ONLY here: they are
        # compared constant-time, never logged, never journaled, and
        # never ride an obs event or metric name.
        self._auth_tokens = (
            {str(t): str(s) for t, s in auth_tokens.items()}
            if auth_tokens is not None else None
        )
        self.logger = logger or logging.getLogger("hpbandster_tpu_torch.serve")
        self._lock = threading.Lock()
        #: serializes admission-check -> registration: the RPC server is
        #: threaded, and two concurrent submits must not both read the
        #: same quota headroom before either registers its run
        self._submit_lock = threading.Lock()
        #: sweep_id -> {"master": TenantMaster, "thread": Thread, ...}
        self._runs: Dict[str, Dict[str, Any]] = {}
        self._server = RPCServer(host, port)
        self._server.register("submit_sweep", self.submit_sweep)
        self._server.register("sweep_status", self.sweep_status)
        self._server.register("sweep_result", self.sweep_result)
        self._server.register("tenant_quota", self.tenant_quota)
        self._server.register("pool_snapshot", self.pool_snapshot)
        self._server.register("ping", lambda: "pong")
        obs.HealthEndpoint(
            component="serve_frontend",
            identity=obs.process_identity(component="serve_frontend"),
            in_flight=self._health_in_flight,
        ).register(self._server)

    # ------------------------------------------------------------ lifecycle
    @property
    def uri(self) -> str:
        return self._server.uri

    def start(self) -> "ServeFrontend":
        self._server.start()
        self.logger.info("serve frontend at %s", self.uri)
        return self

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop serving; running sweeps are given ``timeout`` to drain."""
        with self._lock:
            threads = [
                r["thread"] for r in self._runs.values()
                if r.get("thread") is not None
            ]
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
        self._server.shutdown()

    def _health_in_flight(self) -> Dict[str, Any]:
        with self._lock:
            states: Dict[str, int] = {}
            for r in self._runs.values():
                states[r["state"]] = states.get(r["state"], 0) + 1
        return {"sweeps": states, "pool": self.pool.snapshot()}

    # ---------------------------------------------------------------- authn
    def set_token(self, tenant: str, secret: str) -> None:
        """Register (or rotate) one tenant's shared secret. First call
        on an open-mode frontend switches authentication ON for every
        guarded RPC."""
        if self._auth_tokens is None:
            self._auth_tokens = {}
        self._auth_tokens[str(tenant)] = str(secret)

    def _authenticate(self, tenant: Any, token: Any) -> Optional[str]:
        """None when the caller may act as ``tenant``, else the reject
        reason. Constant-time compare (``hmac.compare_digest``); an
        unknown tenant still burns one compare so a probe cannot tell
        "unknown tenant" from "wrong token" by timing. The token itself
        is never logged or journaled — reasons carry no secret
        material."""
        if self._auth_tokens is None:
            return None
        expected = self._auth_tokens.get(
            tenant if isinstance(tenant, str) else ""
        )
        provided = token if isinstance(token, str) else ""
        ok = hmac.compare_digest(
            (expected if expected is not None else uuid.uuid4().hex
             ).encode("utf-8"),
            provided.encode("utf-8"),
        )
        if expected is None or not ok:
            return f"authentication failed for tenant {tenant!r}"
        return None

    def _note_auth(self, tenant: str, ok: bool) -> None:
        """Record one authentication outcome: the reject counter (the
        authn metric operators watch) plus a ``tenant_auth`` event —
        BOTH outcomes, because the auth-reject SLO (obs/slo.py default
        pack) is a ratio and needs the accepted calls as its total."""
        if not ok:
            obs.get_metrics().counter(
                f"serve.tenant.{tenant}.auth_rejected"
            ).inc()
        bus = obs_events.get_bus()
        if bus.active:
            bus.emit("tenant_auth", tenant=tenant, ok=ok)

    # ------------------------------------------------------------- RPC body
    def submit_sweep(
        self, tenant: str, spec: Optional[Dict[str, Any]] = None,
        token: Optional[str] = None,
    ) -> Dict[str, Any]:
        if not isinstance(tenant, str) or not tenant:
            return {"accepted": False, "reason": "tenant must be a non-empty string"}
        denied = self._authenticate(tenant, token)
        self._note_auth(tenant, denied is None)
        if denied is not None:
            return {"accepted": False, "reason": denied}
        try:
            sweep_spec = SweepSpec.from_dict(spec or {})
        except (ValueError, TypeError) as e:
            return {"accepted": False, "reason": f"invalid sweep spec: {e}"}

        session = self.store.session(tenant)
        # one quota truth: the session's quota (operator-settable through
        # the store) is what admission judges against
        self.pool.admission.set_quota(tenant, session.quota)
        # bracket-plan arithmetic stays outside the submit lock (every
        # tenant's submission serializes on it)
        estimated_cost = sweep_spec.estimated_cost()
        with self._submit_lock:
            decision = self.pool.admission.admit_sweep(
                tenant,
                active_sweeps=self.store.active_sweeps(tenant),
                total_active_sweeps=self.store.total_active_sweeps(),
            )
            if decision:
                # the estimated whole-sweep cost must fit the tenant's
                # in-flight budget: a 1M-config submission is rejected at
                # the door with the number that condemned it, not queued
                # forever
                decision = self.pool.admission.admit_work(
                    tenant,
                    inflight_cost=self._inflight_cost(tenant),
                    item_cost=estimated_cost,
                )
            if not decision:
                obs.get_metrics().counter(
                    f"serve.tenant.{tenant}.rejected"
                ).inc()
                self.logger.info(
                    "sweep from %r rejected: %s", tenant, decision.reason
                )
                return {"accepted": False, "reason": decision.reason}

            # reserve the slot (a "queued" run counts against quota and
            # in-flight cost) and release the lock: optimizer construction
            # — warm-model replay included — must not serialize every
            # other tenant's submissions behind this one
            sweep_id = f"{tenant}-{uuid.uuid4().hex[:8]}"
            run = {
                "tenant": tenant,
                "master": None,
                "state": "queued",
                "error": None,
                "cost": estimated_cost,
                "submitted_wall": time.time(),
            }
            with self._lock:
                self._runs[sweep_id] = run
            self.store.register_sweep(tenant, sweep_id, run)
        self._update_headroom(tenant)

        try:
            master = TenantMaster(
                self.pool, tenant, sweep_spec,
                store=self.store, sweep_id=sweep_id,
            )
        except Exception as e:
            # a reject, not a transport error (the API contract): undo the
            # reservation and answer with the reason
            self.logger.exception(
                "sweep construction for %r failed", tenant
            )
            with self._lock:
                self._runs.pop(sweep_id, None)
            self.store.unregister_sweep(tenant, sweep_id)
            self._update_headroom(tenant)
            obs.get_metrics().counter(
                f"serve.tenant.{tenant}.rejected"
            ).inc()
            return {
                "accepted": False,
                "reason": (
                    f"sweep construction failed: {type(e).__name__}: {e}"
                ),
            }

        thread = threading.Thread(
            target=self._drive, args=(master, run),
            daemon=True, name=f"sweep-{sweep_id}",
        )
        with self._lock:
            # thread is installed and started under the lock, so shutdown's
            # snapshot can never see a registered-but-unstarted thread
            run["master"] = master
            run["state"] = "running"
            run["thread"] = thread
            thread.start()
        return {"accepted": True, "sweep_id": sweep_id}

    def _drive(self, master: TenantMaster, run: Dict[str, Any]) -> None:
        try:
            master.run()
            state, error = "done", None
        except Exception as e:
            self.logger.exception(
                "sweep %s failed", master.sweep_id
            )
            state, error = "failed", f"{type(e).__name__}: {e}"
        try:
            progress = master.progress()
        except Exception:  # graftlint: disable=swallowed-exception — final counters are best-effort on a sweep that already failed (its error is recorded above)
            progress = {}
        with self._lock:
            run["state"] = state
            run["error"] = error
            # a finished sweep only needs its Result (sweep_result) and
            # final counters (sweep_status): drop the TenantMaster — its
            # optimizer, iterations, and KDE state would otherwise pin
            # memory per sweep ever served for the life of the process
            run["progress"] = progress
            run["result"] = master.result
            run["master"] = None
        self._update_headroom(run["tenant"])

    def _inflight_cost(self, tenant: str) -> float:
        with self._lock:
            return sum(
                r["cost"] for r in self._runs.values()
                if r["tenant"] == tenant
                and r["state"] in ("queued", "running")
            )

    def _update_headroom(self, tenant: str) -> None:
        session = self.store.session(tenant)
        obs.get_metrics().gauge(
            f"serve.tenant.{tenant}.quota_headroom"
        ).set(
            max(
                session.quota.max_active_sweeps
                - self.store.active_sweeps(tenant),
                0,
            )
        )

    def _run_for(
        self, tenant: str, sweep_id: str
    ) -> Optional[Dict[str, Any]]:
        with self._lock:
            run = self._runs.get(sweep_id)
        if run is None or run["tenant"] != tenant:
            # a foreign sweep id is indistinguishable from an unknown one:
            # tenants cannot probe each other's namespaces
            return None
        return run

    def sweep_status(
        self, tenant: str, sweep_id: str, token: Optional[str] = None
    ) -> Dict[str, Any]:
        denied = self._authenticate(tenant, token)
        # counted like submit rejects: status/result probes are the
        # cheap brute-force surface
        self._note_auth(tenant, denied is None)
        if denied is not None:
            return {"error": denied}
        run = self._run_for(tenant, sweep_id)
        if run is None:
            return {"error": f"unknown sweep {sweep_id!r}"}
        with self._lock:
            out = {
                "sweep_id": sweep_id,
                "state": run["state"],
                "error": run["error"],
            }
            master = run["master"]
            final = run.get("progress", {})
        out.update(master.progress() if master is not None else final)
        return out

    def sweep_result(
        self, tenant: str, sweep_id: str, token: Optional[str] = None
    ) -> Dict[str, Any]:
        denied = self._authenticate(tenant, token)
        self._note_auth(tenant, denied is None)
        if denied is not None:
            return {"error": denied}
        run = self._run_for(tenant, sweep_id)
        if run is None:
            return {"error": f"unknown sweep {sweep_id!r}"}
        with self._lock:
            state = run["state"]
            result = run.get("result")
        if state != "done":
            return {"error": f"sweep {sweep_id!r} is {state}"}
        inc_id = result.get_incumbent_id()
        incumbent = None
        if inc_id is not None:
            runs = result.get_runs_by_id(inc_id)
            best = min(
                (r for r in runs if r.loss is not None),
                key=lambda r: r.loss, default=None,
            )
            id2conf = result.get_id2config_mapping()
            incumbent = {
                "config_id": list(inc_id),
                "config": id2conf[inc_id]["config"],
                "loss": best.loss if best is not None else None,
            }
        all_runs = result.get_all_runs()
        return {
            "sweep_id": sweep_id,
            "incumbent": incumbent,
            "configs_evaluated": len(all_runs),
            "configs_crashed": sum(
                1 for r in all_runs if r.loss is None
            ),
        }

    def tenant_quota(self, tenant: str) -> Dict[str, Any]:
        session = self.store.session(tenant)
        q = session.quota
        active = self.store.active_sweeps(tenant)
        return {
            "tenant": tenant,
            "quota": q.to_dict(),
            "active_sweeps": active,
            "headroom_sweeps": max(q.max_active_sweeps - active, 0),
            "inflight_cost": self._inflight_cost(tenant),
            "sweeps_completed": session.sweeps_completed,
        }

    def pool_snapshot(self) -> Dict[str, Any]:
        return self.pool.snapshot()

    # ----------------------------------------------------------- inspection
    def sweeps(self, tenant: Optional[str] = None) -> List[str]:
        with self._lock:
            return sorted(
                sid for sid, r in self._runs.items()
                if tenant is None or r["tenant"] == tenant
            )
