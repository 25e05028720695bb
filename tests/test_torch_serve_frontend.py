"""The serving tier's front: sweep specs, tenant sessions with warm models
and their persistence, the per-sweep ``TenantMaster`` and the RPC
``ServeFrontend`` (``hpbandster_tpu_torch/serve/session.py``,
``serve/frontend.py``), on the CPU (``device="cpu"``).

The cases of the reference's ``tests/test_serve.py`` that reach the
front (admission through the frontend, the tenant stamp over RPC,
sessions and warm start, persistence, the frontend end to end over
sockets, the frontend's observability rows and tenant tokens), run on
the port; then the port against the reference: the same spec costs the
same in both packages, and a random-search sweep submitted to a port
frontend by a reference proxy equals the same sweep submitted to a
reference frontend by a port proxy (draws are numpy's in both; losses within ``atol 1e-4, rtol 1e-4``: XLA
contracts Branin's polynomial differently from eager PyTorch, ROADMAP
C.15). Every wait is bounded.
"""

import os
import threading
import time

import numpy as np
import pytest

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.parallel import VmapBackend
from hpbandster_tpu_torch.serve import (
    ServeFrontend,
    ServePool,
    SweepSpec,
    TenantMaster,
    TenantQuota,
    TenantStore,
)
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import ref, ref_host  # noqa: F401


def _smoke_backend():
    return VmapBackend(branin, device="cpu")


class TestAdmission:
    def test_concurrent_submits_cannot_overshoot_quota(self, monkeypatch):
        """The RPC server is threaded: N racing submits against a quota
        of 2 must admit exactly 2 (check-then-register is atomic, no
        TOCTOU), and concurrent census reads must never crash on the
        session dict mutating underneath them.

        Sweep completion is gated on an event until every submit has
        been decided: a finished sweep legitimately frees quota, so a
        real (fast) sweep racing the later submits would let a third
        admission through and flake the exact-count assertion."""
        gate = threading.Event()

        class _GatedMaster:
            def __init__(self, pool, tenant, spec, store=None, sweep_id=None):
                import uuid

                self.sweep_id = sweep_id or f"{tenant}-{uuid.uuid4().hex[:8]}"
                self.result = None

            def run(self):
                assert gate.wait(timeout=60)

            def progress(self):
                return {}

        monkeypatch.setattr(
            "hpbandster_tpu_torch.serve.frontend.TenantMaster", _GatedMaster
        )
        pool = ServePool(
            _smoke_backend(), branin_space(seed=0), pack_window_s=0.02
        )
        store = TenantStore(
            default_quota=TenantQuota(max_active_sweeps=2)
        )
        frontend = ServeFrontend(pool, store=store)
        replies, errors = [], []

        def submit(i):
            try:
                replies.append(frontend.submit_sweep(
                    "acme",
                    {"optimizer": "random", "n_iterations": 1,
                     "max_budget": 9, "seed": i},
                ))
            except Exception as e:  # pragma: no cover - the regression
                errors.append(e)

        def census(stop):
            while not stop.is_set():
                frontend.tenant_quota("acme")

        stop = threading.Event()
        reader = threading.Thread(target=census, args=(stop,), daemon=True)
        reader.start()
        threads = [
            threading.Thread(target=submit, args=(i,)) for i in range(12)
        ]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            stop.set()
            reader.join(timeout=5)
        assert not errors, errors
        accepted = [r for r in replies if r["accepted"]]
        assert len(accepted) == 2, replies
        assert all(
            "max_active_sweeps" in r["reason"]
            for r in replies if not r["accepted"]
        )
        gate.set()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            states = {
                frontend.sweep_status("acme", r["sweep_id"])["state"]
                for r in accepted
            }
            if states == {"done"}:
                break
            time.sleep(0.05)
        assert states == {"done"}

    def test_construction_failure_rejects_and_frees_quota(self, monkeypatch):
        """A sweep that admission accepted but whose optimizer fails to
        construct must answer as a reject (not a transport error), undo
        its quota reservation, and release the pool facade it minted."""

        class _Boom:
            def __init__(self, pool, tenant, spec, store=None, sweep_id=None):
                # mirror the real construction order: the facade is minted
                # first, so the release path is what keeps the pool clean
                self._executor = pool.executor_for(tenant)
                try:
                    raise RuntimeError("warm model replay exploded")
                except Exception:
                    self._executor.shutdown()
                    raise

        monkeypatch.setattr(
            "hpbandster_tpu_torch.serve.frontend.TenantMaster", _Boom
        )
        pool = ServePool(
            _smoke_backend(), branin_space(seed=0), pack_window_s=0.0
        )
        store = TenantStore(default_quota=TenantQuota(max_active_sweeps=1))
        frontend = ServeFrontend(pool, store=store)
        reply = frontend.submit_sweep("acme", {"optimizer": "random"})
        assert not reply["accepted"]
        assert "warm model replay exploded" in reply["reason"]
        # the reservation was undone: the tenant's quota slot is free again
        assert store.active_sweeps("acme") == 0
        assert frontend.tenant_quota("acme")["headroom_sweeps"] == 1
        # ... and the pool carries no phantom tenant census entry
        assert pool.tenants() == []

    def test_tenant_master_releases_facade_on_construction_failure(self):
        """The real construction path: a corrupt warm model blows up BOHB
        construction AFTER the pool facade was minted — TenantMaster must
        release it on the way out."""
        pool = ServePool(
            _smoke_backend(), branin_space(seed=0), pack_window_s=0.0
        )
        store = TenantStore()
        store.remember_result("acme", object())  # not a Result
        with pytest.raises(AttributeError):
            TenantMaster(
                pool, "acme", SweepSpec(optimizer="bohb"), store=store
            )
        assert pool.tenants() == []




class TestTenantStamp:
    def test_rpc_handler_enters_tenant(self):
        from hpbandster_tpu_torch.parallel.rpc import RPCProxy, RPCServer

        seen = {}
        server = RPCServer("127.0.0.1", 0)
        server.register(
            "who", lambda: seen.setdefault("tenant", obs.current_tenant())
        )
        server.start()
        try:
            with obs.use_tenant("acme"):
                RPCProxy(server.uri).call("who")
            assert seen["tenant"] == "acme"
        finally:
            server.shutdown()

    def test_dead_letter_carries_tenant(self):
        from hpbandster_tpu_torch.parallel.dispatcher import Dispatcher

        d = Dispatcher(run_id="dl", nameserver="127.0.0.1",
                       nameserver_port=1)
        with obs.use_tenant("acme"):
            assert d._rpc_register_result(
                id=[0, 0, 0], result={"result": {"loss": 1.0}}
            ) is False
        letter = d.dead_letters.snapshot()[-1]
        assert letter["tenant_id"] == "acme"
        # no tenant context -> the default tenant, never a missing key
        assert d._rpc_register_result(
            id=[0, 0, 1], result={"result": {"loss": 2.0}}
        ) is False
        assert d.dead_letters.snapshot()[-1]["tenant_id"] == "default"




class TestSessionsAndWarmStart:
    def test_spec_validation_reasons(self):
        with pytest.raises(ValueError, match="unknown optimizer"):
            SweepSpec(optimizer="gru")
        with pytest.raises(ValueError, match="n_iterations"):
            SweepSpec(n_iterations=0)
        with pytest.raises(ValueError, match="unknown sweep spec"):
            SweepSpec.from_dict({"objective": "mnist"})
        spec = SweepSpec.from_dict({"optimizer": "random", "seed": 3})
        assert spec.to_dict()["optimizer"] == "random"
        assert spec.estimated_cost() > 0

    def test_returning_tenant_gets_warm_model(self):
        pool = ServePool(
            _smoke_backend(), branin_space(seed=0), pack_window_s=0.0
        )
        store = TenantStore()
        spec = SweepSpec(n_iterations=1, seed=7, max_budget=9)
        m1 = TenantMaster(pool, "acme", spec, store=store)
        m1.run()
        assert store.warm("acme") is not None
        assert store.session("acme").sweeps_completed == 1
        # the second sweep replays the first Result into its generator:
        # a WarmStartIteration is present and the KDE already has points
        m2 = TenantMaster(pool, "acme", spec, store=store)
        assert m2.optimizer.warmstart_iteration, (
            "previous_result not replayed"
        )
        # warm_start=False opts out
        cold = TenantMaster(
            pool, "acme",
            SweepSpec(n_iterations=1, seed=8, warm_start=False),
            store=store,
        )
        assert not cold.optimizer.warmstart_iteration

    def test_warm_models_are_per_tenant(self):
        pool = ServePool(
            _smoke_backend(), branin_space(seed=0), pack_window_s=0.0
        )
        store = TenantStore()
        TenantMaster(
            pool, "acme", SweepSpec(n_iterations=1, seed=7), store=store
        ).run()
        assert store.warm("acme") is not None
        assert store.warm("other") is None


class TestTenantPersistence:
    """Per-tenant warm-state persistence (docs/fault_tolerance.md
    "Serving tier"): the KDE a tenant paid to learn survives frontend
    restarts."""

    def test_warm_state_survives_store_restart(self, tmp_path):
        persist = str(tmp_path / "tenants")
        pool = ServePool(
            _smoke_backend(), branin_space(seed=0), pack_window_s=0.0
        )
        store = TenantStore(persist_dir=persist)
        TenantMaster(
            pool, "acme", SweepSpec(n_iterations=1, seed=7), store=store
        ).run()
        assert store.warm("acme") is not None
        del store  # the frontend process dies

        reborn = TenantStore(persist_dir=persist)
        assert reborn.warm("acme") is not None
        assert reborn.session("acme").sweeps_completed == 1
        assert reborn.warm("other") is None
        # the reloaded Result actually warm-starts the next sweep
        m = TenantMaster(
            pool, "acme", SweepSpec(n_iterations=1, seed=8), store=reborn
        )
        assert m.optimizer.warmstart_iteration, (
            "persisted result not replayed into the new sweep"
        )
        m.optimizer.shutdown()

    def test_corrupt_persisted_state_degrades_to_cold(self, tmp_path):
        from hpbandster_tpu_torch.serve.session import _tenant_filename

        persist = str(tmp_path / "tenants")
        os.makedirs(persist)
        with open(os.path.join(persist, _tenant_filename("acme")), "wb") as fh:
            fh.write(b"not a pickle at all")
        store = TenantStore(persist_dir=persist)
        # cold start, not a bricked tenant
        assert store.warm("acme") is None
        assert store.session("acme").sweeps_completed == 0

    def test_self_reported_ids_cannot_collide_on_disk(self):
        from hpbandster_tpu_torch.serve.session import _tenant_filename

        a, b = _tenant_filename("a/b"), _tenant_filename("a_b")
        assert a != b  # sanitization alone would alias these
        assert "/" not in a and "\\" not in a
        # hostile ids stay inside the directory
        evil = _tenant_filename("../../etc/passwd")
        assert "/" not in evil

    def test_warm_probe_of_unknown_id_mints_no_session(self, tmp_path):
        """Tenant ids are self-reported: a read probe of an id with no
        persisted state must not register a phantom session (unbounded
        growth from read-only queries)."""
        store = TenantStore(persist_dir=str(tmp_path / "tenants"))
        assert store.warm("never-seen") is None
        assert store.warm("another-probe") is None
        assert store.tenants() == []

    def test_memory_only_store_writes_nothing(self, tmp_path):
        pool = ServePool(
            _smoke_backend(), branin_space(seed=0), pack_window_s=0.0
        )
        store = TenantStore()  # no persist_dir
        TenantMaster(
            pool, "acme", SweepSpec(n_iterations=1, seed=7), store=store
        ).run()
        assert store.warm("acme") is not None
        assert list(tmp_path.iterdir()) == []

    def test_frontend_persist_dir_passthrough(self, tmp_path):
        persist = str(tmp_path / "tenants")
        pool = ServePool(
            _smoke_backend(), branin_space(seed=0), pack_window_s=0.0
        )
        f = ServeFrontend(pool, persist_dir=persist).start()
        try:
            assert f.store.persist_dir == persist
            assert os.path.isdir(persist)
        finally:
            f.shutdown(timeout=1.0)


# ----------------------------------------------------- frontend over sockets
class TestFrontendEndToEnd:
    def test_three_tenants_over_sockets_with_journal_reconciliation(
        self, tmp_path
    ):
        """The full story: 3 tenants submit over TCP, sweeps run
        concurrently against one pool, and afterwards each tenant's
        slice of the SHARED journal reconciles with its own sweep
        result."""
        from hpbandster_tpu_torch.obs.report import filter_tenant
        from hpbandster_tpu_torch.parallel.rpc import RPCProxy

        journal = str(tmp_path / "serve.jsonl")
        handle = obs.configure(journal_path=journal)
        frontend = None
        try:
            pool = ServePool(
                _smoke_backend(), branin_space(seed=0),
                pack_window_s=0.05,
            )
            frontend = ServeFrontend(pool).start()
            proxy = RPCProxy(frontend.uri, timeout=30)
            sweep_ids = {}
            for i, tenant in enumerate(("acme", "bob", "carol")):
                reply = proxy.call(
                    "submit_sweep", tenant=tenant,
                    spec={"optimizer": "bohb", "n_iterations": 2,
                          "max_budget": 9, "seed": 20 + i},
                )
                assert reply["accepted"], reply
                sweep_ids[tenant] = reply["sweep_id"]
            deadline = time.monotonic() + 120
            states = {}
            while time.monotonic() < deadline:
                states = {
                    t: proxy.call(
                        "sweep_status", tenant=t, sweep_id=sid
                    )["state"]
                    for t, sid in sweep_ids.items()
                }
                if all(s == "done" for s in states.values()):
                    break
                time.sleep(0.1)
            assert all(s == "done" for s in states.values()), states

            for tenant, sid in sweep_ids.items():
                result = proxy.call(
                    "sweep_result", tenant=tenant, sweep_id=sid
                )
                assert result["incumbent"] is not None
                assert result["configs_evaluated"] == 19
        finally:
            if frontend is not None:
                frontend.shutdown()
            handle.close()

        records = obs.read_journal(journal)
        for tenant in ("acme", "bob", "carol"):
            mine = filter_tenant(records, tenant)
            finished = [
                r for r in mine
                if r.get("event") in ("job_finished", "job_failed")
                and "loss" in r
            ]
            assert len(finished) == 19, tenant
            sampled = [
                r for r in mine if r.get("event") == "config_sampled"
            ]
            assert len(sampled) == 14, tenant  # 9 + 5 fresh samples
            # no cross-tenant bleed: every record names this tenant
            assert all(r.get("tenant_id") == tenant for r in mine)

    def test_admission_rejects_over_sockets(self):
        from hpbandster_tpu_torch.parallel.rpc import RPCProxy

        pool = ServePool(
            _smoke_backend(), branin_space(seed=0), pack_window_s=0.02
        )
        store = TenantStore(
            default_quota=TenantQuota(max_active_sweeps=1)
        )
        frontend = ServeFrontend(pool, store=store).start()
        try:
            proxy = RPCProxy(frontend.uri, timeout=30)
            spec = {"optimizer": "bohb", "n_iterations": 2,
                    "max_budget": 9, "seed": 1}
            first = proxy.call("submit_sweep", tenant="acme", spec=spec)
            assert first["accepted"]
            second = proxy.call("submit_sweep", tenant="acme", spec=spec)
            assert not second["accepted"]
            assert "max_active_sweeps" in second["reason"]
            bad = proxy.call(
                "submit_sweep", tenant="acme", spec={"optimizer": "gru"}
            )
            assert not bad["accepted"] and "unknown optimizer" in bad["reason"]
            huge = proxy.call(
                "submit_sweep", tenant="whale",
                spec={"optimizer": "bohb", "n_iterations": 3,
                      "min_budget": 1, "max_budget": 10_000_000},
            )
            assert not huge["accepted"]
            assert "max_inflight_cost" in huge["reason"]
            # foreign sweep ids are invisible
            foreign = proxy.call(
                "sweep_status", tenant="bob",
                sweep_id=first["sweep_id"],
            )
            assert "unknown sweep" in foreign["error"]
            quota = proxy.call("tenant_quota", tenant="acme")
            assert quota["active_sweeps"] >= 0
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                st = proxy.call(
                    "sweep_status", tenant="acme",
                    sweep_id=first["sweep_id"],
                )
                if st["state"] != "running":
                    break
                time.sleep(0.1)
            assert st["state"] == "done", st
        finally:
            frontend.shutdown()



class TestServingObservability:
    def test_export_tenant_label_round_trip(self):
        from hpbandster_tpu_torch.obs.export import (
            metric_family,
            parse_prometheus_text,
            render_snapshot,
        )

        fam, labels = metric_family("serve.tenant.acme.configs_done")
        assert fam == "hpbandster_serve_tenant_configs_done"
        assert labels == {"tenant": "acme"}
        # hostile tenant ids survive the escaping round trip
        evil = 'a.b"x\nY\\z'
        snap = {
            "counters": {f"serve.tenant.{evil}.configs_done": 3},
            "gauges": {}, "histograms": {},
        }
        text = render_snapshot(snap)
        parsed = parse_prometheus_text(text)
        fam_total = "hpbandster_serve_tenant_configs_done_total"
        (labels, value), = parsed[fam_total]["samples"]
        assert labels == {"tenant": evil} and value == 3.0

    def test_endpoint_row_distills_tenants(self):
        from hpbandster_tpu_torch.obs.collector import _endpoint_row

        row = _endpoint_row({
            "component": "serve_frontend",
            "metrics": {"counters": {
                "serve.tenant.acme.configs_done": 19,
                "serve.tenant.bob.configs_done": 38,
                "serve.tenant.acme.rejected": 1,  # not a throughput
                "rpc.client_calls": 5,
            }},
        })
        assert row["tenants"] == {"acme": 19.0, "bob": 38.0}

    def test_derive_fleet_fairness_ratio(self):
        from hpbandster_tpu_torch.obs.collector import derive_fleet

        rows = {
            "fe": {"ok": True, "tenants": {"a": 10.0, "b": 40.0}},
            "w0": {"ok": True, "tenants": {"a": 10.0}},
        }
        fleet = derive_fleet(
            rows, ok=2, stale=0, lost=0, churn_events=0
        )
        assert fleet["tenants"] == 2
        assert fleet["tenant_throughput_ratio"] == 2.0  # 40 / (10+10)
        assert fleet["tenants_starved"] == 0
        # single tenant -> no ratio (no pair to compare)
        fleet1 = derive_fleet(
            {"fe": {"ok": True, "tenants": {"a": 5.0}}},
            ok=1, stale=0, lost=0, churn_events=0,
        )
        assert fleet1["tenant_throughput_ratio"] is None

    def test_derive_fleet_starved_tenant_is_counted(self):
        """The ratio goes None over a zero denominator — permanent
        starvation must surface through its own gauge instead."""
        from hpbandster_tpu_torch.obs.collector import derive_fleet

        fleet = derive_fleet(
            {"fe": {"ok": True, "tenants": {"a": 500.0, "b": 0.0}}},
            ok=1, stale=0, lost=0, churn_events=0,
        )
        assert fleet["tenant_throughput_ratio"] is None
        assert fleet["tenants_starved"] == 1
        # warmup (nobody has progressed) is not starvation
        cold = derive_fleet(
            {"fe": {"ok": True, "tenants": {"a": 0.0, "b": 0.0}}},
            ok=1, stale=0, lost=0, churn_events=0,
        )
        assert cold["tenants_starved"] == 0
        # no tenants at all -> unmeasurable, not zero
        none = derive_fleet(
            {"fe": {"ok": True}}, ok=1, stale=0, lost=0, churn_events=0,
        )
        assert none["tenants_starved"] is None

    def test_fleet_table_tenant_column_and_filter(self):
        from hpbandster_tpu_torch.obs.collector import format_fleet_table

        sample = {
            "fleet": {"endpoints": 2, "ok": 2, "stale": 0, "tenants": 2,
                      "tenant_throughput_ratio": 1.5},
            "endpoints": {
                "fe": {"ok": True, "component": "serve_frontend",
                       "uptime_s": 5.0,
                       "tenants": {"acme": 19.0, "bob": 38.0}},
                "w0": {"ok": True, "component": "worker",
                       "uptime_s": 5.0, "tenants": {}},
            },
        }
        text = format_fleet_table(sample)
        assert "tenants=2" in text and "throughput_ratio=1.50" in text
        filtered = format_fleet_table(sample, tenant="acme")
        assert "fe" in filtered and "w0" not in filtered
        assert "[filter: tenant=acme]" in filtered

    def test_watch_snapshot_line_tenant_part(self):
        from hpbandster_tpu_torch.obs.summarize import _snapshot_status_line

        snap = {
            "component": "serve_frontend", "uptime_s": 1.0,
            "in_flight": None,
            "metrics": {"counters": {
                "serve.tenant.acme.configs_done": 19,
                "serve.tenant.bob.configs_done": 7,
            }},
        }
        line = _snapshot_status_line(snap)
        assert "tenants=2(acme:19,bob:7)" in line
        line_t = _snapshot_status_line(snap, tenant="acme")
        assert "tenant[acme]: configs_done=19" in line_t
        # no serving counters -> no tenant part (byte-compat lines)
        bare = _snapshot_status_line(
            {"component": "worker", "uptime_s": 1.0, "in_flight": None,
             "metrics": {"counters": {}}}
        )
        assert "tenant" not in bare



class TestTenantAuthn:
    """ISSUE 15 satellite: optional per-tenant shared-secret tokens on
    submit_sweep / sweep_status / sweep_result — reject-with-reason,
    constant-time compare, and the secret NEVER lands in a journal."""

    def _frontend(self, tokens, store=None):
        pool = ServePool(
            _smoke_backend(), branin_space(seed=0), pack_window_s=0.0
        )
        # never start()ed: these are in-process API tests (the socket
        # round-trip is the slow-marked e2e's job); sweep threads are
        # daemons and drain on their own
        return ServeFrontend(pool, auth_tokens=tokens, store=store)

    @staticmethod
    def _wait_done(fe, tenant, sid, token=None, timeout=60):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = fe.sweep_status(tenant, sid, token=token)
            if st.get("state") in ("done", "failed"):
                return st
            time.sleep(0.05)
        raise AssertionError(f"sweep {sid} never finished")

    def test_open_mode_unchanged_without_tokens(self):
        fe = self._frontend(None)
        out = fe.submit_sweep("acme", {"n_iterations": 1})
        assert out["accepted"] is True
        assert self._wait_done(fe, "acme", out["sweep_id"])["state"] == "done"

    def test_submit_rejects_wrong_and_missing_token(self):
        fe = self._frontend({"acme": "s3cret"})
        out = fe.submit_sweep("acme", {"n_iterations": 1})
        assert out["accepted"] is False
        assert "authentication failed" in out["reason"]
        out = fe.submit_sweep("acme", {"n_iterations": 1}, token="wrong")
        assert out["accepted"] is False
        # an unknown tenant reads identically to a wrong token, and the
        # secret itself never rides a reject reason
        out = fe.submit_sweep(
            "mallory", {"n_iterations": 1}, token="s3cret"
        )
        assert out["accepted"] is False
        assert "authentication failed" in out["reason"]
        assert "s3cret" not in out["reason"]

    def test_status_and_result_guarded_and_token_never_journaled(
        self, tmp_path
    ):
        journal = str(tmp_path / "authn.jsonl")
        handle = obs.configure(journal_path=journal)
        try:
            fe = self._frontend({"acme": "s3cret-tok"})
            out = fe.submit_sweep(
                "acme", {"n_iterations": 1}, token="s3cret-tok"
            )
            assert out["accepted"] is True
            sid = out["sweep_id"]
            # wrong/missing tokens cannot read status or results
            assert "authentication failed" in fe.sweep_status(
                "acme", sid
            )["error"]
            assert "authentication failed" in fe.sweep_result(
                "acme", sid, token="nope"
            )["error"]
            st = self._wait_done(fe, "acme", sid, token="s3cret-tok")
            assert st["state"] == "done"
            res = fe.sweep_result("acme", sid, token="s3cret-tok")
            assert res["incumbent"] is not None
        finally:
            handle.close()
        text = open(journal).read()
        assert "config_sampled" in text  # the sweep DID journal
        assert "s3cret-tok" not in text  # the secret never did

    def test_token_rotation_via_set_token(self):
        fe = self._frontend(None)
        fe.set_token("acme", "v2")
        out = fe.submit_sweep("acme", {"n_iterations": 1})
        assert out["accepted"] is False
        out = fe.submit_sweep("acme", {"n_iterations": 1}, token="v2")
        assert out["accepted"] is True
        assert self._wait_done(
            fe, "acme", out["sweep_id"], token="v2"
        )["state"] == "done"



# ------------------------------------------------------ against the reference
def test_spec_cost_and_validation_equal_reference(ref_host):  # noqa: F811
    """A spec's estimated cost and a bad spec's reason, in both packages."""
    for d in ({"n_iterations": 3, "max_budget": 27}, {"optimizer": "random", "eta": 2.0},
              {"n_iterations": 10, "min_budget": 1, "max_budget": 81, "seed": 3}):
        assert SweepSpec.from_dict(d).to_dict() == ref_host.session.SweepSpec.from_dict(
            d).to_dict()
        assert SweepSpec.from_dict(d).estimated_cost() == ref_host.session.SweepSpec.from_dict(
            d).estimated_cost()
    for bad in ({"optimizer": "gru"}, {"n_iterations": 0}, {"objective": "x"},
                {"optimizer": "random", "promotion_rule": "asha"}):
        with pytest.raises(ValueError) as mine:
            SweepSpec.from_dict(bad)
        with pytest.raises(ValueError) as theirs:
            ref_host.session.SweepSpec.from_dict(bad)
        assert str(mine.value) == str(theirs.value)


def _wait(proxy, tenant, sweep_id, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = proxy.call("sweep_status", tenant=tenant, sweep_id=sweep_id)
        if st.get("state") in ("done", "failed"):
            return st
        time.sleep(0.05)
    raise AssertionError(f"sweep {sweep_id} did not finish in {timeout} s")


def test_random_sweep_through_either_frontend_equals(ref, ref_host):  # noqa: F811
    """The same random-search spec submitted over RPC to a port frontend
    by a reference proxy, and to a reference frontend by a port proxy:
    the same configs (numpy draws in both), losses within ``atol 1e-4,
    rtol 1e-4`` (XLA contracts Branin's polynomial differently, ROADMAP
    C.15), the same incumbent and census in the ``sweep_result`` reply."""
    from hpbandster_tpu_torch.parallel.rpc import RPCProxy

    spec = {"optimizer": "random", "n_iterations": 2, "max_budget": 9, "seed": 4}
    port_fe = ServeFrontend(ServePool(_smoke_backend(), branin_space(seed=0),
                                      pack_window_s=0.0)).start()
    ref_fe = ref_host.frontend.ServeFrontend(ref_host.serve.ServePool(
        ref_host.parallel.VmapBackend(ref.toys.branin_from_vector),
        ref.toys.branin_space(seed=0), pack_window_s=0.0)).start()
    replies, results = {}, {}
    try:
        for name, fe, proxy in (("port", port_fe, ref_host.rpc.RPCProxy(port_fe.uri, timeout=60)),
                                ("ref", ref_fe, RPCProxy(ref_fe.uri, timeout=60))):
            sub = proxy.call("submit_sweep", tenant="acme", spec=spec)
            assert sub["accepted"], sub
            assert _wait(proxy, "acme", sub["sweep_id"])["state"] == "done"
            replies[name] = proxy.call("sweep_result", tenant="acme", sweep_id=sub["sweep_id"])
            results[name] = fe._runs[sub["sweep_id"]]["result"]
    finally:
        port_fe.shutdown(timeout=5.0)
        ref_fe.shutdown(timeout=5.0)
    runs = {k: {(r.config_id, r.budget): r.loss for r in res.get_all_runs()}
            for k, res in results.items()}
    assert set(runs["port"]) == set(runs["ref"]) and len(runs["port"]) == 9 + 5
    keys = sorted(runs["ref"])
    np.testing.assert_allclose([runs["port"][k] for k in keys], [runs["ref"][k] for k in keys],
                               atol=1e-4, rtol=1e-4)
    id2c = {k: res.get_id2config_mapping() for k, res in results.items()}
    assert all(id2c["port"][c]["config"] == id2c["ref"][c]["config"] for c in id2c["ref"])
    mine, theirs = replies["port"], replies["ref"]
    assert mine["configs_evaluated"] == theirs["configs_evaluated"] == 14
    assert mine["incumbent"]["config_id"] == theirs["incumbent"]["config_id"]
    assert mine["incumbent"]["config"] == theirs["incumbent"]["config"]
    assert mine["incumbent"]["loss"] == pytest.approx(theirs["incumbent"]["loss"], abs=1e-4,
                                                      rel=1e-4)
