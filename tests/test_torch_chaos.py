"""Chaos harness — seeded fault injection and the elastic fleet's
survival of it (parallel/chaos.py + docs/fault_tolerance.md), on the port
and on the CPU: the cases of the reference's ``tests/test_chaos.py``.

Two layers:

* unit: every fault kind (kill / delay / partition / duplicate) does
  exactly what it says at the TCP relay, on a seeded, replayable
  schedule;
* e2e (the acceptance criterion): a seeded sweep with workers killed,
  delayed, partitioned, and double-delivered mid-rung produces the SAME
  losses, promotions, and incumbent as the undisturbed run, with a
  duplicate-free audit lineage — every submitted job joins exactly one
  terminal result. The fast smoke runs in tier-1; the sustained-churn
  matrix (ChaosMonkey at 25% kill probability per tick) rides the slow
  lane. Both carry the ``chaos`` marker (``pytest -m chaos``).
"""

import threading
import time

import pytest

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.nameserver import NameServer
from hpbandster_tpu_torch.core.worker import Worker
from hpbandster_tpu_torch.optimizers import BOHB
from hpbandster_tpu_torch.parallel.chaos import (
    DELAY,
    DUPLICATE,
    KILL,
    PARTITION,
    ChaosMonkey,
    ChaosProxy,
    ChaosSchedule,
)
from hpbandster_tpu_torch.parallel.dispatcher import Dispatcher
from hpbandster_tpu_torch.parallel.rpc import (
    CommunicationError,
    RPCProxy,
    RPCServer,
)

from hpbandster_tpu_torch.workloads.toys import branin_dict, branin_space

pytestmark = pytest.mark.chaos


class TestChaosSchedule:
    def test_seeded_and_replayable(self):
        kw = dict(
            seed=42, kill_rate=0.05, delay_rate=0.2, partition_rate=0.1,
            duplicate_rate=0.1,
        )
        a, b = ChaosSchedule(**kw), ChaosSchedule(**kw)
        decisions_a = [a.next_fault("m") for _ in range(200)]
        decisions_b = [b.next_fault("m") for _ in range(200)]
        assert decisions_a == decisions_b
        assert a.log == b.log
        kinds = {k for k in decisions_a if k}
        assert kinds == {KILL, DELAY, PARTITION, DUPLICATE}

    def test_rates_over_one_rejected(self):
        with pytest.raises(ValueError, match="sum"):
            ChaosSchedule(kill_rate=0.6, delay_rate=0.6)

    def test_obs_snapshot_never_faulted(self):
        s = ChaosSchedule(seed=0, partition_rate=1.0)
        assert all(
            s.next_fault("obs_snapshot") is None for _ in range(20)
        )

    def test_method_filter(self):
        s = ChaosSchedule(seed=0, delay_rate=1.0, methods=("register_result",))
        assert s.next_fault("ping") is None
        assert s.next_fault("register_result") == DELAY


@pytest.fixture
def backend():
    srv = RPCServer("127.0.0.1", 0)
    calls = []

    def echo(x=0):
        calls.append(x)
        return x * 2

    srv.register("echo", echo)
    srv.register("ping", lambda: "pong")
    srv.start()
    yield srv, calls
    srv.shutdown()


class TestChaosProxy:
    def test_transparent_relay_when_clean(self, backend):
        srv, _ = backend
        proxy = ChaosProxy(srv.uri, ChaosSchedule()).start()
        try:
            assert RPCProxy(proxy.uri).call("echo", x=21) == 42
        finally:
            proxy.shutdown()

    def test_delay_fault_slows_but_succeeds(self, backend):
        srv, _ = backend
        sched = ChaosSchedule(seed=1, delay_rate=1.0, delay_s=0.15)
        proxy = ChaosProxy(srv.uri, sched).start()
        m = obs.get_metrics()
        before = m.counter("chaos.faults_delay").value
        try:
            t0 = time.monotonic()
            assert RPCProxy(proxy.uri).call("echo", x=1) == 2
            assert time.monotonic() - t0 >= 0.15
        finally:
            proxy.shutdown()
        assert m.counter("chaos.faults_delay").value == before + 1

    def test_partition_fault_is_communication_error(self, backend):
        srv, calls = backend
        proxy = ChaosProxy(
            srv.uri, ChaosSchedule(seed=2, partition_rate=1.0)
        ).start()
        try:
            with pytest.raises(CommunicationError):
                RPCProxy(proxy.uri, timeout=5).call("echo", x=1)
            assert calls == []  # the backend never saw the request
        finally:
            proxy.shutdown()

    def test_duplicate_fault_serves_backend_twice(self, backend):
        srv, calls = backend
        proxy = ChaosProxy(
            srv.uri, ChaosSchedule(seed=3, duplicate_rate=1.0)
        ).start()
        try:
            assert RPCProxy(proxy.uri).call("echo", x=7) == 14
            deadline = time.monotonic() + 5
            while len(calls) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)  # the duplicate lands after the reply
            assert calls == [7, 7]
        finally:
            proxy.shutdown()

    def test_kill_then_revive_same_port(self, backend):
        srv, _ = backend
        proxy = ChaosProxy(srv.uri, ChaosSchedule()).start()
        uri = proxy.uri
        try:
            assert RPCProxy(uri).call("echo", x=1) == 2
            proxy.kill()
            assert not proxy.alive
            with pytest.raises(CommunicationError):
                RPCProxy(uri, timeout=2).call("echo", x=1)
            proxy.revive()
            assert proxy.alive
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                try:
                    assert RPCProxy(uri, timeout=2).call("echo", x=3) == 6
                    break
                except CommunicationError:
                    time.sleep(0.02)
            else:
                pytest.fail("revived proxy never served again")
            assert proxy.kills == 1
        finally:
            proxy.shutdown()

    def test_kill_rate_takes_proxy_down_mid_call(self, backend):
        srv, _ = backend
        proxy = ChaosProxy(
            srv.uri, ChaosSchedule(seed=4, kill_rate=1.0)
        ).start()
        try:
            # the in-flight request dies with the 'process'
            with pytest.raises(CommunicationError):
                RPCProxy(proxy.uri, timeout=2).call("echo", x=1)
            assert not proxy.alive
        finally:
            proxy.shutdown()

    def test_interpose_reroutes_nameserver_entry(self, backend):
        srv, _ = backend
        ns = NameServer(run_id="interpose", host="127.0.0.1", port=0)
        host, port = ns.start()
        proxy = ChaosProxy(srv.uri, ChaosSchedule()).start()
        try:
            RPCProxy(f"{host}:{port}").call(
                "register", name="w0", uri=srv.uri
            )
            proxy.interpose(host, port, "w0")
            listing = RPCProxy(f"{host}:{port}").call("list", prefix="")
            assert listing["w0"] == proxy.uri
        finally:
            proxy.shutdown()
            ns.shutdown()


class TestChaosMonkey:
    def test_seeded_churn_kills_and_revives(self, backend):
        srv, _ = backend
        proxies = {
            f"w{i}": ChaosProxy(srv.uri, ChaosSchedule()).start()
            for i in range(4)
        }
        monkey = ChaosMonkey(
            proxies, seed=7, interval_s=0.02, kill_fraction=0.5,
            outage_s=0.1, max_dead=2,
        ).start()
        try:
            time.sleep(0.6)
            kills = [e for e in monkey.log if e[2] == "kill"]
            revives = [e for e in monkey.log if e[2] == "revive"]
            assert kills, "50% per tick over 30 ticks must kill"
            assert revives, "outage_s elapsed; corpses must revive"
            # the cap held at every instant: never more than 2 dead
            dead = set()
            for _, name, action in monkey.log:
                if action == "kill":
                    dead.add(name)
                    assert len(dead) <= 2
                else:
                    dead.discard(name)
        finally:
            monkey.stop()
            assert all(p.alive for p in proxies.values())  # stop revives
            for p in proxies.values():
                p.shutdown()


# --------------------------------------------------------------------- e2e
class _ChaosBranin(Worker):
    def compute(self, config_id, config, budget, working_directory):
        time.sleep(0.004 * budget)  # make mid-rung kills land mid-compute
        return {"loss": branin_dict(config, budget), "info": {}}


def _run_sweep(seed, n_workers, n_iterations, chaos=None, journal=None):
    """One seeded sweep over real sockets; ``chaos`` = (schedule, killer)
    where killer(proxies, dispatcher) runs in a thread during the sweep.
    Returns (result, proxies, dispatcher)."""
    handle = obs.configure(journal_path=journal) if journal else None
    ns = NameServer(run_id="chaos-e2e", host="127.0.0.1", port=0)
    host, port = ns.start()
    proxies = {}
    schedule = chaos[0] if chaos else None
    try:
        for i in range(n_workers):
            w = _ChaosBranin(
                run_id="chaos-e2e", nameserver=host, nameserver_port=port,
                id=i,
            )
            w.result_delivery_backoff = 0.02
            w.result_delivery_backoff_cap = 0.1
            w.run(background=True)
            if schedule is not None:
                p = ChaosProxy(w._server.uri, schedule).start()
                p.interpose(host, port, w.worker_id)
                proxies[w.worker_id] = p
        d = Dispatcher(
            run_id="chaos-e2e", nameserver=host, nameserver_port=port,
            ping_interval=0.1, discover_interval=0.1,
            requeue_backoff=0.02, requeue_backoff_cap=0.1,
        )
        opt = BOHB(
            configspace=branin_space(seed=seed), run_id="chaos-e2e",
            executor=d, min_budget=1, max_budget=9, eta=3, seed=seed, device="cpu",
            # pure seeded sampling: the trajectory is then a function of
            # the seed alone, which is what makes chaos/clean comparable
            min_points_in_model=10_000,
        )
        stop = threading.Event()
        killer_thread = None
        if chaos and chaos[1] is not None:
            killer_thread = threading.Thread(
                target=chaos[1], args=(proxies, d, stop), daemon=True
            )
            killer_thread.start()
        try:
            res = opt.run(n_iterations=n_iterations, min_n_workers=n_workers)
        finally:
            stop.set()
            if killer_thread is not None:
                killer_thread.join(timeout=5)
            for p in proxies.values():
                p.revive()
            opt.shutdown(shutdown_workers=True)
    finally:
        for p in proxies.values():
            p.shutdown()
        ns.shutdown()
        if handle is not None:
            handle.close()
    return res


def _runs_of(res):
    return {(r.config_id, r.budget): r.loss for r in res.get_all_runs()}


def _assert_lineage_exactly_once(journal):
    """Every submitted job joined exactly one terminal result, and every
    sampled config has a terminal result at every rung it entered."""
    records = obs.read_journal(journal)
    submitted = []
    terminals = []
    sampled = set()
    for r in records:
        if r["event"] == "config_sampled":
            sampled.add(tuple(r["config_id"]))
        elif r["event"] == "job_submitted":
            submitted.append((tuple(r["config_id"]), r["budget"]))
        elif r["event"] in ("job_finished", "job_failed") and "loss" in r:
            # master-side terminal twin (the worker-side twin carries
            # compute_s, never loss)
            terminals.append((tuple(r["config_id"]), r["budget"]))
    assert len(submitted) == len(set(submitted)), "a job was submitted twice"
    assert len(terminals) == len(set(terminals)), (
        "duplicate terminal results leaked past the exactly-once gate"
    )
    assert set(submitted) == set(terminals), (
        "submitted and terminal sets diverge: lost or phantom work"
    )
    terminal_cids = {cid for cid, _ in terminals}
    assert sampled and sampled <= terminal_cids, (
        "a sampled config never joined a terminal result"
    )


class TestChaosSweepSmoke:
    def test_faulted_sweep_matches_clean_trajectory(self, tmp_path):
        """Acceptance smoke: delays, partitions, duplicate deliveries, and
        one mid-rung kill+revive leave the trajectory untouched and the
        lineage duplicate-free."""
        res_clean = _run_sweep(seed=31, n_workers=3, n_iterations=2)
        clean = _runs_of(res_clean)
        assert len(clean) == 13 + 6  # eta=3 brackets 0 and 1

        schedule = ChaosSchedule(
            seed=13, delay_rate=0.15, partition_rate=0.1,
            duplicate_rate=0.15, delay_s=0.03,
        )

        def kill_one_mid_rung(proxies, dispatcher, stop):
            if stop.wait(0.3):
                return
            name = sorted(proxies)[0]
            proxies[name].kill(reason="mid_rung_test_kill")
            if stop.wait(0.4):
                return
            proxies[name].revive()

        faults0 = obs.get_metrics().counter("chaos.faults").value
        journal = str(tmp_path / "chaos.jsonl")
        res = _run_sweep(
            seed=31, n_workers=3, n_iterations=2,
            chaos=(schedule, kill_one_mid_rung), journal=journal,
        )
        assert obs.get_metrics().counter("chaos.faults").value > faults0, (
            "the schedule injected nothing — the run proved nothing"
        )
        # same work, same losses, same winner — chaos changed NOTHING
        assert _runs_of(res) == clean
        assert res.get_incumbent_id() == res_clean.get_incumbent_id()
        _assert_lineage_exactly_once(journal)


@pytest.mark.slow
class TestChaosChurnMatrix:
    def test_sustained_churn_preserves_trajectory(self, tmp_path):
        """The full matrix: ChaosMonkey churning 4 workers (25% kill
        probability per 0.15 s tick, 0.3 s outages) under rate faults for
        the whole sweep. Throughput may crater; correctness may not."""
        res_clean = _run_sweep(seed=47, n_workers=4, n_iterations=3)
        clean = _runs_of(res_clean)

        schedule = ChaosSchedule(
            seed=29, delay_rate=0.1, partition_rate=0.1,
            duplicate_rate=0.1, delay_s=0.02,
        )

        def churn(proxies, dispatcher, stop):
            monkey = ChaosMonkey(
                proxies, seed=5, interval_s=0.15, kill_fraction=0.25,
                outage_s=0.3, max_dead=len(proxies) - 1,
            ).start()
            stop.wait()
            monkey.stop()
            assert [e for e in monkey.log if e[2] == "kill"], (
                "churn never killed anything — the matrix proved nothing"
            )

        m = obs.get_metrics()
        recovered0 = (
            m.counter("recovery.requeues").value
            + m.counter("recovery.duplicates_dropped").value
            + m.counter("recovery.replayed_results").value
        )
        journal = str(tmp_path / "churn.jsonl")
        res = _run_sweep(
            seed=47, n_workers=4, n_iterations=3,
            chaos=(schedule, churn), journal=journal,
        )
        assert _runs_of(res) == clean
        assert res.get_incumbent_id() == res_clean.get_incumbent_id()
        _assert_lineage_exactly_once(journal)
        recovered = (
            m.counter("recovery.requeues").value
            + m.counter("recovery.duplicates_dropped").value
            + m.counter("recovery.replayed_results").value
        )
        assert recovered > recovered0, (
            "sustained churn exercised no recovery path at all"
        )
