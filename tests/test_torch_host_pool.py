"""Integration tests for the host tier: NameServer + Dispatcher + Worker
over real localhost TCP — the reference's own integration fixture
(SURVEY.md §4: 'the real RPC stack runs against 127.0.0.1') — on the port
and on the CPU.

The cases of the reference's ``tests/test_host_pool.py``, run on the
port; then the port against the reference, one worker each and one job in
flight at a time: ``HyperBand`` and ``RandomSearch`` over the Dispatcher
give the same (config, budget, loss) set and incumbent in both packages;
``BOHB`` does too with the reference's KDE draws fed through the port's
draw seam (``ReferenceKDEDraws``), its picks' ``lg_score`` within 1e-4 of
the reference's. Workers compute Branin on the host with numpy, so the
losses are exact; a port dispatcher drives a reference worker and the
reverse. Every wait is bounded by the run's own length."""

import threading
import time

import pytest

from hpbandster_tpu_torch.core.nameserver import NameServer
from hpbandster_tpu_torch.core.worker import Worker
from hpbandster_tpu_torch.optimizers import BOHB, HyperBand, RandomSearch

from hpbandster_tpu_torch.workloads.toys import branin_dict, branin_space
from tests.test_torch_harness import ReferenceKDEDraws, ref, ref_host, sequential  # noqa: F401


class BraninWorker(Worker):
    def compute(self, config_id, config, budget, working_directory):
        return {"loss": branin_dict(config, budget), "info": {"budget": budget}}


class CrashyWorker(Worker):
    """Crashes on every config whose x is negative."""

    def compute(self, config_id, config, budget, working_directory):
        if config["x"] < 0:
            raise RuntimeError("intentional crash for x<0")
        return {"loss": branin_dict(config, budget), "info": {}}


class SlowWorker(Worker):
    def compute(self, config_id, config, budget, working_directory):
        time.sleep(0.05)
        return {"loss": branin_dict(config, budget), "info": {}}


@pytest.fixture
def ns():
    ns = NameServer(run_id="t", host="127.0.0.1", port=0)
    host, port = ns.start()
    yield ns, host, port
    ns.shutdown()


def start_workers(cls, n, run_id, port, **kwargs):
    workers = []
    for i in range(n):
        w = cls(
            run_id=run_id, nameserver="127.0.0.1", nameserver_port=port,
            id=i, **kwargs,
        )
        w.run(background=True)
        workers.append(w)
    return workers


class TestNameServer:
    def test_register_list_unregister(self, ns):
        from hpbandster_tpu_torch.parallel.rpc import RPCProxy

        _, host, port = ns
        proxy = RPCProxy(f"{host}:{port}")
        assert proxy.call("ping") == "pong"
        proxy.call("register", name="hpbandster.run_t.worker.a", uri="1.2.3.4:5")
        proxy.call("register", name="other.service", uri="9.9.9.9:9")
        listing = proxy.call("list", prefix="hpbandster.run_t.worker.")
        assert listing == {"hpbandster.run_t.worker.a": "1.2.3.4:5"}
        assert proxy.call("unregister", name="hpbandster.run_t.worker.a") is True
        assert proxy.call("list", prefix="hpbandster.run_t.worker.") == {}

    def test_credentials_file(self, tmp_path):
        ns = NameServer(run_id="cred", working_directory=str(tmp_path))
        host, port = ns.start()
        w = Worker(run_id="cred")
        w.load_nameserver_credentials(str(tmp_path))
        assert (w.nameserver, w.nameserver_port) == (host, port)
        ns.shutdown()


class TestSingleWorker:
    def test_hyperband_sequential(self, ns):
        _, host, port = ns
        workers = start_workers(BraninWorker, 1, "t", port)
        opt = HyperBand(
            configspace=branin_space(seed=0), run_id="t",
            nameserver=host, nameserver_port=port,
            min_budget=1, max_budget=9, eta=3, seed=0,
        )
        res = opt.run(n_iterations=2, min_n_workers=1)
        opt.shutdown(shutdown_workers=True)
        assert len(res.get_all_runs()) == 13 + 6
        assert res.get_incumbent_id() is not None
        # workers got the shutdown signal
        time.sleep(0.3)
        assert workers[0]._shutdown_event.is_set()


class TestParallelWorkers:
    def test_bohb_four_workers(self, ns):
        _, host, port = ns
        start_workers(SlowWorker, 4, "t", port)
        opt = BOHB(
            configspace=branin_space(seed=1), run_id="t",
            nameserver=host, nameserver_port=port,
            min_budget=1, max_budget=9, eta=3, seed=1, min_points_in_model=4,
            device="cpu",
        )
        res = opt.run(n_iterations=3, min_n_workers=4)
        opt.shutdown(shutdown_workers=True)
        runs = res.get_all_runs()
        assert len(runs) == 13 + 6 + 3
        # parallelism actually happened: distinct workers served jobs
        names = {j.worker_name for j in opt.jobs}
        assert len(names) >= 2

    def test_elastic_join_mid_run(self, ns):
        _, host, port = ns
        start_workers(SlowWorker, 1, "t", port)
        opt = HyperBand(
            configspace=branin_space(seed=2), run_id="t",
            nameserver=host, nameserver_port=port,
            min_budget=1, max_budget=9, eta=3, seed=2,
        )
        late = []

        def join_later():
            time.sleep(0.4)
            late.extend(start_workers(SlowWorker, 2, "t", port))

        t = threading.Thread(target=join_later)
        t.start()
        res = opt.run(n_iterations=3, min_n_workers=1)
        t.join()
        opt.shutdown(shutdown_workers=True)
        assert len(res.get_all_runs()) == 22
        assert opt.executor.number_of_workers() >= 1


class TestFailureHandling:
    def test_crashed_configs_recorded_not_fatal(self, ns):
        _, host, port = ns
        start_workers(CrashyWorker, 2, "t", port)
        opt = HyperBand(
            configspace=branin_space(seed=3), run_id="t",
            nameserver=host, nameserver_port=port,
            min_budget=1, max_budget=9, eta=3, seed=3,
        )
        res = opt.run(n_iterations=2, min_n_workers=2)
        opt.shutdown(shutdown_workers=True)
        runs = res.get_all_runs()
        crashed = [r for r in runs if r.loss is None]
        ok = [r for r in runs if r.loss is not None]
        # Branin space straddles x=0, so both kinds must exist
        assert crashed and ok
        assert all("intentional crash" in r.error_logs for r in crashed)
        assert res.get_incumbent_id() is not None

    def test_worker_death_requeues_job(self, ns):
        _, host, port = ns
        [w1] = start_workers(SlowWorker, 1, "kill", port)
        # separate run_id so the other tests' workers don't interfere
        opt = HyperBand(
            configspace=branin_space(seed=4), run_id="kill",
            nameserver=host, nameserver_port=port,
            min_budget=1, max_budget=9, eta=3, seed=4,
        )
        opt.executor.ping_interval = 0.2

        killed = threading.Event()

        def kill_soon():
            time.sleep(0.3)
            # hard-kill: server vanishes without unregistering
            w1._server.shutdown()
            w1._server = None
            start_workers(SlowWorker, 1, "kill", port)
            killed.set()

        t = threading.Thread(target=kill_soon)
        t.start()
        res = opt.run(n_iterations=1, min_n_workers=1)
        t.join()
        opt.shutdown(shutdown_workers=True)
        assert killed.is_set()
        # every one of the bracket's 13 runs completed despite the death
        assert len(res.get_all_runs()) == 13
        assert all(r.loss is not None for r in res.get_all_runs())


# ------------------------------------------------------ against the reference
def _pool_run(pkg_ns, pkg_worker, optimizer, space, seed, n_iterations, **kw):
    """One sweep over a nameserver and one worker: ``pkg_ns`` and
    ``pkg_worker`` name the packages of the nameserver and of the worker,
    the optimizer (and its Dispatcher) is ``optimizer``'s."""
    class W(pkg_worker):
        def compute(self, config_id, config, budget, working_directory):
            return {"loss": branin_dict(config, budget), "info": {}}

    ns = pkg_ns(run_id="x", host="127.0.0.1", port=0)
    host, port = ns.start()
    try:
        W(run_id="x", nameserver=host, nameserver_port=port).run(background=True)
        opt = sequential(optimizer(
            configspace=space, run_id="x", nameserver=host, nameserver_port=port,
            min_budget=1, max_budget=9, eta=3, seed=seed, **kw))
        res = opt.run(n_iterations=n_iterations, min_n_workers=1)
        opt.shutdown(shutdown_workers=True)
    finally:
        ns.shutdown()
    return opt, res


def _runs(res):
    id2c = res.get_id2config_mapping()
    return {(r.config_id, r.budget): (r.loss, id2c[r.config_id]["config"])
            for r in res.get_all_runs()}


@pytest.mark.parametrize("name", ["HyperBand", "RandomSearch"])
def test_random_samplers_over_the_dispatcher_equal_reference(ref, ref_host, name):  # noqa: F811
    """Same seed, one worker: the same runs and incumbent in both packages;
    a port master with a reference nameserver and worker too."""
    ref_cls = getattr(ref_host.optimizers, name)
    cls = {"HyperBand": HyperBand, "RandomSearch": RandomSearch}[name]
    _, want = _pool_run(ref_host.nameserver.NameServer, ref_host.worker.Worker, ref_cls,
                        ref.toys.branin_space(seed=3), 3, 3)
    _, got = _pool_run(NameServer, Worker, cls, branin_space(seed=3), 3, 3)
    _, mixed = _pool_run(ref_host.nameserver.NameServer, ref_host.worker.Worker, cls,
                         branin_space(seed=3), 3, 3)
    assert _runs(got) == _runs(want) == _runs(mixed)
    assert len(_runs(got)) == (22 if name == "HyperBand" else 17)
    assert got.get_incumbent_id() == want.get_incumbent_id() == mixed.get_incumbent_id()


def test_bohb_over_the_dispatcher_equals_reference(ref, ref_host):  # noqa: F811
    """BOHB on Branin, 1..9, 3 brackets, seed 0, one reference worker
    behind a port master: with the reference's candidate draws injected,
    every run has the reference's config, budget and loss (exact), the
    same ``model_based_pick`` and ``lg_score`` within 1e-4."""
    _, want = _pool_run(ref_host.nameserver.NameServer, ref_host.worker.Worker,
                        ref_host.optimizers.BOHB, ref.toys.branin_space(seed=0), 0, 3,
                        min_points_in_model=4)
    class Seeded(BOHB):
        def __init__(self, **kw):
            super().__init__(device="cpu", min_points_in_model=4, **kw)
            self.config_generator.draws = ReferenceKDEDraws(ref, trickle_seed=0)

    opt, got = _pool_run(NameServer, ref_host.worker.Worker, Seeded, branin_space(seed=0), 0, 3)
    assert _runs(got) == _runs(want)
    assert got.get_incumbent_id() == want.get_incumbent_id()
    id2c, id2c_ref = got.get_id2config_mapping(), want.get_id2config_mapping()
    picks = 0
    for cid, v in id2c_ref.items():
        info, info_ref = id2c[cid]["config_info"], v["config_info"]
        assert info["model_based_pick"] == info_ref["model_based_pick"], cid
        if "lg_score" in info_ref:
            assert abs(info["lg_score"] - info_ref["lg_score"]) <= 1e-4 + 2e-6
        picks += info["model_based_pick"]
    assert picks >= 3


def test_model_runs_under_the_master_lock(ns):
    """Over the Dispatcher, results arrive on the RPC handler threads while
    the master thread samples: every call into the config generator (the
    model's device work: refits in ``new_result``, scoring in
    ``get_config``) runs with the master's lock held, by whichever thread
    makes it."""
    _, host, port = ns
    start_workers(SlowWorker, 2, "lock", port)
    opt = BOHB(configspace=branin_space(seed=6), run_id="lock", nameserver=host,
               nameserver_port=port, min_budget=1, max_budget=9, eta=3, seed=6,
               min_points_in_model=4, device="cpu")
    cg, calls = opt.config_generator, []

    def guarded(name):
        fn = getattr(cg, name)

        def call(*args, **kwargs):
            calls.append((name, threading.current_thread().name, opt.thread_cond._is_owned()))
            return fn(*args, **kwargs)

        setattr(cg, name, call)

    for name in ("get_config", "new_result"):
        guarded(name)
    opt.run(n_iterations=3, min_n_workers=2)
    opt.shutdown(shutdown_workers=True)
    assert {n for n, _, _ in calls} == {"get_config", "new_result"}
    assert len({t for n, t, _ in calls if n == "new_result"}) >= 2  # handler threads
    assert all(owned for _, _, owned in calls)
