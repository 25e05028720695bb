"""Multi-host batched tier: TPUBatchedWorker + RPCBatchBackend over real
localhost TCP — one RPC per *wave* of configs instead of one per config
(SURVEY.md §2 "Task parallel" row: TPUBatchedWorker evaluating a vector of
configs per job) — on the port and on the CPU (``device="cpu"``).

The cases of the reference's ``tests/test_batched_worker.py``, run on the
port; then: a BOHB run over ``RPCBatchBackend`` with two port workers
equals, bit for bit, the same run over an in-process ``VmapBackend`` with
bracket fusion off (Branin is row-wise, so a wave split two ways gives the
same losses); the executor over the RPC backend takes the stage-by-stage
way even with its default ``bucket_brackets=True``; losses cross the wire
as Python floats; a reference batched worker serves a port backend.
Every wait is bounded (``wait_for_workers(timeout=)``)."""

import threading
import time

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.core.nameserver import NameServer
from hpbandster_tpu_torch.core.successive_halving import JaxSuccessiveHalving
from hpbandster_tpu_torch.core.worker import Worker
from hpbandster_tpu_torch.optimizers import BOHB, HyperBand
from hpbandster_tpu_torch.parallel import BatchedExecutor, RPCBatchBackend, TPUBatchedWorker

from hpbandster_tpu_torch.workloads.toys import branin, branin_dict, branin_space
from tests.test_torch_harness import ref, ref_host  # noqa: F401


@pytest.fixture
def ns():
    ns = NameServer(run_id="tb", host="127.0.0.1", port=0)
    host, port = ns.start()
    yield ns, host, port
    ns.shutdown()


def start_batched_workers(n, port, run_id="tb", **kwargs):
    workers = []
    for i in range(n):
        w = TPUBatchedWorker(
            run_id=run_id,
            eval_fn=branin,
            configspace=branin_space(seed=i),
            device="cpu",
            nameserver="127.0.0.1",
            nameserver_port=port,
            id=i,
            **kwargs,
        )
        w.run(background=True)
        workers.append(w)
    return workers


class TestEvaluateBatchRPC:
    def test_single_worker_wave(self, ns):
        _, host, port = ns
        workers = start_batched_workers(1, port)
        try:
            backend = RPCBatchBackend("tb", host, port)
            backend.wait_for_workers(1, timeout=10)
            cs = branin_space(seed=0)
            vectors = cs.sample_vectors(17)
            losses = backend.evaluate(vectors, budget=81.0)
            assert losses.shape == (17,)
            assert np.all(np.isfinite(losses))
            # parity with the direct on-device path
            direct = branin(torch.from_numpy(vectors), 81.0).numpy()
            np.testing.assert_allclose(losses, direct, rtol=1e-5)
        finally:
            for w in workers:
                w.shutdown()

    def test_wave_splits_across_workers(self, ns):
        _, host, port = ns
        workers = start_batched_workers(3, port)
        try:
            backend = RPCBatchBackend("tb", host, port)
            backend.wait_for_workers(3, timeout=10)
            assert backend.parallelism >= 3
            vectors = branin_space(seed=1).sample_vectors(31)
            losses = backend.evaluate(vectors, budget=27.0)
            assert losses.shape == (31,)
            assert np.all(np.isfinite(losses))
        finally:
            for w in workers:
                w.shutdown()

    def test_plain_workers_ignored_by_pool(self, ns):
        """Dict-workers behind the same nameserver never join the batch pool."""
        _, host, port = ns

        class PlainWorker(Worker):
            def compute(self, config_id, config, budget, working_directory):
                return {"loss": branin_dict(config, budget), "info": {}}

        plain = PlainWorker(
            run_id="tb", nameserver="127.0.0.1", nameserver_port=port, id="plain"
        )
        plain.run(background=True)
        workers = start_batched_workers(1, port)
        try:
            backend = RPCBatchBackend("tb", host, port)
            backend.wait_for_workers(1, timeout=10)
            backend.refresh_workers(force=True)
            assert len(backend._workers) == 1
            name = next(iter(backend._workers))
            assert ".plain" not in name
        finally:
            plain.shutdown()
            for w in workers:
                w.shutdown()

    def test_worker_death_midrun_retries_on_survivor(self, ns):
        _, host, port = ns
        workers = start_batched_workers(2, port)
        try:
            backend = RPCBatchBackend("tb", host, port)
            backend.wait_for_workers(2, timeout=10)
            # kill one worker after discovery: its shard must be retried on
            # the survivor, not NaN-filled
            workers[0].shutdown()
            import time

            time.sleep(0.3)
            vectors = branin_space(seed=2).sample_vectors(16)
            losses = backend.evaluate(vectors, budget=9.0)
            assert np.all(np.isfinite(losses))
        finally:
            for w in workers:
                w.shutdown()

    def test_nonfinite_losses_survive_the_wire(self, ns):
        """NaN (crashed) and +/-inf (diverged) round-trip the JSON RPC
        exactly, so local and remote backends agree on identical inputs."""
        _, host, port = ns

        def spiky(vecs, budget):
            # vec[0] buckets: <0.25 -> +inf, <0.5 -> nan, else finite
            x = vecs[:, 0]
            return torch.where(
                x < 0.25, torch.inf, torch.where(x < 0.5, torch.nan, x))

        w = TPUBatchedWorker(
            run_id="tb", eval_fn=spiky, device="cpu",
            nameserver="127.0.0.1", nameserver_port=port, id="spiky",
        )
        w.run(background=True)
        try:
            backend = RPCBatchBackend("tb", host, port)
            backend.wait_for_workers(1, timeout=10)
            vectors = np.array([[0.1, 0], [0.3, 0], [0.9, 0]], np.float32)
            losses = backend.evaluate(vectors, budget=1.0)
            assert np.isposinf(losses[0])
            assert np.isnan(losses[1])
            np.testing.assert_allclose(losses[2], 0.9, rtol=1e-6)
        finally:
            w.shutdown()

    def test_busy_during_wave(self, ns):
        """is_busy reports True while a wave is evaluating (watchdog /
        dispatcher double-booking guard)."""
        import time

        _, host, port = ns

        def slow(vecs, budget):
            # a wave that takes a while: many small matmuls
            c = torch.eye(64)
            for _ in range(400):
                c = c @ c * 1e-3 + 1.0
            time.sleep(0.2)
            return vecs[:, 0] + c.sum() * 0

        w = TPUBatchedWorker(
            run_id="tb", eval_fn=slow, device="cpu",
            nameserver="127.0.0.1", nameserver_port=port, id="slow",
        )
        w.run(background=True)
        try:
            backend = RPCBatchBackend("tb", host, port)
            backend.wait_for_workers(1, timeout=10)
            vecs = np.random.default_rng(0).random((64, 2)).astype(np.float32)
            t = threading.Thread(
                target=backend.evaluate, args=(vecs, 1.0), daemon=True
            )
            t.start()
            from hpbandster_tpu_torch.parallel.rpc import RPCProxy

            uri = w._server.uri
            saw_busy = False
            deadline = time.time() + 20
            while t.is_alive() and time.time() < deadline:
                if RPCProxy(uri, timeout=5).call("is_busy"):
                    saw_busy = True
                    break
                time.sleep(0.01)
            t.join(timeout=60)
            assert saw_busy, "worker never reported busy during a wave"
        finally:
            w.shutdown()

    def test_no_workers_gives_nan_wave(self, ns):
        _, host, port = ns
        backend = RPCBatchBackend("tb", host, port, max_retries=0)
        losses = backend.evaluate(np.zeros((4, 2), np.float32), budget=1.0)
        assert losses.shape == (4,)
        assert np.all(np.isnan(losses))


class TestEndToEnd:
    def test_bohb_over_rpc_batch_backend(self, ns, tmp_path):
        """Full BOHB run where every stage is one RPC wave per worker."""
        _, host, port = ns
        workers = start_batched_workers(2, port)
        try:
            cs = branin_space(seed=3)
            backend = RPCBatchBackend("tb", host, port)
            backend.wait_for_workers(2, timeout=10)
            # no eval_fn attribute on the RPC backend -> no bracket fusion;
            # stage batching still applies
            executor = BatchedExecutor(backend, cs)
            opt = BOHB(
                configspace=cs, run_id="tb", executor=executor,
                min_budget=1, max_budget=9, eta=3, seed=0, device="cpu",
            )
            res = opt.run(n_iterations=2)
            opt.shutdown()
            runs = res.get_all_runs()
            assert len(runs) > 0
            assert res.get_incumbent_id() is not None
            assert all(np.isfinite(r.loss) for r in runs)
        finally:
            for w in workers:
                w.shutdown()

    def test_batched_worker_serves_single_config_jobs(self, ns):
        """Compatibility: the plain dispatcher path drives a TPUBatchedWorker."""
        _, host, port = ns
        workers = start_batched_workers(1, port)
        try:
            opt = HyperBand(
                configspace=branin_space(seed=4), run_id="tb",
                nameserver=host, nameserver_port=port,
                min_budget=1, max_budget=9, eta=3, seed=0,
            )
            res = opt.run(n_iterations=1, min_n_workers=1)
            opt.shutdown()
            assert len(res.get_all_runs()) > 0
        finally:
            for w in workers:
                w.shutdown()


class TestJaxSuccessiveHalving:
    def test_on_device_promotion_matches_host_rule(self):
        from hpbandster_tpu_torch.ops.bracket import sh_promotion_mask_np

        it = JaxSuccessiveHalving(
            HPB_iter=0,
            num_configs=[9, 3, 1],
            budgets=[1.0, 3.0, 9.0],
            config_sampler=lambda b: ({"x": 0.0}, {}),
            device="cpu",
        )
        rng = np.random.default_rng(0)
        losses = rng.normal(size=9)
        losses[4] = np.nan  # crashed config never promoted
        mask = it._advance_to_next_stage([None] * 9, losses)
        np.testing.assert_array_equal(mask, sh_promotion_mask_np(losses, 3))
        assert not mask[4]
        assert mask.sum() == 3

    def test_bohb_with_jax_iteration_class(self):
        from hpbandster_tpu_torch.parallel import VmapBackend

        cs = branin_space(seed=5)
        executor = BatchedExecutor(VmapBackend(branin, device="cpu"), cs)
        opt = BOHB(
            configspace=cs, run_id="tb-jaxit", executor=executor,
            min_budget=1, max_budget=9, eta=3, seed=0, device="cpu",
            iteration_class=JaxSuccessiveHalving,
        )
        res = opt.run(n_iterations=2)
        opt.shutdown()
        assert isinstance(opt.iterations[0], JaxSuccessiveHalving)
        assert len(res.get_all_runs()) > 0


# --------------------------------------------------------- parity and wire
def _bohb(executor, seed=0):
    opt = BOHB(configspace=branin_space(seed=seed), run_id="tb", executor=executor,
               min_budget=1, max_budget=27, eta=3, seed=seed, min_points_in_model=4,
               device="cpu")
    res = opt.run(n_iterations=4)
    opt.shutdown()
    return opt, res


def test_rpc_backend_equals_vmap_backend_in_process(ns):
    """Two port workers behind ``RPCBatchBackend`` and the in-process
    ``VmapBackend`` (fusion off): the same configs, budgets and losses,
    bit for bit, and every wave split over both workers."""
    from hpbandster_tpu_torch import obs
    from hpbandster_tpu_torch.parallel import VmapBackend

    _, host, port = ns
    workers = start_batched_workers(2, port)
    m = obs.get_metrics()
    retries0 = m.counter("rpc.batch_shard_retries").value
    filled0 = m.counter("rpc.batch_nan_filled").value
    try:
        backend = RPCBatchBackend("tb", host, port)
        backend.wait_for_workers(2, timeout=10)
        assert backend.parallelism == 2  # one device each
        rpc_ex = BatchedExecutor(backend, branin_space(seed=0))
        _, got = _bohb(rpc_ex)
    finally:
        for w in workers:
            w.shutdown()
    local_ex = BatchedExecutor(VmapBackend(branin, device="cpu"), branin_space(seed=0),
                               fuse_brackets=False)
    _, want = _bohb(local_ex)
    runs = lambda res: sorted((r.config_id, r.budget, r.loss) for r in res.get_all_runs())
    assert runs(got) == runs(want)
    assert got.get_incumbent_id() == want.get_incumbent_id()
    assert m.counter("rpc.batch_shard_retries").value == retries0
    assert m.counter("rpc.batch_nan_filled").value == filled0
    # without eval_fn the executor cannot fuse or bucket: stage by stage
    assert not rpc_ex.fuse_brackets and not rpc_ex.bucket_brackets
    assert rpc_ex.fused_brackets_run == 0


def test_losses_cross_the_wire_as_python_floats(ns):
    """The worker's reply holds Python floats only (json writes NaN and
    Infinity as literals), and the proxy sends Python floats."""
    import json

    _, host, port = ns
    [w] = start_batched_workers(1, port)
    try:
        x = np.array([[0.1, 0.2], [0.7, 0.4]], np.float32)
        reply = w._rpc_evaluate_batch(x.tolist(), 3.0)
        assert all(type(v) is float for v in reply["losses"])
        json.dumps(reply)
        np.testing.assert_array_equal(
            np.array(reply["losses"], np.float32), branin(torch.from_numpy(x), 3.0).numpy())
        assert w._rpc_capabilities() == {"batch": True, "devices": 1}
    finally:
        w.shutdown()


def test_reference_batched_worker_serves_a_port_backend(ref, ref_host, ns):  # noqa: F811
    """A reference ``TPUBatchedWorker`` (the reference's own objective, on
    its CPU jax) behind a port ``RPCBatchBackend``: the wave's losses equal
    the reference's own evaluation (exact: the numbers only cross JSON)."""
    _, host, port = ns
    w = ref_host.batched_worker.TPUBatchedWorker(
        run_id="tb", eval_fn=ref.toys.branin_from_vector, mesh=None,
        nameserver="127.0.0.1", nameserver_port=port, id="ref")
    w.run(background=True)
    try:
        backend = RPCBatchBackend("tb", host, port)
        backend.wait_for_workers(1, timeout=10)
        x = np.random.default_rng(0).random((9, 2)).astype(np.float32)
        got = backend.evaluate(x, 3.0)
        want = w.backend.evaluate(x, 3.0)
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    finally:
        w.shutdown()
