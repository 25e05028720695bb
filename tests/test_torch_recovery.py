"""Elastic recovery — exactly-once replay, WAL crash-restart, requeue
budgets, quarantine (core/recovery.py + parallel/dispatcher.py), on the
port and on the CPU.

The cases of the reference's ``tests/test_recovery.py``, run on the port;
then the port against the reference: ``idempotency_key`` is the same
string in both packages, a WAL either package writes the other reads to
equal records (exact: the same JSON lines), and a BOHB run over the RPC
Dispatcher, checkpointed and journaled, cut mid-bracket and resumed with
``Master.resume``, equals the uninterrupted run exactly (its workers
compute the same numpy objective).

The contracts pinned here are the ones docs/fault_tolerance.md promises:
every copy of a result (delivery retry racing a slow ack, late arrival
from a presumed-dead worker, dead-letter replay on resubmit) joins the
run EXACTLY once; a crash-restart from checkpoint + WAL tail re-runs
only genuinely unfinished configs; a job whose workers keep dying fails
after a capped requeue budget instead of hot-looping; and a flapping
worker is quarantined — dropped AND banned from rediscovery — when the
anomaly detector names it.
"""

import json
import math
import os
import threading
import time

import numpy as np
import pytest

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.core.job import Job
from hpbandster_tpu_torch.core.recovery import (
    DeadLetterBox,
    ExactlyOnceGate,
    ResultWAL,
    idempotency_key,
)
from hpbandster_tpu_torch.optimizers import BOHB
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend
from hpbandster_tpu_torch.parallel.dispatcher import Dispatcher, WorkerProxy

from hpbandster_tpu_torch.workloads.toys import branin, branin_dict, branin_space
from tests.test_torch_harness import ref, ref_host, sequential  # noqa: F401


class TestIdempotencyKey:
    def test_stable_across_budget_spellings(self):
        # 9 and 9.0 are one rung (journal-reader %g convention)
        assert idempotency_key((0, 0, 3), 9) == idempotency_key((0, 0, 3), 9.0)

    def test_distinct_budgets_and_configs_distinct(self):
        k = idempotency_key
        assert len({
            k((0, 0, 0), 1), k((0, 0, 0), 3), k((0, 0, 1), 1), k((1, 0, 0), 1)
        }) == 4

    def test_requeue_computes_the_same_key(self):
        # the whole point: a redispatch is the SAME logical evaluation
        job = Job((2, 0, 5), config={}, budget=3.0)
        job.requeue_count = 4
        assert idempotency_key(job.id, 3.0) == idempotency_key((2, 0, 5), 3.0)


class TestExactlyOnceGate:
    def test_admit_once(self):
        g = ExactlyOnceGate()
        assert g.admit("k") is True
        assert g.admit("k") is False
        assert g.seen("k") and not g.seen("other")
        assert len(g) == 1

    def test_mark_preadmits(self):
        g = ExactlyOnceGate()
        g.mark(["a", "b"])
        assert g.admit("a") is False and g.admit("c") is True

    def test_thread_safety_one_winner(self):
        g = ExactlyOnceGate()
        wins = []
        barrier = threading.Barrier(8)

        def race():
            barrier.wait()
            if g.admit("contested"):
                wins.append(1)

        threads = [threading.Thread(target=race) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(wins) == 1


class TestResultWAL:
    def test_append_read_roundtrip_first_per_key_wins(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        wal = ResultWAL(path)
        assert wal.append("a", (0, 0, 0), 1.0, {"loss": 0.5}, None) is True
        assert wal.append("a", (0, 0, 0), 1.0, {"loss": 9.9}, None) is False
        assert wal.append("b", (0, 0, 1), 3.0, None, "boom") is True
        wal.close()
        recs = ResultWAL.read(path)
        assert [r["key"] for r in recs] == ["a", "b"]
        assert recs[0]["result"] == {"loss": 0.5}
        assert recs[1]["exception"] == "boom"

    def test_truncated_final_line_tolerated(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        wal = ResultWAL(path)
        wal.append("a", (0, 0, 0), 1.0, {"loss": 0.5}, None)
        wal.close()
        with open(path, "a") as fh:
            fh.write('{"key": "b", "config_id"')  # crash mid-append
        assert [r["key"] for r in ResultWAL.read(path)] == ["a"]

    def test_corrupt_interior_line_skipped(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        good = {"key": "z", "config_id": [0, 0, 1], "budget": 1.0,
                "result": None, "exception": None, "timestamps": {}}
        with open(path, "w") as fh:
            fh.write("not json at all\n")
            fh.write(json.dumps(good) + "\n")
        assert [r["key"] for r in ResultWAL.read(path)] == ["z"]

    def test_reopen_continues_dedup_from_disk(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        wal = ResultWAL(path)
        wal.append("a", (0, 0, 0), 1.0, {"loss": 0.5}, None)
        wal.close()
        # a restarted master appending to the same path must not
        # double-record a key it already holds
        wal2 = ResultWAL(path)
        assert wal2.append("a", (0, 0, 0), 1.0, {"loss": 0.5}, None) is False
        assert wal2.append("b", (0, 0, 1), 1.0, {"loss": 0.7}, None) is True
        wal2.close()
        assert len(ResultWAL.read(path)) == 2

    def test_truncate_clears_state_and_disk(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        wal = ResultWAL(path)
        wal.append("a", (0, 0, 0), 1.0, {"loss": 0.5}, None)
        wal.truncate()
        # the checkpoint now carries 'a'; the key is appendable again and
        # the file restarts empty
        assert ResultWAL.read(path) == []
        assert wal.append("b", (0, 0, 1), 1.0, {"loss": 0.1}, None) is True
        wal.close()

    def test_reused_path_across_runs_neither_dedups_nor_replays(
        self, tmp_path
    ):
        """Idempotency keys restart at (0,0,0)@1 every run: run B reusing
        run A's wal_path must journal normally (A's leftovers must not
        pre-seed B's dedup) and a resume must never join A's losses."""
        from hpbandster_tpu_torch.core.recovery import _run_matches

        path = str(tmp_path / "wal.jsonl")
        a = ResultWAL(path, run_id="run-A")
        assert a.append("0-0-0@1", (0, 0, 0), 1.0, {"loss": 0.9}, None)
        a.close()

        b = ResultWAL(path, run_id="run-B")
        # same key, different run: NOT suppressed
        assert b.append("0-0-0@1", (0, 0, 0), 1.0, {"loss": 0.1}, None)
        b.close()
        recs = ResultWAL.read(path)
        # read() keeps first-per-key (post-mortem surface) but replay
        # filters by run identity
        assert [_run_matches(r, "run-B") for r in recs] == [False]
        assert _run_matches(recs[0], "run-A")
        # legacy unstamped records keep matching any run
        assert _run_matches({"key": "k"}, "run-B")

    def test_foreign_run_records_skipped_on_resume(self, tmp_path):
        """Crash-restart with a reused wal_path: the other run's records
        pass the QUEUED-at-that-budget eligibility check (every fresh
        bracket looks alike) and MUST be rejected by run identity."""
        ckpt = str(tmp_path / "state.pkl")
        wal = str(tmp_path / "wal.jsonl")
        victim = make_opt()  # run_id "recover"
        it = victim.get_next_iteration(0, {})
        victim.iterations.append(it)
        stage0 = [it.get_next_run() for _ in range(9)]
        victim.save_checkpoint(ckpt)
        # a previous run's WAL leftovers under the same path
        other = ResultWAL(wal, run_id="someone-else")
        for cid, config, budget in stage0[:4]:
            other.append(
                idempotency_key(cid, budget), cid, budget,
                {"loss": 123.0}, None,
            )
        other.close()
        victim.shutdown()

        resumed = make_opt()
        stats = resumed.resume(ckpt, wal)
        assert stats == {"replayed": 0, "skipped": 4}
        for cid, config, budget in stage0[:4]:
            d = resumed.iterations[0].data[cid]
            assert budget not in d.results  # 123.0 never joined
        resumed.shutdown()

    def test_nonfinite_floats_nulled_not_poisonous(self, tmp_path):
        path = str(tmp_path / "wal.jsonl")
        wal = ResultWAL(path)
        wal.append(
            "n", (0, 0, 0), 1.0,
            {"loss": float("nan"), "info": {"lc": [1.0, float("inf")]}},
            None,
        )
        wal.close()
        rec = ResultWAL.read(path)[0]  # strict readers must not choke
        assert rec["result"]["loss"] is None
        assert rec["result"]["info"]["lc"] == [1.0, None]


class TestDeadLetterBox:
    def test_overflow_counted_not_silent(self):
        box = DeadLetterBox(capacity=2)
        before = obs.get_metrics().counter(
            "dispatcher.dead_letters_dropped"
        ).value
        for i in range(5):
            box.append({"key": f"k{i}", "config_id": [0, 0, i]})
        assert len(box) == 2
        assert box.dropped == 3
        assert [e["key"] for e in box.snapshot()] == ["k3", "k4"]
        assert obs.get_metrics().counter(
            "dispatcher.dead_letters_dropped"
        ).value == before + 3

    def test_duplicate_key_retained_once(self):
        """Chaos duplicate frames of the same stranded result: one
        payload is enough to replay — the copy is counted as a duplicate
        instead of occupying (and eventually evicting) box slots."""
        m = obs.get_metrics()
        dups0 = m.counter("recovery.duplicates_dropped").value
        box = DeadLetterBox(capacity=4)
        box.append({"key": "k1", "result": {"n": 1}})
        box.append({"key": "k1", "result": {"n": 2}})
        assert len(box) == 1
        assert m.counter("recovery.duplicates_dropped").value == dups0 + 1
        assert box.take("k1")["result"] == {"n": 1}  # first copy wins
        # keyless letters (old workers) are never collapsed
        box.append({"key": None, "result": {}})
        box.append({"key": None, "result": {}})
        assert len(box) == 2

    def test_take_by_key(self):
        box = DeadLetterBox(capacity=4)
        box.append({"key": "a", "config_id": [0, 0, 0]})
        box.append({"key": "b", "config_id": [0, 0, 1]})
        assert box.take("b")["config_id"] == [0, 0, 1]
        assert box.take("b") is None
        assert len(box) == 1


class TestDispatcherExactlyOnce:
    """Direct-call dispatcher tests (no background threads started)."""

    def _dispatcher(self, **kw):
        d = Dispatcher(run_id="xonce", **kw)
        delivered = []
        d._new_result_callback = delivered.append
        d._new_worker_callback = lambda n: None
        return d, delivered

    def _running_job(self, d, cid=(0, 0, 1), budget=3.0):
        job = Job(cid, config={}, budget=budget)
        job.idem_key = idempotency_key(cid, budget)
        job.time_it("submitted")
        with d._cond:
            d.running_jobs[cid] = job
        return job

    def test_worker_retry_duplicate_acked_once(self):
        """The register_result retry race (core/worker.py): a retry after
        a lost ack redelivers the same key — the first copy joins, the
        second is acked as a duplicate, the callback fires ONCE."""
        d, delivered = self._dispatcher()
        job = self._running_job(d)
        m = obs.get_metrics()
        dups0 = m.counter("recovery.duplicates_dropped").value
        payload = {"result": {"loss": 0.25}, "exception": None}
        assert d._rpc_register_result([0, 0, 1], payload, key=job.idem_key)
        # the retry copy: same key, job no longer running
        assert d._rpc_register_result([0, 0, 1], payload, key=job.idem_key)
        assert len(delivered) == 1
        assert delivered[0].result == {"loss": 0.25}
        assert m.counter("recovery.duplicates_dropped").value == dups0 + 1

    def test_late_result_claims_requeued_waiting_job(self):
        """A presumed-dead worker's late result lands while its requeued
        job is still WAITING: the evaluation is done — claim it from the
        queue, never re-run it."""
        d, delivered = self._dispatcher()
        job = Job((1, 0, 2), config={}, budget=9.0)
        job.idem_key = idempotency_key((1, 0, 2), 9.0)
        job.time_it("submitted")
        with d._cond:
            d.waiting_jobs.append(job)  # requeued, not yet redispatched
        assert d._rpc_register_result(
            [1, 0, 2], {"result": {"loss": 0.1}, "exception": None},
            key=job.idem_key,
        )
        assert delivered == [job]
        with d._cond:
            assert not d.waiting_jobs  # claimed, not left to redispatch

    def test_dead_letter_joins_back_on_resubmit_exactly_once(self):
        """Crash-restart replay: a result arrives for a job nobody knows
        (dead-lettered, keyed); resubmitting the job joins the stranded
        payload back — once. A second stranded copy is a counted dup."""
        d, delivered = self._dispatcher()
        m = obs.get_metrics()
        key = idempotency_key((2, 0, 0), 1.0)
        payload = {"result": {"loss": 0.4}, "exception": None}
        assert d._rpc_register_result([2, 0, 0], payload, key=key) is False
        assert len(d.dead_letters) == 1
        replays0 = m.counter("recovery.replayed_results").value

        job = Job((2, 0, 0), config={}, budget=1.0)
        job.time_it("submitted")
        d.submit_job(job)
        assert delivered == [job]
        assert job.result == {"loss": 0.4}
        with d._cond:
            assert not d.waiting_jobs  # joined, never queued for dispatch
        assert m.counter("recovery.replayed_results").value == replays0 + 1
        # the same key arriving again is a duplicate now, not a new letter
        assert d._rpc_register_result([2, 0, 0], payload, key=key) is True
        assert len(d.dead_letters) == 0 and len(delivered) == 1

    def test_dead_letter_capacity_knob(self):
        d, _ = self._dispatcher(dead_letter_capacity=3)
        assert d.dead_letters.capacity == 3

    def test_keyless_old_worker_still_exactly_once(self):
        """A pre-recovery worker omits the key: the dispatcher recovers
        it from its own job record and the gate still holds."""
        d, delivered = self._dispatcher()
        self._running_job(d, cid=(3, 0, 0), budget=3.0)
        payload = {"result": {"loss": 0.2}, "exception": None}
        assert d._rpc_register_result([3, 0, 0], payload)  # no key kwarg
        assert len(delivered) == 1
        # replayed copy with the derived key is recognized
        assert d._rpc_register_result(
            [3, 0, 0], payload, key=idempotency_key((3, 0, 0), 3.0)
        )
        assert len(delivered) == 1

    def test_cross_budget_duplicate_never_claims_live_job(self):
        """A config re-runs at every rung with the SAME cid: a late
        duplicate of the budget-1 delivery arriving while the promoted
        budget-9 job is in flight must be acked as a duplicate WITHOUT
        claiming (and discarding) the live job."""
        d, delivered = self._dispatcher()
        cid = (5, 0, 0)
        key1 = idempotency_key(cid, 1.0)
        assert d._gate.admit(key1)  # budget-1 result already ingested
        job9 = self._running_job(d, cid=cid, budget=9.0)
        payload1 = {"result": {"loss": 0.9}, "exception": None}
        assert d._rpc_register_result(list(cid), payload1, key=key1)
        assert not delivered  # nothing mis-registered at budget 9
        with d._cond:
            assert d.running_jobs[cid] is job9  # live job untouched
        # the real budget-9 result still lands normally
        assert d._rpc_register_result(
            list(cid), {"result": {"loss": 0.1}, "exception": None},
            key=job9.idem_key,
        )
        assert delivered == [job9] and job9.result == {"loss": 0.1}

    def test_cross_budget_unknown_key_dead_letters_without_claiming(self):
        """Same cid race, but the foreign-budget key was never ingested:
        it dead-letters (keyed, replayable) instead of being registered
        as the live job's result at the wrong budget."""
        d, delivered = self._dispatcher()
        cid = (6, 0, 0)
        job9 = self._running_job(d, cid=cid, budget=9.0)
        key1 = idempotency_key(cid, 1.0)
        assert d._rpc_register_result(
            list(cid), {"result": {"loss": 0.7}, "exception": None}, key=key1
        ) is False
        assert not delivered
        with d._cond:
            assert d.running_jobs[cid] is job9
        assert len(d.dead_letters) == 1
        assert d.dead_letters.take(key1)["result"]["result"] == {"loss": 0.7}

    def test_requeue_budget_exhausted_fails_job(self):
        d, delivered = self._dispatcher(
            max_job_requeues=2, requeue_backoff=0.01, requeue_backoff_cap=0.02
        )
        m = obs.get_metrics()
        exhausted0 = m.counter("recovery.requeue_budget_exhausted").value
        job = Job((4, 0, 0), config={}, budget=1.0)
        job.idem_key = idempotency_key((4, 0, 0), 1.0)
        job.time_it("submitted")
        for attempt in range(3):
            with d._cond:
                w = WorkerProxy(f"w{attempt}", "127.0.0.1:1")
                w.runs_job = job.id
                d.workers[f"w{attempt}"] = w
                d.running_jobs[tuple(job.id)] = job
            d._drop_worker(f"w{attempt}", reason="test crash")
            if attempt < 2:
                # still within budget: requeued with a backoff stamp
                with d._cond:
                    assert d.waiting_jobs.pop(0) is job
                assert job.not_before_mono > time.monotonic() - 0.1
                assert not delivered
        assert job.requeue_count == 3
        assert len(delivered) == 1  # failed terminally, exactly once
        assert delivered[0].exception is not None
        assert "requeue budget exhausted" in delivered[0].exception
        with d._cond:
            assert not d.waiting_jobs
        assert m.counter("recovery.requeue_budget_exhausted").value == \
            exhausted0 + 1

    def test_dispatch_failure_requeue_obeys_budget_and_backoff(self):
        """The job-runner's dispatch-failure path rides the SAME bounded
        retry contract as a worker death: backoff stamps within budget,
        terminal failure through the gate beyond it — a payload every
        worker rejects must not hot-loop the pool."""
        d, delivered = self._dispatcher(
            max_job_requeues=2, requeue_backoff=0.01, requeue_backoff_cap=0.02
        )
        job = Job((7, 0, 0), config={}, budget=1.0)
        job.idem_key = idempotency_key((7, 0, 0), 1.0)
        job.time_it("submitted")
        for attempt in (1, 2):
            d._requeue_or_fail(job, "w0", reason="dispatch failed: boom")
            assert job.requeue_count == attempt
            assert job.not_before_mono > time.monotonic() - 0.1
            with d._cond:
                assert d.waiting_jobs.pop(0) is job
            assert not delivered
        d._requeue_or_fail(job, "w0", reason="dispatch failed: boom")
        assert len(delivered) == 1
        assert "requeue budget exhausted" in delivered[0].exception
        with d._cond:
            assert not d.waiting_jobs

    def test_backoff_grows_and_caps(self):
        d, _ = self._dispatcher(
            max_job_requeues=8, requeue_backoff=0.1, requeue_backoff_cap=0.3
        )
        delays = []
        job = Job((5, 0, 0), config={}, budget=1.0)
        job.idem_key = idempotency_key((5, 0, 0), 1.0)
        for attempt in range(4):
            with d._cond:
                w = WorkerProxy("w", "127.0.0.1:1")
                w.runs_job = job.id
                d.workers["w"] = w
                d.running_jobs[tuple(job.id)] = job
            t0 = time.monotonic()
            d._drop_worker("w", reason="crash")
            delays.append(job.not_before_mono - t0)
            with d._cond:
                d.waiting_jobs.clear()
        assert delays[0] == pytest.approx(0.1, abs=0.05)
        assert delays[1] == pytest.approx(0.2, abs=0.05)
        assert delays[2] == pytest.approx(0.3, abs=0.05)  # capped
        assert delays[3] == pytest.approx(0.3, abs=0.05)

    def test_quarantine_blocks_rediscovery_until_expiry(self):
        d, _ = self._dispatcher(quarantine_s=0.2)
        name = d.prefix + "flappy"
        with d._cond:
            w = WorkerProxy(name, "127.0.0.1:1")
            d.workers[name] = w
        m = obs.get_metrics()
        q0 = m.counter("recovery.quarantines").value
        d.quarantine_worker(name, reason="worker_flapping")
        assert m.counter("recovery.quarantines").value == q0 + 1
        with d._cond:
            assert name not in d.workers
        # rediscovery is a no-op while quarantined (the listing offers a
        # URI nobody answers; a non-quarantined worker would be probed)
        d._sync_workers({name: "127.0.0.1:1"})
        with d._cond:
            assert name not in d.workers
        time.sleep(0.25)
        # expired: the name is probe-able again (dead URI, so still not
        # added — but the quarantine ledger no longer lists it)
        d._sync_workers({name: "127.0.0.1:1"})
        with d._cond:
            assert name not in d._quarantined

    def test_worker_flapping_alert_triggers_quarantine(self):
        """The anomaly loop closes: a worker_flapping alert on the bus
        quarantines the named worker instead of just being counted."""
        from hpbandster_tpu_torch.obs.events import make_event

        d, _ = self._dispatcher()
        mine = d.prefix + "w1"
        with d._cond:
            d.workers[mine] = WorkerProxy(mine, "127.0.0.1:1")
        try:
            d._on_alert(make_event("alert", {
                "rule": "worker_flapping", "subject": mine, "count": 3,
            }))
            with d._cond:
                assert mine not in d.workers
                assert mine in d._quarantined
            # foreign subjects (another run's workers) are not ours to act on
            d._on_alert(make_event("alert", {
                "rule": "worker_flapping", "subject": "hpbandster.run_other.worker.x",
            }))
            with d._cond:
                assert "hpbandster.run_other.worker.x" not in d._quarantined
            # other rules pass through
            d._on_alert(make_event("alert", {
                "rule": "straggler", "subject": mine + "zz",
            }))
            with d._cond:
                assert mine + "zz" not in d._quarantined
        finally:
            pass


def make_opt(seed=11, wal_path=None, **kw):
    cs = branin_space(seed=seed)
    executor = BatchedExecutor(VmapBackend(branin, device="cpu"), cs)
    return BOHB(
        configspace=cs, run_id="recover", executor=executor,
        min_budget=1, max_budget=9, eta=3, seed=seed, device="cpu",
        # pure seeded sampling: the model never activates, so the sampled
        # configs — and therefore the whole trajectory — are independent
        # of result-arrival order (what makes recovery runs comparable)
        min_points_in_model=10_000,
        wal_path=wal_path, **kw,
    )


class TestCrashRestartResume:
    def test_checkpoint_plus_wal_tail_resumes_without_rerunning(self, tmp_path):
        """The crash window: checkpoint at t0, four results arrive (WAL
        only), crash. resume() = restore checkpoint + replay WAL tail;
        the finished run matches an undisturbed reference bit-for-bit and
        every evaluation is recorded exactly once across both lives."""
        ckpt = str(tmp_path / "state.pkl")
        wal = str(tmp_path / "wal.jsonl")

        ref = make_opt()
        res_ref = ref.run(n_iterations=1)
        ref.shutdown()
        loss_of = {
            (r.config_id, r.budget): r.loss for r in res_ref.get_all_runs()
        }
        assert len(loss_of) == 13  # eta=3, 1..9 ladder: 9 + 3 + 1 stages

        # --- the doomed first life -------------------------------------
        victim = make_opt(wal_path=wal)
        it = victim.get_next_iteration(0, {})
        victim.iterations.append(it)
        stage0 = [it.get_next_run() for _ in range(9)]
        assert all(r is not None for r in stage0)
        victim.save_checkpoint(ckpt)  # everything QUEUED on restore
        for cid, config, budget in stage0[:4]:
            job = Job(cid, config=config, budget=budget)
            job.idem_key = idempotency_key(cid, budget)
            job.time_it("submitted")
            job.time_it("started")
            job.result = {"loss": loss_of[(cid, budget)], "info": {}}
            job.time_it("finished")
            victim.job_callback(job)
        assert len(ResultWAL.read(wal)) == 4
        del victim  # crash: no shutdown, no final checkpoint

        # --- second life ------------------------------------------------
        resumed = make_opt(wal_path=wal)
        stats = resumed.resume(ckpt, wal)
        assert stats == {"replayed": 4, "skipped": 0}
        res = resumed.run(n_iterations=1)
        resumed.shutdown()

        got = {(r.config_id, r.budget): r.loss for r in res.get_all_runs()}
        want = {
            (r.config_id, r.budget): r.loss for r in res_ref.get_all_runs()
        }
        # same trajectory: identical (config, budget) work-set and losses.
        # Loss equality is float-tolerance, not bitwise: the restored
        # mid-bracket life evaluates per-stage while the reference fused
        # the whole bracket — numerically-twin tiers by design (the
        # fused-tier checkpoint test owns the bitwise guarantee).
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5)
        # the replayed results joined VERBATIM — the fed values, not
        # re-evaluations
        for cid, config, budget in stage0[:4]:
            assert got[(cid, budget)] == loss_of[(cid, budget)]
        assert res.get_incumbent_id() == res_ref.get_incumbent_id()
        # exactly-once across both lives: 13 unique keys, none re-recorded
        keys = [r["key"] for r in ResultWAL.read(wal)]
        assert len(keys) == len(set(keys)) == 13

    def test_resume_seeds_executor_gate_with_ingested_keys(self, tmp_path):
        """A first-life worker that survives the crash and rediscovers
        the new pool re-delivers its result: the restored executor's
        exactly-once gate must already know every key the checkpoint
        accounts for (recovery.ingested_keys / ExactlyOnceGate.mark)."""
        from hpbandster_tpu_torch.core.recovery import ingested_keys

        ckpt = str(tmp_path / "state.pkl")
        victim = make_opt()
        victim.run(n_iterations=1)
        victim.save_checkpoint(ckpt)
        victim.shutdown()

        resumed = make_opt()
        gate = ExactlyOnceGate()
        resumed.executor._gate = gate  # the dispatcher carries one
        resumed.resume(ckpt)
        keys = ingested_keys(resumed)
        assert len(keys) == 13  # every recorded rung result
        for k in keys:
            assert gate.seen(k), f"{k} not pre-admitted after resume"
        resumed.shutdown()

    def test_wal_truncates_after_checkpoint(self, tmp_path):
        ckpt = str(tmp_path / "state.pkl")
        wal = str(tmp_path / "wal.jsonl")
        opt = make_opt(
            wal_path=wal, checkpoint_path=ckpt, checkpoint_interval=0.0
        )
        opt.run(n_iterations=1)
        opt.shutdown()
        # interval 0: a checkpoint follows every result, so the WAL tail
        # is empty — the checkpoint carries the state now
        assert ResultWAL.read(wal) == []
        assert os.path.exists(ckpt)

    def test_stale_wal_records_skipped_not_double_counted(self, tmp_path):
        """WAL records the restored checkpoint already holds (recorded
        AFTER the results) replay as skipped, never double-registered."""
        ckpt = str(tmp_path / "state.pkl")
        wal = str(tmp_path / "wal.jsonl")
        victim = make_opt(wal_path=wal)
        it = victim.get_next_iteration(0, {})
        victim.iterations.append(it)
        stage0 = [it.get_next_run() for _ in range(9)]
        for cid, config, budget in stage0[:3]:
            job = Job(cid, config=config, budget=budget)
            job.idem_key = idempotency_key(cid, budget)
            job.time_it("submitted")
            job.result = {"loss": 0.5, "info": {}}
            job.time_it("finished")
            victim.job_callback(job)
        # checkpoint AFTER the results, via the low-level path that does
        # NOT truncate the WAL — the stale-tail shape a torn shutdown or
        # a copied artifact can produce
        from hpbandster_tpu_torch.core.checkpoint import save_checkpoint

        save_checkpoint(victim, ckpt)
        del victim

        resumed = make_opt()
        stats = resumed.resume(ckpt, wal)
        assert stats == {"replayed": 0, "skipped": 3}
        resumed.shutdown()


class TestWorkerStampsKeyOnEveryAttempt:
    def test_retry_carries_same_idempotency_key(self, tmp_path):
        """Regression (the satellite fix): a delivery retry racing a slow
        ack used to arrive keyless and register twice. Every attempt now
        carries the SAME idempotency key, so the dispatcher's gate can
        recognize the second copy."""
        from hpbandster_tpu_torch.core.worker import Worker
        from hpbandster_tpu_torch.parallel.rpc import RPCServer

        seen = []
        srv = RPCServer("127.0.0.1", 0)

        def register_result(id, result, key=None):
            seen.append((tuple(id), key))
            if len(seen) == 1:
                # the ack of the FIRST copy is lost after the handler ran
                raise RuntimeError("synthetic lost ack")
            return True

        srv.register("register_result", register_result)
        srv.start()

        class W(Worker):
            def compute(self, config_id, config, budget, working_directory):
                return {"loss": 0.0, "info": {}}

        w = W(run_id="stamp", nameserver="127.0.0.1")
        w.result_delivery_backoff = 0.01
        w.result_delivery_backoff_cap = 0.02
        try:
            assert w._deliver_result(
                srv.uri, (0, 0, 7), {"result": {"loss": 0.0}}, budget=3.0
            ) is True
        finally:
            srv.shutdown()
        assert len(seen) == 2  # original + retry: BOTH copies keyed
        expected = idempotency_key((0, 0, 7), 3.0)
        assert [k for _, k in seen] == [expected, expected]

    def test_unknown_budget_delivers_keyless(self, tmp_path):
        # defensive: a job without a numeric budget still delivers (the
        # dispatcher falls back to its own job record for the key)
        from hpbandster_tpu_torch.core.worker import Worker
        from hpbandster_tpu_torch.parallel.rpc import RPCServer

        seen = []
        srv = RPCServer("127.0.0.1", 0)
        srv.register(
            "register_result",
            lambda id, result, key=None: seen.append(key) or True,
        )
        srv.start()

        class W(Worker):
            def compute(self, config_id, config, budget, working_directory):
                return {"loss": 0.0, "info": {}}

        w = W(run_id="stamp2", nameserver="127.0.0.1")
        try:
            assert w._deliver_result(
                srv.uri, (0, 0, 8), {"result": {"loss": 0.0}}, budget=None
            ) is True
        finally:
            srv.shutdown()
        assert seen == [None]


# ------------------------------------------------------ against the reference
def test_idempotency_key_equals_reference(ref_host):  # noqa: F811
    rng = np.random.default_rng(0)
    for _ in range(50):
        cid = tuple(int(x) for x in rng.integers(0, 100, size=3))
        budget = float(rng.choice([1, 3, 9, 27, 81, 0.5, 1e-3, 1e6]))
        for b in (budget, int(budget) if budget.is_integer() else budget):
            assert idempotency_key(cid, b) == ref_host.recovery.idempotency_key(cid, b)
            assert idempotency_key(list(cid), b) == ref_host.recovery.idempotency_key(
                list(cid), b)


def _fill_wal(wal_cls, path, run_id):
    """Append the same records through one package's ``ResultWAL``: a
    finished result, a crashed one, a non-finite loss (nulled), a numpy
    scalar (coerced) and a duplicate key (dropped)."""
    w = wal_cls(path, run_id=run_id)
    w.append("0-0-0@1", (0, 0, 0), 1.0, {"loss": 0.25, "info": {"a": [1, 2]}}, None,
             {"submitted": 1.0, "finished": 2.0})
    w.append("0-0-1@1", (0, 0, 1), 1.0, None, "Traceback: boom", {})
    w.append("0-0-2@3", (0, 0, 2), 3, {"loss": math.inf, "info": {}}, None, None)
    w.append("0-0-3@9", (0, 0, 3), 9.0, {"loss": np.float32(0.5), "info": {}}, None, None)
    assert w.append("0-0-0@1", (0, 0, 0), 1.0, {"loss": 9.0}, None, None) is False
    w.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wal_is_read_by_the_other_package(ref_host, tmp_path, writer):  # noqa: F811
    """A WAL written by either package reads to equal records in both; a
    reopened WAL of the other package continues its dedup set and ignores
    another run's records."""
    path = str(tmp_path / "wal.jsonl")
    wal_w, wal_r = ((ResultWAL, ref_host.recovery.ResultWAL) if writer == "port"
                    else (ref_host.recovery.ResultWAL, ResultWAL))
    _fill_wal(wal_w, path, run_id="r1")
    mine, theirs = ResultWAL.read(path), ref_host.recovery.ResultWAL.read(path)
    assert mine == theirs
    assert [r["key"] for r in mine] == ["0-0-0@1", "0-0-1@1", "0-0-2@3", "0-0-3@9"]
    assert mine[2]["result"]["loss"] is None and mine[3]["result"]["loss"] == 0.5
    assert all(r["run_id"] == "r1" for r in mine)
    reopened = wal_r(path, run_id="r1")
    assert reopened.keys() == {r["key"] for r in mine}
    assert reopened.append("0-0-1@1", (0, 0, 1), 1.0, None, "again", None) is False
    reopened.close()
    assert wal_r(path, run_id="other").keys() == set()


class _BraninWorker:
    """A plain worker computing Branin on the host (numpy): the same
    losses in every package and process."""

    def compute(self, config_id, config, budget, working_directory):
        return {"loss": branin_dict(config, budget), "info": {}}


def test_dispatcher_run_resumes_to_the_uninterrupted_run(tmp_path):
    """BOHB over the Dispatcher with one worker, a WAL and checkpoints: the
    uninterrupted run's state is captured at a cut a bracket and a half in
    (its checkpoint taken while a result is being ingested, and the WAL a
    few results later); a fresh master resumed from them replays the WAL's
    eligible records and finishes with the same (config, budget, loss)
    set and incumbent."""
    from hpbandster_tpu_torch.core.checkpoint import save_checkpoint
    from hpbandster_tpu_torch.core.nameserver import NameServer
    from hpbandster_tpu_torch.core.worker import Worker

    class W(_BraninWorker, Worker):
        pass

    ckpt, wal = str(tmp_path / "cut.pkl"), str(tmp_path / "wal.jsonl")
    cut_wal = str(tmp_path / "cut_wal.jsonl")
    ns = NameServer(run_id="resume", host="127.0.0.1", port=0)
    host, port = ns.start()
    w = W(run_id="resume", nameserver=host, nameserver_port=port)
    w.run(background=True)
    seen = []

    class Cut:
        """The result logger that takes the cut: called under the master's
        lock, after the result's WAL append and before its bookkeeping."""

        def new_config(self, *args):
            pass

        def __call__(self, job):
            seen.append(job)
            if len(seen) == 16:  # bracket 0 (13 runs), half of bracket 1 (6)
                save_checkpoint(opt, ckpt)
            if len(seen) == 19:
                with open(wal) as src, open(cut_wal, "w") as dst:
                    dst.write(src.read())

    def make(**kw):
        return sequential(BOHB(
            configspace=branin_space(seed=5), run_id="resume", nameserver=host,
            nameserver_port=port, min_budget=1, max_budget=9, eta=3, seed=5,
            min_points_in_model=4, device="cpu", **kw))

    try:
        opt = make(result_logger=Cut(), wal_path=wal)
        full = opt.run(n_iterations=3, min_n_workers=1)
        opt.shutdown()
        assert len(seen) == 22 and os.path.exists(cut_wal)
        resumed = make()
        stats = resumed.resume(ckpt, cut_wal)
        res = resumed.run(n_iterations=3, min_n_workers=1)
        resumed.shutdown(shutdown_workers=True)
    finally:
        ns.shutdown()
    want = {(r.config_id, r.budget): r.loss for r in full.get_all_runs()}
    got = {(r.config_id, r.budget): r.loss for r in res.get_all_runs()}
    assert got == want
    assert res.get_incumbent_id() == full.get_incumbent_id()
    assert stats["replayed"] >= 1 and stats["skipped"] >= 15
