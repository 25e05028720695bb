"""SLOs and their alert lifecycle (``hpbandster_tpu_torch.obs.slo`` and
``obs.alerts``), held against the reference's.

The same records, made from a seed with numpy
(``test_torch_harness.synth_journal``), feed both packages'
``SLOEvaluator`` and ``AlertManager``: the measurements, the pending ->
firing -> resolved transitions, the published gauges and the snapshots
must be equal, under the default pack and under a fast pack whose short
windows fire on a journal of seconds. Live, the manager journals each
transition as one ``slo_alert`` event and keeps the ``slo.<name>.*``
gauges.
"""

import dataclasses

import pytest

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.obs import alerts, slo
from hpbandster_tpu_torch.obs.events import EventBus
from hpbandster_tpu_torch.obs.journal import RingBuffer
from hpbandster_tpu_torch.obs.metrics import MetricsRegistry
from tests.test_torch_harness import ref, ref_obs_all, synth_journal  # noqa: F401

SEEDS = [0, 1, 2, 3]


def fast_pack(m):
    """Specs over ``m`` (either package's ``slo`` module) with windows of
    seconds: the synthetic journals burn through them."""
    windows = (m.BurnWindow(short_s=0.5, long_s=2.0, burn=2.0, severity="page"),
               m.BurnWindow(short_s=2.0, long_s=8.0, burn=1.0, severity="ticket"))
    return [
        m.SLOSpec(name="admission_fast", objective=0.9,
                  total=m.Selector(event="serve_admission"),
                  good_when=m.Selector(field="wait_s", le=0.25), windows=windows,
                  clear_for_s=1.0),
        m.SLOSpec(name="jobs_ok", objective=0.95,
                  total=m.Selector(event=("job_finished", "job_failed")),
                  bad=m.Selector(event="job_failed"), windows=windows, for_s=0.2,
                  clear_for_s=0.5),
        m.SLOSpec(name="device_crashes", objective=0.9,
                  total=m.Selector(event="device_telemetry"),
                  total_field="evaluations", bad_field="crashes", windows=windows),
        m.SLOSpec(name="fresh_model", objective=0.9,
                  total=m.Selector(event=("sweep_chunk", "serve_chunk")),
                  fresh=m.Selector(event="kde_refit"), max_age_s=0.5, windows=windows),
    ]


def test_default_pack_equals_the_reference(ref_obs_all):
    mine = [dataclasses.asdict(s) for s in slo.default_slo_pack()]
    theirs = [dataclasses.asdict(s) for s in ref_obs_all.slo.default_slo_pack()]
    assert mine == theirs
    assert [dataclasses.asdict(w) for w in slo.DEFAULT_WINDOWS] == \
        [dataclasses.asdict(w) for w in ref_obs_all.slo.DEFAULT_WINDOWS]
    with pytest.raises(ValueError, match="duplicate"):
        slo.SLOEvaluator(slo.default_slo_pack() * 2)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pack", ["default", "fast"])
def test_evaluator_measurements_equal_the_reference(ref_obs_all, seed, pack):
    rs = ref_obs_all.slo
    specs = slo.default_slo_pack() if pack == "default" else fast_pack(slo)
    ref_specs = rs.default_slo_pack() if pack == "default" else fast_pack(rs)
    mine, theirs = slo.SLOEvaluator(specs), rs.SLOEvaluator(ref_specs)
    touched = 0
    for rec in synth_journal(seed):
        a, b = mine.update(rec), theirs.update(rec)
        assert a == b
        touched += len(a)
    assert touched > 0
    assert mine.measure_all() == theirs.measure_all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pack", ["default", "fast"])
def test_alert_transitions_equal_the_reference(ref_obs_all, seed, pack):
    records = synth_journal(seed)
    ra = ref_obs_all.alerts
    specs = None if pack == "default" else fast_pack(slo)
    ref_specs = None if pack == "default" else fast_pack(ref_obs_all.slo)
    mine = alerts.scan_slo_records(records, specs)
    theirs = ra.scan_slo_records(records, ref_specs)
    assert list(mine.transitions) == list(theirs.transitions)
    assert mine.published() == theirs.published()
    assert mine.snapshot() == theirs.snapshot()
    if pack == "fast":
        states = {t["state"] for t in mine.transitions}
        assert "firing" in states, states


def test_live_manager_journals_transitions_and_publishes_gauges():
    """With a bus, every transition is one ``slo_alert`` event and the
    ``slo.<name>.{burn_rate,budget_remaining,state}`` gauges follow; the
    offline replay of the same records equals the live manager."""
    records = synth_journal(2)
    bus, registry, ring = EventBus(), MetricsRegistry(), RingBuffer(10_000)
    bus.subscribe(ring)
    live = alerts.AlertManager(specs=fast_pack(slo), bus=bus, registry=registry)
    for rec in records:
        live.process(rec)
    emitted = [e for e in ring.snapshot() if e.name == obs.SLO_ALERT]
    assert len(emitted) == len(live.transitions) > 0
    assert [(e.fields["slo"], e.fields["state"]) for e in emitted] == \
        [(t["slo"], t["state"]) for t in live.transitions]
    gauges = registry.snapshot()["gauges"]
    for name in ("admission_fast", "jobs_ok"):
        assert {f"slo.{name}.burn_rate", f"slo.{name}.state"} <= set(gauges)
    offline = alerts.scan_slo_records(records, fast_pack(slo))
    assert offline.published() == live.published()
    assert [(t["slo"], t["state"]) for t in offline.transitions] == \
        [(t["slo"], t["state"]) for t in live.transitions]
    # a replayed journal skips the manager's own output
    assert live.process({"event": obs.SLO_ALERT, "t_wall": 1.0}) == []


def test_configure_slo_takes_a_custom_pack(tmp_path):
    specs = fast_pack(slo)
    with obs.configure(journal_path=str(tmp_path / "j.jsonl"), slo=specs) as h:
        assert [s.name for s in h.slo.specs] == [s.name for s in specs]
        assert h.anomaly is None
    assert not obs.get_bus().active
