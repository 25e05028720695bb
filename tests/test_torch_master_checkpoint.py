"""Master checkpoints of the port's Master-driven optimizers
(``hpbandster_tpu_torch/core/checkpoint.py``, the Master half): a run
saved mid-way and loaded into a fresh optimizer finishes with exactly the
result of the uninterrupted run, on the CPU."""

import pickle
import shutil

import pytest

from hpbandster_tpu_torch.core import checkpoint as ckpt
from hpbandster_tpu_torch.core.successive_halving import SuccessiveResampling
from hpbandster_tpu_torch.optimizers import BOHB, H2BO, FusedBOHB, HyperBand
from hpbandster_tpu_torch.parallel import BatchedExecutor, VmapBackend
from hpbandster_tpu_torch.workloads.toys import branin, branin_space
from tests.test_torch_harness import ref, ref_opt  # noqa: F401  (fixtures)


def make(cls, seed=0, max_budget=27, **kw):
    cs = branin_space(seed=seed)
    ex = BatchedExecutor(VmapBackend(branin, device="cpu"), cs)
    if cls is not HyperBand:
        kw.setdefault("device", "cpu")
        kw.setdefault("min_points_in_model", 4)
    return cls(configspace=cs, run_id="ckpt", executor=ex, min_budget=1,
               max_budget=max_budget, eta=3, seed=seed, **kw)


def runs_of(res):
    id2c = res.get_id2config_mapping()
    return sorted(
        (r.config_id, r.budget, r.loss, tuple(sorted(id2c[r.config_id]["config"].items())),
         id2c[r.config_id]["config_info"].get("model_based_pick"))
        for r in res.get_all_runs())


@pytest.mark.parametrize("cls", [BOHB, H2BO, HyperBand])
def test_resume_at_a_bracket_boundary_equals_uninterrupted(cls, tmp_path):
    path = str(tmp_path / "master.pkl")
    want = runs_of(make(cls).run(n_iterations=6))
    victim = make(cls)
    victim.run(n_iterations=2)
    victim.save_checkpoint(path)
    resumed = make(cls)
    resumed.load_checkpoint(path)
    assert runs_of(resumed.run(n_iterations=6)) == want


@pytest.mark.parametrize("cls,at,kw", [(BOHB, 10, {}), (BOHB, 35, {}), (H2BO, 35, {}),
                                       (BOHB, 27, {"iteration_class": SuccessiveResampling})])
def test_resume_mid_bracket_equals_uninterrupted(cls, at, kw, tmp_path, monkeypatch):
    """The automatic checkpoint written after result ``at`` of bracket 0
    (27, 9, 3, 1 configs: the 10th inside the fused stage-0 wave, whose
    other jobs roll back to QUEUED and are evaluated again after the
    resume; the 35th in stage 2; with ``SuccessiveResampling`` the 27th,
    where stage 1 still has fresh samples to draw after the resume)
    continues to the uninterrupted result."""
    path, mid = str(tmp_path / "auto.pkl"), str(tmp_path / "mid.pkl")
    want = runs_of(make(cls, **kw).run(n_iterations=5))
    saves = []
    orig = ckpt.save_checkpoint

    def counting(master, p):
        orig(master, p)
        saves.append(p)
        if len(saves) == at:
            shutil.copy(p, mid)

    monkeypatch.setattr(ckpt, "save_checkpoint", counting)
    victim = make(cls, checkpoint_path=path, checkpoint_interval=0.0, **kw)
    victim.run(n_iterations=5)
    monkeypatch.setattr(ckpt, "save_checkpoint", orig)
    with open(mid, "rb") as fh:
        state = pickle.load(fh)
    assert any(not it["is_finished"] for it in state["iterations"])
    resumed = make(cls, **kw)
    resumed.load_checkpoint(mid)
    assert runs_of(resumed.run(n_iterations=5)) == want


def test_checkpoint_guards(ref, ref_opt, tmp_path):  # noqa: F811
    """A shape mismatch, a fused-tier checkpoint and the reference's BOHB
    checkpoint (its generator's stream is a jax key) are refused."""
    path = str(tmp_path / "master.pkl")
    opt = make(BOHB)
    opt.run(n_iterations=1)
    opt.save_checkpoint(path)
    with pytest.raises(ValueError, match="shape mismatch"):
        make(BOHB, max_budget=9).load_checkpoint(path)

    fused_path = str(tmp_path / "fused.pkl")
    fused = FusedBOHB(configspace=branin_space(seed=0), eval_fn=branin, min_budget=1,
                      max_budget=9, device="cpu")
    fused.run(n_iterations=1, checkpoint_path=fused_path)
    with pytest.raises(ValueError, match="fused-tier"):
        make(BOHB, max_budget=9).load_checkpoint(fused_path)

    ref_path = str(tmp_path / "reference.pkl")
    cs = ref.toys.branin_space(seed=0)
    ref_bohb = ref_opt.optimizers.BOHB(
        configspace=cs, run_id="ref", min_budget=1, max_budget=27, eta=3, seed=0,
        executor=ref_opt.parallel.BatchedExecutor(
            ref_opt.parallel.VmapBackend(ref.toys.branin_from_vector), cs,
            bucket_brackets=False))
    ref_bohb.run(n_iterations=1)
    ref_bohb.save_checkpoint(ref_path)
    with pytest.raises(ValueError, match="jax key"):
        make(BOHB).load_checkpoint(ref_path)
