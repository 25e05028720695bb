"""The counterpart of the reference's root entry module
(``hpbandster_tpu_torch/entry.py``) on the CPU.

Held as ``tests/test_graft_entry.py`` holds the reference's: the child's
command line and environment, and a failed child surfacing its exit code
(both with a faked ``subprocess.run``). Further: ``entry(device="cpu")``
against the reference's ``entry()`` on the same weights, every entry point
raising without a card where no device is given, the meshed checkpoint
round trip (the dry run's stage (b)) on meshes of 2 and 8 repeated ``cpu``
positions, and the whole ``dryrun_multichip(8, device="cpu")`` child (slow,
as the reference's is).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import entry as port_entry
from hpbandster_tpu_torch.convert import params_from_numpy
from hpbandster_tpu_torch.workloads.mlp import MLPConfig
from tests.test_torch_harness import REPO, ref, ref_wl  # noqa: F401


class _Done:
    def __init__(self, returncode, stdout="", stderr=""):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


def test_dryrun_child_argv_and_env(monkeypatch, capsys):
    """The child is ``python -m hpbandster_tpu_torch.entry --dryrun-child
    <n> --device <dev>`` with the repository on its path; the parent's
    other variables pass through untouched (no platform or XLA pinning),
    and the child's stdout is forwarded."""
    captured = {}

    def fake_run(cmd, env=None, **kwargs):
        captured.update(cmd=cmd, env=env, kwargs=kwargs)
        return _Done(0, "dryrun: stage\ndryrun child: OK\n")

    monkeypatch.setenv("JAX_PLATFORMS", "no_such_platform")
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    monkeypatch.setattr(subprocess, "run", fake_run)
    port_entry.dryrun_multichip(8, device="cpu")
    assert captured["cmd"] == [sys.executable, "-m", "hpbandster_tpu_torch.entry",
                               "--dryrun-child", "8", "--device", "cpu"]
    env = captured["env"]
    assert env["PYTHONPATH"].split(":") == [str(REPO), "/elsewhere"]
    assert env["JAX_PLATFORMS"] == "no_such_platform"
    assert env["XLA_FLAGS"] == "--xla_force_host_platform_device_count=2"
    assert captured["kwargs"]["timeout"] == port_entry.CHILD_TIMEOUT_S
    assert capsys.readouterr().out == "dryrun: stage\ndryrun child: OK\n"


def test_dryrun_child_failure_surfaces(monkeypatch):
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: _Done(3, "partial output", "boom"))
    with pytest.raises(RuntimeError, match="rc=3") as info:
        port_entry.dryrun_multichip(4, device="cpu")
    assert "partial output" in str(info.value) and "boom" in str(info.value)


def test_entry_points_raise_without_a_card(monkeypatch):
    """``device=None`` means CUDA: without it ``entry()`` and
    ``dryrun_multichip`` raise, and no child starts."""
    def no_child(*args, **kwargs):
        raise AssertionError("a child process started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(subprocess, "run", no_child)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.run_dryrun(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.main([])


def test_entry_matches_the_reference_on_the_same_weights(ref_wl):  # noqa: F811
    """The port's forward and example input against the reference's
    ``entry()`` (jitted), the reference's weights carried with a lane axis:
    logits ``[1, 32, 8]`` against ``[32, 8]``."""
    import jax

    sys.path.insert(0, str(REPO))
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.remove(str(REPO))
    r_fn, (r_params, r_x) = graft.entry()
    want = np.asarray(jax.jit(r_fn)(r_params, r_x))
    fn, (params, x) = port_entry.entry(device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: (1,) + tuple(np.shape(v)) for k, v in r_params.items()}
    np.testing.assert_array_equal(x.numpy(), np.asarray(r_x))
    carried = params_from_numpy({k: np.asarray(v)[None] for k, v in r_params.items()})
    with torch.no_grad():
        got = fn(carried, x)
        own = fn(params, x)
    assert got.shape == (1, 32, 8) and want.shape == (32, 8)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-5)
    assert own.shape == (1, 32, 8) and bool(torch.isfinite(own).all())


@pytest.mark.parametrize("fit", ["0", "1"])
@pytest.mark.parametrize("n", [2, 8])
def test_meshed_checkpoint_round_trip(n, fit, monkeypatch):
    """The dry run's stage (b): a chunked meshed ``FusedBOHB`` stopped at a
    chunk boundary, restored into a fresh meshed optimizer and finished,
    equals the uninterrupted run bit for bit (35 runs of Branin, 1..9), with
    the two-pass fit and with the masked-moment fit
    (``HPB_PALLAS_KDE_FIT``)."""
    monkeypatch.setenv("HPB_PALLAS_KDE_FIT", fit)
    mesh = port_entry.dryrun_mesh(n, torch.device("cpu"))
    assert mesh.shape == {"config": n // 2, "model": 2}
    assert port_entry.meshed_checkpoint_round_trip(mesh) == 35


@pytest.mark.parametrize("n", [8, 3])
def test_tensor_parallel_stage(n):
    """The dry run's stage (a) at the reference's tiny shapes (``width = 4 *
    model_par``, ``2 * config_par`` lanes), on an even mesh (``(4, 2)``) and
    an odd one (``(3, 1)``)."""
    mesh = port_entry.dryrun_mesh(n, torch.device("cpu"))
    c, m = mesh.shape["config"], mesh.shape["model"]
    assert (c, m) == ((4, 2) if n == 8 else (3, 1))
    cfg = MLPConfig(d_in=8, width=4 * m, n_classes=4, batch_size=16)
    out = port_entry.tensor_parallel_stage(mesh, cfg, 2 * c, "cpu")
    assert out["n_configs"] == 2 * c and out["max_dw1"] > 0
    assert out["max_abs_err_vs_unsplit"] < 1e-5


@pytest.mark.slow
def test_dryrun_multichip_on_the_cpu(capfd):
    """The whole dry run through its child on 8 ``cpu`` positions: every
    stage's line, the two gloo ranks included."""
    port_entry.dryrun_multichip(8, device="cpu")
    out = capfd.readouterr().out
    for stage in ("tensor-parallel train step OK", "fused bracket OK",
                  "fused whole-sweep OK", "fused conditional-space sweep OK",
                  "fused mesh checkpoint/resume OK", "seq-parallel ring attention OK",
                  "fused 2-process gloo sweep OK", "dryrun child: OK"):
        assert f"{stage}" in out, out
