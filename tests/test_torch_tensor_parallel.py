"""The tensor-parallel batched MLP step (``hpbandster_tpu_torch/parallel/tensor_parallel.py``)
on the CPU: the tree's layout over a ``("config", "model")`` mesh and its
gather, the split step against the unsplit port step
(``workloads/mlp.py::sgd_train_step_batch``) and against the reference's
jitted step with the shardings of its root entry module on its eight
virtual CPU devices, the gradients against the unsplit loss's, and two
gloo ranks (``tests/torch_tensor_parallel_child.py``) against one process.

Tolerance: float32, ``rtol 1e-5`` / ``atol 1e-6``. The row-parallel sum of
the partial logits and the reduce-scatter of the hidden gradients reorder
additions, so a split over two or more model shards is not bit-equal to
the unsplit step; a ``(1, 1)`` mesh is.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.convert import params_from_numpy
from hpbandster_tpu_torch.parallel.mesh import config_mesh, config_model_mesh
from hpbandster_tpu_torch.parallel.tensor_parallel import (
    MODEL_SPLIT,
    gather_mlp_params,
    mlp_grads_tp,
    sgd_train_step_batch_tp,
    shard_mlp_params,
)
from hpbandster_tpu_torch.workloads.mlp import (
    MLPConfig,
    _xent,
    mlp_forward,
    sgd_train_step_batch,
)
from tests.test_torch_harness import REPO, ref, ref_wl  # noqa: F401
from tests.torch_tensor_parallel_child import inputs

CHILD = REPO / "tests" / "torch_tensor_parallel_child.py"
RTOL, ATOL = 1e-5, 1e-6
RANK_TIMEOUT_S = 180
CFG = MLPConfig(d_in=8, width=8, n_classes=4, batch_size=16)
N_LANES = 8


def cpu_mesh(config_par, model_par):
    return config_model_mesh(config_par, ["cpu"] * (config_par * model_par))


def torch_inputs():
    params, velocity, x, y, hp = inputs(N_LANES, CFG.d_in, CFG.width, CFG.n_classes,
                                        CFG.batch_size)
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in velocity.items()},
            torch.from_numpy(x), torch.from_numpy(y),
            [torch.from_numpy(hp[k]) for k in ("lrs", "momenta", "wds")])


def split_step(mesh, params, velocity, x, y, hp):
    new_p, new_v, losses = sgd_train_step_batch_tp(
        shard_mlp_params(params, mesh), shard_mlp_params(velocity, mesh), x, y, *hp, mesh)
    return gather_mlp_params(new_p, mesh), gather_mlp_params(new_v, mesh), losses


def assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 1), (4, 2), (2, 2), (2, 4), (8, 1)])
def test_layout_and_gather_round_trip(shape):
    """Every owned block is the reference's ``PartitionSpec`` slice of its
    leaf (lanes over ``config``; ``w1``/``b1``/``w2``/``b2`` columns, ``w3``
    rows over ``model``; ``b3`` whole), and the gather restores the tree
    bit for bit."""
    params = torch_inputs()[0]
    mesh = cpu_mesh(*shape)
    shards = shard_mlp_params(params, mesh)
    C, M = shape
    assert sorted(shards) == [(c, m) for c in range(C) for m in range(M)]
    per = N_LANES // C
    for (c, m), block in shards.items():
        for k, leaf in params.items():
            want = leaf[c * per:(c + 1) * per]
            dim = MODEL_SPLIT[k]
            if dim is not None:
                w = leaf.shape[dim] // M
                want = want.narrow(dim, m * w, w)
            assert torch.equal(block[k], want), (k, c, m)
    back = gather_mlp_params(shards, mesh)
    assert all(torch.equal(back[k], params[k]) for k in params)


def test_layout_refuses_what_does_not_split():
    params = torch_inputs()[0]
    with pytest.raises(ValueError, match="config shards"):
        shard_mlp_params(params, cpu_mesh(3, 1))
    with pytest.raises(ValueError, match="model shards"):
        shard_mlp_params(params, cpu_mesh(1, 3))
    with pytest.raises(ValueError, match="'config', 'model'"):
        shard_mlp_params(params, config_mesh(["cpu"] * 2))


def test_split_step_on_one_position_is_the_unsplit_step_bit_for_bit():
    params, velocity, x, y, hp = torch_inputs()
    got_p, got_v, got_l = split_step(cpu_mesh(1, 1), params, velocity, x, y, hp)
    want_p, want_v, want_l = sgd_train_step_batch(params, velocity, x, y, *hp)
    assert all(torch.equal(got_p[k], want_p[k]) for k in want_p)
    assert all(torch.equal(got_v[k], want_v[k]) for k in want_v)
    assert torch.equal(got_l, want_l)


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (2, 4)])
def test_split_step_matches_the_unsplit_step(shape):
    params, velocity, x, y, hp = torch_inputs()
    got_p, got_v, got_l = split_step(cpu_mesh(*shape), params, velocity, x, y, hp)
    want_p, want_v, want_l = sgd_train_step_batch(params, velocity, x, y, *hp)
    for k in want_p:
        assert_close(got_p[k], want_p[k])
        assert_close(got_v[k], want_v[k])
    assert got_l.shape == (N_LANES,)
    assert_close(got_l, want_l)
    # the split really moved every weight, as the unsplit step does
    assert float((got_p["w1"] - params["w1"]).abs().max()) > 0


@pytest.mark.parametrize("shape", [(1, 1), (4, 2), (2, 2), (2, 4)])
def test_gradients_match_the_unsplit_loss(shape):
    """The gathered split gradients equal ``torch.autograd.grad`` of the
    unsplit per-lane losses, and every position's losses (replicated over
    ``model``) its config shard's unsplit losses."""
    params, _, x, y, _ = torch_inputs()
    mesh = cpu_mesh(*shape)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    losses = _xent(mlp_forward(leaves, x), y)
    want = torch.autograd.grad(losses, list(leaves.values()), torch.ones_like(losses))
    shards = shard_mlp_params(params, mesh)
    grads, got_losses = mlp_grads_tp(shards, x, y, mesh)
    got = gather_mlp_params(grads, mesh)
    for k, g in zip(leaves, want):
        assert_close(got[k], g)
    per = N_LANES // shape[0]
    assert sorted(got_losses) == sorted(shards)
    for (c, m), block in got_losses.items():
        assert_close(block, losses.detach()[c * per:(c + 1) * per])


@pytest.mark.parametrize("shape", [(4, 2), (2, 2)])
def test_split_step_matches_the_reference_sharded_jit(ref_wl, shape):  # noqa: F811
    """The reference's ``sgd_train_step_batch`` jitted with its root entry
    module's shardings on a mesh of its virtual CPU devices, and the port's
    split step on a mesh of ``cpu`` of the same shape, from the same
    weights (carried by ``params_from_numpy``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    mlp = ref_wl.mlp
    rcfg = mlp.MLPConfig(d_in=CFG.d_in, width=CFG.width, n_classes=CFG.n_classes,
                         batch_size=CFG.batch_size)
    keys = jax.random.split(jax.random.key(0), N_LANES)
    r_params = jax.vmap(lambda k: mlp.init_mlp_params(k, rcfg, 1.0))(keys)
    _, velocity, x, y, hp = inputs(N_LANES, CFG.d_in, CFG.width, CFG.n_classes,
                                   CFG.batch_size)
    jmesh = JaxMesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                    ("config", "model"))
    specs = {"w1": P("config", None, "model"), "b1": P("config", "model"),
             "w2": P("config", None, "model"), "b2": P("config", "model"),
             "w3": P("config", "model", None), "b3": P("config", None)}
    param_sh = {k: NamedSharding(jmesh, s) for k, s in specs.items()}
    vec_sh, rep_sh = NamedSharding(jmesh, P("config")), NamedSharding(jmesh, P())
    # nothing donated: the reference's dry run jits this step without
    # donation, and the inputs are read again after the call
    step = jax.jit(mlp.sgd_train_step_batch,
                   in_shardings=(param_sh, param_sh, rep_sh, rep_sh, vec_sh, vec_sh, vec_sh),
                   out_shardings=(param_sh, param_sh, vec_sh), donate_argnums=())
    r_velocity = {k: jnp.asarray(v) for k, v in velocity.items()}
    want_p, want_v, want_l = step(r_params, r_velocity, jnp.asarray(x),
                                  jnp.asarray(y, jnp.int32),
                                  *(jnp.asarray(hp[k]) for k in ("lrs", "momenta", "wds")))
    params = params_from_numpy({k: np.asarray(v) for k, v in r_params.items()})
    got_p, got_v, got_l = split_step(
        cpu_mesh(*shape), params, {k: torch.from_numpy(v) for k, v in velocity.items()},
        torch.from_numpy(x), torch.from_numpy(y),
        [torch.from_numpy(hp[k]) for k in ("lrs", "momenta", "wds")])
    for k in specs:
        assert_close(got_p[k], want_p[k])
        assert_close(got_v[k], want_v[k])
    assert_close(got_l, want_l)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """Two ranks of a gloo group, with ``model`` across the ranks (``(1, 2)``
    and ``(2, 2)``) and with ``config`` across them (``(2, 2)``), reach the
    one-process split's trees, losses and gradients."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), coordinator, str(i), str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out}"
    ranks = [np.load(tmp_path / f"rank_{i}.npz") for i in range(2)]
    assert sorted(ranks[0].files) == sorted(ranks[1].files)
    params, velocity, x, y, hp = torch_inputs()
    for name, shape in (("model_1x2", (1, 2)), ("model_2x2", (2, 2)), ("config_2x2", (2, 2))):
        mesh = cpu_mesh(*shape)
        want_p, want_v, want_l = split_step(mesh, params, velocity, x, y, hp)
        grads, _ = mlp_grads_tp(shard_mlp_params(params, mesh), x, y, mesh)
        want_g = gather_mlp_params(grads, mesh)
        for got in ranks:
            for k in MODEL_SPLIT:
                assert_close(got[f"{name}.params.{k}"], want_p[k])
                assert_close(got[f"{name}.velocity.{k}"], want_v[k])
                assert_close(got[f"{name}.grads.{k}"], want_g[k])
            assert_close(got[f"{name}.losses"], want_l)

