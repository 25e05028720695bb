"""The port's ring attention (``hpbandster_tpu_torch/ops/ring_attention.py``)
against the reference's (``hpbandster_tpu/ops/ring_attention.py``) and
against dense attention, on the CPU.

Mirrors ``tests/test_ring_attention.py`` case for case, at its sizes (T=64,
H=4, dh=16, a ring of 8) and tolerances: float32 values within 2e-5
(absolute and relative), bfloat16 products within 5e-2 of float32 dense
attention, gradients within ``atol 2e-5, rtol 2e-4``. The port's ring runs
on a mesh that repeats the ``cpu`` device 8 times; the reference's on its
eight virtual CPU devices, and the two agree within 2e-5 (float32) on the
same numpy-seeded inputs. The reference's non-causal ring cannot run on the
CPU (its test marks it expected to fail there), so the non-causal cases
hold the port against the reference's dense formulation only. Two gloo
ranks (fresh interpreters, ``tests/torch_ring_child.py``) run the
process-group form: values and gradients within 1e-6 of one process, and
the sequence-parallel transformer's parameter gradients, summed over the
ranks, within a relative norm of 1e-2 (bfloat16 rounds each rank's share).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.ops.ring_attention import (
    dense_attention,
    make_ring_attention,
    ring_attention_block,
    seq_mesh,
    stripe_indices,
)
from tests.test_torch_harness import REPO, ref  # noqa: F401

T, H, DH = 64, 4, 16
F32_TOL = 2e-5
BF16_TOL = 5e-2
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4
CHILD = REPO / "tests" / "torch_ring_child.py"
RANK_TIMEOUT_S = 180


@pytest.fixture(scope="module")
def rr(ref):  # noqa: F811
    """The reference's ring module and mesh helpers, inside the ``ref``
    window."""
    import importlib
    from types import SimpleNamespace

    return SimpleNamespace(ring=importlib.import_module("hpbandster_tpu.ops.ring_attention"))


def _qkv(seed, t=T, lead=()):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(lead + (t, H, DH)).astype(np.float32) for _ in range(3)]


def _ring(n=8, **kw):
    return make_ring_attention(seq_mesh([torch.device("cpu")] * n), **kw)


def _ref_dense(q, k, v, causal):
    """The reference test's dense attention, in jnp."""
    import jax
    import jax.numpy as jnp

    s = jnp.einsum("qhd,khd->hqk", q, k) * (DH ** -0.5)
    if causal:
        t = q.shape[0]
        s = jnp.where(jnp.tril(jnp.ones((t, t), bool))[None], s, -1e30)
    a = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("hqk,khd->hqd", a, v).transpose(1, 0, 2)


def _ref_ring(rr, compute_dtype="float32", **kw):
    import jax
    import jax.numpy as jnp

    return jax.jit(rr.ring.make_ring_attention(
        rr.ring.seq_mesh(), compute_dtype=getattr(jnp, compute_dtype), **kw))


def _grads(fn, arrays, wrt=(0, 1, 2)):
    ts = [torch.from_numpy(a.copy()).requires_grad_(i in wrt) for i, a in enumerate(arrays)]
    (fn(*ts) ** 2).mean().backward()
    return [ts[i].grad.numpy() for i in wrt]


# ------------------------------------------------------------------ values
@pytest.mark.parametrize("causal", [True, False])
def test_f32_matches_dense_exactly(rr, causal):
    """float32 products: the ring equals dense attention within 2e-5, and
    (causal) the reference's ring on its eight devices within 2e-5."""
    q, k, v = _qkv(0)
    out = _ring(causal=causal, compute_dtype=torch.float32)(
        *map(torch.from_numpy, (q, k, v))).numpy()
    assert out.shape == (T, H, DH)
    np.testing.assert_allclose(out, np.asarray(_ref_dense(q, k, v, causal)), atol=F32_TOL,
                               rtol=F32_TOL)
    dense = dense_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(out, dense, atol=F32_TOL, rtol=F32_TOL)
    if causal:
        want = np.asarray(_ref_ring(rr, causal=True)(q, k, v))
        np.testing.assert_allclose(out, want, atol=F32_TOL, rtol=F32_TOL)


def test_bf16_products_within_rounding(rr):
    """bfloat16 operands, float32 results: within 5e-2 of float32 dense
    attention, and within 2e-5 of the reference's bfloat16 ring (both round
    the same operands and sum exact products in float32)."""
    q, k, v = _qkv(1)
    out = _ring(compute_dtype=torch.bfloat16)(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(out, np.asarray(_ref_dense(q, k, v, True)), atol=BF16_TOL,
                               rtol=BF16_TOL)
    want = np.asarray(_ref_ring(rr, "bfloat16")(q, k, v))
    np.testing.assert_allclose(out, want, atol=F32_TOL, rtol=F32_TOL)


def test_single_shard_ring_is_local_attention():
    q, k, v = _qkv(2, t=16)
    out = _ring(n=1, compute_dtype=torch.float32)(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(out, np.asarray(_ref_dense(q, k, v, True)), atol=F32_TOL,
                               rtol=F32_TOL)


def test_striped_layout_matches_dense(rr):
    q, k, v = _qkv(5)
    out = _ring(causal=True, striped=True, compute_dtype=torch.float32)(
        *map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(out, np.asarray(_ref_dense(q, k, v, True)), atol=F32_TOL,
                               rtol=F32_TOL)
    want = np.asarray(_ref_ring(rr, causal=True, striped=True)(q, k, v))
    np.testing.assert_allclose(out, want, atol=F32_TOL, rtol=F32_TOL)


def test_striped_noncausal_downgrades_to_contiguous():
    """Non-causal attention has nothing to balance: ``striped=True`` gives
    the contiguous path's result bit for bit."""
    q, k, v = map(torch.from_numpy, _qkv(7))
    a = _ring(causal=False, striped=True, compute_dtype=torch.float32)(q, k, v)
    b = _ring(causal=False, striped=False, compute_dtype=torch.float32)(q, k, v)
    assert torch.equal(a, b)


@pytest.mark.parametrize("striped", [False, True])
def test_query_and_key_lengths_may_differ(rr, striped):
    """q and k/v of different lengths (each its own block size): the
    reference's ring's values, float32 within 2e-5."""
    q = _qkv(8, t=32)[0]
    _, k, v = _qkv(9, t=64)
    out = _ring(striped=striped, compute_dtype=torch.float32)(
        *map(torch.from_numpy, (q, k, v))).numpy()
    want = np.asarray(_ref_ring(rr, striped=striped)(q, k, v))
    np.testing.assert_allclose(out, want, atol=F32_TOL, rtol=F32_TOL)


def test_leading_batch_dims_are_independent_rings():
    """Blocks take leading batch dims (the lane-batched transformer's
    ``[n, B, T, H, dh]``): each batch entry equals its own ring."""
    q, k, v = map(torch.from_numpy, _qkv(10, lead=(2, 3)))
    ring = _ring(n=4, compute_dtype=torch.float32)
    out = ring(q, k, v)
    for a in range(2):
        for b in range(3):
            np.testing.assert_allclose(out[a, b].numpy(), ring(q[a, b], k[a, b], v[a, b]).numpy(),
                                       atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.numpy(), dense_attention(q, k, v).numpy(), atol=F32_TOL,
                               rtol=F32_TOL)


# --------------------------------------------------------------- gradients
def test_differentiable(rr):
    """d mean(ring(q)^2) / dq equals the dense formulation's (jax.grad of
    the reference test's dense attention) and the reference ring's."""
    import jax

    q, k, v = _qkv(3)
    (g,) = _grads(_ring(compute_dtype=torch.float32), (q, k, v), wrt=(0,))
    assert g.shape == q.shape and np.isfinite(g).all()
    g_ref = np.asarray(jax.grad(lambda x: (_ref_dense(x, k, v, True) ** 2).mean())(q))
    np.testing.assert_allclose(g, g_ref, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    ring = _ref_ring(rr)
    g_ring = np.asarray(jax.jit(jax.grad(lambda x: (ring(x, k, v) ** 2).mean()))(q))
    np.testing.assert_allclose(g, g_ring, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("striped", [False, True])
def test_grads_match_dense(rr, striped):
    """dq, dk and dv, contiguous and striped, against the dense
    formulation and the reference's ring."""
    import jax

    q, k, v = _qkv(6)
    got = _grads(_ring(compute_dtype=torch.float32, striped=striped), (q, k, v))
    want = jax.grad(lambda a: (_ref_dense(*a, True) ** 2).mean())((q, k, v))
    ring = _ref_ring(rr, striped=striped)
    want_ring = jax.jit(jax.grad(lambda a: (ring(*a) ** 2).mean()))((q, k, v))
    for g, w, wr, name in zip(got, want, want_ring, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"d{name}")
        np.testing.assert_allclose(g, np.asarray(wr), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"d{name} against the reference's ring")


def test_noncausal_grads_match_dense():
    """The non-causal ring's gradients against plain dense attention."""
    q, k, v = _qkv(11)
    got = _grads(_ring(causal=False, compute_dtype=torch.float32), (q, k, v))
    want = _grads(lambda a, b, c: dense_attention(a, b, c, causal=False), (q, k, v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_autograd_saves_no_rotated_block():
    """The memory bound: the graph keeps this process's q, k, v, the
    output and the logsumexp, never a rotated K/V block, however long the
    ring."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(12))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = _ring(compute_dtype=torch.float32)(q, k, v)
    # q, k, v and out of T*H*DH each, the logsumexp of H*T
    assert sorted(saved) == sorted([T * H * DH] * 4 + [H * T])
    (out ** 2).mean().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None


# ------------------------------------------------------------- block form
def test_stripe_indices_roundtrip(rr):
    to_striped, to_natural = stripe_indices(24, 8)
    want = rr.ring.stripe_indices(24, 8)
    np.testing.assert_array_equal(to_striped, want[0])
    np.testing.assert_array_equal(to_natural, want[1])
    x = np.arange(24)
    np.testing.assert_array_equal(x[to_striped][to_natural], x)
    striped = x[to_striped]
    for i in range(8):
        assert all(p % 8 == i for p in striped[i * 3:(i + 1) * 3])
    with pytest.raises(ValueError, match="divide"):
        stripe_indices(20, 8)


def test_block_form_equals_the_reference_block_in_shard_map(rr):
    """``ring_attention_block`` called with this process's blocks (all of
    them in one process) equals the reference's block inside a user's
    ``shard_map`` (the composition seam)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    q, k, v = _qkv(4)
    mesh = rr.ring.seq_mesh()
    spec = PartitionSpec("seq", None, None)
    want = np.asarray(jax.jit(rr.ring.shard_map(
        lambda qb, kb, vb: rr.ring.ring_attention_block(qb, kb, vb, "seq",
                                                        compute_dtype=jnp.float32),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec))(q, k, v))
    got = ring_attention_block(*map(torch.from_numpy, (q, k, v)),
                               seq_mesh([torch.device("cpu")] * 8),
                               compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_global_form_refuses_a_process_group_mesh():
    from hpbandster_tpu_torch.parallel.mesh import Mesh

    group_mesh = Mesh(np.array([torch.device("cpu")] * 2, dtype=object), ("seq",),
                      ranks=[0, 1], process_group=object())
    with pytest.raises(ValueError, match="ring_attention_block"):
        make_ring_attention(group_mesh)


# -------------------------------------------------------------- two ranks
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two gloo ranks, each with two ``cpu`` shards of a four-shard ring,
    run to their end (bounded); their dumps."""
    outdir = tmp_path_factory.mktemp("ring_ranks")
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), coordinator, "2", str(i), str(outdir)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(2)]
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
    dumps = []
    for i in range(2):
        with open(outdir / f"rank_{i}.json") as f:
            dumps.append(json.load(f))
    return dumps


def _child_inputs():
    sys.path.insert(0, str(REPO / "tests"))
    try:
        import torch_ring_child
    finally:
        sys.path.pop(0)
    return torch_ring_child


@pytest.mark.parametrize("striped", [False, True])
def test_two_gloo_ranks_equal_one_process(two_ranks, striped):
    """Each rank's output rows and its rows of dq, dk, dv equal the
    one-process ring's on the same global inputs (a loss summed over the
    ranks' shares), within 1e-6: the same tiles in the same order."""
    child = _child_inputs()
    q, k, v = child.global_qkv()
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = make_ring_attention(seq_mesh([torch.device("cpu")] * 4), striped=striped,
                              compute_dtype=torch.float32)(*ts)
    (out ** 2).sum().div(out.numel()).backward()
    key = "striped" if striped else "contiguous"
    layout = stripe_indices(q.shape[0], 4)[0] if striped else np.arange(q.shape[0])
    for rank, dump in enumerate(two_ranks):
        rows = layout[rank * (q.shape[0] // 2):(rank + 1) * (q.shape[0] // 2)]
        got = dump[key]
        np.testing.assert_allclose(np.asarray(got["out"]), out.detach().numpy()[rows],
                                   atol=1e-6, rtol=0)
        for name, t in zip("qkv", ts):
            np.testing.assert_allclose(np.asarray(got[f"d{name}"]), t.grad.numpy()[rows],
                                       atol=1e-6, rtol=0, err_msg=f"rank {rank} d{name}")


def test_two_gloo_ranks_sum_the_transformer_gradients(two_ranks):
    """The sequence-parallel transformer on two ranks: each rank's logits
    equal its rows of the one-process seq-parallel forward, and every
    parameter's gradient, summed over the ranks in the backward, equals
    the one-process gradient on both ranks (a dropped sum would leave each
    rank with its share only)."""
    from hpbandster_tpu_torch.ops.fused import tree_leaves, tree_map
    from hpbandster_tpu_torch.workloads import transformer as tfm

    child = _child_inputs()
    cfg, params, tokens = child.transformer_inputs()
    params = tree_map(lambda p: p.requires_grad_(), params)
    logits = tfm.transformer_forward_seq_parallel(params, tokens, cfg,
                                                  seq_mesh([torch.device("cpu")] * 4))
    (logits ** 2).sum().div(logits.numel()).backward()
    want = [p.grad.numpy() for p in tree_leaves(params)]
    half = tokens.shape[1] // 2
    for rank, dump in enumerate(two_ranks):
        np.testing.assert_allclose(np.asarray(dump["logits"]),
                                   logits.detach().numpy()[:, :, rank * half:(rank + 1) * half],
                                   atol=1e-5, rtol=0)
        assert len(dump["grads"]) == len(want)
        for g, w in zip(dump["grads"], want):
            # the backward of a bfloat16 cast rounds the gradient to
            # bfloat16, so each rank's share rounds before the sum: the
            # relative norm of the difference is at bfloat16's precision,
            # where a dropped sum would leave about half the gradient
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            assert np.linalg.norm(g - w) <= 1e-2 * max(np.linalg.norm(w), 1e-6)
