"""The transformer workload (dense attention) against the reference on the
CPU, at a small size: 2 layers, ``d_model`` 16, 2 heads, prefix 5.

The port takes the reference's copy dataset and unit-scale initial
weights. Both compute every matrix product from bfloat16-rounded operands
with float32 accumulation (the port multiplies the rounded operands as
float32, exact products), so they differ only in the order of float32
sums. Tolerances: forward logits 1e-5 (absolute, logits of order 1);
masked cross-entropy 1e-5 relative; dataset structure exact. Validation
losses after 1-3 SGD steps: 2e-2 relative. The backward passes round
differently: JAX differentiates a product of bfloat16 operands with
bfloat16 operands again, while the port's gradient meets the rounded
operands in float32 and is rounded to bfloat16 only where the cast is
undone; at learning rates up to 0.4 the losses part by up to 0.5% after
3 steps.
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.convert import dataset_from_numpy, params_from_numpy
from hpbandster_tpu_torch.workloads import transformer as tfm
from hpbandster_tpu_torch.workloads.train import make_generator
from tests.test_torch_harness import ref, ref_wl  # noqa: F401

CFG = dict(vocab=8, prefix_len=5, d_model=16, n_heads=2, n_layers=2, d_ff=64,
           n_train=64, n_val=32, batch_size=16)


def _vectors(n, seed=0):
    """Learning rates 0.02-0.4, init scales 0.4-1.6: a few steps learn."""
    v = np.random.default_rng(seed).uniform(0.5, 0.9, size=(n, 4))
    v[:, 3] = np.random.default_rng(seed + 1).uniform(0.3, 0.6, size=n)
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def pair(ref_wl):
    import jax

    rcfg = ref_wl.transformer.TransformerConfig(**CFG)
    data = ref_wl.transformer.make_copy_dataset(jax.random.key(0), rcfg)
    unit = ref_wl.transformer.init_transformer_params(jax.random.key(1), rcfg, 1.0)
    port = dict(data=dataset_from_numpy(jax.tree.map(np.asarray, data)),
                init=params_from_numpy(jax.tree.map(np.asarray, unit)))
    return rcfg, tfm.TransformerConfig(**CFG), data, port


def test_copy_dataset_structure_and_mask():
    cfg = tfm.TransformerConfig(**CFG)
    (x, y), (xv, yv), mask = tfm.make_copy_dataset(make_generator(torch.device("cpu"), 0), cfg)
    p, t = cfg.prefix_len, cfg.seq_len - 1
    assert x.shape == (64, t) and xv.shape == (32, t) and x.dtype == torch.int64
    # y is x shifted by one: both views of [prefix, SEP, prefix]
    assert torch.equal(x[:, 1:], y[:, :-1])
    assert bool((x[:, p] == cfg.vocab).all()) and bool((x[:, :p] < cfg.vocab).all())
    assert torch.equal(y[:, p:], x[:, :p])  # the copied half
    assert mask.tolist() == [0.0] * p + [1.0] * (t - p)
    assert not torch.equal(x[:32], xv)


def test_forward_matches(pair, ref_wl):
    import jax

    rcfg, cfg, data, port = pair
    scale = np.array([0.7, 1.3], np.float32)
    x = np.asarray(data[0][0])[:8]
    fwd = jax.jit(jax.vmap(lambda p, s: ref_wl.transformer.transformer_forward(p, s, rcfg),
                           in_axes=(None, 0)))
    want = np.stack([np.asarray(fwd(ref_wl.transformer.init_transformer_params(
        jax.random.key(1), rcfg, s), x)) for s in scale])
    params = tfm.init_transformer_params(port["init"], torch.from_numpy(scale))
    got = tfm.transformer_forward(params, port["data"][0][0][:8], cfg).numpy()
    assert got.shape == (2, 8, cfg.seq_len - 1, cfg.vocab + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the layer norms start at one and zero in every lane
    assert torch.equal(params["l0"]["ln1"], torch.ones(2, 16))


def test_masked_xent_matches(pair, ref_wl):
    import jax

    rcfg, cfg, data, port = pair
    (x, y), _, mask = data
    unit = ref_wl.transformer.init_transformer_params(jax.random.key(1), rcfg, 1.0)
    want = float(jax.jit(lambda p: ref_wl.transformer._masked_xent(p, x, y, rcfg, mask))(unit))
    params = tfm.init_transformer_params(port["init"], torch.ones(1))
    got = tfm._masked_xent(params, *port["data"][0], cfg, port["data"][2])
    assert got.shape == (1,)
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-5)


@pytest.mark.parametrize("budget", [1.0, 3.0])
def test_eval_fn_matches(pair, ref_wl, budget):
    import jax

    rcfg, cfg, data, port = pair
    v = _vectors(3, seed=int(budget))
    want = np.asarray(jax.jit(jax.vmap(ref_wl.transformer.make_transformer_eval_fn(rcfg, 0),
                                       in_axes=(0, None)))(v, budget))
    got = tfm.make_transformer_eval_fn(cfg, device="cpu", **port)(torch.from_numpy(v), budget)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2)


def test_training_reduces_the_loss_and_errors_agree(pair):
    _, cfg, _, port = pair
    v = torch.from_numpy(_vectors(3, seed=5))
    fn = tfm.make_transformer_eval_fn(cfg, device="cpu", **port)
    before, after = fn(v, 0.0), fn(v, 12.0)
    assert bool((after < before).all())
    err = tfm.make_transformer_error_fn(cfg, device="cpu", **port)(v, 4.0)
    train_acc, val_acc = tfm.make_transformer_accuracy_fn(cfg, device="cpu", **port)(v, 4.0)
    assert torch.equal(err, 1.0 - val_acc)
    assert bool(((train_acc >= 0) & (train_acc <= 1)).all())


def test_poisoned_lane_leaves_other_lanes_unchanged(pair):
    _, cfg, _, port = pair
    fn = tfm.make_transformer_eval_fn(cfg, device="cpu", **port)
    v = torch.from_numpy(_vectors(4, seed=7))
    clean = fn(v, 2.0)
    bad = v.clone()
    bad[0] = float("nan")
    out = fn(bad, 2.0)
    assert torch.isnan(out[0]) and torch.equal(out[1:], clean[1:])
