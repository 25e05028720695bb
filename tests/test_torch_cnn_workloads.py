"""The CNN and ResNet workloads against the reference on the CPU, at small
widths (8x8 images, width 8).

The port's batched functions take the reference's dataset (NHWC to NCHW)
and unit-scale initial weights (HWIO to OIHW) and are held against the
reference's per-config functions. Tolerances:

- the templates' bilinear resize against ``jax.image.resize``: 1e-6;
- forward logits: 3e-2 relative, 3e-3 absolute. The port rounds every
  convolution's output and the head's to bfloat16 as the reference's code
  casts; the reference's XLA keeps the float32 accumulator there instead
  (excess precision is allowed by default). With the outputs left in
  float32 the port agrees to 4e-6, so the gap is those roundings (2^-9
  relative each) through four layers, worst where the head cancels;
- validation losses after 1-3 SGD steps: 2e-2 relative, for the same
  reason;
- within the port, exact: the error function is one minus the accuracy
  function's validation accuracy; a ResNet block starts as the identity;
  a poisoned lane leaves the other lanes' losses bit for bit unchanged.
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import FusedBOHB
from hpbandster_tpu_torch.convert import dataset_from_numpy, params_from_numpy
from hpbandster_tpu_torch.workloads import cnn, resnet
from hpbandster_tpu_torch.workloads.train import make_generator
from tests.test_torch_harness import ref, ref_wl  # noqa: F401

SMALL = dict(image_size=8, n_classes=4, n_train=64, n_val=32, batch_size=32)
CNN_CFG = dict(SMALL, width=8)
RESNET_CFG = dict(SMALL, width=8, groups=2)
FWD_RTOL, FWD_ATOL = 3e-2, 3e-3
LOSS_RTOL = 2e-2


def _vectors(n, seed=0):
    """Configs with learning rates below ~0.16 and moderate init scales."""
    return np.random.default_rng(seed).uniform(0.05, 0.8, size=(n, 4)).astype(np.float32)


def _inputs(ref_wl, kind):
    """The reference's dataset and unit-scale init (data seed 0) for
    ``kind``, and the same as the port's ``data=`` / ``init=``."""
    import jax

    if kind == "cnn":
        rcfg = ref_wl.cnn.CNNConfig(**CNN_CFG)
        data = ref_wl.cnn.make_image_dataset(jax.random.key(0), rcfg)
        unit = ref_wl.cnn.init_cnn_params(jax.random.key(1), rcfg, 1.0)
    else:
        rcfg = ref_wl.resnet.ResNetConfig(**RESNET_CFG)
        data = ref_wl.cnn.make_image_dataset(jax.random.key(0), ref_wl.cnn.CNNConfig(**SMALL))
        unit = ref_wl.resnet.init_resnet_params(jax.random.key(1), rcfg)
    port = dict(data=dataset_from_numpy(jax.tree.map(np.asarray, data)),
                init=params_from_numpy(jax.tree.map(np.asarray, unit)))
    return rcfg, data, port


def test_templates_match_jax_image_resize():
    import jax
    import jax.numpy as jnp

    coarse = np.random.default_rng(0).normal(size=(10, 4, 4, 3)).astype(np.float32)
    for s in (8, 32):
        want = np.asarray(jax.image.resize(jnp.asarray(coarse), (10, s, s, 3), "linear"))
        got = torch.nn.functional.interpolate(
            torch.from_numpy(coarse.transpose(0, 3, 1, 2)), size=(s, s), mode="bilinear",
            align_corners=False).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_image_dataset_flips_train_labels_only():
    noisy = cnn.CNNConfig(**dict(CNN_CFG, n_train=512, label_noise=0.3))
    clean = noisy._replace(label_noise=0.0)
    (x, y), (xv, yv) = cnn.make_image_dataset(make_generator(torch.device("cpu"), 0), noisy)
    (x0, y0), (xv0, yv0) = cnn.make_image_dataset(make_generator(torch.device("cpu"), 0), clean)
    assert x.shape == (512, 3, 8, 8) and xv.shape == (32, 3, 8, 8)
    assert y.dtype == torch.int64
    assert torch.equal(x, x0) and torch.equal(xv, xv0) and torch.equal(yv, yv0)
    assert 0.15 < float((y != y0).float().mean()) < 0.3


def test_cnn_forward_matches(ref_wl):
    import jax

    rcfg, data, port = _inputs(ref_wl, "cnn")
    scale = np.array([0.5, 1.0, 2.0], np.float32)
    x = np.asarray(data[0][0])[:16]
    fwd = jax.jit(ref_wl.cnn.cnn_forward)
    want = np.stack([np.asarray(fwd(ref_wl.cnn.init_cnn_params(jax.random.key(1), rcfg, s), x))
                     for s in scale])
    params = cnn.init_cnn_params(port["init"], torch.from_numpy(scale))
    got = cnn.cnn_forward(params, port["data"][0][0][:16]).numpy()
    assert got.shape == (3, 16, 4)
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)


@pytest.mark.parametrize("budget", [1.0, 3.0])
def test_cnn_eval_fn_matches(ref_wl, budget):
    import jax

    rcfg, _, port = _inputs(ref_wl, "cnn")
    v = _vectors(4, seed=int(budget))
    want = np.asarray(jax.jit(jax.vmap(ref_wl.cnn.make_cnn_eval_fn(rcfg, 0),
                                       in_axes=(0, None)))(v, budget))
    got = cnn.make_cnn_eval_fn(cnn.CNNConfig(**CNN_CFG), device="cpu", **port)(
        torch.from_numpy(v), budget)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL)


def test_cnn_error_fn_is_the_accuracy_twin():
    cfg = cnn.CNNConfig(**CNN_CFG)
    v = torch.from_numpy(_vectors(3, seed=4))
    err = cnn.make_cnn_error_fn(cfg, device="cpu")(v, 2.0)
    train_acc, val_acc = cnn.make_cnn_accuracy_fn(cfg, device="cpu")(v, 2.0)
    assert torch.equal(err, 1.0 - val_acc)
    assert bool(((train_acc >= 0) & (train_acc <= 1)).all())


def test_cnn_poisoned_lane_leaves_other_lanes_unchanged():
    fn = cnn.make_cnn_eval_fn(cnn.CNNConfig(**CNN_CFG), device="cpu")
    v = torch.from_numpy(_vectors(4, seed=6))
    clean = fn(v, 2.0)
    bad = v.clone()
    bad[2] = float("nan")
    out = fn(bad, 2.0)
    assert torch.isnan(out[2]) and torch.equal(out[[0, 1, 3]], clean[[0, 1, 3]])


def test_resnet_forward_matches(ref_wl):
    import jax

    rcfg, data, port = _inputs(ref_wl, "resnet")
    x = np.asarray(data[0][0])[:16]
    unit = ref_wl.resnet.init_resnet_params(jax.random.key(1), rcfg)
    # break the zero-initialised block gains, so every layer shows
    unit = jax.tree.map(lambda t: t + 0.1, unit)
    want = np.asarray(jax.jit(ref_wl.resnet.resnet_forward, static_argnums=2)(unit, x, 2))
    params = resnet.init_resnet_params(params_from_numpy(jax.tree.map(np.asarray, unit)), 2)
    got = resnet.resnet_forward(params, port["data"][0][0][:16], 2).numpy()
    assert got.shape == (2, 16, 4)
    np.testing.assert_allclose(got[0], want, rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("budget", [1.0, 2.0])
def test_resnet_eval_fn_matches(ref_wl, budget):
    import jax

    rcfg, _, port = _inputs(ref_wl, "resnet")
    v = _vectors(3, seed=8)
    want = np.asarray(jax.jit(jax.vmap(ref_wl.resnet.make_resnet_eval_fn(rcfg, 0),
                                       in_axes=(0, None)))(v, budget))
    got = resnet.make_resnet_eval_fn(resnet.ResNetConfig(**RESNET_CFG), device="cpu",
                                     **port)(torch.from_numpy(v), budget)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL)


def test_resnet_blocks_start_as_identity():
    cfg = resnet.ResNetConfig(**RESNET_CFG)
    unit = resnet.draw_resnet_unit_params(make_generator(torch.device("cpu"), 1), cfg)
    params = resnet.init_resnet_params(unit, 3)
    h = torch.relu(torch.randn(5, 3 * cfg.width, 8, 8, generator=torch.Generator().manual_seed(0)))
    for name in ("s0b0", "s0b1"):
        assert torch.equal(resnet._basic_block(h, params[name], cfg.groups, 1), h)
    # a widening block projects: not the identity, but its residual branch is 0
    assert "proj" in params["s1b0"] and not params["s1b0"]["g2"].any()


def test_resnet_group_norm_is_per_lane():
    """The lanes' GroupNorm on stacked channels equals each lane's own."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 3 * 8, 5, 5, generator=g)
    gamma, beta = torch.randn(3, 8, generator=g), torch.randn(3, 8, generator=g)
    out = resnet._group_norm(x, gamma, beta, 2)
    for i in range(3):
        one = torch.nn.functional.group_norm(x[:, 8 * i:8 * (i + 1)], 2, gamma[i], beta[i],
                                             eps=1e-5)
        torch.testing.assert_close(out[:, 8 * i:8 * (i + 1)], one, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["cnn", "resnet"])
def test_one_bracket_through_fused_bohb(kind):
    if kind == "cnn":
        space, fn = cnn.cnn_space(seed=0), cnn.make_cnn_error_fn(cnn.CNNConfig(**CNN_CFG),
                                                                device="cpu")
    else:
        space, fn = resnet.resnet_space(seed=0), resnet.make_resnet_eval_fn(
            resnet.ResNetConfig(**RESNET_CFG), device="cpu")
    opt = FusedBOHB(configspace=space, eval_fn=fn, min_budget=1, max_budget=3, eta=3,
                    seed=0, num_samples=8, device="cpu")
    res = opt.run(n_iterations=1)
    runs = res.get_all_runs()
    assert sorted(r.budget for r in runs) == [1.0, 1.0, 1.0, 3.0]
    losses = np.array([r.loss for r in runs])
    assert np.isfinite(losses).all()
    if kind == "cnn":
        assert ((losses >= 0) & (losses <= 1)).all()
