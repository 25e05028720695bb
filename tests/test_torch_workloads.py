"""The MLP, teacher and ensemble workloads' building blocks, and the
training loop they share, against the reference on the CPU.

The port's batched functions take the reference's own dataset and
unit-scale initial weights (``convert.dataset_from_numpy`` /
``params_from_numpy``) and are held against ``jax.vmap`` of the reference's
per-config functions. Tolerances:

- decoders: momentum and label smoothing exact, and the log-scale knobs'
  exponents; the powers ``10 ** e`` within 1 ulp (the reference's float32
  ``pow`` is not correctly rounded; the port's is, computed in float64);
- ``mlp_forward``: 1e-6 (float32 products summed in another order);
- ``momentum_sgd_train``, 1-5 steps: 1e-5 (the same, through a few steps;
  the port scales the unit weights by ``init_scale`` where the reference
  scales the normals, an ulp apart);
- validation losses after 1 and 3 steps: 1e-5 relative;
- the teacher's error rates: one validation example (an argmax can flip
  on a near-tie);
- the toys: Branin 1e-4 (XLA contracts its cancelling polynomial
  differently), Hartmann-6 1e-5 (``exp`` and the noise term's sum in
  another order), ``branin_dict`` exact;
- step counts: exact.

A diverged lane leaves every other lane bit for bit unchanged.
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.convert import dataset_from_numpy, params_from_numpy
from hpbandster_tpu_torch.workloads import ensemble, mlp, teacher, toys, train
from tests.test_torch_harness import ref, ref_wl  # noqa: F401

MLP_CFG = dict(d_in=8, width=16, n_classes=4, n_train=64, n_val=32, batch_size=16)
TEACHER_CFG = dict(n_train=256, n_val=128, student_width=16, batch_size=64)


def _vectors(n, seed=0, lo=0.05, hi=0.8):
    """Seeded configs whose learning rates stay below ~0.16 and whose init
    scales stay moderate, so a few steps do not diverge."""
    return np.random.default_rng(seed).uniform(lo, hi, size=(n, 4)).astype(np.float32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.fixture(scope="module")
def mlp_pair(ref_wl):
    """The reference's MLP dataset and unit-scale init (data seed 0) and
    the port's copies."""
    import jax

    rcfg = ref_wl.mlp.MLPConfig(**MLP_CFG)
    data = ref_wl.mlp.make_synthetic_dataset(jax.random.key(0), rcfg)
    unit = ref_wl.mlp.init_mlp_params(jax.random.key(1), rcfg, 1.0)
    port = dict(data=dataset_from_numpy(jax.tree.map(np.asarray, data)),
                init=params_from_numpy(jax.tree.map(np.asarray, unit)))
    return rcfg, mlp.MLPConfig(**MLP_CFG), data, unit, port


def test_decoders_match_the_reference(ref_wl):
    import jax

    v = np.random.default_rng(1).random((4096, 4)).astype(np.float32)
    want = [np.asarray(x) for x in jax.jit(jax.vmap(ref_wl.mlp.decode_mlp_hparams))(v)]
    got = [x.numpy() for x in mlp.decode_mlp_hparams(torch.from_numpy(v))]
    np.testing.assert_array_equal(got[1], want[1])  # momentum
    for g, w in zip(got[::2] + got[3:], want[::2] + want[3:]):
        assert _ulps(g, w).max() <= 1
    # the exponent is the reference's (one rounding, as its fused
    # multiply-add), the power its correctly rounded value
    e = np.asarray(jax.jit(lambda x: -7.0 + 5.0 * x)(v[:, 2]))
    np.testing.assert_array_equal(got[2], np.power(10.0, e.astype(np.float64)).astype(np.float32))
    rw = [np.asarray(x) for x in jax.jit(jax.vmap(ref_wl.resnet.decode_resnet_hparams))(v)]
    from hpbandster_tpu_torch.workloads.resnet import decode_resnet_hparams

    gw = [x.numpy() for x in decode_resnet_hparams(torch.from_numpy(v))]
    np.testing.assert_array_equal(gw[1], rw[1])
    np.testing.assert_array_equal(gw[3], rw[3])  # label smoothing
    assert max(_ulps(gw[i], rw[i]).max() for i in (0, 2)) <= 1
    decoders = jax.jit(lambda v: [jax.vmap(fn)(v) for fn in (
        ref_wl.cnn.decode_cnn_hparams, ref_wl.transformer.decode_transformer_hparams)])
    for out in decoders(v):
        np.testing.assert_array_equal(np.stack([np.asarray(x) for x in out]), np.stack(want))


def test_spaces_match_the_reference(ref_wl):
    from hpbandster_tpu_torch.workloads import cnn, resnet, transformer

    pairs = [(mlp.mlp_space, ref_wl.mlp.mlp_space),
             (teacher.teacher_space, ref_wl.teacher.teacher_space),
             (cnn.cnn_space, ref_wl.cnn.cnn_space),
             (resnet.resnet_space, ref_wl.resnet.resnet_space),
             (transformer.transformer_space, ref_wl.transformer.transformer_space)]
    for port_fn, ref_fn in pairs:
        p, r = port_fn(seed=0), ref_fn(seed=0)
        assert [h.name for h in p.get_hyperparameters()] == [h.name for h in r.get_hyperparameters()]
        for hp, hr in zip(p.get_hyperparameters(), r.get_hyperparameters()):
            assert (hp.lower, hp.upper, hp.log) == (hr.lower, hr.upper, hr.log)


def test_mlp_forward_matches(mlp_pair, ref_wl):
    import jax

    rcfg, cfg, data, unit, port = mlp_pair
    scale = np.array([0.5, 1.0, 2.0], np.float32)
    x = np.asarray(data[0][0])
    want = np.stack([np.asarray(ref_wl.mlp.mlp_forward(
        ref_wl.mlp.init_mlp_params(jax.random.key(1), rcfg, s), x)) for s in scale])
    got = mlp.mlp_forward(mlp.init_mlp_params(port["init"], torch.from_numpy(scale)),
                          port["data"][0][0]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("steps", [1, 3, 5])
def test_momentum_sgd_train_matches(mlp_pair, ref_wl, steps):
    import jax
    import jax.numpy as jnp

    rcfg, cfg, data, unit, port = mlp_pair
    v = _vectors(4, seed=steps)
    lr, mom, wd, scale = jax.jit(jax.vmap(ref_wl.mlp.decode_mlp_hparams))(v)

    def ref_one(lr, mom, wd, s):
        p = ref_wl.mlp.init_mlp_params(jax.random.key(1), rcfg, s)
        return ref_wl.train.momentum_sgd_train(
            p, lr, mom, wd, data[0], jnp.float32(steps),
            lambda q, xb, yb: ref_wl.mlp._xent(ref_wl.mlp.mlp_forward(q, xb), yb),
            rcfg.batch_size, rcfg.n_train)

    want = jax.jit(jax.vmap(ref_one))(lr, mom, wd, scale)
    plr, pmom, pwd, pscale = mlp.decode_mlp_hparams(torch.from_numpy(v))
    got = train.momentum_sgd_train(
        mlp.init_mlp_params(port["init"], pscale), plr, pmom, pwd, port["data"][0],
        float(steps), lambda q, xb, yb: mlp._xent(mlp.mlp_forward(q, xb), yb),
        cfg.batch_size, cfg.n_train)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("budget", [1.0, 3.0])
def test_mlp_eval_fn_matches(mlp_pair, ref_wl, budget):
    import jax

    rcfg, cfg, data, unit, port = mlp_pair
    v = _vectors(6, seed=7)
    want = np.asarray(jax.jit(jax.vmap(ref_wl.mlp.make_mlp_eval_fn(rcfg, 0), in_axes=(0, None)))(v, budget))
    got = mlp.make_mlp_eval_fn(cfg, device="cpu", **port)(torch.from_numpy(v), budget)
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_sgd_train_step_batch_matches(mlp_pair, ref_wl):
    import jax

    rcfg, cfg, data, unit, port = mlp_pair
    v = _vectors(3, seed=9)
    lr, mom, wd, scale = jax.jit(jax.vmap(ref_wl.mlp.decode_mlp_hparams))(v)
    params = jax.vmap(lambda s: ref_wl.mlp.init_mlp_params(jax.random.key(1), rcfg, s))(scale)
    vel = jax.tree.map(lambda x: 0.5 * x, params)
    x, y = data[0]
    want = jax.jit(ref_wl.mlp.sgd_train_step_batch)(params, vel, x, y, lr, mom, wd)
    p_port = params_from_numpy(jax.tree.map(np.asarray, params))
    v_port = params_from_numpy(jax.tree.map(np.asarray, vel))
    got = mlp.sgd_train_step_batch(p_port, v_port, *port["data"][0],
                                   *mlp.decode_mlp_hparams(torch.from_numpy(v))[:3])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(want[1][k]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


def test_synthetic_dataset_structure():
    cfg = mlp.MLPConfig(**MLP_CFG)
    gen = train.make_generator(torch.device("cpu"), 0)
    (x, y), (xv, yv) = mlp.make_synthetic_dataset(gen, cfg)
    assert x.shape == (64, 8) and xv.shape == (32, 8)
    assert x.dtype == torch.float32 and y.dtype == torch.int64
    assert 0 <= int(y.min()) and int(y.max()) < 4
    again = mlp.make_synthetic_dataset(train.make_generator(torch.device("cpu"), 0), cfg)
    assert torch.equal(again[0][0], x) and torch.equal(again[1][1], yv)


@pytest.fixture(scope="module")
def teacher_pair(ref_wl):
    import jax

    rcfg = ref_wl.teacher.TeacherConfig(**TEACHER_CFG)
    data = ref_wl.teacher.make_teacher_dataset(0, rcfg)
    unit = ref_wl.mlp.init_mlp_params(jax.random.key(1), ref_wl.teacher._student_cfg(rcfg), 1.0)
    port = dict(data=dataset_from_numpy(jax.tree.map(np.asarray, data)),
                init=params_from_numpy(jax.tree.map(np.asarray, unit)))
    return rcfg, teacher.TeacherConfig(**TEACHER_CFG), data, port


@pytest.mark.parametrize("budget", [1.0, 3.0])
def test_teacher_eval_fn_matches(teacher_pair, ref_wl, budget):
    import jax

    rcfg, cfg, data, port = teacher_pair
    v = _vectors(6, seed=3)
    want = np.asarray(jax.jit(jax.vmap(ref_wl.teacher.make_teacher_eval_fn(rcfg, 0),
                                       in_axes=(0, None)))(v, budget))
    got = teacher.make_teacher_eval_fn(cfg, device="cpu", **port)(torch.from_numpy(v), budget)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1.0 / cfg.n_val + 1e-6)
    acc = teacher.make_teacher_accuracy_fn(cfg, device="cpu", **port)(torch.from_numpy(v), budget)
    np.testing.assert_allclose(acc[1].numpy(), 1.0 - got.numpy(), rtol=0, atol=1e-6)


def test_teacher_dataset_flips_train_labels_only():
    cfg = teacher.TeacherConfig(**dict(TEACHER_CFG, label_noise=0.3))
    clean = teacher.TeacherConfig(**dict(TEACHER_CFG, label_noise=0.0))
    (x, y), (xv, yv) = teacher.make_teacher_dataset(0, cfg, device="cpu")
    (x0, y0), (xv0, yv0) = teacher.make_teacher_dataset(0, clean, device="cpu")
    assert torch.equal(x, x0) and torch.equal(xv, xv0) and torch.equal(yv, yv0)
    flipped = float((y != y0).float().mean())
    # a flip draws a uniform class: 3/4 of the 30% change
    assert 0.15 < flipped < 0.3


def test_budget_to_steps_rules(ref_wl):
    """``train.py`` truncates the float32 budget; the teacher truncates the
    float32 product ``epochs * steps_per_epoch``; the ensemble rounds."""
    import jax.numpy as jnp

    budgets = [1.0, 2.5, 2.9999, 2.99999999, 26.999999999999996, 81.0 / 3, 81 * 3.0**-2,
               1 / 3, 0.7, 9.0]
    for b in budgets:
        assert train.budget_steps(b) == int(jnp.asarray(b, jnp.float32).astype(jnp.int32))
        for cfg in (teacher.TeacherConfig(), teacher.TeacherConfig(**TEACHER_CFG)):
            spe = max(cfg.n_train // cfg.batch_size, 1)
            want = int((jnp.asarray(b, jnp.float32) * spe).astype(jnp.int32))
            assert train.budget_steps(teacher.teacher_steps(b, cfg)) == want
        assert ensemble._steps(b) == ref_wl.ensemble._steps(b)
    assert train.budget_steps(26.999999999999996) == 27 and ensemble._steps(26.999999) == 27
    assert train.budget_steps(2.9999) == 2 and ensemble._steps(2.9999) == 3


def test_toys_per_vector_forms_match(ref_wl):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    for _ in range(8):
        v2, v6 = rng.random(2).astype(np.float32), rng.random(6).astype(np.float32)
        for budget in (1.0, 9.0):
            got = toys.branin_from_vector(torch.from_numpy(v2), budget)
            assert got.dim() == 0
            # XLA contracts Branin's cancelling polynomial differently
            np.testing.assert_allclose(
                float(got), float(ref_wl.toys.branin_from_vector(jnp.asarray(v2), budget)),
                rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(
                float(toys.hartmann6_from_vector(torch.from_numpy(v6), budget)),
                float(ref_wl.toys.hartmann6_from_vector(jnp.asarray(v6), budget)),
                rtol=1e-5, atol=1e-5)
            cfg = {"x": float(v2[0]) * 15 - 5, "y": float(v2[1]) * 15}
            assert toys.branin_dict(cfg, budget) == ref_wl.toys.branin_dict(cfg, budget)


def test_diverged_lane_leaves_other_lanes_unchanged(mlp_pair):
    """A lane whose config is NaN (NaN learning rate and init) reports NaN;
    the other lanes' losses are bit for bit the clean run's."""
    _, cfg, _, _, port = mlp_pair
    fn = mlp.make_mlp_eval_fn(cfg, device="cpu", **port)
    v = torch.from_numpy(_vectors(4, seed=11))
    clean = fn(v, 3.0)
    poisoned = v.clone()
    poisoned[1] = float("nan")
    out = fn(poisoned, 3.0)
    assert torch.isnan(out[1])
    keep = [0, 2, 3]
    assert torch.equal(out[keep], clean[keep])


def test_constructors_refuse_to_run_without_a_device(monkeypatch):
    from hpbandster_tpu_torch.workloads import (
        make_cnn_eval_fn,
        make_mlp_ensemble,
        make_resnet_eval_fn,
        make_teacher_eval_fn,
        make_transformer_eval_fn,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (mlp.make_mlp_eval_fn, make_teacher_eval_fn, make_mlp_ensemble,
                 make_cnn_eval_fn, make_resnet_eval_fn, make_transformer_eval_fn):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        teacher.make_teacher_dataset(0)
