"""Port vs reference: bracket arithmetic and the space codec
(``build_space_codec``, ``quantize_unit``, ``random_unit``)."""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.ops import bracket as tbracket
from hpbandster_tpu_torch.ops.sweep import (
    build_space_codec,
    codec_tables,
    quantize_unit,
    random_unit,
    random_unit_from,
)
from tests.test_torch_harness import codecs, port_space, ref  # noqa: F401


@pytest.mark.parametrize(
    "min_budget,max_budget,eta",
    [(1, 27, 3), (1, 81, 3), (0.01, 1, 3), (1, 64, 2), (9, 9, 3)],
)
def test_bracket_arithmetic_matches(ref, min_budget, max_budget, eta):
    rb = ref.bracket
    assert tbracket.max_sh_iterations(min_budget, max_budget, eta) == \
        rb.max_sh_iterations(min_budget, max_budget, eta)
    np.testing.assert_array_equal(
        tbracket.budget_ladder(min_budget, max_budget, eta),
        rb.budget_ladder(min_budget, max_budget, eta),
    )
    for i in range(12):
        got = tbracket.hyperband_bracket(i, min_budget, max_budget, eta)
        want = rb.hyperband_bracket(i, min_budget, max_budget, eta)
        assert tuple(got) == tuple(want)


def test_host_promotion_rule_matches(ref):
    rng = np.random.default_rng(3)
    for _ in range(20):
        losses = np.round(rng.normal(size=17), 1).astype(np.float32)  # ties
        losses[rng.integers(17, size=4)] = np.nan
        k = int(rng.integers(1, 17))
        np.testing.assert_array_equal(
            tbracket.sh_promotion_mask_np(losses, k),
            ref.bracket.sh_promotion_mask_np(losses, k),
        )


@pytest.mark.parametrize("name", ["branin", "mixed"])
def test_codec_matches(ref, name):
    want, carried = codecs(ref, name)
    got = build_space_codec(port_space(name))
    for field, a, b, c in zip(want._fields, want, got, carried):
        np.testing.assert_array_equal(a, b, err_msg=field)
        np.testing.assert_array_equal(a, c, err_msg=field)
        assert a.dtype == b.dtype == c.dtype, field


@pytest.mark.parametrize("name", ["branin", "mixed"])
def test_quantize_unit_within_one_ulp(ref, name):
    import jax.numpy as jnp

    rc, codec = codecs(ref, name)
    rng = np.random.default_rng(7)
    d = len(rc.kind)
    # out-of-range values and raw categorical indices exercise the clamps
    u = rng.uniform(-0.2, 1.2, size=(512, d)).astype(np.float32)
    cat = rc.kind == 2
    u[:, cat] = rng.uniform(-1.0, rc.cards[cat] + 0.5, size=(512, cat.sum()))
    u = u.astype(np.float32)
    want = np.asarray(ref.sweep.quantize_unit(rc, jnp.asarray(u)))
    tables = codec_tables(codec, "cpu")
    got = quantize_unit(tables, torch.from_numpy(u)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # quantization is idempotent on its own output
    np.testing.assert_array_equal(
        quantize_unit(tables, torch.from_numpy(got)).numpy(), got
    )


@pytest.mark.parametrize("name", ["branin", "mixed"])
def test_random_unit_from_reference_draws(ref, name):
    """Fed the reference's own uniforms and categorical draws, the port
    composes exactly the reference's ``random_unit`` vectors."""
    import jax
    import jax.numpy as jnp

    rc, codec = codecs(ref, name)
    n, d = 300, len(rc.kind)
    key = jax.random.key(11)
    k_u, k_c = jax.random.split(key)
    u = jax.random.uniform(k_u, (n, d))
    idx = jax.random.categorical(
        k_c, jnp.asarray(rc.logits)[None, :, :], axis=-1, shape=(n, d)
    )
    want = np.asarray(ref.sweep.random_unit(rc, key, n))
    got = random_unit_from(
        codec_tables(codec, "cpu"), torch.from_numpy(np.array(u)), torch.from_numpy(np.array(idx))
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_unit_distribution():
    """The port's own sampler: uniform unit dims, weighted categorical
    draws, uniform ordinal levels."""
    cs = port_space("mixed")
    cs.get_hyperparameter("act").probabilities = np.asarray([0.6, 0.3, 0.1])
    tables = codec_tables(build_space_codec(cs), "cpu")
    gen = torch.Generator().manual_seed(0)
    v = random_unit(tables, gen, 20000).numpy()
    assert v.dtype == np.float32 and v.shape == (20000, 6)
    cont = v[:, [0, 1, 4, 5]]
    assert cont.min() >= 0.0 and cont.max() < 1.0
    assert abs(cont.mean() - 0.5) < 0.01
    act = np.bincount(v[:, 2].astype(int), minlength=3) / len(v)
    np.testing.assert_allclose(act, [0.6, 0.3, 0.1], atol=0.015)
    depth = np.bincount(v[:, 3].astype(int), minlength=4) / len(v)
    np.testing.assert_allclose(depth, [0.25] * 4, atol=0.015)
    # the same seed gives the same draws
    again = random_unit(tables, torch.Generator().manual_seed(0), 20000).numpy()
    np.testing.assert_array_equal(v, again)
