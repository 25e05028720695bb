"""Port vs reference: the successive-halving rung ladder (``fused_sh_bracket``)
with a deterministic objective that ties, crashes (NaN) and pads.

Stage indices must be identical (ties keep the lower row index in both);
losses agree to ``atol 1e-6`` (the same float32 formula on both sides).
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.ops.fused import fused_sh_bracket
from tests.test_torch_harness import ref  # noqa: F401


def _loss(xp, v, budget):
    """Coarse (tied) losses, NaN crashes where v1 > 0.8, a budget term."""
    q = xp.floor(v[..., 0] * 4.0) / 4.0
    val = q + 0.01 * xp.floor(v[..., 2] * 3.0) - 0.001 * budget
    return xp.where(v[..., 1] > 0.8, float("nan"), val)


@pytest.mark.parametrize(
    "num_configs,budgets,n_pad",
    [
        ((27, 9, 3, 1), (1.0, 3.0, 9.0, 27.0), 0),
        ((9, 3, 1), (3.0, 9.0, 27.0), 3),   # padding rows never promote
        ((40, 13, 4), (1.0, 3.0, 9.0), 0),  # many crashes at a wide rung
        ((5,), (27.0,), 0),                  # single-stage bracket
    ],
)
def test_rung_ladder_matches(ref, num_configs, budgets, n_pad):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(sum(num_configs))
    vectors = rng.uniform(size=(num_configs[0] + n_pad, 3)).astype(np.float32)

    def bracket(v):
        return ref.fused.fused_sh_bracket(
            lambda x, b: _loss(jnp, x, b), v, num_configs, budgets)

    want = jax.jit(bracket)(jnp.asarray(vectors))
    got = fused_sh_bracket(
        lambda x, b: _loss(torch, x, b), torch.from_numpy(vectors),
        num_configs, budgets,
    )
    assert len(got) == len(want) == len(num_configs)
    for (gi, gl), (wi, wl), k in zip(got, want, num_configs):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        assert gi.shape == (k,)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=1e-6)
    if n_pad:
        assert all((idx.numpy() < num_configs[0]).all() for idx, _ in got)


def test_eval_fn_shape_is_checked():
    with pytest.raises(ValueError, match="one loss per row"):
        fused_sh_bracket(lambda x, b: x.sum(), torch.zeros((3, 2)), (3, 1), (1.0, 3.0))
