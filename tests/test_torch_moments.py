"""The masked-moment bandwidth fit: the port's plain version against the
reference's ``_moments_kernel`` run in the Pallas interpreter.

Inputs are made from a numpy seed and handed to both sides. Tolerances:
counts exact (sums of 0/1 masks in float32); sums and bandwidths ``rtol
1e-5, atol 1e-6``, since both sides sum float32 in different orders (the
reference in 512-row tiles, the port in one reduction).
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.ops.cuda_kde import (
    masked_moments,
    masked_moments_reference,
    moment_bandwidths,
)
from tests.test_torch_harness import ref  # noqa: F401

MIN_BW = 1e-3

#: (C, cards per dim, rows masked in): the fit's main-path size with a
#: handful of rows live, a mixed space with discrete dims, a wide space
#: 30% live, and an all-masked buffer
CASES = {
    "c256_d6_7live": (256, [0] * 6, 7),
    "c1000_d5_mixed": (1000, [0, 3, 5, 0, 2], 400),
    "c4096_d16_30pct": (4096, [0] * 10 + [3, 4, 5] + [4, 6, 8], int(0.3 * 4096)),
    "c256_d6_all_masked": (256, [0] * 6, 0),
}


def _inputs(name):
    c, cards, live = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    d = len(cards)
    data = rng.uniform(size=(c, d)).astype(np.float32)
    for j, k in enumerate(cards):
        if k:
            data[:, j] = rng.integers(k, size=c)
    mask = np.zeros(c, np.float32)
    mask[rng.permutation(c)[:live]] = 1.0
    return data, mask, np.asarray(cards, np.int32)


def _ref_moments(ref, data, mask):
    """The reference kernel's [8, 128] output, read back as [3, d], with
    the padding its wrapper applies."""
    import jax.numpy as jnp

    c, d = data.shape
    tile, lane = ref.pallas_kde._TILE_R, ref.pallas_kde._LANE
    c_pad = -(-c // tile) * tile
    dpad = np.zeros((c_pad, lane), np.float32)
    dpad[:c, :d] = data
    mpad = np.zeros((c_pad, lane), np.float32)
    mpad[:c, :d] = mask[:, None]
    out = ref.pallas_kde._masked_moments_padded(
        jnp.asarray(dpad), jnp.asarray(mpad), interpret=True
    )
    return np.asarray(out)[:3, :d]


@pytest.mark.parametrize("name", sorted(CASES))
def test_moments_match_reference_kernel(ref, name):
    data, mask, _ = _inputs(name)
    want = _ref_moments(ref, data, mask)
    got = masked_moments(torch.from_numpy(data), torch.from_numpy(mask)[None])[0].numpy()
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bandwidths_match_reference(ref, name):
    import jax.numpy as jnp

    data, mask, cards = _inputs(name)
    want = ref.pallas_kde.pallas_normal_reference_bandwidths(
        jnp.asarray(data), jnp.asarray(mask), jnp.asarray(cards), MIN_BW,
        interpret=True,
    )
    got = moment_bandwidths(
        torch.from_numpy(data), torch.from_numpy(mask), torch.from_numpy(cards),
        MIN_BW,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_two_sides_in_one_pass_equal_each_side_alone():
    """The fit scores both sides with one launch; each side's moments and
    bandwidths equal the one-side call's exactly."""
    data, mask, cards = _inputs("c1000_d5_mixed")
    other = (1.0 - mask).astype(np.float32)
    x, cd = torch.from_numpy(data), torch.from_numpy(cards)
    masks = torch.from_numpy(np.stack([mask, other]))
    both = moment_bandwidths(x, masks, cd, MIN_BW)
    assert both.shape == (2, data.shape[1])
    for s in range(2):
        assert torch.equal(both[s], moment_bandwidths(x, masks[s], cd, MIN_BW))
    assert torch.equal(masked_moments(x, masks), masked_moments_reference(x, masks))


def test_moments_wrapper_refuses_unknown_devices():
    data = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        masked_moments(data, torch.ones((1, 4), device="meta"))
