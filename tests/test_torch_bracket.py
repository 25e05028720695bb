"""The port's bracket functions (``hpbandster_tpu_torch/ops/bracket.py``)
against the reference's on seeded losses with NaNs and ties: the HyperBand
schedule, the promotion rule on the tensor's device and its compiled form,
and the resampling rule. All exact."""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.ops import bracket as tb
from tests.test_torch_harness import ref  # noqa: F401  (fixture)


def _losses(seed, n):
    """Seeded float32 losses with crashes (NaN) and ties: a third of the
    values repeat an earlier one, a few are NaN, one is -inf."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    x[rng.integers(n, size=n // 3)] = x[rng.integers(n, size=n // 3)]
    x[rng.integers(n, size=max(n // 8, 1))] = np.nan
    if n > 4:
        x[n - 1] = -np.inf
    return x


@pytest.mark.parametrize("args", [(5, 1, 81, 3), (7, 1, 27, 3), (4, 0.01, 1, 2), (9, 3, 243, 3)])
def test_hyperband_schedule(ref, args):  # noqa: F811
    assert tb.hyperband_schedule(*args) == ref.bracket.hyperband_schedule(*args)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 9), (2, 27), (3, 81), (4, 64)])
def test_promotion_mask_matches_reference(ref, seed, n):  # noqa: F811
    losses = _losses(seed, n)
    compiled = tb.sh_promotion_mask_compiled()
    for k in sorted({0, 1, n // 3, n // 2, n}):
        want = np.asarray(ref.bracket.sh_promotion_mask(losses, k))
        got = tb.sh_promotion_mask(torch.from_numpy(losses), k).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tb.sh_promotion_mask_np(losses, k), want)
        # the compiled rule takes k as a tensor, one callable for every width
        np.testing.assert_array_equal(
            compiled(torch.from_numpy(losses), torch.tensor(k, dtype=torch.int32)).numpy(),
            want)


def test_promotion_mask_ties_go_to_the_lower_index(ref):  # noqa: F811
    losses = np.array([1.0, np.nan, 0.5, 0.5, np.nan, 0.5, 2.0], np.float32)
    got = tb.sh_promotion_mask(torch.from_numpy(losses), 2).numpy()
    np.testing.assert_array_equal(got, [False, False, True, True, False, False, False])
    np.testing.assert_array_equal(got, np.asarray(ref.bracket.sh_promotion_mask(losses, 2)))
    # NaN ranks as +inf, behind every finite loss, lower index first
    got = tb.sh_promotion_mask(torch.from_numpy(losses), 6).numpy()
    np.testing.assert_array_equal(got, [True, True, True, True, False, True, True])


@pytest.mark.parametrize("seed,n,k,rate", [(0, 9, 3, 0.5), (1, 27, 9, 2 / 3),
                                           (2, 81, 27, 0.1), (3, 12, 4, 0.99),
                                           (4, 3, 1, 0.0)])
def test_resample_mask_matches_reference(ref, seed, n, k, rate):  # noqa: F811
    import jax

    losses = _losses(seed, n)
    mask_r, n_res_r = ref.bracket.sh_resample_mask(losses, k, rate, jax.random.key(seed))
    mask, n_res = tb.sh_resample_mask(torch.from_numpy(losses), k, rate)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_r))
    assert int(n_res) == int(n_res_r)
    # k as a tensor takes the same path on the device
    mask_t, n_res_t = tb.sh_resample_mask(torch.from_numpy(losses),
                                          torch.tensor(k, dtype=torch.int32), rate)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_r))
    assert int(n_res_t) == int(n_res_r)
