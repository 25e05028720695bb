"""Port vs reference: KDE fit, candidate sampling and the acquisition scorer.

The scorer's plain version (``score_candidates_reference``, what the port
runs on the CPU) is held against the Pallas kernel run by the Pallas
interpreter, on the cases of ``tests/test_pallas_kde.py``. Tolerances: the
logsumexp sums in another order, so scores agree to ``atol 1e-4, rtol
1e-5``; fits and draws compute the same float32 formulas, to ``1e-6``.
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.convert import kde_from_numpy
from hpbandster_tpu_torch.ops.cuda_kde import (
    LAUNCHES,
    propose_from_candidates,
    score_candidates,
)
from hpbandster_tpu_torch.ops.kde import (
    candidates_from_uniforms,
    normal_reference_bandwidths,
)
from hpbandster_tpu_torch.ops.sweep import _fit_kde_pair_device
from tests.test_torch_harness import ref  # noqa: F401

SCORE_TOL = dict(atol=1e-4, rtol=1e-5)


def _data(rng, n, cards):
    d = len(cards)
    data = np.zeros((n, d), np.float32)
    for j, c in enumerate(cards):
        data[:, j] = rng.integers(c, size=n) if c > 0 else rng.uniform(size=n)
    return data


def _vartypes(cards):
    # discrete dims alternate unordered (1) / ordinal (2), as in
    # tests/test_pallas_kde.py
    return np.asarray([0 if c == 0 else 1 + (i % 2) for i, c in enumerate(cards)], np.int32)


def _kde(ref, rng, n, cards, cap=64):
    """A reference KDE padded to ``cap`` rows, bandwidths from the reference."""
    import jax.numpy as jnp

    padded = np.zeros((cap, len(cards)), np.float32)
    padded[:n] = _data(rng, n, cards)
    mask = np.zeros(cap, np.float32)
    mask[:n] = 1.0
    bw = np.asarray(ref.kde.normal_reference_bandwidths(
        padded, mask, np.asarray(cards, np.int32)))
    return ref.kde.KDE(jnp.asarray(padded), jnp.asarray(mask), jnp.asarray(bw))


def _port(kde):
    return kde_from_numpy(*(np.asarray(x) for x in kde))


@pytest.mark.parametrize(
    "cards,n_rows",
    [([0, 0], 40), ([0, 0, 3, 4], 25), ([0, 3, 0, 5, 2, 0], 64), ([4, 2, 0], 1)],
)
def test_bandwidths_match(ref, cards, n_rows):
    rng = np.random.default_rng(len(cards))
    data = _data(rng, 64, cards)
    mask = (np.arange(64) < n_rows).astype(np.float32)
    cards_np = np.asarray(cards, np.int32)
    want = np.asarray(ref.kde.normal_reference_bandwidths(data, mask, cards_np, 1e-3))
    got = normal_reference_bandwidths(
        torch.from_numpy(data), torch.from_numpy(mask),
        torch.from_numpy(cards_np), 1e-3,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cards", [[0, 0], [0, 3, 0, 5, 2, 0]])
def test_fit_kde_pair_matches(ref, cards):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    n = 60
    vecs = _data(rng, n, cards)
    losses = np.round(rng.normal(size=n), 1).astype(np.float32)  # ties
    losses[:5] = np.inf  # crashed observations enter as +inf
    cards_np = np.asarray(cards, np.int32)
    for n_good, n_bad in [(9, 51), (12, 40)]:
        want = ref.sweep._fit_kde_pair_device(
            jnp.asarray(vecs), jnp.asarray(losses), n_good, n_bad,
            jnp.asarray(cards_np), 1e-3,
        )
        got = _fit_kde_pair_device(
            torch.from_numpy(vecs), torch.from_numpy(losses), n_good, n_bad,
            torch.from_numpy(cards_np), 1e-3,
        )
        for w, g in zip(want, got):
            for wa, ga in zip(w, g):
                np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cards", [[0, 0], [0, 3, 0, 5, 2, 0]])
def test_candidates_from_reference_uniforms(ref, cards):
    """Fed the uniforms the reference's ``generate_candidates`` draws from
    its key, the port's sampling arithmetic gives the same candidates."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    good = _kde(ref, rng, 20, cards)
    vt = _vartypes(cards)
    cards_np = np.asarray(cards, np.int32)
    total, d = 256, len(cards)
    key = jax.random.key(21)
    want = np.asarray(ref.kde.generate_candidates(
        key, good, jnp.asarray(vt), jnp.asarray(cards_np), total, 3.0, 1e-3))

    k_idx, k_samp = jax.random.split(key)
    logits = jnp.where(good.mask > 0, 0.0, -jnp.inf)
    idx = jax.random.categorical(k_idx, logits, shape=(total,))

    def uniforms(k):
        k_cont, k_keep, k_cat = jax.random.split(k, 3)
        return (jax.random.uniform(k_cont, (d,)), jax.random.uniform(k_keep, (d,)),
                jax.random.uniform(k_cat, (d,)))

    u = [torch.from_numpy(np.array(x))
         for x in jax.vmap(uniforms)(jax.random.split(k_samp, total))]
    got = candidates_from_uniforms(
        _port(good), torch.from_numpy(np.array(idx)), *u,
        torch.from_numpy(vt), torch.from_numpy(cards_np), 3.0, 1e-3,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _score_case(ref, case):
    rng = np.random.default_rng([2, 4, 6, "empty_rows", "all_masked_side"].index(case))
    if case == "empty_rows":  # tests/test_pallas_kde.py::test_empty_mask_rows_ignored
        cards = [0, 0]
        good, bad = _kde(ref, rng, 5, cards), _kde(ref, rng, 5, cards)
        vt = np.zeros(2, np.int32)
        n_cands = 8
    elif case == "all_masked_side":  # every bad row masked out
        cards = [0, 4, 3]
        good = _kde(ref, rng, 20, cards)
        bad = _kde(ref, rng, 20, cards)
        bad = bad._replace(mask=bad.mask * 0.0)
        vt = np.asarray([0, 2, 1], np.int32)
        n_cands = 64
    else:  # tests/test_pallas_kde.py::test_matches_xla_path
        cards = {2: [0, 0], 4: [0, 0, 3, 4], 6: [0, 3, 0, 5, 2, 0]}[case]
        vt = _vartypes(cards)
        good, bad = _kde(ref, rng, 20, cards), _kde(ref, rng, 25, cards)
        n_cands = 37  # not a multiple of the reference's 128-row tile
    cands = _data(rng, n_cands, cards)
    return cands, good, bad, vt, np.asarray(cards, np.int32)


@pytest.mark.parametrize("case", [2, 4, 6, "empty_rows", "all_masked_side"])
def test_scorer_matches_pallas_interpreter(ref, case):
    cands, good, bad, vt, cards = _score_case(ref, case)
    want = np.asarray(ref.pallas_kde.pallas_score_candidates(
        cands, good, bad, vt, cards, interpret=True))
    before = LAUNCHES["kde_score"]
    got = score_candidates(
        torch.from_numpy(cands), _port(good), _port(bad),
        torch.from_numpy(vt), torch.from_numpy(cards),
    ).numpy()
    assert LAUNCHES["kde_score"] == before  # CPU tensors never launch
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    if case == "all_masked_side":
        # the all-masked side floors at LOG_PDF_FLOOR: score = max(lg, F) - F
        assert np.isfinite(got).all() and (got >= 0.0).all()


@pytest.mark.parametrize("case", [4, 6])
def test_proposal_argmax_matches(ref, case):
    """Per-proposal argmax over the scores: equal to the reference's unless
    the reference's top two are within the scoring tolerance."""
    import jax.numpy as jnp

    rng = np.random.default_rng(100 + case)
    _, good, bad, vt, cards = _score_case(ref, case)
    n, k = 12, 16
    cands = _data(rng, n * k, list(cards))
    want = np.asarray(ref.pallas_kde.pallas_score_candidates(
        cands, good, bad, vt, cards, interpret=True)).reshape(n, k)
    got_vecs = propose_from_candidates(
        torch.from_numpy(cands), _port(good), _port(bad),
        torch.from_numpy(vt), torch.from_numpy(cards), n,
    ).numpy()
    best = np.argmax(want, axis=1)
    top2 = np.sort(want, axis=1)[:, -2:]
    near_tie = np.abs(top2[:, 1] - top2[:, 0]) <= SCORE_TOL["atol"] + SCORE_TOL["rtol"] * np.abs(top2[:, 1])
    picked = cands.reshape(n, k, -1)[np.arange(n), best]
    for i in range(n):
        if not near_tie[i]:
            np.testing.assert_array_equal(got_vecs[i], picked[i])
    # the reference's own jnp.argmax agrees with numpy's first-max rule
    np.testing.assert_array_equal(np.asarray(jnp.argmax(jnp.asarray(want), axis=1)), best)


def test_propose_batch_draws_and_picks_the_best():
    """``propose_batch``: one flat draw of ``n * num_samples`` candidates,
    then the best-scoring one per proposal; deterministic in its generator."""
    from hpbandster_tpu_torch.ops.cuda_kde import propose_batch, score_candidates
    from hpbandster_tpu_torch.ops.kde import generate_candidates

    rng = np.random.default_rng(4)
    cards = np.asarray([0, 3, 0, 4], np.int32)
    vt = torch.from_numpy(np.asarray([0, 1, 0, 2], np.int32))
    cards_t = torch.from_numpy(cards)

    def kde(n):
        data = torch.from_numpy(_data(rng, n, list(cards)))
        mask = torch.ones(n)
        return kde_from_numpy(data, mask, normal_reference_bandwidths(data, mask, cards_t))

    good, bad = kde(12), kde(30)
    n, k = 5, 16
    got = propose_batch(torch.Generator().manual_seed(3), good, bad, vt, cards_t, n, k)
    again = propose_batch(torch.Generator().manual_seed(3), good, bad, vt, cards_t, n, k)
    np.testing.assert_array_equal(got.numpy(), again.numpy())
    cands = generate_candidates(torch.Generator().manual_seed(3), good, vt, cards_t, n * k)
    scores = score_candidates(cands, good, bad, vt, cards_t).reshape(n, k)
    want = cands.reshape(n, k, -1)[torch.arange(n), scores.argmax(1)]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.shape == (n, 4)
    assert ((got >= 0) & (got <= torch.from_numpy(np.maximum(cards - 1, 1)).float())).all()
