"""What the Hopper designs of ``csrc/kde_score.cu`` and ``csrc/kde_moments.cu``
rely on, checked on the CPU against the JAX reference.

* The scorer compacts each side's masked-in rows before its pair loop: the
  reference's scores must not change when a side gets only its live rows
  with an all-ones mask. A float32 model of the kernel's algorithm (its
  geometry from :func:`kde_score_geometry`, compaction in chunks of
  ``row_chunk`` rows, ``lanes`` lanes per candidate over rows ``l, l+K,
  ...``, the butterfly merge, ``1/bw`` scaling and hoisted constants) must
  agree with the Pallas kernel run by the Pallas interpreter.
* The launch geometry of both kernels comes from shapes only and stays
  inside the card's limits.
* The plain route of the fused moments-plus-bandwidths call equals
  ``pallas_normal_reference_bandwidths(..., interpret=True)`` bit for bit.

Inputs are made from numpy seeds. Scores agree to ``SCORE_TOL`` (the sums
run in another order); the plain bandwidth route is exact.
"""

import math

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.convert import kde_from_numpy
from hpbandster_tpu_torch.ops.cuda_kde import (
    kde_moments_geometry,
    kde_score_geometry,
    masked_moments,
    moment_bandwidths,
    score_candidates_reference,
)
from tests.test_torch_harness import ref  # noqa: F401

SCORE_TOL = dict(atol=1e-4, rtol=1e-5)
MIN_BW = 1e-3
F32 = np.float32

#: the main path's candidate counts (stage-0 counts 81/34/15/8/5 x 64)
MAIN_PATH_S = (5184, 2176, 960, 512, 320)


def _data(rng, n, cards):
    x = rng.uniform(size=(n, len(cards))).astype(F32)
    for j, k in enumerate(cards):
        if k:
            x[:, j] = rng.integers(k, size=n)
    return x


def _bw(ref, data, mask, cards):
    return np.asarray(ref.kde.normal_reference_bandwidths(
        data, mask, np.asarray(cards, np.int32)))


def _case(ref, name):
    """``(cands, good (data, mask, bw), bad (...), vartypes, cards)``.

    ``chunked_d6``: the chunked path's layout, one loss-sorted 256-row
    buffer shared by both sides, good = the rank prefix of 7, bad = a
    window of 8, d=6. ``mixed_all_masked``: all three kernel types, a
    partly masked good side and an all-masked bad side. ``overflow_d6``:
    more live rows than the list holds, so the kernel scores in chunks.
    ``wide_d64``: coordinates in shared memory, 128-row chunks."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "chunked_d6":
        cards = [0] * 6
        vt = np.zeros(6, np.int32)
        buf = _data(rng, 256, cards)
        count = 60  # rows filled; the rest are the sweep's zero pads
        buf[count:] = 0.0
        rank = np.arange(256)
        gmask = (rank < 7).astype(F32)
        bmask = ((rank >= count - 8) & (rank < count)).astype(F32)
        good = (buf, gmask, _bw(ref, buf, gmask, cards))
        bad = (buf, bmask, _bw(ref, buf, bmask, cards))
        s = 320
    elif name == "mixed_all_masked":
        cards = [0, 3, 5, 0, 2]
        vt = np.asarray([0, 1, 2, 0, 3], np.int32)  # 3: the inert code
        gdata, bdata = _data(rng, 40, cards), _data(rng, 30, cards)
        gmask = (rng.uniform(size=40) < 0.6).astype(F32)
        bmask = np.zeros(30, F32)
        good = (gdata, gmask, _bw(ref, gdata, gmask, cards))
        bad = (bdata, bmask, _bw(ref, bdata, np.ones(30, F32), cards))
        s = 100
    elif name == "overflow_d6":
        cards = [0, 0, 4, 0, 0, 3]
        vt = np.asarray([0, 0, 2, 0, 0, 1], np.int32)
        gdata, bdata = _data(rng, 1500, cards), _data(rng, 1200, cards)
        gmask = (rng.uniform(size=1500) < 0.97).astype(F32)
        bmask = np.ones(1200, F32)
        good = (gdata, gmask, _bw(ref, gdata, gmask, cards))
        bad = (bdata, bmask, _bw(ref, bdata, bmask, cards))
        s = 48
    else:  # wide_d64
        cards = [0] * 56 + [3, 4, 5, 6] * 2
        vt = np.asarray([0] * 56 + [1, 2] * 4, np.int32)
        gdata, bdata = _data(rng, 300, cards), _data(rng, 300, cards)
        gmask = (rng.uniform(size=300) < 0.5).astype(F32)
        bmask = (rng.uniform(size=300) < 0.9).astype(F32)
        good = (gdata, gmask, _bw(ref, gdata, gmask, cards))
        bad = (bdata, bmask, _bw(ref, bdata, bmask, cards))
        s = 40
    # candidates near the good rows, so scores sit above the floor
    cands = _data(rng, s, cards)
    live = np.flatnonzero(good[1] > 0)
    near = good[0][rng.choice(live, size=s)]
    cont = np.asarray(cards) == 0
    cands[:, cont] = np.clip(near[:, cont] + 0.05 * rng.normal(size=(s, int(cont.sum()))), 0, 1)
    return cands.astype(F32), good, bad, vt, np.asarray(cards, np.int32)


def _compact(side):
    """Only the live rows, all-ones mask; an all-masked side keeps one
    masked-out row (the function reads no masked row, and an empty buffer
    has no shape the reference accepts)."""
    data, mask, bw = side
    live = mask > 0
    if not live.any():
        return data[:1], np.zeros(1, F32), bw
    return data[live], np.ones(int(live.sum()), F32), bw


def _pallas(ref, cands, good, bad, vt, cards):
    import jax.numpy as jnp

    def kde(side):
        return ref.kde.KDE(*(jnp.asarray(x) for x in side))

    return np.asarray(ref.pallas_kde.pallas_score_candidates(
        cands, kde(good), kde(bad), vt, cards, interpret=True))


def _port(cands, good, bad, vt, cards):
    return score_candidates_reference(
        torch.from_numpy(cands), kde_from_numpy(*good), kde_from_numpy(*bad),
        torch.from_numpy(vt), torch.from_numpy(cards)).numpy()


@pytest.mark.parametrize("name", ["chunked_d6", "mixed_all_masked"])
def test_compaction_leaves_scores_unchanged(ref, name):
    """The masked buffer and its live rows alone give the same scores, in
    the reference and in the port's plain version."""
    cands, good, bad, vt, cards = _case(ref, name)
    want = _pallas(ref, cands, good, bad, vt, cards)
    cg, cb = _compact(good), _compact(bad)
    assert cg[0].shape[0] < good[0].shape[0]
    np.testing.assert_allclose(_pallas(ref, cands, cg, cb, vt, cards), want, **SCORE_TOL)
    np.testing.assert_allclose(_port(cands, good, bad, vt, cards), want, **SCORE_TOL)
    np.testing.assert_allclose(_port(cands, cg, cb, vt, cards), want, **SCORE_TOL)
    if name == "mixed_all_masked":
        # the all-masked side floors: score = max(lg, F) - F >= 0
        assert np.isfinite(want).all() and (want >= 0).all()


# ------------------------------------------------- the scorer's algorithm
_LOG_SQRT_2PI = F32(0.91893853320467274178)
_LOG_HALF = F32(-0.69314718055994530942)


def _side_consts(bw, cards):
    bw = np.maximum(bw.astype(F32), F32(1e-10))
    lam = np.minimum(np.maximum(bw, F32(1e-10)), F32(1.0 - 1e-7))
    km1 = np.maximum(cards.astype(F32) - F32(1), F32(1))
    l1m = np.log1p(-lam).astype(F32)
    loglam = np.log(lam).astype(F32)
    return dict(inv=(F32(1) / bw).astype(F32), cc=(-np.log(bw) - _LOG_SQRT_2PI).astype(F32),
                l1m=l1m, lu=(loglam - np.log(km1)).astype(F32),
                lo=(_LOG_HALF + l1m).astype(F32), loglam=loglam)


def _finish_side(m, s, n_eff):
    """The kernel's merge of the K lanes' (max, sum) pairs ``[S, K]``: a
    butterfly max, each lane's sum rescaled to it, a butterfly sum."""
    k = m.shape[1]
    mx = m.copy()
    o = k // 2
    while o:
        mx = np.maximum(mx, mx[:, np.arange(k) ^ o])
        o //= 2
    with np.errstate(invalid="ignore"):
        t = np.where(m == -np.inf, F32(0), s * np.exp(m - mx).astype(F32)).astype(F32)
    o = k // 2
    while o:
        t = (t + t[:, np.arange(k) ^ o]).astype(F32)
        o //= 2
    mx0, t0 = mx[:, 0], t[:, 0]
    m_safe = np.where(np.isfinite(mx0), mx0, F32(0))
    return (m_safe + np.log(np.maximum(t0, F32(1e-38))) - np.log(max(n_eff, F32(1)))).astype(F32)


class _SideModel:
    """One side's state in the model: constants, the list, the lanes'
    online (max, sum) pairs and the mask sum."""

    def __init__(self, x, data, mask, bw, vt, cards, lanes):
        self.x, self.data, self.mask, self.vt = x, data, mask, vt
        self.c = _side_consts(bw, cards)
        self.side_c = F32(0)
        for j in range(x.shape[1]):
            if vt[j] == 0:
                self.side_c = F32(self.side_c + self.c["cc"][j])
        self.m = np.full((x.shape[0], lanes), -np.inf, F32)
        self.s = np.zeros((x.shape[0], lanes), F32)
        self.n_eff, self.held = F32(0), []

    def add_pass(self, base, pass_rows):
        w = self.mask[base:base + pass_rows]
        self.n_eff = F32(self.n_eff + w.sum(dtype=F32))
        self.held += list(base + np.flatnonzero(w > 0))

    def walk(self):
        """Score the list: lane l takes rows l, l+K, ... in list order."""
        k, c, x = self.m.shape[1], self.c, self.x
        rows = np.asarray(self.held, np.int64)
        for t in range(0, len(rows), k):
            mu = self.data[rows[t:t + k]]
            lanes = mu.shape[0]
            acc = np.full((x.shape[0], lanes), self.side_c, F32)
            for j in range(x.shape[1]):
                diff = (x[:, None, j] - mu[None, :, j]).astype(F32)
                if self.vt[j] == 0:
                    z = (diff * c["inv"][j]).astype(F32)
                    acc = (acc + F32(-0.5) * z * z).astype(F32)
                elif self.vt[j] in (1, 2):
                    same = diff * diff < F32(0.25)
                    other = (c["lu"][j] if self.vt[j] == 1
                             else c["lo"][j] + np.abs(diff) * c["loglam"][j])
                    acc = (acc + np.where(same, c["l1m"][j], other)).astype(F32)
            mm, ss = self.m[:, :lanes], self.s[:, :lanes]
            up = acc > mm
            with np.errstate(invalid="ignore"):
                ss_new = np.where(up, ss * np.exp(mm - acc) + F32(1),
                                  np.where(acc != -np.inf, ss + np.exp(acc - mm), ss))
            self.m[:, :lanes] = np.where(up, acc, mm)
            self.s[:, :lanes] = ss_new.astype(F32)
        self.held = []


def _model_score(cands, good, bad, vt, cards):
    """Scores the kernel's way: both sides compact in lockstep passes of
    ``rows_per_thread * threads`` rows into their own lists of
    ``row_chunk`` rows, scored when either could overflow and after the
    last pass; then the lanes' merge and the floor."""
    geo = kde_score_geometry(cands.shape[0], cands.shape[1], good[0].shape[0], bad[0].shape[0])
    sides = [_SideModel(cands, *side, vt, cards, geo.lanes) for side in (good, bad)]
    pass_rows = geo.rows_per_thread * geo.threads
    n_max = max(good[0].shape[0], bad[0].shape[0])
    for base in range(0, n_max, pass_rows):
        for side in sides:
            side.add_pass(base, pass_rows)
            assert len(side.held) <= geo.row_chunk
        if base + pass_rows >= n_max or any(
                len(side.held) + pass_rows > geo.row_chunk for side in sides):
            for side in sides:
                side.walk()
    lg, lb = (_finish_side(side.m, side.s, side.n_eff) for side in sides)
    floor = F32(math.log(1e-32))
    return np.maximum(lg, floor) - np.maximum(lb, floor), geo


@pytest.mark.parametrize("name", ["chunked_d6", "mixed_all_masked", "overflow_d6", "wide_d64"])
def test_kernel_algorithm_matches_pallas_interpreter(ref, name):
    """Compaction in chunks, K lanes per candidate, the butterfly merge and
    the 1/bw scaling give the reference's scores within ``SCORE_TOL``; the
    same inputs give the same bits again."""
    cands, good, bad, vt, cards = _case(ref, name)
    want = _pallas(ref, cands, good, bad, vt, cards)
    got, geo = _model_score(cands, good, bad, vt, cards)
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    assert np.array_equal(got, _model_score(cands, good, bad, vt, cards)[0])
    if name == "overflow_d6":
        live = int((good[1] > 0).sum())
        assert live > geo.row_chunk  # the chunked branch really ran
    if name == "wide_d64":
        assert geo.dmax == 0 and geo.row_chunk < 300


# ------------------------------------------------------------- geometry
@pytest.mark.parametrize("d", [2, 6, 16, 64])
@pytest.mark.parametrize("shape", [(s, 7, 8) for s in MAIN_PATH_S]
                         + [(s, 256, 256) for s in MAIN_PATH_S]
                         + [(5184, 64, 320), (8192, 256, 256), (1000, 40, 30)])
def test_score_geometry_fits_the_card(shape, d):
    s, ng, nb = shape
    geo = kde_score_geometry(s, d, ng, nb)
    assert geo.threads == 128 and geo.lanes & (geo.lanes - 1) == 0 and 1 <= geo.lanes <= 32
    assert geo.blocks * (geo.threads // geo.lanes) >= s
    assert geo.smem_bytes <= 227 * 1024
    if d <= 32:
        # no opt-in attribute needed (wider spaces: the launch sets it)
        assert geo.smem_bytes <= 48 * 1024
    assert geo.row_chunk >= geo.rows_per_thread * geo.threads
    assert geo.dmax == (0 if d > 32 else next(w for w in (8, 16, 32) if d <= w))
    if s == 5184:
        assert geo.blocks >= 2 * 132


def test_score_geometry_reads_shapes_only(ref):
    """The geometry is a function of (S, d, n_good, n_bad): every mask over
    the same buffers launches the same grid, and the model of the kernel
    gives the same bits for the same inputs."""
    cands, good, bad, vt, cards = _case(ref, "chunked_d6")
    shapes = (cands.shape[0], cands.shape[1], good[0].shape[0], bad[0].shape[0])
    geo = kde_score_geometry(*shapes)
    assert kde_score_geometry.__wrapped__(*shapes) == geo
    for live in (0, 7, 200, 256):
        mask = (np.arange(256) < live).astype(F32)
        g2 = (good[0], mask, good[2])
        assert kde_score_geometry(*shapes) == geo
        first = _model_score(cands, g2, bad, vt, cards)
        assert first[1] == geo
        assert np.array_equal(first[0], _model_score(cands, g2, bad, vt, cards)[0])


@pytest.mark.parametrize("c,d,sides", [(256, 6, 2), (256, 6, 1), (1 << 17, 16, 2),
                                       (1 << 20, 6, 2), (1 << 17, 6, 2), (1000, 64, 2)])
def test_moments_geometry(c, d, sides):
    geo = kde_moments_geometry(c, d, sides)
    rows_per_thread = -(-c // (geo.row_blocks * geo.threads))
    assert geo.dim_chunks * geo.dmax >= d > (geo.dim_chunks - 1) * geo.dmax
    if c <= 256 and d <= 32:
        # the main path's fit: one block, no partials, no ticket
        assert geo.row_blocks == geo.dim_chunks == 1 and geo.partial_floats == 0
    else:
        assert geo.partial_floats == geo.row_blocks * sides * 3 * d
    if c >= 1 << 17:
        assert rows_per_thread >= 4
    if d > 32:
        assert geo.dmax == 8 and geo.dim_chunks == 8


# ------------------------------------- the fused bandwidths' plain route
#: (C, cards, live rows per side): live counts whose float32 n^(-1/(4+d))
#: torch and XLA round alike (ROADMAP C: their pow differs in the last bit
#: for some n; the test checks that precondition itself)
FIT_CASES = {
    "one_side_c256_d6": (256, [0] * 6, [7]),
    "two_sides_c256_d6": (256, [0] * 6, [7, 12]),
    "two_sides_c1000_mixed": (1000, [0, 3, 5, 0, 2], [150, 600]),
}


@pytest.mark.parametrize("name", sorted(FIT_CASES))
def test_fused_bandwidths_plain_route_is_the_reference_bit_for_bit(ref, name):
    import jax.numpy as jnp

    c, cards, lives = FIT_CASES[name]
    d = len(cards)
    rng = np.random.default_rng(sum(map(ord, name)))
    data = _data(rng, c, cards)
    masks = np.zeros((len(lives), c), F32)
    for s, live in enumerate(lives):
        masks[s, rng.permutation(c)[:live]] = 1.0
    exponent = -1.0 / (4.0 + d)
    n = np.asarray(lives, F32)
    assert np.array_equal((torch.from_numpy(n) ** exponent).numpy(),
                          np.asarray(jnp.asarray(n) ** exponent))
    cards_np = np.asarray(cards, np.int32)
    want = np.stack([np.asarray(ref.pallas_kde.pallas_normal_reference_bandwidths(
        jnp.asarray(data), jnp.asarray(m), jnp.asarray(cards_np), MIN_BW,
        interpret=True)) for m in masks])
    x, cd = torch.from_numpy(data), torch.from_numpy(cards_np)
    if len(lives) == 1:
        got = moment_bandwidths(x, torch.from_numpy(masks[0]), cd, MIN_BW).numpy()[None]
    else:
        got = moment_bandwidths(x, torch.from_numpy(masks), cd, MIN_BW).numpy()
        # the fused call serves both sides from one pass, as each alone
        for s in range(2):
            alone = moment_bandwidths(x, torch.from_numpy(masks[s]), cd, MIN_BW)
            assert torch.equal(alone, torch.from_numpy(got[s]))
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    # and the moments under them are exact too
    mom = masked_moments(x, torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(mom[:, 2], np.broadcast_to(n[:, None], (len(lives), d)))
