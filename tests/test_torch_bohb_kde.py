"""The port's ``BOHBKDE`` (``hpbandster_tpu_torch/models/bohb_kde.py``) and
its proposal functions against the reference's, on the CPU.

The host half must be the reference's draw for draw: after the same
sequence of ``new_result`` calls both generators hold equal KDE models (bit
for bit), the same split arithmetic, imputation and model budget, and the
same numpy stream. The proposals take the reference's own candidates
through the draw seam (``tests/test_torch_harness.py::ReferenceKDEDraws``)
and score them with the port's scorer (the plain version here,
``kde_score.cu`` on a card), which sums the per-dim terms in another order
than the reference's XLA ``kde_logpdf``. So, with the tolerance stated
once (``SCORE_TOL``):

* a pick equals the reference's wherever the reference's two best scores
  of that proposal differ by more than ``SCORE_TOL``;
* elsewhere the pick's reference score is within ``SCORE_TOL`` of the best;
* ``lg_score`` agrees within ``SCORE_TOL`` (plus its 6-decimal rounding).

The spaces are the harness's mixed space (continuous, log, integer,
categorical, ordinal, quantized) and its conditional space.
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import space as tspace
from hpbandster_tpu_torch.core.job import Job
from hpbandster_tpu_torch.models.bohb_kde import BOHBKDE
from hpbandster_tpu_torch.ops import cuda_kde
from hpbandster_tpu_torch.ops import kde as tkde
from tests.test_torch_harness import (  # noqa: F401  (fixtures)
    ReferenceKDEDraws,
    cond_space,
    make_space,
    ref,
    ref_opt,
)

SCORE_TOL = 1e-4
#: the in-trace fit's pair and the vectors drawn around it (see
#: test_refit_propose_matches_twin)
PAIR_RTOL = 1e-6
VEC_RTOL = 1e-5
#: small waves keep the reference's Pallas interpreter quick
KW = dict(num_samples=16, proposal_batch_size=8, seed=3)


@pytest.fixture(scope="module")
def ref_logpdf(ref):  # noqa: F811
    """The reference's XLA acquisition score of candidates ``[S, d]``
    under a pair, jitted once."""
    import jax
    import jax.numpy as jnp

    kde = ref.kde

    def scores(cands, g, b, vt, cards):
        lg = jax.vmap(lambda c: kde.kde_logpdf(c, g, vt, cards))(cands)
        lb = jax.vmap(lambda c: kde.kde_logpdf(c, b, vt, cards))(cands)
        return jnp.maximum(lg, kde.LOG_PDF_FLOOR) - jnp.maximum(lb, kde.LOG_PDF_FLOOR)

    jitted = jax.jit(scores)

    def run(cands, good, bad, vt, cards):
        to = lambda t: jnp.asarray(np.asarray(t))  # noqa: E731
        return np.asarray(jitted(to(cands), kde.KDE(*map(to, good)),
                                 kde.KDE(*map(to, bad)), to(vt), to(cards)))

    return run


def spaces(ref, name):  # noqa: F811
    if name == "conditional":
        return cond_space(ref.space, seed=1), cond_space(tspace, seed=1)
    return make_space(ref.space, "mixed", seed=1), make_space(tspace, "mixed", seed=1)


def feed(ref_opt, cg_ref, cg, space, n_per_budget=(30, 12), seed=0):  # noqa: F811
    """The same seeded results into both generators: configs drawn from
    the port's space, losses with crashes, some delivered eagerly and some
    as a burst (``update_model=False``)."""
    rng = np.random.default_rng(seed)
    for b, n in zip((1.0, 3.0), n_per_budget):
        for i, cfg in enumerate(space.sample_configuration(n, rng=rng)):
            loss = float(rng.normal()) if rng.uniform() > 0.1 else None
            eager = i % 3 == 0
            for J, gen in ((ref_opt.master.Job, cg_ref), (Job, cg)):
                job = J((0, 0, i), config=dict(cfg), budget=b)
                job.result = None if loss is None else {"loss": loss, "info": {}}
                job.exception = "crashed" if loss is None else None
                gen.new_result(job, update_model=eager)


def make_pair(ref, ref_opt, name, **kw):  # noqa: F811
    cs_ref, cs = spaces(ref, name)
    cg_ref = ref_opt.bohb_kde.BOHBKDE(cs_ref, **{**KW, **kw})
    cg = BOHBKDE(cs, device="cpu", **{**KW, **kw})
    cg.draws = ReferenceKDEDraws(ref, trickle_seed=KW["seed"])
    feed(ref_opt, cg_ref, cg, cs)
    return cg_ref, cg, cs


def check_picks(ref_logpdf, cg, out, cands, good, bad, ref_out=None, vec_rtol=0.0):
    """Each model pick of ``out`` (the port's ``(config, info)`` list)
    against the reference's scores of its proposal's candidates (block
    ``k`` of ``cands``) under ``(good, bad)``; against ``ref_out``, the
    reference generator's own list, where given (its picks' vectors within
    ``vec_rtol``: 0 is exact). Returns the number of picks decided by a gap
    above ``SCORE_TOL``."""
    s_all = cg.num_samples
    scores = ref_logpdf(cands, good, bad, cg._vartypes_dev, cg._cards_dev)
    port_scores = cuda_kde.score_candidates(cands, good, bad, cg._vartypes_dev,
                                            cg._cards_dev).numpy()
    decided, k = 0, 0
    for i, (cfg, info) in enumerate(out):
        if not info["model_based_pick"]:
            if ref_out is not None:
                assert ref_out[i] == (cfg, info)
            continue
        s = scores[k * s_all:(k + 1) * s_all]
        block = cands[k * s_all:(k + 1) * s_all]
        top = np.argsort(-s, kind="stable")
        j = int(np.argmax(port_scores[k * s_all:(k + 1) * s_all]))
        assert cfg == dict(cg.configspace.from_vector(block[j].numpy())), "pick is not the port's argmax"
        if s[top[0]] - s[top[1]] > SCORE_TOL:
            assert j == top[0]
            decided += 1
        else:
            assert s[j] >= s[top[0]] - SCORE_TOL
        if "lg_score" in info:
            assert abs(info["lg_score"] - s[top[0]]) <= SCORE_TOL + 1e-6
        if ref_out is not None:
            ref_cfg, ref_info = ref_out[i]
            assert ref_info["model_based_pick"]
            if s[top[0]] - s[top[1]] > SCORE_TOL:
                vecs = [cg.configspace.to_vector(c) for c in (cfg, ref_cfg)]
                np.testing.assert_allclose(*vecs, rtol=vec_rtol, atol=0)
            if "lg_score" in info:
                assert abs(info["lg_score"] - ref_info["lg_score"]) <= SCORE_TOL + 2e-6
        k += 1
    return decided


@pytest.mark.parametrize("name", ["mixed", "conditional"])
def test_host_fit_matches_reference(ref, ref_opt, name):  # noqa: F811
    """Equal KDE models bit for bit, the same split arithmetic, imputation,
    model budget and numpy stream after the same results."""
    cg_ref, cg, cs = make_pair(ref, ref_opt, name)
    assert cg.largest_budget_with_model() == cg_ref.largest_budget_with_model() == 3.0
    assert set(cg.kde_models) == set(cg_ref.kde_models)
    for b, pair in cg.kde_models.items():
        for side, side_ref in zip(pair, cg_ref.kde_models[b]):
            for a, a_ref in zip(side, side_ref):
                assert a.dtype == np.asarray(a_ref).dtype
                np.testing.assert_array_equal(a, np.asarray(a_ref))
    for n in range(0, 60):
        assert cg._trained_split(n) == cg_ref._trained_split(n)
    assert cg.rng.bit_generator.state == cg_ref.rng.bit_generator.state
    data = np.stack([cs.to_vector(c) for c in cs.sample_configuration(
        20, rng=np.random.default_rng(5))])
    data[::4, 0] = np.nan
    np.testing.assert_array_equal(cg.impute_conditional_data(data),
                                  cg_ref.impute_conditional_data(data))
    assert cg.rng.bit_generator.state == cg_ref.rng.bit_generator.state


@pytest.mark.parametrize("name", ["mixed", "conditional"])
def test_batch_per_proposal_route(ref, ref_opt, ref_logpdf, name):  # noqa: F811
    """``get_config_batch`` in the reference's default layout (its vmapped
    ``propose``), with ``lg_score``, against the reference generator."""
    cg_ref, cg, _ = make_pair(ref, ref_opt, name)
    assert not cg.use_pallas
    decided = 0
    for n in (9, 27, 3):
        out_ref = cg_ref.get_config_batch(3.0, n)
        out = cg.get_config_batch(3.0, n)
        good, bad = cg._device_kde_pair(3.0)
        decided += check_picks(ref_logpdf, cg, out, cg.draws.calls[-1], good, bad, out_ref)
        assert cg.rng.bit_generator.state == cg_ref.rng.bit_generator.state
    assert decided > 5


@pytest.mark.parametrize("name", ["mixed", "conditional"])
def test_batch_flat_route(ref, ref_opt, ref_logpdf, name):  # noqa: F811
    """``get_config_batch`` in the flat layout (the reference's
    ``use_pallas`` route, ``generate_candidates_seeded``), which the port
    takes on a card; forced here on the CPU. No ``lg_score``. The
    reference's own Pallas route (interpreted) picks the same where its
    scores leave no tie."""
    import jax.numpy as jnp

    cg_ref, cg, _ = make_pair(ref, ref_opt, name)
    cg.use_pallas = True
    n = 9
    out_ref = cg_ref.get_config_batch(3.0, n)  # aligns the host stream
    out = cg.get_config_batch(3.0, n)
    assert cg.rng.bit_generator.state == cg_ref.rng.bit_generator.state
    good, bad = cg._device_kde_pair(3.0)
    cands = cg.draws.calls[-1]
    assert check_picks(ref_logpdf, cg, out, cands, good, bad) > 0
    assert all("lg_score" not in info for _, info in out)
    for (c, i), (c_ref, i_ref) in zip(out, out_ref):
        if not i["model_based_pick"]:
            assert (c, i) == (c_ref, i_ref)
    # the reference's Pallas route on the same seed and pair
    seed = cg.draws.seeds[-1]
    to = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    n_pad = cands.shape[0] // cg.num_samples
    vecs = np.asarray(ref.pallas_kde.pallas_propose_batch_seeded(
        jnp.uint32(seed), ref.kde.KDE(*map(to, good)), ref.kde.KDE(*map(to, bad)),
        to(cg._vartypes_dev), to(cg._cards_dev), n_pad, cg.num_samples,
        cg.bandwidth_factor, cg.min_bandwidth, interpret=True))
    scores = ref_logpdf(cands, good, bad, cg._vartypes_dev, cg._cards_dev)
    scores = np.sort(scores.reshape(n_pad, -1), axis=1)
    picks = [c for (c, i) in out if i["model_based_pick"]]
    assert picks
    for k, cfg in enumerate(picks):
        if scores[k, -1] - scores[k, -2] > SCORE_TOL:
            assert cfg == dict(cg.configspace.from_vector(vecs[k]))


def test_trickle_get_config(ref, ref_opt, ref_logpdf):  # noqa: F811
    """The one-at-a-time ``get_config``: its candidates come from a stream
    of its own (the reference's jax key chain, the port's seeded
    generator), not from ``self.rng``."""
    cg_ref, cg, _ = make_pair(ref, ref_opt, "mixed", random_fraction=0.25)
    n_model = 0
    for _ in range(12):
        cfg_ref, info_ref = cg_ref.get_config(1.0)
        cfg, info = cg.get_config(1.0)
        assert cg.rng.bit_generator.state == cg_ref.rng.bit_generator.state
        if info["model_based_pick"]:
            good, bad = cg._device_kde_pair(3.0)
            check_picks(ref_logpdf, cg, [(cfg, info)], cg.draws.calls[-1], good, bad,
                        [(cfg_ref, info_ref)])
            n_model += 1
        else:
            assert (cfg, info) == (cfg_ref, info_ref)
    assert n_model >= 6


@pytest.fixture
def moments_fit(request, monkeypatch):
    monkeypatch.setenv("HPB_PALLAS_KDE_FIT", request.param)


def buffers(space, n_obs, cap, seed):
    rng = np.random.default_rng(seed)
    v = np.zeros((cap, space.dim), np.float32)
    v[:n_obs] = np.stack([space.to_vector(c) for c in space.sample_configuration(n_obs, rng=rng)])
    losses = np.full(cap, np.inf, np.float32)
    losses[:n_obs] = rng.normal(size=n_obs)
    return v, losses


@pytest.mark.parametrize("moments_fit", ["0", "1"], indirect=True)
@pytest.mark.parametrize("name", ["mixed", "conditional"])
def test_refit_propose_matches_twin(ref, ref_logpdf, moments_fit, name):  # noqa: F811
    """``refit_propose_batch_seeded`` against the reference's on the same
    raw buffers (the moments fit on and off, imputation on the conditional
    space), and the flat twin against the reference's Pallas route. The
    fitted pairs agree to ``PAIR_RTOL``: the moments fit's one-pass
    variance goes through a float32 ``pow`` that differs from XLA's in the
    last bit on some inputs (ROADMAP C.10), and the candidates drawn around
    a bandwidth one ulp apart move by a few ulps (``VEC_RTOL``)."""
    import jax
    import jax.numpy as jnp

    cs_ref, cs = spaces(ref, name)
    cap, n_obs, n_good, n_bad, n, s = 64, 40, 7, 34, 8, 16
    v, losses = buffers(cs, n_obs, cap, 7)
    if name == "mixed":
        v = np.nan_to_num(v)
    vt = torch.as_tensor(cs.vartypes())
    cards = torch.as_tensor(cs.cardinalities())
    seed, impute_seed = 123456789, (987654 if name == "conditional" else None)
    draws = ReferenceKDEDraws(ref)
    vecs, scores = tkde.refit_propose_batch_seeded(
        seed, torch.from_numpy(v), torch.from_numpy(losses), n_obs, n_good, n_bad,
        vt, cards, n, s, 3.0, 1e-3, impute_seed=impute_seed, draws=draws)
    impute_key = None if impute_seed is None else jax.random.key(np.uint32(impute_seed))
    jv, jl = jnp.asarray(v), jnp.asarray(losses)
    jvt, jcards = jnp.asarray(cs.vartypes()), jnp.asarray(cs.cardinalities())
    good_r, bad_r = ref.kde.fit_kde_pair_masked(
        jv, jl, jnp.int32(n_obs), jnp.int32(n_good), jnp.int32(n_bad), jcards, 1e-3,
        impute_key=impute_key)
    good, bad = tkde.refit_pair(torch.from_numpy(v), torch.from_numpy(losses), n_obs,
                                n_good, n_bad, cards, 1e-3, impute_seed, draws)
    for side, side_r in ((good, good_r), (bad, bad_r)):
        for a, a_r in zip(side, side_r):
            np.testing.assert_allclose(a.numpy(), np.asarray(a_r), rtol=PAIR_RTOL, atol=0)
    vecs_r, scores_r = ref.kde.refit_propose_batch_seeded(
        jnp.uint32(seed), jv, jl, jnp.int32(n_obs), jnp.int32(n_good), jnp.int32(n_bad),
        jvt, jcards, n, s, 3.0, 1e-3,
        impute_seed=None if impute_seed is None else jnp.uint32(impute_seed))
    cands = draws.calls[0]
    all_r = ref_logpdf(cands, good, bad, vt, cards).reshape(n, s)
    top2 = np.sort(all_r, axis=1)[:, -2:]
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_r), atol=SCORE_TOL, rtol=0)
    sure = top2[:, 1] - top2[:, 0] > SCORE_TOL
    assert sure.sum() >= n // 2
    np.testing.assert_allclose(vecs.numpy()[sure], np.asarray(vecs_r)[sure],
                               rtol=VEC_RTOL, atol=0)

    # the flat twin against the reference's Pallas route (interpreted)
    draws = ReferenceKDEDraws(ref)
    flat = cuda_kde.refit_propose_batch_seeded(
        seed, torch.from_numpy(v), torch.from_numpy(losses), n_obs, n_good, n_bad,
        vt, cards, n, s, 3.0, 1e-3, 1e-3, impute_seed=impute_seed, draws=draws)
    flat_r = ref.pallas_kde.pallas_refit_propose_batch_seeded(
        jnp.uint32(seed), jv, jl, jnp.int32(n_obs), jnp.int32(n_good), jnp.int32(n_bad),
        jvt, jcards, n, s, 3.0, 1e-3, 1e-3,
        impute_seed=None if impute_seed is None else jnp.uint32(impute_seed),
        interpret=True)
    all_r = np.sort(ref_logpdf(draws.calls[0], good, bad, vt, cards).reshape(n, s), axis=1)
    sure = all_r[:, -1] - all_r[:, -2] > SCORE_TOL
    np.testing.assert_allclose(flat.numpy()[sure], np.asarray(flat_r)[sure],
                               rtol=VEC_RTOL, atol=0)


@pytest.mark.parametrize("name", ["mixed", "conditional"])
def test_in_trace_batch(ref, ref_opt, ref_logpdf, name, monkeypatch):  # noqa: F811
    """``in_trace_refit=True``: the fit over the raw buffers and the wave in
    one call, against the reference generator (two seeds from ``self.rng``
    on the conditional space, one otherwise). The device fit's pair is the
    reference's within ``PAIR_RTOL``, so picks agree within ``VEC_RTOL``."""
    cg_ref, cg, _ = make_pair(ref, ref_opt, name, in_trace_refit=True)
    pairs = []
    refit = tkde.refit_pair
    monkeypatch.setattr(tkde, "refit_pair", lambda *a: pairs.append(refit(*a)) or pairs[-1])
    for n in (9, 4):
        out_ref = cg_ref.get_config_batch(3.0, n)
        out = cg.get_config_batch(3.0, n)
        assert cg.rng.bit_generator.state == cg_ref.rng.bit_generator.state
        check_picks(ref_logpdf, cg, out, cg.draws.calls[-1], *pairs[-1], out_ref,
                    vec_rtol=VEC_RTOL)


def test_state_roundtrip_and_reference_state_refused(ref, ref_opt):  # noqa: F811
    """``get_state``/``set_state`` carry the observations, the numpy stream
    and the one-at-a-time generator; a reference state (a jax key) is
    refused."""
    cs_ref, cs = spaces(ref, "mixed")
    cg = BOHBKDE(cs, device="cpu", **KW)
    cg_ref = ref_opt.bohb_kde.BOHBKDE(cs_ref, **KW)
    feed(ref_opt, cg_ref, cg, cs)
    cg.get_config(1.0)
    twin = BOHBKDE(cs, device="cpu", **KW)
    twin.set_state(cg.get_state())
    for b in cg.kde_models:
        for side, side2 in zip(cg.kde_models[b], twin.kde_models[b]):
            for a, a2 in zip(side, side2):
                np.testing.assert_array_equal(a, a2)
    for _ in range(4):
        assert cg.get_config(1.0) == twin.get_config(1.0)
    assert cg.get_config_batch(3.0, 9) == twin.get_config_batch(3.0, 9)
    with pytest.raises(ValueError, match="jax key"):
        twin.set_state(cg_ref.get_state())


def test_model_failure_falls_back_only_on_the_cpu(ref, ref_opt, monkeypatch):  # noqa: F811
    """A failed model-based ``get_config`` samples at random on the CPU, as
    the reference does; on a card it raises (checked by pretending the
    generator's device is CUDA)."""
    cs = make_space(tspace, "mixed", seed=1)
    cg = BOHBKDE(cs, device="cpu", random_fraction=0.0, **{k: v for k, v in KW.items()})
    cg_ref = ref_opt.bohb_kde.BOHBKDE(make_space(ref.space, "mixed", seed=1), **KW)
    feed(ref_opt, cg_ref, cg, cs)

    def broken(*a, **k):
        raise RuntimeError("scorer failed")

    monkeypatch.setattr(tkde, "propose_batch_seeded_scored", broken)
    cfg, info = cg.get_config(1.0)
    assert info == {"model_based_pick": False, "sample_reason": "model_failure"}
    monkeypatch.setattr(cg, "device", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="scorer failed"):
        cg.get_config(1.0)


def test_kde_logpdf_and_proposals(ref):  # noqa: F811
    """``kde_logpdf`` (the plain density the tests hold the scorer
    against) equals the reference's; ``propose`` and ``propose_batch`` pick
    each proposal's best candidate by the port's scorer."""
    import jax
    import jax.numpy as jnp

    cs = make_space(tspace, "mixed", seed=1)
    rng = np.random.default_rng(11)
    data = np.stack([cs.to_vector(c) for c in cs.sample_configuration(40, rng=rng)]).astype(np.float32)
    mask = (np.arange(40) < 30).astype(np.float32)
    vt, cards = cs.vartypes(), cs.cardinalities()
    bw = np.array(ref.kde.normal_reference_bandwidths(data, mask, cards), np.float32)
    x = np.stack([cs.to_vector(c) for c in cs.sample_configuration(50, rng=rng)]).astype(np.float32)
    want = jax.vmap(lambda c: ref.kde.kde_logpdf(
        c, ref.kde.KDE(jnp.asarray(data), jnp.asarray(mask), jnp.asarray(bw)),
        jnp.asarray(vt), jnp.asarray(cards)))(jnp.asarray(x))
    kde = tkde.KDE(*map(torch.from_numpy, (data, mask, bw)))
    got = tkde.kde_logpdf(torch.from_numpy(x), kde, torch.from_numpy(vt), torch.from_numpy(cards))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    gen = torch.Generator().manual_seed(0)
    vt_t, cards_t = torch.from_numpy(vt), torch.from_numpy(cards)
    best, cands, scores = tkde.propose(gen, kde, kde, vt_t, cards_t, num_samples=32)
    assert cands.shape == (32, cs.dim) and scores.shape == (32,)
    assert torch.equal(best, cands[int(torch.argmax(scores))])
    vecs = tkde.propose_batch(gen, kde, kde, vt_t, cards_t, 5, num_samples=32)
    assert vecs.shape == (5, cs.dim) and torch.isfinite(vecs).all()
    # the seeded entry points: one host seed gives the same draws, and the
    # flat layout's candidates are generate_candidates_seeded's
    seeded, _ = tkde.propose_batch_seeded_scored(7, kde, kde, vt_t, cards_t, 5, 32)
    assert torch.equal(tkde.propose_batch_seeded(7, kde, kde, vt_t, cards_t, 5, 32), seeded)
    cands = tkde.generate_candidates_seeded(7, kde, vt_t, cards_t, 5, 32)
    flat = cuda_kde.propose_batch_seeded(7, kde, kde, vt_t, cards_t, 5, 32)
    assert torch.equal(flat, cuda_kde.propose_from_candidates(cands, kde, kde, vt_t, cards_t, 5))
