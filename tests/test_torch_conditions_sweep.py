"""The conditional space with a forbidden clause through the whole sweep,
static and dynamic-count tiers, against the reference (its Pallas scorer in
the interpreter) on the reference's own draws (``ReferenceDraws``): stage
indices, model-based masks and the NaN pattern of every output exact,
vectors within ``1e-6``, losses within ``atol 1e-4, rtol 1e-4`` (the bound
of ``tests/test_torch_sweep.py``: Branin's cancelling polynomial inside the
reference's compiled sweep). One tier per file, so that each stays within a
minute on one core.
"""

import numpy as np
import torch

from hpbandster_tpu_torch import space as tspace
from hpbandster_tpu_torch.convert import codec_from_numpy
from hpbandster_tpu_torch.ops.sweep import (
    codec_tables,
    compile_active_mask,
    compile_forbidden_mask,
    make_fused_sweep_fn,
    plan_additions,
    pow2_capacities,
)
from tests.test_torch_harness import (  # noqa: F401
    ReferenceDraws,
    cond_eval_fns,
    cond_space,
    plans_for,
    ref,
)

NUM_SAMPLES = 32
LOSS_TOL = 1e-4
#: a valid configuration of the conditional space (sgd, depth 4)
FALLBACK = np.array([0.3, 0.6, 0.0, 0.5, 2.0, 0.25], np.float32)


def run_conditional_pair(ref, dynamic, seed=1234, n_iterations=3, **modes):
    """The reference's and the port's sweep on the conditional space and the
    same draws, both built with ``modes`` (e.g. ``resident=True``) as well.
    Returns ``(want, got, forbidden rows the port saw)``."""
    rcs, tcs = cond_space(ref.space), cond_space(tspace)
    rc = ref.sweep.build_space_codec(rcs)
    codec = codec_from_numpy(*rc)
    ref_eval, port_eval = cond_eval_fns(ref)
    plans = plans_for(n_iterations, max_budget=9.0)
    kw = {}
    if dynamic:
        kw = dict(dynamic_counts=True, capacities=pow2_capacities(plan_additions(plans)),
                  return_state=True)
    want = ref.sweep.make_fused_sweep_fn(
        ref_eval, plans, rc, num_samples=NUM_SAMPLES, use_pallas=True,
        pallas_interpret=True, active_mask_fn=ref.sweep.compile_active_mask(rcs, rc),
        forbidden_fn=ref.sweep.compile_forbidden_mask(rcs, rc),
        fallback_vector=FALLBACK, **kw, **modes,
    )(np.uint32(seed))
    tables = codec_tables(codec, "cpu")
    forbidden = compile_forbidden_mask(tcs, tables)
    seen = []

    def counting_forbidden(q, act):
        rows = forbidden(q, act)
        seen.append(int(rows.sum()))
        return rows

    got = make_fused_sweep_fn(
        port_eval, plans, codec, device="cpu", tables=tables, num_samples=NUM_SAMPLES,
        active_mask_fn=compile_active_mask(tcs, tables),
        forbidden_fn=counting_forbidden, fallback_vector=FALLBACK, **kw, **modes,
    )(seed, draws=ReferenceDraws(ref, rc, seed))
    return want, got, seen


def assert_conditional_sweeps_match(want, got):
    n_model = 0
    for b_i, (w, g) in enumerate(zip(want, got)):
        wv, gv = np.asarray(w.vectors), g.vectors.numpy()
        np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv), err_msg=f"bracket {b_i} NaN")
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6, err_msg=f"bracket {b_i} vectors")
        np.testing.assert_array_equal(g.model_based.numpy(), np.asarray(w.model_based),
                                      err_msg=f"bracket {b_i} model_based")
        np.testing.assert_array_equal(g.idx_packed.numpy(), np.asarray(w.idx_packed),
                                      err_msg=f"bracket {b_i} stage indices")
        np.testing.assert_allclose(g.loss_packed.numpy(), np.asarray(w.loss_packed),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=f"bracket {b_i} losses")
        n_model += int(np.asarray(w.model_based).sum())
        assert bool(torch.isnan(g.vectors).any()), "no inactive dim in the bracket"
    return n_model


def test_static_conditional_sweep_matches_reference(ref):
    want, got, seen = run_conditional_pair(ref, dynamic=False)
    assert assert_conditional_sweeps_match(want, got) > 0, "no model-based pick"
    assert sum(seen) > 0, "no forbidden proposal was redrawn"
