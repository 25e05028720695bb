"""The conditional space with a forbidden clause through the dynamic-count
tier against the reference, on its draws (see
``tests/test_torch_conditions_sweep.py`` for the comparison and its
tolerances); the returned state must agree too, NaN holes included.
"""

from tests.test_torch_conditions_sweep import (
    LOSS_TOL,
    assert_conditional_sweeps_match,
    run_conditional_pair,
)
from tests.test_torch_dynamic import assert_states_match
from tests.test_torch_harness import ref  # noqa: F401


def test_dynamic_conditional_sweep_matches_reference(ref):
    (want, want_state), (got, got_state), seen = run_conditional_pair(ref, dynamic=True)
    assert assert_conditional_sweeps_match(want, got) > 0, "no model-based pick"
    assert sum(seen) > 0, "no forbidden proposal was redrawn"
    assert_states_match(want_state, got_state, LOSS_TOL)
