"""More whole-sweep cases of the dynamic-count tier against the reference
(see ``tests/test_torch_dynamic.py`` for the comparison and its
tolerances): the mixed space, and warm Branin buffers with
``HPB_PALLAS_KDE_FIT=1``, where both sides take the fit's bandwidths from one
masked-moment pass (the reference's Pallas kernel in the interpreter, the
port's plain version, which sums in the kernel's order and matches its
moments bit for bit).

The bandwidths still differ in the last bit now and then: XLA's float32
``pow`` (``n ** (-1/(4+d))``) is not libm's. The one-pass variance
``s2/n - mean^2`` magnifies such a difference by ``mean^2 / var`` at every
later fit, and a clustered good set makes that large, so a long cold
sweep drifts past ``1e-6`` within a few model brackets (seen on cold Branin
at six brackets). The flag's case therefore runs three brackets on warm
buffers: the gate is open from the first bracket, every bracket fits
through the moment pass, and the drift stays below ``1e-7``.
A file of its own so that each stays within a minute on one core.
"""

import pytest

from tests.test_torch_dynamic import check_dynamic_sweep
from tests.test_torch_harness import ref  # noqa: F401


@pytest.mark.parametrize(
    "name,n_iterations,warm,flag",
    [("mixed", 4, False, None), ("branin", 3, True, "1")],
)
def test_dynamic_sweep_matches_reference(ref, monkeypatch, name, n_iterations,
                                         warm, flag):
    check_dynamic_sweep(ref, monkeypatch, name, n_iterations, warm, flag)
