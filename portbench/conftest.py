"""Fixtures of the benchmark's CPU tests (``python -m pytest portbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and the ``card``
fixture, which decides inside the test whether a card exists and skips
with the reason where none does.
"""

from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips with its reason where none is")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the benchmark's runs measure the card")
    return "cuda:0"


@pytest.fixture
def recorded_scorer(monkeypatch):
    """On the CPU the scorer's plain route records nothing; this records
    each proposal's scorer inputs in ``cuda_kde.RECORD`` as the card's
    launches do, so the fused check reads them."""
    from hpbandster_tpu_torch.ops import cuda_kde
    from hpbandster_tpu_torch.ops import sweep as sweep_mod

    inner = sweep_mod.propose_from_candidates

    def recording(cands, good, bad, vartypes, cards, n):
        if isinstance(cuda_kde.RECORD, list):
            cuda_kde.RECORD.append(("kde_score", (cands, good, bad, vartypes, cards)))
        return inner(cands, good, bad, vartypes, cards, n)

    monkeypatch.setattr(sweep_mod, "propose_from_candidates", recording)
    monkeypatch.setattr(cuda_kde, "RECORD", None)
    return cuda_kde


@pytest.fixture
def small(monkeypatch):
    """``manifest.resolve`` at sizes a CPU test holds: budgets up to 27 and
    8 brackets in chunks of 2 for the sweeps, 10 requests a second for the
    open loop. Everything else is the committed cell's."""
    from portbench.harness import manifest

    real = manifest.resolve

    def resolve(name, root=manifest.ROOT):
        spec = real(name, root)
        tr, opt = spec["traffic"], spec["config_data"]["optimizer"]
        if tr["driver"] == "portbench.harness.fused:run":
            opt["max_budget"] = 27
            tr.update(n_iterations=8, chunk_brackets=2)
        if "rate_per_s" in tr:
            tr["rate_per_s"] = 10.0
        return spec

    monkeypatch.setattr(manifest, "resolve", resolve)
    return resolve
