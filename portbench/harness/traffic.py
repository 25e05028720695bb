"""The one generator of every traffic mix. A mix is a JSON file of
parameters (``traffic/<name>.json``) whose ``driver`` key names the
function that runs it (``"portbench.harness.fused:run"``), found by name
like every other piece; a new shape of traffic is a new driver module and
a mix that names it. Everything else comes from the mix and ``--seed``:

* the fused driver: back-to-back whole sweeps (``optimizer``,
  ``n_iterations``, ``chunk_brackets``), one fresh optimizer per sweep on
  a seed of its own (``sweep_seeds``);
* the serving driver, ``"arrivals": "open"``: ``rate_per_s`` requests a
  second from ``tenants`` independent tenants, for the window's length: a
  Poisson process whose gaps are the exponential distribution's quantiles
  in an order drawn from the seed, so every seed sends the same set of
  gaps and sizes; request ``i`` belongs to tenant ``i mod tenants`` and
  runs ``brackets[i mod len(brackets)]`` brackets (``open_requests``);
* the serving driver, ``"arrivals": "closed"``: one request after another
  from ``tenants`` callers (each sends when its last answer came), sizes
  round robin as above (``closed_requests``).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np

class Request(NamedTuple):
    index: int
    #: seconds after the window opens at which it is due (open loop)
    due_s: float
    tenant: str
    brackets: int
    seed: int


def _seeds(seed: int, stream: int, n: int) -> List[int]:
    """``n`` seeds below 2**31 drawn from ``seed`` (any size) and a stream
    number, so that set-up, window and check draw apart."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), int(seed) >> 64, stream])
    return [int(x) & 0x7FFFFFFF for x in ss.generate_state(n, np.uint64)]


def sweep_seeds(seed: int, n: int, stream: int = 1) -> List[int]:
    """The window's sweeps' seeds (stream 1); set-up uses stream 0."""
    return _seeds(seed, stream, n)


def open_requests(traffic: Dict[str, Any], seed: int, seconds: float) -> List[Request]:
    """The open loop's requests over ``seconds``, in due order."""
    rate = float(traffic["rate_per_s"])
    n = max(int(round(rate * seconds)), 1)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    rng = np.random.default_rng(_seeds(seed, 2, 1)[0])
    gaps = gaps[rng.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return _requests(traffic, seed, due)


def closed_requests(traffic: Dict[str, Any], seed: int, n: int) -> List[Request]:
    """The first ``n`` requests of the closed loop (due when sent)."""
    return _requests(traffic, seed, np.zeros(n))


def _requests(traffic, seed, due) -> List[Request]:
    tenants = int(traffic["tenants"])
    sizes = [int(k) for k in traffic["brackets"]]
    seeds = _seeds(seed, 3, len(due))
    return [Request(i, float(due[i]), f"t{i % tenants}", sizes[i % len(sizes)], seeds[i])
            for i in range(len(due))]

