"""Known-GOOD fixture for the capture-in-loop rule: one capture hoisted
out of the loop and replayed in it, cached programs, and one justified
suppression."""

import torch

from hpbandster_tpu_torch.ops.graphs import RoundGraph

_CACHE = {}


def replayed(body, device, n_rounds):
    g = RoundGraph(body, device)
    for _ in range(n_rounds):
        g.replay()
    return g


def cached(key, body, device):
    g = _CACHE.get(key)
    if g is None:
        g = _CACHE[key] = RoundGraph(body, device)
    return g


def first_iterable_runs_once(body, device):
    return [r for r in [RoundGraph(body, device)]]


def factory_in_loop(bodies, device):
    makers = []
    for body in bodies:
        def make(b=body):
            return RoundGraph(b, device)
        makers.append(make)
    return makers


def one_program_per_bucket(buckets, device):
    # justified: each bucket is a distinct program, captured once and kept
    programs = {}
    for key, body in buckets.items():
        programs[key] = RoundGraph(body, device)  # graftlint: disable=capture-in-loop — one graph per bucket
    return programs
