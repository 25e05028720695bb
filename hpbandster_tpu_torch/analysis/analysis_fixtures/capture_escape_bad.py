"""Known-BAD fixture for the capture-escape rule: host syncs and obs
emission reached *through* helper calls from captured bodies — invisible
to the intraprocedural capture-host-sync / obs-emit-in-capture rules."""

import torch

from hpbandster_tpu_torch.obs import emit
from hpbandster_tpu_torch.ops.graphs import RoundGraph


def _to_host(v):
    return float(v)


def _norm(v):
    # no sink here — the escape is one more hop down
    return _to_host(v) + 1.0


def _log_step(tag):
    emit("fixture.step", tag=tag)


def _best(losses):
    return losses.argmin().item()


def make_round(device):
    losses = torch.zeros(8, device=device)

    def round_body():
        total = losses.sum()
        z = _norm(total)  # BAD
        _log_step("round")  # BAD
        k = _best(losses)  # BAD
        return z, k

    return RoundGraph(round_body, device)


def step(g, static_x):
    with torch.cuda.graph(g):
        y = torch.relu(static_x)
        _norm(y)  # BAD
    return y
