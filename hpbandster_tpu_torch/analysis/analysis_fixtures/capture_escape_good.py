"""Known-GOOD fixture for the capture-escape rule: captured bodies whose
helpers stay on the card, host work and emission around the replay, and
one justified suppression."""

import torch

from hpbandster_tpu_torch.obs import emit
from hpbandster_tpu_torch.ops.graphs import RoundGraph


def _scale(v, n):
    # shape arithmetic on the host, tensor math on the card
    return v * float(n) / float(v.shape[0])


def _to_host(v):
    return float(v)


def make_round(device, n):
    losses = torch.zeros(8, device=device)
    out = torch.zeros(8, device=device)

    def round_body():
        out.copy_(_scale(losses, n))

    graph = RoundGraph(round_body, device)

    def run():
        graph.replay()
        emit("fixture.replayed", n=n)  # around the replay: fires every call
        return _to_host(out.sum())  # outside the capture: legal

    return run


def make_probe(device):
    flag = torch.zeros(1, device=device)

    def probe_body():
        # justified: a capture-failure probe, never replayed
        return _to_host(flag)  # graftlint: disable=capture-escape — capture-failure probe

    return RoundGraph(probe_body, device)
