"""Known-GOOD fixture for the obs-emit-in-capture rule: emission around
the replay, a pure captured body, and one justified suppression."""

import torch

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.ops.graphs import RoundGraph


def make_round(device):
    losses = torch.zeros(8, device=device)

    def round_body():
        losses.add_(1)

    graph = RoundGraph(round_body, device)

    def run():
        with obs.span("round"):
            graph.replay()
        obs.emit("round.replayed", n=8)

    return run


def make_marked(device):
    losses = torch.zeros(8, device=device)

    def marked_body():
        losses.add_(1)
        # justified: the capture itself is the event being recorded (one
        # record per capture, which is exactly what the reader wants)
        obs.emit("capture.recorded")  # graftlint: disable=obs-emit-in-capture — one per capture

    return RoundGraph(marked_body, device)
