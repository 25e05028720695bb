"""Known-BAD fixture for the obs-emit-in-capture rule: obs emission inside
bodies captured as CUDA graphs (fires once at capture, never at replay)."""

import torch

from hpbandster_tpu_torch import obs
from hpbandster_tpu_torch.obs import emit, get_bus, span
from hpbandster_tpu_torch.obs.timeline import mark, phase_span
from hpbandster_tpu_torch.ops.graphs import RoundGraph


def make_round(device):
    losses = torch.zeros(8, device=device)

    def round_body():
        emit("round.start")  # BAD
        obs.emit("round.losses", n=8)  # BAD
        get_bus().emit("round.bus")  # BAD
        with span("round"):  # BAD
            losses.add_(1)
        with phase_span("execute"):  # BAD
            losses.mul_(2)
        mark("round.end")  # BAD

    return RoundGraph(round_body, device)


def step(g, static_x):
    with torch.cuda.graph(g):
        static_x.add_(1)
        obs.emit("step")  # BAD
