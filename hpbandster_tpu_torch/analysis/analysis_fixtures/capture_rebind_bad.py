"""Known-BAD fixture for the capture-rebind rule: carried state rebound to
a new tensor inside captured bodies, and graph inputs bound with = before
a replay."""

import torch

from hpbandster_tpu_torch.ops.graphs import RoundGraph


def make_round(device):
    state = torch.zeros(8, device=device)
    bufs = {"best": torch.zeros(1, device=device)}

    def round_body():
        nonlocal state
        state = state + 1.0  # BAD
        bufs["best"] = torch.minimum(bufs["best"], state.min())  # BAD

    return RoundGraph(round_body, device)


class Program:
    def __init__(self, device):
        self.buf = torch.zeros(8, device=device)
        self.inp = torch.zeros(8, device=device)
        self.graph = RoundGraph(self.body, device)

    def body(self):
        self.buf = torch.where(self.inp > 0, self.buf, self.inp)  # BAD

    def run(self, x):
        self.inp = torch.as_tensor(x)  # BAD
        self.graph.replay()
        return self.buf


def make_chunk(device):
    inp = {0: torch.zeros(4, device=device)}
    out = {}

    def chunk_body():
        out["y"] = inp[0] * 2

    graph = RoundGraph(chunk_body, device)

    def run(x):
        inp[0] = torch.as_tensor(x)  # BAD
        graph.replay()
        return out["y"]

    return run


def step(g, static_x):
    acc = torch.zeros(4)
    with torch.cuda.graph(g):
        acc = acc + static_x.sum()  # BAD
    return acc
