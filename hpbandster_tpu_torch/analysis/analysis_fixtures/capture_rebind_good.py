"""Known-GOOD fixture for the capture-rebind rule: carried state updated
in place, outputs bound once per capture, inputs written with copy_, and
one justified suppression."""

import torch

from hpbandster_tpu_torch.ops.graphs import RoundGraph


def make_round(device):
    state = torch.zeros(8, device=device)
    best = torch.zeros(1, device=device)
    r_idx = torch.zeros(1, dtype=torch.int64, device=device)

    def round_body():
        state.add_(1.0)
        best.copy_(torch.minimum(best, state.min()))
        tmp = state * 2  # a temporary, made and used inside the body
        state.index_copy_(0, r_idx, tmp[:1])
        r_idx.add_(1)

    return RoundGraph(round_body, device)


def make_chunk(device):
    inp = {0: torch.zeros(4, device=device)}
    holder = {}

    def chunk_body():
        holder["out"] = inp[0] * 2  # an output, read after the replay

    graph = RoundGraph(chunk_body, device)

    def run(x):
        inp[0].copy_(torch.as_tensor(x))
        graph.replay()
        return holder["out"]

    return run


class Program:
    def __init__(self, device):
        self.buf = torch.zeros(8, device=device)
        self.scratch = torch.zeros(8, device=device)
        self.graph = RoundGraph(self.body, device)

    def body(self):
        # justified: the scratch tensor is rebuilt every capture and never
        # read across replays
        self.scratch = self.scratch * 0  # graftlint: disable=capture-rebind — scratch, not carried
        self.buf.mul_(2)

    def run(self, x):
        self.buf.copy_(torch.as_tensor(x))
        self.graph.replay()
        return self.buf.clone()
