"""Known-BAD fixture for the capture-in-loop rule: captures and compiles
in per-iteration positions."""

import torch
from torch.cuda import CUDAGraph

from hpbandster_tpu_torch.ops.graphs import RoundGraph


def per_chunk(chunks, body, device):
    out = []
    for c in chunks:
        g = RoundGraph(body, device)  # BAD
        g.replay()
        out.append(g)
    return out


def raw(steps, x):
    for _ in range(steps):
        g = torch.cuda.CUDAGraph()  # BAD
        with torch.cuda.graph(g):  # BAD
            x.add_(1)
    return x


def aliased(steps):
    graphs = [CUDAGraph() for _ in range(steps)]  # BAD
    return graphs


def compiled(fns, x):
    while fns:
        f = torch.compile(fns.pop())  # BAD
        x = f(x)
    return x


def graphed(models, x):
    return [torch.cuda.make_graphed_callables(m, (x,)) for m in models]  # BAD
