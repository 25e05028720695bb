"""Known-BAD fixture for the capture-host-sync rule: host syncs inside
bodies captured as CUDA graphs. Every flagged line ends in ``# BAD``."""

import numpy as np
import torch

from hpbandster_tpu_torch.ops.graphs import RoundGraph


def make_round(device):
    losses = torch.zeros(8, device=device)
    best = torch.zeros(1, device=device)

    def round_body():
        total = losses.sum()
        print(total.item())  # BAD
        rows = losses.tolist()  # BAD
        host = losses.cpu()  # BAD
        arr = losses.numpy()  # BAD
        torch.cuda.synchronize()  # BAD
        scale = float(total)  # BAD
        as_np = np.asarray(losses)  # BAD
        if total > 0:  # BAD
            best.add_(1)
        while best < 3:  # BAD
            best.add_(1)
        pick = losses[torch.argmin(losses)]  # BAD
        live = losses[losses > 0]  # BAD
        idx = torch.nonzero(losses)  # BAD
        uniq = losses.unique()  # BAD
        sel = torch.masked_select(losses, losses > 0)  # BAD
        assert best  # BAD
        flag = 1.0 if best else 0.0  # BAD
        return rows, host, arr, scale, as_np, pick, live, idx, uniq, sel, flag

    return RoundGraph(round_body, device)


def step(static_x, static_y):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = torch.relu(static_x)
        static_y.copy_(out)
        peak = int(out.max())  # BAD
    return g, peak


def graphed(model, x):
    def forward(inp):
        y = model(inp)
        mask = torch.isnan(y)
        y[mask] = 0.0  # BAD
        return y

    return torch.cuda.make_graphed_callables(forward, (x,))
