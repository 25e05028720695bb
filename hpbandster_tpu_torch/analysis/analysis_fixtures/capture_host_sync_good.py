"""Known-GOOD fixture for the capture-host-sync rule: captured bodies
that stay on the card, host work around the capture, and one justified
suppression."""

import torch

from hpbandster_tpu_torch.ops.graphs import RoundGraph

BUDGETS = (1.0, 3.0, 9.0)


def make_round(device, n_rows):
    losses = torch.zeros(8, device=device)
    best = torch.full((1,), float("inf"), device=device)
    r_idx = torch.zeros(1, dtype=torch.int64, device=device)

    def round_body(r=None):
        # metadata is concrete on the host: no sync
        rows = float(losses.shape[0])
        n = len(losses)
        scale = float(BUDGETS[0]) * float(n_rows)
        if r is None:
            pass
        if losses.dim() == 1 and losses.numel() > 0:
            pass
        # selection by arithmetic on the card, not by a host index
        a = torch.argmin(losses).view(1)
        best.copy_(torch.minimum(best, losses.gather(0, a)))
        # masks are applied with where, not by indexing
        losses.copy_(torch.where(torch.isnan(losses), torch.zeros_like(losses), losses))
        r_idx.add_(1)
        return rows * scale

    return RoundGraph(round_body, device)


def not_captured(losses):
    # host code outside any capture may sync freely
    return losses.cpu().numpy(), float(losses.sum()), losses[losses > 0]


def make_probe(device):
    flag = torch.zeros(1, device=device)

    def probe_body():
        # justified: the probe graph is never replayed, only its capture's
        # error is read (a capture-safety self test)
        return flag.item()  # graftlint: disable=capture-host-sync — capture-failure probe

    return RoundGraph(probe_body, device)
