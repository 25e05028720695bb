"""Known-BAD fixture for the generator-seeding rule: draws from the
unregistered process default, loop-invariant re-seeds, twin seeds, and
global seeding in library code."""

import torch


def sample(n, device):
    u = torch.rand((n, 3), device=device)  # BAD
    z = torch.randn(n)  # BAD
    k = torch.randint(0, 10, (n,))  # BAD
    p = torch.randperm(n)  # BAD
    m = torch.multinomial(torch.ones(n), 2)  # BAD
    b = torch.bernoulli(torch.full((n,), 0.5))  # BAD
    w = torch.empty(n).uniform_()  # BAD
    w.normal_(0.0, 1.0)  # BAD
    return u, z, k, p, m, b, w


def per_bracket(seed, n_brackets, device):
    gen = torch.Generator(device=device)
    out = []
    for b in range(n_brackets):
        gen.manual_seed(seed)  # BAD
        out.append(torch.rand(4, generator=gen, device=device))
    return out


def shards(seed, device):
    g0 = torch.Generator(device=device)
    g1 = torch.Generator(device=device)
    g0.manual_seed(seed)
    g1.manual_seed(seed)  # BAD
    return g0, g1


def reproducible():
    torch.manual_seed(0)  # BAD
