"""Known-GOOD fixture for the generator-seeding rule: every draw takes a
seeded generator, seeds vary per iteration and per shard, and one
justified suppression."""

import torch


def shard_seed(seed, s):
    return (int(seed) * 1_000_003 + s) % (2 ** 63)


def sample(gen, n, device):
    u = torch.rand((n, 3), generator=gen, device=device)
    k = torch.randint(0, 10, (n,), generator=gen, device=device)
    w = torch.empty(n, device=device).uniform_(generator=gen)
    return u, k, w


def per_bracket(seed, n_brackets, device):
    gen = torch.Generator(device=device)
    out = []
    for b in range(n_brackets):
        gen.manual_seed(seed + b)  # varies with the loop
        out.append(torch.rand(4, generator=gen, device=device))
    return out


def shards(seed, devices):
    gens = {}
    for s, dev in enumerate(devices):
        gens[s] = torch.Generator(device=dev)
        gens[s].manual_seed(shard_seed(seed, s))
    return gens


class Draws:
    def __init__(self, seed, device):
        self.generator = torch.Generator(device=device)
        self.reseed(seed)

    def reseed(self, seed):
        self.generator.manual_seed(int(seed))


def per_config(configs, device):
    # a fresh generator per config, each seeded alike on purpose
    return [torch.Generator(device=device).manual_seed(0) for _ in configs]


def noise_for_display(n):
    # justified: a plot's jitter, never part of a run's result
    return torch.rand(n)  # graftlint: disable=generator-seeding — display jitter
