"""Known-BAD fixture for the port's pytest-marker rule: heavy tests
without @pytest.mark.slow."""

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank):
    dist.init_process_group("gloo", rank=rank, world_size=2)


def test_spawns_ranks():  # BAD
    mp.spawn(_rank, nprocs=2)


def test_joins_a_group():  # BAD
    dist.init_process_group("gloo", init_method="tcp://localhost:0", rank=0, world_size=1)


def test_long_sweep(opt):  # BAD
    opt.run(n_iterations=32)


def test_deep_ladder(make_opt):  # BAD
    make_opt(max_budget=729)


def test_captures_in_a_long_loop(x):  # BAD
    for _ in range(100):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            x.add_(1)
