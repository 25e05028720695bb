"""Known-GOOD fixture for the port's pytest-marker rule: light tests, and
heavy ones carrying the slow marker."""

import subprocess
import sys

import pytest
import torch
import torch.multiprocessing as mp


def test_small_sweep(opt):
    opt.run(n_iterations=4)


def test_short_loop(x):
    for _ in range(8):
        torch.compile(lambda y: y)(x)


def test_ranks_as_subprocesses():
    # ranks started as their own interpreters are bounded by their timeouts
    subprocess.run([sys.executable, "-c", "pass"], timeout=60, check=True)


@pytest.mark.slow
def test_spawns_ranks():
    mp.spawn(print, nprocs=2)


class TestHeavy:
    pytestmark = pytest.mark.slow

    def test_deep_ladder(self, make_opt):
        make_opt(max_budget=729)
