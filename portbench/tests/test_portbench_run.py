"""The command: no result and a non-zero exit without a card, and one
short run of a cell on the card (the ``card`` marker)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.harness.manifest import ROOT


def _run(*args, timeout=900):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: this checks the run without one")
    out = _run("--workload", "h6_b729_hyperband", "--seed", "1", "--seconds", "1")
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_an_unknown_cell_is_refused():
    out = _run("--workload", "no_such_cell", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card):
    out = _run("--workload", "h6_b729_hyperband", "--seed", str(2**32 + 9), "--seconds", "2")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
