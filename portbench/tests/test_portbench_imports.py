"""What the benchmark may load: never JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
a reference that takes nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.harness.manifest import BENCH, ROOT

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_the_check_compares_whole_top_level_names(monkeypatch):
    fake = {"hpbandster_tpu_torch": 1, "hpbandster_tpu_torch.ops": 1, "jaxtyping": 1,
            "hpbandster_tpux": 1}
    monkeypatch.setattr(sys, "modules", dict(fake))
    assert run.forbidden_modules() == []
    for bad in ("jax", "jaxlib.xla_client", "flax.linen", "hpbandster_tpu.ops.sweep"):
        monkeypatch.setattr(sys, "modules", dict(fake, **{bad: 1}))
        assert run.forbidden_modules() == [bad.split(".")[0]]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "math", "typing", "numpy", "torch", "portbench"}


def test_loading_the_harness_and_reference_loads_no_jax_and_no_port():
    code = ("import sys, portbench.harness.check, portbench.harness.trace, "
            "portbench.harness.traffic, portbench.reference.kde; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'hpbandster_tpu', "
            "'hpbandster_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
