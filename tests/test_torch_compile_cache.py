"""The port's kernel cache (``hpbandster_tpu_torch/utils/compile_cache.py``)
and the build it directs (``ops/_build.py``), on the CPU.

There is no nvcc here, so a fake one stands in: an executable script under
a temporary ``$CUDA_HOME/bin`` (``find_nvcc`` looks there first) that
writes its ``-o`` target and appends one line to a counter file. Only
``build_library`` runs; a fake library cannot be loaded. The cases: the
order in which the directory resolves, an installed package's layout, the
disabled and unwritable caches, an edited source, two processes on one
directory, nvcc's faults, the four startup paths that call the cache, the
reference's disabled branch and interface, and a counterpart in the port
for every module of the JAX package.
"""

from __future__ import annotations

import inspect
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from hpbandster_tpu_torch.ops import _build
from hpbandster_tpu_torch.utils import compile_cache
from tests.test_torch_harness import ref  # noqa: F401
from tests.test_torch_host_pool import ns  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
KERNEL_SOURCES = ("kde_score", "kde_moments")

_FAKE_NVCC = """#!/bin/sh
echo "$@" >> {counter}
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; printf 'not a library' > "$1"; fi
  shift
done
exit {status}
"""


def fake_cuda_home(root: Path, status: int = 0) -> Path:
    """A ``CUDA_HOME`` whose ``bin/nvcc`` counts its calls in
    ``root/nvcc_calls`` and exits ``status``."""
    nvcc = root / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC.format(counter=root / "nvcc_calls", status=status))
    nvcc.chmod(0o755)
    return nvcc.parent.parent


def nvcc_calls(root: Path) -> int:
    counter = root / "nvcc_calls"
    return len(counter.read_text().splitlines()) if counter.exists() else 0


def package_copy(site: Path) -> Path:
    """The port's CUDA sources copied to ``site/hpbandster_tpu_torch/csrc``,
    a package tree with no ``setup.py`` beside it; returns that ``csrc``."""
    csrc = site / "hpbandster_tpu_torch" / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    return csrc


def files_under(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh cache state, a fake nvcc, temporary files under ``tmp_path``
    and no cache knob set; yields ``tmp_path``."""
    monkeypatch.setattr(compile_cache, "_explicit", "")
    monkeypatch.setattr(compile_cache, "_enabled_dir", "")
    monkeypatch.setattr(compile_cache, "_warned_dir", "")
    monkeypatch.setattr(compile_cache, "_private", None)
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    monkeypatch.setenv("CUDA_HOME", str(fake_cuda_home(tmp_path)))
    monkeypatch.delenv("HPB_XLA_CACHE", raising=False)
    monkeypatch.delenv("HPB_XLA_CACHE_DIR", raising=False)
    yield tmp_path
    compile_cache._remove_private()


@pytest.mark.parametrize("source", ["argument", "env", "checkout"])
def test_directory_resolves_argument_then_env_then_checkout(cache, monkeypatch, source):
    """An explicit directory first, then ``HPB_XLA_CACHE_DIR``, then the
    checkout's ``build/torch_kernels``; the build follows the same order
    whether or not the cache was enabled."""
    want = {"argument": cache / "arg", "env": cache / "env",
            "checkout": REPO / "build" / "torch_kernels"}[source]
    if source != "checkout":
        monkeypatch.setenv("HPB_XLA_CACHE_DIR", str(cache / "env"))
    if source != "argument":
        assert _build.build_dir() == want  # before any call to the cache
    arg = str(want) if source == "argument" else ""
    assert compile_cache.enable_persistent_compile_cache(arg) == str(want)
    # an explicit directory holds for the calls without one
    assert compile_cache.enable_persistent_compile_cache() == str(want)
    assert _build.build_dir() == want
    assert want.is_dir()


def test_installed_package_builds_under_the_home_cache(cache, monkeypatch):
    """A package with no ``setup.py`` beside it (an installed one) builds
    under ``~/.cache/hpbandster_tpu_torch_kernels`` and writes nothing
    beside itself."""
    site = cache / "site"
    monkeypatch.setattr(_build, "CSRC", package_copy(site))
    monkeypatch.setenv("HOME", str(cache / "home"))
    before = files_under(site)
    want = cache / "home" / ".cache" / "hpbandster_tpu_torch_kernels"
    assert _build.build_dir() == want
    lib = _build.build_library("kde_score")
    assert lib.parent == want and lib.name.startswith("libkde_score-")
    assert files_under(want) == [lib.name]
    assert files_under(site) == before
    assert nvcc_calls(cache) == 1


def test_disabled_cache_builds_into_a_private_directory(cache, monkeypatch):
    """``HPB_XLA_CACHE=0``: '' from the cache, no directory until a build,
    then a private one of this process, removed at exit; the shared
    directory is never made."""
    shared = cache / "shared"
    monkeypatch.setenv("HPB_XLA_CACHE", "0")
    monkeypatch.setenv("HPB_XLA_CACHE_DIR", str(shared))
    assert compile_cache.enable_persistent_compile_cache() == ""
    assert compile_cache.enable_persistent_compile_cache(str(shared)) == ""
    assert files_under(cache / "tmp") == []
    libs = [_build.build_library(name) for name in KERNEL_SOURCES]
    private = libs[0].parent
    assert libs[1].parent == private and private.parent == cache / "tmp"
    assert sorted(files_under(private)) == sorted(lib.name for lib in libs)
    assert not shared.exists()
    assert nvcc_calls(cache) == 2
    compile_cache._remove_private()
    assert not private.exists()


def test_unwritable_directory_warns_once_and_still_builds(cache, monkeypatch, caplog):
    """A directory that cannot be made: '' and one warning, however often
    asked; the kernels still build, into the private directory."""
    (cache / "file").write_text("")
    monkeypatch.setenv("HPB_XLA_CACHE_DIR", str(cache / "file" / "sub"))
    with caplog.at_level(logging.WARNING, logger="hpbandster_tpu_torch.compile_cache"):
        assert compile_cache.enable_persistent_compile_cache() == ""
        assert compile_cache.enable_persistent_compile_cache() == ""
        lib = _build.build_library("kde_score")
    warnings = [r for r in caplog.records if r.name == "hpbandster_tpu_torch.compile_cache"]
    assert len(warnings) == 1 and "not writable" in warnings[0].getMessage()
    assert nvcc_calls(cache) == 1
    assert lib.parent == compile_cache.private_dir() and lib.is_file()


def test_edited_source_builds_again(cache, monkeypatch):
    """An unchanged source loads its library; an edited one builds anew."""
    csrc = package_copy(cache / "pkg")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("HPB_XLA_CACHE_DIR", str(cache / "kernels"))
    first = _build.build_library("kde_moments")
    assert _build.build_library("kde_moments") == first
    assert nvcc_calls(cache) == 1
    src = csrc / "kde_moments.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    second = _build.build_library("kde_moments")
    assert second != first and second.is_file() and first.is_file()
    assert nvcc_calls(cache) == 2
    assert set(_build.BUILD_LOG) == {"kde_moments"}
    assert _build.BUILD_SECONDS["kde_moments"] >= 0.0


def test_second_process_on_one_directory_runs_no_nvcc(cache):
    """The first process builds each kernel once; a second process on the
    same directory loads both and calls nvcc zero times."""
    code = (
        "import json\n"
        "from hpbandster_tpu_torch.ops import _build\n"
        f"libs = [str(_build.build_library(n)) for n in {KERNEL_SOURCES!r}]\n"
        "print(json.dumps(dict(built=sorted(_build.BUILD_LOG), libs=libs)))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("HPB_XLA_CACHE")}
    env.update(CUDA_HOME=os.environ["CUDA_HOME"], PYTHONPATH=str(REPO),
               HPB_XLA_CACHE_DIR=str(cache / "shared"), TMPDIR=str(cache / "tmp"))
    outs = []
    for calls in (2, 2):
        proc = subprocess.run([sys.executable, "-c", code], cwd=cache, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs.append(json.loads(proc.stdout.splitlines()[-1]))
        assert nvcc_calls(cache) == calls
    assert outs[0]["built"] == sorted(KERNEL_SOURCES) and outs[1]["built"] == []
    assert outs[0]["libs"] == outs[1]["libs"]
    assert all(Path(lib).parent == cache / "shared" for lib in outs[0]["libs"])
    assert files_under(cache / "tmp") == []


@pytest.mark.parametrize("fault", ["missing", "failing"])
def test_nvcc_faults_still_raise(cache, monkeypatch, fault):
    """No nvcc, or an nvcc that fails, raises as before and leaves no file
    in the cache."""
    monkeypatch.setenv("HPB_XLA_CACHE_DIR", str(cache / "kernels"))
    if fault == "missing":
        monkeypatch.setenv("CUDA_HOME", str(cache / "empty"))
        monkeypatch.setenv("PATH", str(cache / "empty"))
        match = "nvcc not found"
    else:
        monkeypatch.setenv("CUDA_HOME", str(fake_cuda_home(cache / "bad", status=1)))
        match = "nvcc failed"
    with pytest.raises(RuntimeError, match=match):
        _build.build_library("kde_score")
    assert files_under(cache / "kernels") == []


@pytest.mark.parametrize("tier", ["Worker.run", "BatchedExecutor", "TPUBatchedWorker",
                                  "ServePool"])
def test_startup_paths_enable_the_cache(monkeypatch, ns, tier):  # noqa: F811
    """Each startup path the reference warms its compile cache at calls the
    port's kernel cache once, on the CPU."""
    from hpbandster_tpu_torch import BatchedExecutor, ServePool, TPUBatchedWorker, VmapBackend
    from hpbandster_tpu_torch.core.worker import Worker
    from hpbandster_tpu_torch.workloads.toys import branin, branin_dict, branin_space

    calls = []
    monkeypatch.setattr(compile_cache, "enable_persistent_compile_cache",
                        lambda cache_dir="": calls.append(cache_dir) or "")
    _, host, port = ns
    if tier == "Worker.run":
        class BraninWorker(Worker):
            def compute(self, config_id, config, budget, working_directory):
                return {"loss": branin_dict(config, budget), "info": {}}

        w = BraninWorker(run_id="t", nameserver=host, nameserver_port=port)
        assert calls == []
        w.run(background=True)
        w.shutdown()
    elif tier == "BatchedExecutor":
        BatchedExecutor(VmapBackend(branin, device="cpu"), branin_space(seed=0))
    elif tier == "TPUBatchedWorker":
        TPUBatchedWorker(run_id="t", eval_fn=branin, configspace=branin_space(seed=0),
                         device="cpu", nameserver=host, nameserver_port=port)
    else:
        ServePool(VmapBackend(branin, device="cpu"), branin_space(seed=0))
    assert calls == [""]


def test_disabled_branch_and_interface_match_the_reference(ref, monkeypatch):  # noqa: F811
    """Both packages' caches return '' under ``HPB_XLA_CACHE=0`` and share
    ``__all__`` and the signature. The reference's enabled branch is not
    called: it would point jax's cache for every later test here."""
    from hpbandster_tpu.utils import compile_cache as ref_cache

    monkeypatch.setenv("HPB_XLA_CACHE", "0")
    assert ref_cache.enable_persistent_compile_cache() == ""
    assert compile_cache.enable_persistent_compile_cache() == ""
    assert compile_cache.__all__ == ref_cache.__all__ == ["enable_persistent_compile_cache"]
    assert (inspect.signature(compile_cache.enable_persistent_compile_cache)
            == inspect.signature(ref_cache.enable_persistent_compile_cache))


#: modules of the JAX package with no file at the same path in the port, and
#: the port's files that take their place
REPLACED = {
    "ops/pallas_kde.py": ["ops/cuda_kde.py", "csrc/kde_score.cu", "csrc/kde_moments.cu"],
    "analysis/rules/donation.py": ["analysis/rules/capture_rebind.py"],
    "analysis/rules/jit_loop.py": ["analysis/rules/capture_loop.py"],
    "analysis/rules/jit_purity.py": ["analysis/rules/capture_purity.py"],
    "analysis/rules/prng.py": ["analysis/rules/generator.py"],
    "analysis/rules/trace_escape.py": ["analysis/rules/capture_escape.py"],
}


def test_every_reference_module_has_a_counterpart():
    """Every ``.py`` of ``hpbandster_tpu/`` has a file at the same path in
    ``hpbandster_tpu_torch/``, or the replacements :data:`REPLACED` names."""
    ref_root, port_root = REPO / "hpbandster_tpu", REPO / "hpbandster_tpu_torch"
    modules = sorted(str(p.relative_to(ref_root)) for p in ref_root.rglob("*.py")
                     if "analysis_fixtures" not in p.parts)
    missing = [m for m in modules if m not in REPLACED and not (port_root / m).is_file()]
    assert not missing, missing
    for module, replacements in REPLACED.items():
        assert module in modules, f"{module} left the JAX package: drop it from REPLACED"
        assert not (port_root / module).exists(), f"{module} is ported at its own path now"
        assert all((port_root / r).is_file() for r in replacements), replacements
