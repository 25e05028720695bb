"""Harness for holding the PyTorch port (``hpbandster_tpu_torch``) against
the JAX reference (``hpbandster_tpu``), plus the port's import and device
contracts.

The reference does not import under the installed jax as it stands:
``hpbandster_tpu/obs/runtime.py`` reads ``jax.core.trace_state_clean``,
which newer jax moved to ``jax._src.core``. The :func:`ref` fixture puts the
name back for the duration of one test module, imports the reference inside
that window, and on teardown removes both the shim and every reference
module it imported. The reference's own test files therefore see the
interpreter exactly as they would without this harness.

Other ``tests/test_torch_*.py`` files import their helpers and the fixture
from here.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch import space as tspace
from hpbandster_tpu_torch.convert import codec_from_numpy
from hpbandster_tpu_torch.ops.bracket import hyperband_bracket

REPO = Path(__file__).resolve().parent.parent


def _is_reference_module(name: str) -> bool:
    return name == "hpbandster_tpu" or name.startswith("hpbandster_tpu.")


@pytest.fixture(scope="module")
def ref():
    """The reference's modules, importable for this test module only."""
    import jax
    from jax._src import core as jax_core

    before = {m for m in sys.modules if _is_reference_module(m)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            jax.core, "trace_state_clean", jax_core.trace_state_clean,
            raising=False,
        )
        from hpbandster_tpu import space as rspace
        from hpbandster_tpu.ops import bracket, fused, kde, pallas_kde, sweep
        from hpbandster_tpu.workloads import toys

        yield SimpleNamespace(
            space=rspace, bracket=bracket, fused=fused, kde=kde,
            pallas_kde=pallas_kde, sweep=sweep, toys=toys,
        )
    for name in sorted(set(sys.modules) - before, reverse=True):
        if not _is_reference_module(name):
            continue
        del sys.modules[name]
        parent, _, child = name.rpartition(".")
        if parent in sys.modules and getattr(sys.modules[parent], child, None) is not None:
            delattr(sys.modules[parent], child)


# ------------------------------------------------------------------ spaces
#: search spaces built identically in both packages: (kind, name, *args, kw)
SPACES = {
    "branin": [
        ("float", "x", -5.0, 10.0, {}),
        ("float", "y", 0.0, 15.0, {}),
    ],
    "mixed": [
        ("float", "lr", 1e-4, 1e-1, {"log": True}),
        ("int", "units", 8, 256, {"log": True}),
        ("cat", "act", ["relu", "tanh", "elu"], {}),
        ("ord", "depth", [1, 2, 3, 4], {}),
        ("float", "drop", 0.0, 0.5, {"q": 0.05}),
        ("int", "batch", 2, 9, {}),
    ],
}


def make_space(space_module, name: str, seed: int = 0):
    """Build the named space with either package's ``space`` module."""
    cs = space_module.ConfigurationSpace(seed=seed)
    for kind, hp_name, *args, kw in SPACES[name]:
        if kind == "float":
            hp = space_module.UniformFloatHyperparameter(hp_name, *args, **kw)
        elif kind == "int":
            hp = space_module.UniformIntegerHyperparameter(hp_name, *args, **kw)
        elif kind == "cat":
            hp = space_module.CategoricalHyperparameter(hp_name, *args, **kw)
        else:
            hp = space_module.OrdinalHyperparameter(hp_name, *args, **kw)
        cs.add_hyperparameter(hp)
    return cs


def port_space(name: str, seed: int = 0):
    return make_space(tspace, name, seed)


def mixed_loss(xp, v, budget: float):
    """An objective over the ``mixed`` space written once for both numpy-
    like modules (``jax.numpy`` on one vector, ``torch`` on a batch):
    smooth terms, a categorical and an ordinal effect, budget noise, and
    crashes (NaN) in one corner."""
    lr, units, act, depth, drop = v[..., 0], v[..., 1], v[..., 2], v[..., 3], v[..., 4]
    val = (
        (lr - 0.3) ** 2
        + 0.5 * (units - 0.6) ** 2
        + xp.where(act == 1.0, 0.2, 0.0)
        + 0.05 * depth
        + 0.1 * drop
        + 0.3 * xp.sin(7.0 * lr + 3.0 * units) / math.sqrt(budget)
    )
    return xp.where((units > 0.9) & (drop > 0.6), math.nan, val)


def eval_fns(ref, name: str):
    """``(reference eval_fn(vector, budget), port eval_fn(batch, budget))``."""
    import jax.numpy as jnp

    from hpbandster_tpu_torch.workloads.toys import branin

    if name == "branin":
        return ref.toys.branin_from_vector, branin
    return (
        lambda v, b: mixed_loss(jnp, v, b),
        lambda v, b: mixed_loss(torch, v, b),
    )


def codecs(ref, name: str):
    """``(reference codec, port codec carried over by convert)``."""
    rc = ref.sweep.build_space_codec(make_space(ref.space, name))
    return rc, codec_from_numpy(*rc)


def plans_for(n_iterations: int, max_budget: float = 27.0):
    return [hyperband_bracket(i, 1.0, max_budget, 3.0) for i in range(n_iterations)]


# ------------------------------------------------------------------- draws
class ReferenceDraws:
    """The reference's own random draws, fed into the port's sweep through
    its draw seam: bracket ``b_i`` uses ``split(fold_in(key(seed), b_i),
    4)`` as ``ops/sweep.py``'s ``run_bracket`` does, for ``random_unit``,
    ``generate_candidates`` (around the PORT's fitted good KDE) and the
    ``uniform >= random_fraction`` model mask."""

    def __init__(self, ref, ref_codec, seed, random_fraction=1 / 3,
                 bandwidth_factor=3.0, min_bandwidth=1e-3):
        import jax

        self.ref = ref
        self.codec = ref_codec
        self.root = jax.random.key(np.uint32(seed))
        self.random_fraction = random_fraction
        self.bandwidth_factor = bandwidth_factor
        self.min_bandwidth = min_bandwidth

    def _bracket_keys(self, b_i):
        import jax

        k_rand, k_prop, k_frac, k_fit = jax.random.split(
            jax.random.fold_in(self.root, b_i), 4
        )
        return k_rand, k_prop, k_frac

    def stage0(self, b_i, n0):
        k_rand = self._bracket_keys(b_i)[0]
        return torch.from_numpy(
            np.array(self.ref.sweep.random_unit(self.codec, k_rand, n0))
        )

    def candidates(self, b_i, good, total):
        import jax.numpy as jnp

        k_prop = self._bracket_keys(b_i)[1]
        good_ref = self.ref.kde.KDE(
            jnp.asarray(good.data.numpy()), jnp.asarray(good.mask.numpy()),
            jnp.asarray(good.bw.numpy()),
        )
        cands = self.ref.kde.generate_candidates(
            k_prop, good_ref, jnp.asarray(self.codec.vartypes),
            jnp.asarray(self.codec.cards), total, self.bandwidth_factor,
            self.min_bandwidth,
        )
        return torch.from_numpy(np.array(cands))

    def model_mask(self, b_i, n0):
        import jax

        k_frac = self._bracket_keys(b_i)[2]
        return torch.from_numpy(
            np.array(jax.random.uniform(k_frac, (n0,)) >= self.random_fraction)
        )


# ------------------------------------------------------ import and device
PORT_MODULES = [
    "hpbandster_tpu_torch",
    "hpbandster_tpu_torch.convert",
    "hpbandster_tpu_torch.device",
    "hpbandster_tpu_torch.core.checkpoint",
    "hpbandster_tpu_torch.core.result",
    "hpbandster_tpu_torch.core.successive_halving",
    "hpbandster_tpu_torch.core.warmstart",
    "hpbandster_tpu_torch.ops._build",
    "hpbandster_tpu_torch.ops.cuda_kde",
    "hpbandster_tpu_torch.ops.fused",
    "hpbandster_tpu_torch.ops.kde",
    "hpbandster_tpu_torch.ops.sweep",
    "hpbandster_tpu_torch.optimizers.fused_bohb",
    "hpbandster_tpu_torch.workloads.toys",
]


def test_port_imports_without_jax():
    """Importing the port pulls in neither jax nor any module of the JAX
    package (checked in a fresh interpreter: this one already holds jax)."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'hpbandster_tpu' or m.startswith('hpbandster_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    """No source file of the port, and not ``chip_smoke.py``, names jax or
    the JAX package in an import."""
    files = sorted((REPO / "hpbandster_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    offenders = []
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                if mod.split(".")[0] in ("jax", "jaxlib", "hpbandster_tpu"):
                    offenders.append(f"{f.name}: {s}")
    assert not offenders, offenders


def test_fused_bohb_refuses_to_run_without_a_device(monkeypatch):
    """``device=None`` means CUDA; where CUDA is absent the optimizer
    raises instead of carrying on on the CPU."""
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.workloads.toys import branin, branin_space

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedBOHB(configspace=branin_space(seed=0), eval_fn=branin,
                  min_budget=1, max_budget=9)
    # the CPU is used only when asked for
    opt = FusedBOHB(configspace=branin_space(seed=0), eval_fn=branin,
                    min_budget=1, max_budget=9, device="cpu")
    assert opt.device.type == "cpu"


def test_scorer_refuses_unknown_devices():
    """The scorer's wrapper takes CPU tensors to the plain version and
    CUDA tensors to the kernel; any other device raises."""
    from hpbandster_tpu_torch.ops.cuda_kde import score_candidates
    from hpbandster_tpu_torch.ops.kde import KDE

    meta = torch.zeros((4, 2), device="meta")
    kde = KDE(torch.zeros((3, 2), device="meta"), torch.ones(3, device="meta"),
              torch.ones(2, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        score_candidates(meta, kde, kde, torch.zeros(2), torch.zeros(2))


def test_unported_tiers_raise():
    """Tiers and seams that later slices port raise instead of silently
    running the static tier."""
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.ops.sweep import build_space_codec, make_fused_sweep_fn
    from hpbandster_tpu_torch.workloads.toys import branin, branin_space

    codec = build_space_codec(branin_space())
    for kw in ({"resident": True}, {"incumbent_only": True},
               {"device_metrics": True}):
        with pytest.raises(NotImplementedError):
            make_fused_sweep_fn(branin, plans_for(2), codec, device="cpu", **kw)
    opt = FusedBOHB(configspace=branin_space(seed=0), eval_fn=branin,
                    min_budget=1, max_budget=9, device="cpu")
    for kw in ({"resident": True}, {"chunk_brackets": 2, "resident": True}):
        with pytest.raises(NotImplementedError):
            opt.run(n_iterations=2, **kw)
