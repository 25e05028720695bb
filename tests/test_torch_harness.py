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
import os
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
        from hpbandster_tpu.obs import device_metrics
        from hpbandster_tpu.ops import bracket, fused, kde, pallas_kde, sweep
        from hpbandster_tpu.workloads import toys

        yield SimpleNamespace(
            space=rspace, bracket=bracket, fused=fused, kde=kde,
            pallas_kde=pallas_kde, sweep=sweep, toys=toys,
            device_metrics=device_metrics,
        )
    for name in sorted(set(sys.modules) - before, reverse=True):
        if not _is_reference_module(name):
            continue
        del sys.modules[name]
        parent, _, child = name.rpartition(".")
        if parent in sys.modules and getattr(sys.modules[parent], child, None) is not None:
            delattr(sys.modules[parent], child)


@pytest.fixture(scope="module")
def ref_wl(ref):
    """The reference's training workloads (``hpbandster_tpu.workloads.*``),
    imported inside :func:`ref`'s window and removed with it."""
    import importlib

    names = ("train", "mlp", "toys", "ensemble", "teacher", "cnn", "resnet",
             "transformer", "flops")
    return SimpleNamespace(**{
        n: importlib.import_module(f"hpbandster_tpu.workloads.{n}") for n in names})


@pytest.fixture(scope="module")
def ref_opt(ref):
    """The reference's Master-driven tier (``core``, ``models``,
    ``optimizers``, ``parallel``), imported inside :func:`ref`'s window and
    removed with it."""
    import importlib

    names = {
        "master": "core.master", "checkpoint": "core.checkpoint",
        "result": "core.result", "successive_halving": "core.successive_halving",
        "bohb_kde": "models.bohb_kde", "random_sampling": "models.random_sampling",
        "learning_curves": "models.learning_curves",
        "optimizers": "optimizers", "h2bo": "optimizers.h2bo",
        "parallel": "parallel",
    }
    return SimpleNamespace(**{
        k: importlib.import_module(f"hpbandster_tpu.{m}") for k, m in names.items()})


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


def cond_space(space_module, seed: int = 0):
    """The conditional space with a forbidden clause, built with either
    package's ``space`` module: Branin's ``x``, ``y``; a categorical ``opt``
    whose ``sgd`` activates ``momentum``; an ordinal ``depth`` whose values
    above 2 activate ``extra``; and ``opt == adam`` with ``depth == 8``
    forbidden."""
    m = space_module
    cs = m.ConfigurationSpace(seed=seed)
    x = m.UniformFloatHyperparameter("x", -5.0, 10.0)
    y = m.UniformFloatHyperparameter("y", 0.0, 15.0)
    opt = m.CategoricalHyperparameter("opt", ["sgd", "adam"])
    mom = m.UniformFloatHyperparameter("momentum", 0.0, 0.99)
    depth = m.OrdinalHyperparameter("depth", [1, 2, 4, 8])
    extra = m.UniformFloatHyperparameter("extra", 0.0, 1.0)
    cs.add_hyperparameters([x, y, opt, mom, depth, extra])
    cs.add_condition(m.EqualsCondition(mom, opt, "sgd"))
    cs.add_condition(m.GreaterThanCondition(extra, depth, 2))
    cs.add_forbidden_clause(m.ForbiddenAndConjunction(
        m.ForbiddenEqualsClause(opt, "adam"), m.ForbiddenEqualsClause(depth, 8)))
    return cs


def cond_eval_fns(ref):
    """The conditional space's objective, Branin plus ``0.1 * momentum +
    0.05 * extra`` (inactive dims arrive as 0): ``(reference eval_fn(vector,
    budget), port eval_fn(batch, budget))``."""
    from hpbandster_tpu_torch.workloads.toys import branin

    def ref_fn(v, budget):
        return ref.toys.branin_from_vector(v[:2], budget) + 0.1 * v[3] + 0.05 * v[5]

    def port_fn(v, budget):
        return branin(v[:, :2], budget) + 0.1 * v[:, 3] + 0.05 * v[:, 5]

    return ref_fn, port_fn


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
    ``generate_candidates`` (around the PORT's fitted good KDE), the
    ``uniform >= random_fraction`` model mask, the fit's imputation
    uniforms and the forbidden-row redraws."""

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

        return jax.random.split(jax.random.fold_in(self.root, b_i), 4)

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

    def impute(self, b_i, side, n, d):
        """``k_fit`` splits into the good and the bad side's keys, each
        into a donor and a fallback key (``ops/kde.py``
        ``impute_conditional_masked``)."""
        import jax

        k_side = jax.random.split(self._bracket_keys(b_i)[3])[side]
        k_pick, k_fb = jax.random.split(k_side)
        return tuple(torch.from_numpy(np.array(jax.random.uniform(k, (n, d))))
                     for k in (k_pick, k_fb))

    def forbidden_redraw(self, b_i, t, n0):
        """``random_unit(fold_in(fold_in(k_rand, 0x7FB), t))``, as the
        reference's rejection resampling draws."""
        import jax

        k_forb = jax.random.fold_in(self._bracket_keys(b_i)[0], 0x7FB)
        return torch.from_numpy(np.array(self.ref.sweep.random_unit(
            self.codec, jax.random.fold_in(k_forb, t), n0)))


class ReferenceKDEDraws:
    """The reference's candidate and imputation draws of the per-bracket
    path (``models/bohb_kde.py``), fed through the port's draw seam
    (``ops.kde.SeededDraws``) as a port ``BOHBKDE``'s ``draws``:

    * a wave's seed keys ``split(key(seed), n)``, one key per proposal,
      each drawing its candidates as the reference's ``propose`` does; in
      the flat layout ``generate_candidates_seeded(seed)``;
    * seed ``None`` (one proposal at a time) splits the reference
      generator's own key chain, ``key(trickle_seed)``;
    * the in-trace fit's imputation uniforms come from
      ``split(key(impute_seed))``, a donor and a fallback key per side.

    Each call's candidates are kept in ``calls`` and its seed in ``seeds``,
    so a test can score them with the reference's own log-density."""

    def __init__(self, ref, trickle_seed=0):
        import jax
        import jax.numpy as jnp

        self.ref = ref
        self.key = jax.random.key(trickle_seed)
        self.calls, self.seeds = [], []
        sample_around = ref.kde.sample_around

        def one(k, data, mask, bw, vt, cards, bf, mbw, num_samples):
            k_idx, k_samp = jax.random.split(k)
            logits = jnp.where(mask > 0, 0.0, -jnp.inf)
            idx = jax.random.categorical(k_idx, logits, shape=(num_samples,))
            keys = jax.random.split(k_samp, num_samples)
            return jax.vmap(lambda kk, x: sample_around(kk, x, bw, vt, cards, bf, mbw))(
                keys, data[idx])

        def batch(keys, data, mask, bw, vt, cards, bf, mbw, num_samples):
            return jax.vmap(lambda k: one(k, data, mask, bw, vt, cards, bf, mbw,
                                          num_samples))(keys)

        self._batch = jax.jit(batch, static_argnames=("num_samples",))

    def candidates(self, seed, good, vartypes, cards, n, num_samples,
                   bandwidth_factor, min_bandwidth, flat):
        import jax
        import jax.numpy as jnp

        g = self.ref.kde.KDE(*(jnp.asarray(t.numpy()) for t in good))
        vt, cd = jnp.asarray(vartypes.numpy()), jnp.asarray(cards.numpy())
        if flat:
            c = self.ref.kde.generate_candidates_seeded(
                jnp.uint32(seed), g, vt, cd, n, num_samples, bandwidth_factor,
                min_bandwidth)
        else:
            if seed is None:
                self.key, sub = jax.random.split(self.key)
                keys = sub[None]
            else:
                keys = jax.random.split(jax.random.key(np.uint32(seed)), n)
            c = self._batch(keys, g.data, g.mask, g.bw, vt, cd, bandwidth_factor,
                            min_bandwidth, num_samples=num_samples)
        out = torch.from_numpy(np.array(c).reshape(n * num_samples, -1))
        self.calls.append(out)
        self.seeds.append(seed)
        return out

    def impute(self, seed, n, d):
        import jax

        sides = []
        for k_side in jax.random.split(jax.random.key(np.uint32(seed))):
            k_pick, k_fb = jax.random.split(k_side)
            sides.append(tuple(torch.from_numpy(np.array(jax.random.uniform(k, (n, d))))
                               for k in (k_pick, k_fb)))
        return tuple(sides)


# ------------------------------------------------------ import and device
PORT_MODULES = [
    "hpbandster_tpu_torch",
    "hpbandster_tpu_torch.convert",
    "hpbandster_tpu_torch.device",
    "hpbandster_tpu_torch.obs",
    "hpbandster_tpu_torch.obs.audit",
    "hpbandster_tpu_torch.obs.device_metrics",
    "hpbandster_tpu_torch.obs.events",
    "hpbandster_tpu_torch.obs.journal",
    "hpbandster_tpu_torch.obs.metrics",
    "hpbandster_tpu_torch.obs.profile",
    "hpbandster_tpu_torch.obs.report",
    "hpbandster_tpu_torch.obs.runtime",
    "hpbandster_tpu_torch.obs.trace",
    "hpbandster_tpu_torch.promote",
    "hpbandster_tpu_torch.promote.asha",
    "hpbandster_tpu_torch.promote.earlystop",
    "hpbandster_tpu_torch.promote.pareto",
    "hpbandster_tpu_torch.promote.replay",
    "hpbandster_tpu_torch.core.checkpoint",
    "hpbandster_tpu_torch.core.master",
    "hpbandster_tpu_torch.core.result",
    "hpbandster_tpu_torch.core.successive_halving",
    "hpbandster_tpu_torch.core.warmstart",
    "hpbandster_tpu_torch.ops._build",
    "hpbandster_tpu_torch.ops.bracket",
    "hpbandster_tpu_torch.ops.buckets",
    "hpbandster_tpu_torch.ops.cuda_kde",
    "hpbandster_tpu_torch.ops.fused",
    "hpbandster_tpu_torch.ops.graphs",
    "hpbandster_tpu_torch.ops.kde",
    "hpbandster_tpu_torch.ops.sweep",
    "hpbandster_tpu_torch.models",
    "hpbandster_tpu_torch.models.base",
    "hpbandster_tpu_torch.models.bohb_kde",
    "hpbandster_tpu_torch.models.learning_curves",
    "hpbandster_tpu_torch.models.random_sampling",
    "hpbandster_tpu_torch.optimizers",
    "hpbandster_tpu_torch.optimizers.bohb",
    "hpbandster_tpu_torch.optimizers.fused_bohb",
    "hpbandster_tpu_torch.optimizers.h2bo",
    "hpbandster_tpu_torch.optimizers.hyperband",
    "hpbandster_tpu_torch.optimizers.randomsearch",
    "hpbandster_tpu_torch.parallel",
    "hpbandster_tpu_torch.parallel.backends",
    "hpbandster_tpu_torch.parallel.batched_executor",
    "hpbandster_tpu_torch.serve",
    "hpbandster_tpu_torch.serve.continuous",
    "hpbandster_tpu_torch.serve.megabatch",
    "hpbandster_tpu_torch.serve.pool",
    "hpbandster_tpu_torch.serve.scheduler",
    "hpbandster_tpu_torch.space",
    "hpbandster_tpu_torch.space.conditions",
    "hpbandster_tpu_torch.space.forbidden",
    "hpbandster_tpu_torch.utils.lru",
    "hpbandster_tpu_torch.utils.profiling",
    "hpbandster_tpu_torch.workloads",
    "hpbandster_tpu_torch.workloads.cnn",
    "hpbandster_tpu_torch.workloads.ensemble",
    "hpbandster_tpu_torch.workloads.flops",
    "hpbandster_tpu_torch.workloads.mlp",
    "hpbandster_tpu_torch.workloads.resnet",
    "hpbandster_tpu_torch.workloads.teacher",
    "hpbandster_tpu_torch.workloads.toys",
    "hpbandster_tpu_torch.workloads.train",
    "hpbandster_tpu_torch.workloads.transformer",
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
    """No source file of the port, and neither ``chip_smoke.py`` nor
    ``compare_kernels.py``, names jax or the JAX package in an import."""
    files = sorted((REPO / "hpbandster_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "compare_kernels.py"]
    offenders = []
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                if mod.split(".")[0] in ("jax", "jaxlib", "hpbandster_tpu"):
                    offenders.append(f"{f.name}: {s}")
    assert not offenders, offenders


@pytest.mark.parametrize("script", [["chip_smoke.py"],
                                    ["compare_kernels.py", "--root", "."]])
def test_card_scripts_fail_without_a_card(script):
    """The scripts that need a CUDA card exit non-zero and print no result
    where there is none."""
    proc = subprocess.run(
        [sys.executable, *script], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "compare {" not in proc.stdout
    assert "no CUDA device" in proc.stderr


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
    """What later slices port (meshes) raises ``NotImplementedError``
    instead of silently running without one; the resident tier refuses,
    with the reference's ``ValueError``, the tiers it cannot run on."""
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.ops.sweep import build_space_codec, make_fused_sweep_fn
    from hpbandster_tpu_torch.workloads.toys import branin, branin_space

    codec = build_space_codec(branin_space())
    for kw in ({"mesh": object()}, {"shard_sampling": True},
               {"mesh": object(), "resident": True, "dynamic_counts": True}):
        with pytest.raises(NotImplementedError, match="mesh"):
            make_fused_sweep_fn(branin, plans_for(2), codec, device="cpu", **kw)
    with pytest.raises(ValueError, match="dynamic_counts"):
        make_fused_sweep_fn(branin, plans_for(2), codec, device="cpu", resident=True)
    for kw in ({"resident": True}, {"incumbent_only": True}):
        with pytest.raises(ValueError, match="at least one bracket"):
            make_fused_sweep_fn(branin, [], codec, device="cpu", dynamic_counts=True, **kw)
    opt = FusedBOHB(configspace=branin_space(seed=0), eval_fn=branin,
                    min_budget=1, max_budget=9, device="cpu")
    for kw in ({"chunk_brackets": 2, "resident": True},
               {"dynamic_counts": False, "resident": True}):
        with pytest.raises(ValueError, match="resident"):
            opt.run(n_iterations=2, **kw)
    assert opt.iterations == []

    # the Master-driven tier and the serving tier: the RPC host tier,
    # meshes and the write-ahead journal wait for later slices
    from hpbandster_tpu_torch import BOHB, BatchedExecutor, HyperBand, VmapBackend
    from hpbandster_tpu_torch.ops.fused import make_fused_bracket_fn

    cs = branin_space(seed=0)

    def executor():
        return BatchedExecutor(VmapBackend(branin, device="cpu"), cs)

    common = dict(configspace=cs, run_id="unported", min_budget=1, max_budget=9,
                  device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        BOHB(**common)  # executor=None would build the RPC Dispatcher
    with pytest.raises(NotImplementedError, match="A9"):
        BOHB(executor=executor(), wal_path="wal.jsonl", **common)
    # promotion rules are ported: a rule name selects its iteration class
    from hpbandster_tpu_torch.promote.asha import ASHAIteration

    assert BOHB(executor=executor(), promotion_rule="asha",
                **common).iteration_class is ASHAIteration
    from hpbandster_tpu_torch.ops.buckets import build_bucket_set
    from hpbandster_tpu_torch.serve import ContinuousRunner, ServePool, make_lane_mesh

    with pytest.raises(NotImplementedError, match="A7"):
        build_bucket_set(plans_for(2), mesh_size=2)
    with pytest.raises(NotImplementedError, match="A7"):
        make_lane_mesh(2)
    with pytest.raises(NotImplementedError, match="A7"):
        ServePool(VmapBackend(branin, device="cpu"), cs, continuous=True, lane_mesh=object())
    bucket = build_bucket_set(plans_for(2)).buckets[0]
    with pytest.raises(NotImplementedError, match="A7"):
        ContinuousRunner(branin, bucket, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        VmapBackend(branin, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        make_fused_bracket_fn(branin, (9, 3), (1.0, 3.0), mesh=object(), device="cpu")
    hb = HyperBand(configspace=cs, run_id="unported", executor=executor(),
                   min_budget=1, max_budget=9)
    with pytest.raises(NotImplementedError, match="A9"):
        hb.resume("checkpoint.pkl")


def test_master_optimizers_refuse_to_run_without_a_device(monkeypatch):
    """``BOHB``'s model, ``VmapBackend`` and the fused bracket runner take
    ``device=None`` as CUDA and raise where it is absent."""
    from hpbandster_tpu_torch import BOHB, BatchedExecutor, VmapBackend
    from hpbandster_tpu_torch.ops.fused import make_fused_bracket_fn
    from hpbandster_tpu_torch.workloads.toys import branin, branin_space

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cs = branin_space(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        VmapBackend(branin)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_fused_bracket_fn(branin, (9, 3), (1.0, 3.0))
    ex = BatchedExecutor(VmapBackend(branin, device="cpu"), cs)
    with pytest.raises(RuntimeError, match="CUDA"):
        BOHB(configspace=cs, run_id="nodev", executor=ex, min_budget=1, max_budget=9)
