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
from hpbandster_tpu_torch.ops.bracket import hyperband_bracket, mesh_aligned_plan
from hpbandster_tpu_torch.ops.sweep import unstack_resident_outputs

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
    keep_analysis = "hpbandster_tpu.analysis.core" in before
    for name in sorted(set(sys.modules) - before, reverse=True):
        if not _is_reference_module(name):
            continue
        if keep_analysis and name.startswith("hpbandster_tpu.analysis."):
            # the reference's analysis registers its rules once per import
            # of its core: rules imported here stay with the core that
            # holds their registrations, or a later import would register
            # them twice
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


@pytest.fixture(scope="module")
def ref_obs_all(ref):
    """The reference's obs modules (the analysis, the exporter, the health
    endpoint, the collector, the CLI) and its promotion replay, imported
    inside :func:`ref`'s window and removed with it."""
    import importlib

    names = ("timeline", "summarize", "report", "anomaly", "slo", "alerts", "export",
             "health", "collector", "metrics", "events", "journal", "__main__")
    mods = {n.strip("_") or n: importlib.import_module(f"hpbandster_tpu.obs.{n}")
            for n in names}
    mods["replay"] = importlib.import_module("hpbandster_tpu.promote.replay")
    return SimpleNamespace(**mods)


@pytest.fixture(scope="module")
def ref_host(ref):
    """The reference's host tier (the RPC transport, the nameserver, the
    worker, recovery, the batched worker, the optimizers, the serving
    front, its obs facade), imported inside :func:`ref`'s window and
    removed with it."""
    import importlib

    names = {
        "rpc": "parallel.rpc", "nameserver": "core.nameserver",
        "worker": "core.worker", "recovery": "core.recovery",
        "batched_worker": "parallel.batched_worker",
        "parallel": "parallel", "optimizers": "optimizers", "obs": "obs",
        "session": "serve.session", "frontend": "serve.frontend", "serve": "serve",
    }
    return SimpleNamespace(**{
        k: importlib.import_module(f"hpbandster_tpu.{m}") for k, m in names.items()})


@pytest.fixture(scope="module")
def ref_mesh(ref):
    """The reference's config-axis mesh tier (``parallel.mesh``,
    ``parallel.multihost``, ``ops.buckets``, ``workloads.ensemble``) and
    jax's devices (eight virtual CPU devices under ``tests/conftest.py``),
    imported inside :func:`ref`'s window and removed with it."""
    import importlib

    import jax

    names = {"mesh": "parallel.mesh", "multihost": "parallel.multihost",
             "buckets": "ops.buckets", "ensemble": "workloads.ensemble",
             "parallel": "parallel"}
    mods = {k: importlib.import_module(f"hpbandster_tpu.{m}") for k, m in names.items()}
    return SimpleNamespace(devices=jax.devices(), **mods)


def sequential(opt):
    """One job in flight at a time, the next sampled only after the last
    result was ingested (set after construction: the constructor checks
    lower < upper): a run over the Dispatcher then has one order of
    events, the reference's and the port's alike."""
    opt.dynamic_queue_size = False
    opt.job_queue_sizes = (0, 0)
    return opt


#: the timing fields of a journal record: they differ run to run
TIMING_FIELDS = frozenset({"t_wall", "t_mono", "duration_s", "host", "pid", "trace_id",
                           "run_s", "queue_s", "compile_s", "execute_s", "wait_s"})


def strip_timing(records):
    """Records without their timing and identity fields."""
    return [{k: v for k, v in r.items() if k not in TIMING_FIELDS} for r in records]


def synth_journal(seed: int, n_brackets: int = 6, hosts: int = 2):
    """A merged multi-host journal made from ``seed`` with numpy: the
    record kinds every obs analysis reads (jobs with their stage fields
    and workers, sampling and promotion audits, bracket plans, refits,
    capture-ledger compiles, fused chunks and their device telemetry,
    phase spans, serving admissions, chunks and lane events, RPC calls
    and retries, worker drops, fleet samples, tenants), with clock skew
    between hosts and a wall step on one. Both packages read it."""
    rng = np.random.default_rng(seed)
    out = []
    mono = 1000.0 + seed
    offsets = {h: 1.7e9 + float(rng.normal(0.0, 0.02)) for h in range(hosts)}

    def rec(event, host=0, dt=None, **fields):
        nonlocal mono
        mono += float(rng.exponential(0.02)) if dt is None else dt
        r = {"event": event, "t_wall": round(offsets[host] + mono, 6),
             "t_mono": round(mono, 6), "host": f"h{host}", "pid": 100 + host}
        r.update(fields)
        out.append(r)
        return r

    def finite(x):
        return round(float(x), 6)

    tenants = ["default", "t1", "t2"]
    budgets = [1.0, 3.0, 9.0]
    p_crash = 0.05 + 0.1 * (seed % 3)
    cid = 0
    for it in range(n_brackets):
        tenant = tenants[it % len(tenants)]
        tfield = {} if tenant == "default" else {"tenant_id": tenant}
        nc = [9, 3, 1][it % 3:]
        bs = budgets[it % 3:]
        rec("sweep_planning", duration_s=finite(rng.uniform(1e-4, 1e-3)),
            phase="admission_wait", **tfield)
        rec("bracket_created", iteration=it, num_configs=nc, budgets=bs, **tfield)
        ids = []
        for k in range(nc[0]):
            ids.append([it, 0, k])
            rec("config_sampled", config_id=[it, 0, k], iteration=it,
                budget=bs[0], model_based_pick=bool(rng.random() < 0.5 and it > 0),
                **tfield)
        losses = {}
        for stage, (n, b) in enumerate(zip(nc, bs)):
            for c in ids[:n]:
                trace = f"tr-{seed}-{cid}"
                cid += 1
                worker = f"w{int(rng.integers(3))}"
                rec("job_submitted", config_id=c, budget=b, trace_id=trace, **tfield)
                rec("job_started", host=1 % hosts, config_id=c, budget=b,
                    trace_id=trace, worker=worker,
                    queue_wait_s=finite(rng.exponential(0.01)),
                    dispatch_s=finite(rng.exponential(0.002)), **tfield)
                compute = finite(rng.exponential(0.05) * b
                                 * (40.0 if rng.random() < 0.03 else 1.0))
                crashed = rng.random() < p_crash
                loss = None if crashed else finite(rng.normal(1.0 / b, 0.3))
                losses[tuple(c)] = float("inf") if loss is None else loss
                rec("job_finished" if not crashed else "job_failed", host=1 % hosts,
                    config_id=c, budget=b, trace_id=trace, worker=worker,
                    compute_s=compute, delivery_s=finite(rng.exponential(0.003)),
                    **tfield)
                rec("job_finished" if not crashed else "job_failed", config_id=c,
                    budget=b, trace_id=trace, loss=loss, worker=worker,
                    queue_s=finite(rng.exponential(0.01)), run_s=compute, **tfield)
            if stage + 1 < len(nc):
                ranked = sorted(ids[:n], key=lambda c: losses[tuple(c)])
                keep = {tuple(c) for c in ranked[:nc[stage + 1]]}
                rec("promotion_decision", iteration=it, rung=stage, budget=b,
                    config_ids=ids[:n], promoted=[tuple(c) in keep for c in ids[:n]],
                    losses=[None if losses[tuple(c)] == float("inf") else losses[tuple(c)]
                            for c in ids[:n]],
                    rule="successive_halving", **tfield)
                ids = ranked[:nc[stage + 1]]
        if rng.random() < 0.7:
            rec("kde_refit", duration_s=finite(rng.uniform(1e-3, 1e-2)),
                budget=bs[0], **tfield)
        for _ in range(int(rng.integers(1, 4))):
            rec("xla_compile", fn=f"sweep_chunk_{int(rng.integers(2))}",
                compile_s=finite(rng.uniform(0.01, 0.3)), signature="f32[64,2]")
        ev = int(sum(nc))
        rec("chunk_staging", duration_s=finite(rng.uniform(1e-4, 2e-3)),
            phase="transfer")
        rec("compile_lookup", duration_s=finite(rng.uniform(1e-5, 0.1)), phase="compile")
        rec("sweep_chunk", duration_s=finite(rng.uniform(0.01, 0.05)),
            compile_s=finite(rng.uniform(0.0, 0.005)),
            compile_cache_hit=bool(rng.random() < 0.5), evaluations=ev,
            brackets=[it], seq=it, h2d_bytes=int(rng.integers(0, 50000)),
            d2h_bytes=int(rng.integers(1000, 5000)), trace_id=f"sweep-{seed}")
        crashes = int(rng.integers(0, ev + 1)) if rng.random() < 0.3 else 0
        order = [{"seq": s_i, "bracket": it, "stage": s_i, "budget": b, "evals": n,
                  "est_s": finite(rng.uniform(1e-3, 1e-2))}
                 for s_i, (n, b) in enumerate(zip(nc, bs))]
        rec("device_telemetry", execute_s=finite(rng.uniform(0.01, 0.05)),
            evaluations=ev, crashes=crashes, rung_order=order,
            brackets=[{"bracket": it, "crashes": crashes,
                       "best_final_loss": finite(rng.normal(0.1, 0.05))}],
            trace_id=f"sweep-{seed}")
        rec("obs_fold", duration_s=finite(rng.uniform(1e-4, 1e-3)), phase="promotion")
        for _ in range(int(rng.integers(2, 6))):
            rec("serve_admission", wait_s=finite(rng.exponential(0.3)),
                tenant=tenant, **tfield)
        lane = int(rng.integers(4))
        rec("lane_assigned", lane=lane, family=0, tenant=tenant)
        rec("serve_chunk", duration_s=finite(rng.uniform(1e-3, 1e-2)), family=0,
            lanes=int(rng.integers(1, 5)), starved=int(rng.random() < 0.1), seq=it)
        if rng.random() < 0.5:
            rec("lane_released", lane=lane, family=0, tenant=tenant)
        rec("rpc_client_call", duration_s=finite(rng.exponential(0.01)),
            method="evaluate", trace_id=f"tr-{seed}-{cid - 1}")
        if rng.random() < 0.4:
            rec("rpc_retry", method="evaluate", attempt=1)
        if rng.random() < 0.5:
            rec("worker_dropped", worker=f"w{int(rng.integers(3))}")
            rec("worker_discovered", worker=f"w{int(rng.integers(3))}")
        rec("fleet_sample", device_mem_skew=finite(rng.uniform(0.0, 1.0)),
            worker_churn_per_min=finite(rng.uniform(0.0, 2.0)), seq=it)
        rec("bracket_replay", duration_s=finite(rng.uniform(1e-3, 5e-3)),
            phase="promotion")
        if it == n_brackets // 2:
            offsets[0] += 3.0  # a wall-clock step on host 0
    rec("sweep_incumbent", loss=finite(rng.normal(0.0, 0.1)), budget=9.0, vector=[0.5, 0.5],
        trace_id=f"sweep-{seed}")
    return out


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
    4)`` as ``ops/sweep.py``'s ``run_bracket`` does, for ``random_unit``
    (under shard sampling each shard's ``fold_in`` of it),
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

    def stage0_shard(self, b_i, shard, n):
        """Shard ``shard``'s block under shard sampling:
        ``random_unit(fold_in(k_rand, shard), n)``, as the reference's
        ``random_unit_sharded`` draws it."""
        import jax

        k_rand = self._bracket_keys(b_i)[0]
        return torch.from_numpy(np.array(self.ref.sweep.random_unit(
            self.codec, jax.random.fold_in(k_rand, shard), n)))

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
#: the example ladder's modules
EXAMPLE_MODULES = [
    "example_1_local_sequential",
    "example_2_local_parallel_threads",
    "example_3_local_parallel_processes",
    "example_4_cluster",
    "example_5_mlp_worker",
    "example_6_analysis_warmstart",
    "example_7_tpu_batched",
    "example_8_large_sweep",
    "example_9_multihost_batched_workers",
    "example_10_multihost_fused_spmd",
    "example_11_transformer_fused",
    "example_12_long_context_ring",
]

PORT_MODULES = [
    "hpbandster_tpu_torch",
    "hpbandster_tpu_torch.analysis",
    "hpbandster_tpu_torch.analysis.__main__",
    "hpbandster_tpu_torch.analysis.core",
    "hpbandster_tpu_torch.analysis.graph",
    "hpbandster_tpu_torch.analysis.rules",
    "hpbandster_tpu_torch.convert",
    "hpbandster_tpu_torch.device",
    "hpbandster_tpu_torch.entry",
    "hpbandster_tpu_torch.obs",
    "hpbandster_tpu_torch.obs.__main__",
    "hpbandster_tpu_torch.obs.alerts",
    "hpbandster_tpu_torch.obs.anomaly",
    "hpbandster_tpu_torch.obs.audit",
    "hpbandster_tpu_torch.obs.collector",
    "hpbandster_tpu_torch.obs.device_metrics",
    "hpbandster_tpu_torch.obs.events",
    "hpbandster_tpu_torch.obs.export",
    "hpbandster_tpu_torch.obs.health",
    "hpbandster_tpu_torch.obs.journal",
    "hpbandster_tpu_torch.obs.metrics",
    "hpbandster_tpu_torch.obs.profile",
    "hpbandster_tpu_torch.obs.report",
    "hpbandster_tpu_torch.obs.runtime",
    "hpbandster_tpu_torch.obs.slo",
    "hpbandster_tpu_torch.obs.summarize",
    "hpbandster_tpu_torch.obs.timeline",
    "hpbandster_tpu_torch.obs.trace",
    "hpbandster_tpu_torch.promote",
    "hpbandster_tpu_torch.promote.asha",
    "hpbandster_tpu_torch.promote.earlystop",
    "hpbandster_tpu_torch.promote.pareto",
    "hpbandster_tpu_torch.promote.replay",
    "hpbandster_tpu_torch.core",
    "hpbandster_tpu_torch.core.base_config_generator",
    "hpbandster_tpu_torch.core.base_iteration",
    "hpbandster_tpu_torch.core.checkpoint",
    "hpbandster_tpu_torch.core.dispatcher",
    "hpbandster_tpu_torch.core.master",
    "hpbandster_tpu_torch.core.nameserver",
    "hpbandster_tpu_torch.core.recovery",
    "hpbandster_tpu_torch.core.worker",
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
    "hpbandster_tpu_torch.ops.ring_attention",
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
    "hpbandster_tpu_torch.parallel.batched_worker",
    "hpbandster_tpu_torch.parallel.chaos",
    "hpbandster_tpu_torch.parallel.dispatcher",
    "hpbandster_tpu_torch.parallel.mesh",
    "hpbandster_tpu_torch.parallel.multihost",
    "hpbandster_tpu_torch.parallel.tensor_parallel",
    "hpbandster_tpu_torch.parallel.rpc",
    "hpbandster_tpu_torch.serve",
    "hpbandster_tpu_torch.serve.continuous",
    "hpbandster_tpu_torch.serve.megabatch",
    "hpbandster_tpu_torch.serve.pool",
    "hpbandster_tpu_torch.serve.frontend",
    "hpbandster_tpu_torch.serve.scheduler",
    "hpbandster_tpu_torch.serve.session",
    "hpbandster_tpu_torch.space",
    "hpbandster_tpu_torch.space.conditions",
    "hpbandster_tpu_torch.space.forbidden",
    "hpbandster_tpu_torch.utils",
    "hpbandster_tpu_torch.utils.compile_cache",
    "hpbandster_tpu_torch.utils.lru",
    "hpbandster_tpu_torch.utils.network",
    "hpbandster_tpu_torch.utils.profiling",
    "hpbandster_tpu_torch.viz",
    "hpbandster_tpu_torch.viz.plots",
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
    "hpbandster_tpu_torch.examples",
] + [f"hpbandster_tpu_torch.examples.{m}" for m in EXAMPLE_MODULES]


def test_port_imports_without_jax():
    """Importing the port (its analysis and its examples included) pulls in
    neither jax nor any module of the JAX package (checked in a fresh
    interpreter: this one already holds jax), and neither does running its
    obs CLI or its graftlint."""
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
    cli = (
        "import runpy, sys\n"
        "sys.argv = ['obs', '--help']\n"
        "try:\n"
        "    runpy.run_module('hpbandster_tpu_torch.obs', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'hpbandster_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", cli], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "python -m hpbandster_tpu_torch.obs" in proc.stdout
    for command in ("summarize", "report", "timeline", "slo", "alerts", "export"):
        assert command in proc.stdout
    lint = (
        "import runpy, sys\n"
        "sys.argv = ['analysis', '--list-rules']\n"
        "try:\n"
        "    runpy.run_module('hpbandster_tpu_torch.analysis', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'hpbandster_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", lint], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "capture-host-sync" in proc.stdout


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


#: an example's arguments where it needs one
_EXAMPLE_ARGS = {"example_4_cluster": ["--master", "--shared_directory", "."]}


@pytest.mark.parametrize("script", [["chip_smoke.py"],
                                    ["compare_kernels.py", "--root", "."],
                                    ["-m", "hpbandster_tpu_torch.entry"]] + [
    ["-m", f"hpbandster_tpu_torch.examples.{m}", *_EXAMPLE_ARGS.get(m, [])]
    for m in EXAMPLE_MODULES], ids=lambda s: s[0] if s[0] != "-m" else s[1].rsplit(".", 1)[1])
def test_card_scripts_fail_without_a_card(script):
    """The scripts that need a CUDA card exit non-zero and print no result
    where there is none; so do the entry module and every example without
    ``--device cpu``."""
    proc = subprocess.run(
        [sys.executable, *script], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "compare {" not in proc.stdout
    if script[0] == "-m":
        assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_flat_api_matches_the_reference(ref):
    """Every name of the reference's flat API (``hpbandster_tpu._EXPORTS``)
    is an attribute of the port's package."""
    import hpbandster_tpu
    import hpbandster_tpu_torch

    missing = [n for n in hpbandster_tpu._EXPORTS if not hasattr(hpbandster_tpu_torch, n)]
    assert not missing, missing
    assert hpbandster_tpu_torch.json_result_logger.__module__ == (
        "hpbandster_tpu_torch.core.result")


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


def test_unported_tiers_raise(tmp_path):
    """Every tier of the reference is ported and runs: the config-axis
    meshes, the serving tier's lane meshes and the sequence-parallel ring
    (ROADMAP A7b) run, and no source of the port raises
    ``NotImplementedError`` naming A7b or A9. The resident tier refuses,
    with the reference's ``ValueError``, the tiers it cannot run on. The
    host tier is ported: ``wal_path=`` journals and ``resume()`` replays."""
    from hpbandster_tpu_torch import FusedBOHB
    from hpbandster_tpu_torch.ops.sweep import build_space_codec, make_fused_sweep_fn
    from hpbandster_tpu_torch.parallel.mesh import config_mesh
    from hpbandster_tpu_torch.workloads.toys import branin, branin_space

    codec = build_space_codec(branin_space())
    mesh = config_mesh(["cpu"] * 2)
    plain = make_fused_sweep_fn(branin, plans_for(2), codec, device="cpu")(5)
    for kw in ({"mesh": mesh}, {"mesh": mesh, "resident": True, "dynamic_counts": True}):
        got = make_fused_sweep_fn(branin, plans_for(2), codec, device="cpu", **kw)(5)
        got = got if isinstance(got, list) else unstack_resident_outputs(got, 1)
        assert len(got) == 2 and all(torch.isfinite(o.vectors).all() for o in got)
    # a mesh alone places rows: the unmeshed sweep's values
    for a, b in zip(plain, make_fused_sweep_fn(branin, plans_for(2), codec, device="cpu",
                                               mesh=mesh)(5)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="requires a mesh"):
        make_fused_sweep_fn(branin, plans_for(2), codec, device="cpu", shard_sampling=True)
    sharded = make_fused_sweep_fn(
        branin, [mesh_aligned_plan(18, 1, 9, 3, 2)], codec, device="cpu", mesh=mesh,
        shard_sampling=True, incumbent_only=True)(5)
    assert torch.isfinite(sharded.loss)
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

    # the Master-driven tier, the serving tier and its meshes, the host tier
    # (the Dispatcher, the write-ahead journal)
    from hpbandster_tpu_torch import BOHB, BatchedExecutor, HyperBand, VmapBackend
    from hpbandster_tpu_torch.ops.fused import make_fused_bracket_fn

    cs = branin_space(seed=0)

    def executor():
        return BatchedExecutor(VmapBackend(branin, device="cpu"), cs)

    common = dict(configspace=cs, run_id="unported", min_budget=1, max_budget=9,
                  device="cpu")
    wal = str(tmp_path / "wal.jsonl")
    opt = BOHB(executor=executor(), wal_path=wal, **common)
    opt.run(n_iterations=1)
    opt.shutdown()
    from hpbandster_tpu_torch.core.recovery import ResultWAL

    assert len(ResultWAL.read(wal)) == 13
    # promotion rules are ported: a rule name selects its iteration class
    from hpbandster_tpu_torch.promote.asha import ASHAIteration

    assert BOHB(executor=executor(), promotion_rule="asha",
                **common).iteration_class is ASHAIteration
    from hpbandster_tpu_torch.ops.buckets import build_bucket_set
    from hpbandster_tpu_torch.serve import (
        ContinuousRunner,
        MegaRunner,
        ServePool,
        make_lane_mesh,
    )
    from hpbandster_tpu_torch.workloads import transformer_forward_seq_parallel

    assert all(w % 2 == 0 for b in build_bucket_set(plans_for(2), mesh_size=2).buckets
               for w in b.widths)
    x = np.random.default_rng(0).uniform(size=(9, 2)).astype(np.float32)
    assert VmapBackend(branin, mesh=mesh).evaluate(x, 3.0).shape == (9,)
    stages = make_fused_bracket_fn(branin, (9, 3), (1.0, 3.0), mesh=mesh)(x)
    assert [len(i) for i, _ in stages] == [9, 3]
    lane_mesh = make_lane_mesh(2, ["cpu"] * 4)
    assert lane_mesh.shape == {"lane": 2, "config": 2}
    pool = ServePool(VmapBackend(branin, device="cpu"), cs, continuous=True, lane_count=4,
                     lane_mesh=lane_mesh)
    assert pool.lane_mesh is lane_mesh
    bucket = build_bucket_set(plans_for(2), mesh_size=2).buckets[0]
    from hpbandster_tpu_torch.ops.bracket import BracketPlan
    from hpbandster_tpu_torch.serve import PackEntry

    member = bucket.widths[0]
    entry = PackEntry("t", x[:1].repeat(member, 0), BracketPlan((member,) + bucket.widths[1:],
                                                                bucket.budgets), 0)
    out = ContinuousRunner(branin, bucket, lane_count=4, mesh=lane_mesh).run_chunk([entry], d=2)
    assert [len(i) for i, _ in out[0]] == list(bucket.widths)
    out = MegaRunner(branin, bucket, pack_width=2, mesh=mesh).run_packed([entry], d=2)
    assert [len(i) for i, _ in out[0]] == list(bucket.widths)
    from hpbandster_tpu_torch.ops.ring_attention import make_ring_attention, seq_mesh
    from hpbandster_tpu_torch.workloads.transformer import TransformerConfig

    q = torch.ones((8, 2, 4))
    assert make_ring_attention(seq_mesh(["cpu"] * 2))(q, q, q).shape == (8, 2, 4)
    tcfg = TransformerConfig(vocab=4, prefix_len=2, d_model=8, n_heads=2, n_layers=1, d_ff=8)
    params = {"tok_emb": torch.zeros((1, 5, 8)), "pos_emb": torch.zeros((1, 4, 8)),
              "head": torch.zeros((1, 8, 5)), "ln_f": torch.ones((1, 8)),
              "ln_f_b": torch.zeros((1, 8)),
              "l0": {**{w: torch.zeros((1, 8, 8)) for w in ("wq", "wk", "wv", "wo", "w1", "w2")},
                     **{n: torch.ones((1, 8)) for n in ("ln1", "ln2")},
                     **{n: torch.zeros((1, 8)) for n in ("ln1_b", "ln2_b")}}}
    logits = transformer_forward_seq_parallel(params, torch.zeros((1, 4), dtype=torch.long),
                                              tcfg, seq_mesh(["cpu"] * 2))
    assert logits.shape == (1, 1, 4, 5)
    hb = HyperBand(configspace=cs, run_id="unported", executor=executor(),
                   min_budget=1, max_budget=9, checkpoint_path=str(tmp_path / "c.pkl"))
    hb.run(n_iterations=1)
    hb.save_checkpoint(str(tmp_path / "c.pkl"))
    hb2 = HyperBand(configspace=cs, run_id="unported", executor=executor(),
                    min_budget=1, max_budget=9)
    # the WAL holds the BOHB run's records: none is queued in this state
    assert hb2.resume(str(tmp_path / "c.pkl"), wal) == {"replayed": 0, "skipped": 13}
    assert len(hb2.iterations) == 1
    sources = (REPO / "hpbandster_tpu_torch").rglob("*.py")
    assert not [f.name for f in sources if "A9" in f.read_text() or "A7b" in f.read_text()]


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
