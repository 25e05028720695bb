"""The port's mesh helpers (``hpbandster_tpu_torch/parallel/mesh.py``), the
mesh-aligned plan, the sharded sampler, the bucket set's mesh padding and
the placement helpers, against the reference's on its eight virtual CPU
devices (``tests/conftest.py``) and on the port's repeated-``cpu`` meshes.

Geometry (shard counts, padded sizes, stage counts, bucket widths) equals
the reference's exactly. The sharded sampler is the port's own stream
(``torch.Generator`` per shard, ``shard_seed``), so it is held to its
contract, not to jax's numbers: one shard is ``random_unit`` bit for bit,
each shard's block is its own generator's draw, and an indivisible count
raises as the reference does.
"""

import numpy as np
import pytest
import torch

from hpbandster_tpu_torch.ops.bracket import BracketPlan, hyperband_schedule, mesh_aligned_plan
from hpbandster_tpu_torch.ops.buckets import _mesh_pad, build_bucket_set
from hpbandster_tpu_torch.ops.fused import shard_rows
from hpbandster_tpu_torch.ops.sweep import (
    build_space_codec,
    codec_tables,
    random_unit,
    random_unit_sharded,
    shard_seed,
)
from hpbandster_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    config_mesh,
    config_model_mesh,
    is_multiprocess_mesh,
    mesh_device,
    pad_to_shards,
    shard_count,
)
from hpbandster_tpu_torch.workloads.ensemble import (
    EnsembleState,
    shard_ensemble_state,
)
from hpbandster_tpu_torch.workloads.toys import branin_space, hartmann6_space
from tests.test_torch_harness import ref, ref_mesh  # noqa: F401


def cpu_mesh(n):
    return config_mesh([torch.device("cpu")] * n)


def _generators(seed, n):
    out = []
    for s in range(n):
        g = torch.Generator()
        g.manual_seed(shard_seed(seed, s) if n > 1 else seed)
        out.append(g)
    return out


# ------------------------------------------------------------ mesh helpers
def test_shard_count_and_pad_match_reference(ref_mesh):  # noqa: F811
    """``shard_count`` / ``pad_to_shards`` on 1-, 3- and 8-shard meshes
    (and on none, and on an absent axis) equal the reference's."""
    for n in (1, 3, 8):
        want = ref_mesh.mesh.config_mesh(ref_mesh.devices[:n])
        got = cpu_mesh(n)
        assert shard_count(got) == ref_mesh.mesh.shard_count(want) == n
        assert shard_count(got, "nonexistent") == ref_mesh.mesh.shard_count(want, "x") == 1
        for rows in (1, 5, 9, 16, 17, 1000):
            assert pad_to_shards(rows, got) == ref_mesh.mesh.pad_to_shards(rows, want)
    assert shard_count(None) == 1 and pad_to_shards(5, None) == 5
    assert pad_to_shards(9, cpu_mesh(8)) == 16 and pad_to_shards(16, cpu_mesh(8)) == 16


def test_mesh_object_contract():
    """A mesh is immutable and hashable (it keys the program caches), its
    ``shape`` names its axes, a repeated device is allowed, and a
    one-process mesh is not a multi-process one."""
    m = cpu_mesh(4)
    assert m.shape == {"config": 4} and m.size == 4
    assert m == cpu_mesh(4) and hash(m) == hash(cpu_mesh(4)) and m != cpu_mesh(3)
    with pytest.raises(AttributeError):
        m.axis_names = ("x",)
    assert not is_multiprocess_mesh(m) and not is_multiprocess_mesh(None)
    assert mesh_device(m) == torch.device("cpu")
    two = config_model_mesh(2, ["cpu"] * 4)
    assert two.shape == {"config": 2, "model": 2} and shard_count(two, "model") == 2
    with pytest.raises(ValueError, match="divisible"):
        config_model_mesh(3, ["cpu"] * 4)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.asarray(["cpu"] * 4, dtype=object), ("config", "model"))


def test_config_mesh_never_falls_back_to_the_cpu(monkeypatch):
    """Without devices a mesh means every visible CUDA device; with none
    visible it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        config_mesh()


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_row_split_is_identity_on_row_wise_values(n_shards):
    """``batch_sharding(...).map`` evaluates each shard's contiguous block on
    its device and gathers them back in row order: equal to the whole-batch
    call for a row-wise function, pytrees included; an indivisible batch
    runs whole."""
    split = batch_sharding(cpu_mesh(n_shards))
    assert split.n_shards == n_shards
    x = torch.from_numpy(np.random.default_rng(n_shards).uniform(size=(24, 3)).astype(np.float32))
    calls = []

    def fn(v):
        calls.append(v.shape[0])
        return {"sum": v.sum(1), "pair": (v * 2.0, v[:, 0] > 0.5)}

    got = split.map(fn, x)
    want = fn(x)
    assert calls[:-1] == [24 // n_shards] * n_shards
    assert torch.equal(got["sum"], want["sum"])
    assert torch.equal(got["pair"][0], want["pair"][0])
    assert torch.equal(got["pair"][1], want["pair"][1])
    calls.clear()
    split.map(fn, x[:23])
    assert calls == [23] and split.blocks(23) is None


def test_model_axis_replicates_each_config_shard():
    """On a ``("config", "model")`` mesh a config shard runs on the first
    device of its model row."""
    m = config_model_mesh(2, ["cpu"] * 4)
    split = batch_sharding(m, "config")
    assert split.n_shards == 2 and len(split.devices) == 2
    with pytest.raises(ValueError, match="no axis"):
        batch_sharding(m, "seq")


# --------------------------------------------------------------- the plan
@pytest.mark.parametrize("mesh_size", [1, 3, 8])
@pytest.mark.parametrize("n_configs", [16, 1000, 1024, 2**17])
def test_mesh_aligned_plan_matches_reference(ref, mesh_size, n_configs):  # noqa: F811
    """Every stage a multiple of the shard count, a non-increasing
    profile, the full ladder, at least ``n_configs`` at stage 0: the
    reference's plan exactly."""
    want = ref.bracket.mesh_aligned_plan(n_configs, 1, 9, 3, mesh_size=mesh_size)
    got = mesh_aligned_plan(n_configs, 1, 9, 3, mesh_size=mesh_size)
    assert tuple(got.num_configs) == tuple(want.num_configs)
    assert tuple(got.budgets) == tuple(want.budgets) == (1.0, 3.0, 9.0)
    assert all(n % mesh_size == 0 for n in got.num_configs)
    assert all(a >= b for a, b in zip(got.num_configs, got.num_configs[1:]))
    assert got.num_configs[0] >= n_configs
    # a power-of-two count on a power-of-two mesh pads nothing
    assert mesh_aligned_plan(1024, 1, 9, 3, 8).num_configs[0] == 1024


# ------------------------------------------------------- sharded sampling
def test_one_shard_is_bitwise_random_unit():
    tables = codec_tables(build_space_codec(branin_space(seed=0)), "cpu")
    a = random_unit(tables, _generators(123, 1)[0], 64)
    b = random_unit_sharded(tables, _generators(123, 1), 64)
    assert torch.equal(a, b)


@pytest.mark.parametrize("space", [branin_space, hartmann6_space])
def test_shards_are_the_blocks_of_their_own_streams(space):
    """Shard ``s``'s block is ``random_unit`` from the generator seeded
    ``shard_seed(seed, s)``; the streams differ from shard to shard and
    from the unsharded stream."""
    tables = codec_tables(build_space_codec(space(seed=0)), "cpu")
    out = random_unit_sharded(tables, _generators(7, 4), 32)
    blocks = []
    for s in range(4):
        g = torch.Generator()
        g.manual_seed(shard_seed(7, s))
        blocks.append(random_unit(tables, g, 8))
        assert torch.equal(out[s * 8:(s + 1) * 8], blocks[-1])
    assert not torch.equal(blocks[0], blocks[1])
    assert len({shard_seed(7, s) for s in range(64)}) == 64
    assert shard_seed(7, 0) != shard_seed(8, 0)


def test_non_divisible_sharded_sampling_raises():
    tables = codec_tables(build_space_codec(branin_space(seed=0)), "cpu")
    with pytest.raises(ValueError, match="mesh multiple"):
        random_unit_sharded(tables, _generators(0, 4), 10)


# ------------------------------------------------------ bucket mesh padding
def test_mesh_pad_pads_every_stage():
    bs = build_bucket_set([BracketPlan((9, 3, 1), (1.0, 3.0, 9.0))], mesh_size=3)
    assert all(w % 3 == 0 for w in bs.buckets[0].widths)
    padded = _mesh_pad(bs.buckets[0], 5)
    assert all(w % 5 == 0 for w in padded.widths)
    assert all(a >= b for a, b in zip(padded.widths, padded.widths[1:]))
    assert _mesh_pad(bs.buckets[0], 1) is bs.buckets[0]


@pytest.mark.parametrize("mesh_size", [1, 3, 8])
def test_bucket_set_mesh_geometry_matches_reference(ref_mesh, mesh_size):  # noqa: F811
    """``build_bucket_set(mesh_size=)`` (widths and assignment) equals the
    reference's on HyperBand schedules of two ladders."""
    for plans in (hyperband_schedule(27, 1, 9, 3), hyperband_schedule(8, 1, 81, 3)):
        ref_plans = [ref_mesh.buckets.BracketPlan(p.num_configs, p.budgets) for p in plans]
        want = ref_mesh.buckets.build_bucket_set(ref_plans, mesh_size=mesh_size)
        got = build_bucket_set(plans, mesh_size=mesh_size)
        assert [tuple(b.widths) for b in got.buckets] == [tuple(b.widths) for b in want.buckets]
        assert [tuple(b.budgets) for b in got.buckets] == [tuple(b.budgets) for b in want.buckets]
        assert got.assignment == want.assignment


# ------------------------------------------------------------- placement
def test_shard_rows_and_shard_ensemble_state_are_identities():
    """Placing rows or an ensemble state for a mesh changes no value (and
    without a mesh returns the very object)."""
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    mesh = cpu_mesh(4)
    assert shard_rows(x, None) is x
    assert torch.equal(shard_rows(x, mesh), x)
    state = EnsembleState(params={"w": torch.ones((8, 2, 2)), "b": torch.zeros((8, 2))},
                          velocity={"w": torch.full((8, 2, 2), 0.5), "b": torch.ones((8, 2))})
    placed = shard_ensemble_state(state, mesh)
    assert isinstance(placed, EnsembleState)
    for a, b in zip((placed.params, placed.velocity), (state.params, state.velocity)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert shard_ensemble_state(state, None) is state
