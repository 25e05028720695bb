"""Device meshes over the config axis.

Ported from ``hpbandster_tpu/parallel/mesh.py``: ``config_mesh``,
``config_model_mesh``, ``batch_sharding``, ``is_multiprocess_mesh``,
``shard_count`` and ``pad_to_shards``.

A mesh here is a small immutable :class:`Mesh`: an ndarray of
``torch.device`` with one axis per mesh axis, the axis names, and, when it
was built over ``torch.distributed`` ranks, the rank that owns each position
and the process group. A device may appear more than once: a mesh of one
card repeated ``S`` times runs ``S`` shards on that card, the port's
counterpart of the virtual CPU devices the reference's tests shard over
(a repeated ``cpu`` device in the port's tests).

Sharding the config axis splits a batch's rows into ``shard_count``
contiguous blocks; block ``s`` is evaluated, and under shard sampling drawn,
on shard ``s``'s device (:func:`batch_sharding`'s :class:`RowSplit`). A
bracket's rows stay in one tensor on the mesh's home device (its first
device), where rung ranking, promotion and the incumbent run: the
stage-to-stage reductions gather there. On a mesh over a process group every
rank computes the blocks of the shards it owns, and an ``all_gather`` hands
every rank every block, so every output is replicated on every rank, as the
reference's replicated in/out shardings are. Each rank runs the same program
(the SPMD driver contract of ``parallel/multihost.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "Mesh",
    "RowSplit",
    "config_mesh",
    "config_model_mesh",
    "batch_sharding",
    "is_multiprocess_mesh",
    "mesh_device",
    "shard_count",
    "pad_to_shards",
]


def _normalize(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA device with its index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _object_array(items, shape) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    out[:] = list(items)
    return out.reshape(shape)


class Mesh:
    """An immutable device mesh: ``devices`` (an ndarray of ``torch.device``,
    one axis per name in ``axis_names``), ``shape`` (axis name -> size, as
    the reference's), and for a mesh over ``torch.distributed`` ranks
    ``ranks`` (the owning rank of every position, same shape) and
    ``process_group``; both are None in one process. Hashable, so it keys
    the process-wide program caches as the reference's mesh does."""

    __slots__ = ("devices", "axis_names", "ranks", "process_group", "_key")

    def __init__(self, devices, axis_names: Sequence[str], ranks=None,
                 process_group=None):
        flat = [_normalize(d) for d in np.asarray(devices, dtype=object).flat]
        shape = np.shape(np.asarray(devices, dtype=object))
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(axis_names)} axis names for a {len(shape)}-D device array")
        if not flat:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", _object_array(flat, shape))
        object.__setattr__(self, "axis_names", axis_names)
        object.__setattr__(self, "ranks", None if ranks is None
                           else np.asarray(ranks, np.int64).reshape(shape))
        object.__setattr__(self, "process_group", process_group)
        object.__setattr__(self, "_key", (
            tuple(str(d) for d in flat), shape, axis_names,
            None if ranks is None else tuple(int(r) for r in np.ravel(ranks)),
            id(process_group)))

    def __setattr__(self, name, value):
        raise AttributeError("Mesh is immutable")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __hash__(self) -> int:
        return hash(self._key)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __repr__(self) -> str:
        group = "" if self.process_group is None else f", ranks={self.ranks.tolist()}"
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}{group})"


def _this_rank(mesh: Mesh) -> int:
    import torch.distributed as dist

    return dist.get_rank(mesh.process_group)


def is_multiprocess_mesh(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` spans more than one process (the multi-process
    tier of ``parallel/multihost.py``). The one definition of "is this a
    multi-process run": the sweep's eager (uncaptured) execution, the
    streamed warm upload's refusal and ``run_incumbent``'s refusal all
    branch on it. A one-rank group is one process: its mesh is not
    multi-process, though its gathers still run through the group."""
    if mesh is None or mesh.ranks is None:
        return False
    me = _this_rank(mesh)
    return any(int(r) != me for r in mesh.ranks.flat)


def _visible_cuda() -> List[torch.device]:
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "config_mesh() without devices means every visible CUDA device, and "
            "there is none; pass devices (a repeated torch.device('cpu') on the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _group_positions(devices: Optional[Sequence], group):
    """The devices every rank of ``group`` names, rank by rank, and the
    owning rank of each: each rank names its own local devices (default:
    its current CUDA device), and every rank must name as many. A
    collective call: every rank of the group makes it."""
    import torch.distributed as dist

    local = [str(_normalize(d)) for d in (
        devices if devices is not None
        else [torch.device("cuda", torch.cuda.current_device())])]
    per_rank: List[Optional[List[str]]] = [None] * dist.get_world_size(group)
    dist.all_gather_object(per_rank, local, group=group)
    if len({len(p) for p in per_rank}) != 1:
        raise ValueError(
            f"every rank must name as many local devices, got {[len(p) for p in per_rank]}")
    flat = [torch.device(d) for p in per_rank for d in p]
    ranks = [r for r, p in enumerate(per_rank) for _ in p]
    return flat, ranks


def _default_group(devices, process_group):
    """``process_group``, or the default group where no devices are named
    after ``parallel.multihost.initialize_multihost`` joined a group of
    several ranks; None in one process."""
    import torch.distributed as dist

    if (process_group is None and devices is None and dist.is_available()
            and dist.is_initialized() and dist.get_world_size() > 1):
        return dist.group.WORLD
    return process_group


def config_mesh(devices: Optional[Sequence] = None, axis_name: str = "config",
                process_group=None) -> Mesh:
    """1-D mesh over ``devices``; without them, over every visible CUDA
    device (raises where there is none: it never falls back to the CPU).
    A device may repeat.

    Over ``torch.distributed`` ranks: pass ``process_group`` (or call with
    no ``devices`` after ``parallel.multihost.initialize_multihost`` joined
    a group of several ranks, which takes the default group). Each rank
    then names its own local devices (default: its current CUDA device);
    every rank must name as many, and the mesh lists them rank by rank.
    This is a collective call: every rank of the group makes it."""
    group = _default_group(devices, process_group)
    if group is None:
        devices = list(devices) if devices is not None else _visible_cuda()
        return Mesh(_object_array([_normalize(d) for d in devices], (len(devices),)),
                    (axis_name,))
    flat, ranks = _group_positions(devices, group)
    return Mesh(_object_array(flat, (len(flat),)), (axis_name,), ranks=ranks,
                process_group=group)


def config_model_mesh(config_parallel: Optional[int] = None,
                      devices: Optional[Sequence] = None,
                      process_group=None) -> Mesh:
    """2-D ``("config", "model")`` mesh: configs split over ``config``,
    each model over ``model``. The model axis splits the tensor-parallel
    MLP step (``parallel/tensor_parallel.py``, the hidden dims as the
    reference's root entry module shards them) and replicates everywhere
    else: the port's objectives are not model-parallel, so a config
    shard's rows run on the first device of its model row.

    The positions fill the grid row by row from the device list: without
    ``devices`` every visible CUDA device (raises where there is none).
    Over ``torch.distributed`` ranks (``process_group``, or the default
    group as :func:`config_mesh` takes it) the list is every rank's local
    devices, rank by rank, and each position remembers its rank: with one
    device a rank and ``config_parallel=1`` the model axis spans the
    ranks, with a rank's devices filling a row each the config axis does.
    ``config_parallel`` defaults to every position."""
    group = _default_group(devices, process_group)
    ranks = None
    if group is None:
        flat = [_normalize(d) for d in (list(devices) if devices is not None
                                        else _visible_cuda())]
    else:
        flat, ranks = _group_positions(devices, group)
    n = len(flat)
    if config_parallel is None:
        config_parallel = n
    if n % config_parallel != 0:
        raise ValueError(f"{n} devices not divisible by config_parallel={config_parallel}")
    shape = (config_parallel, n // config_parallel)
    return Mesh(_object_array(flat, shape), ("config", "model"),
                ranks=None if ranks is None else np.reshape(ranks, shape),
                process_group=group)


def shard_count(mesh: Optional[Mesh], axis: str = "config") -> int:
    """Number of shards along ``axis`` (1 for no mesh or an absent axis).

    The ONE definition of how many ways the config batch splits: the
    sharded sampler (``ops.sweep.random_unit_sharded``), the row split of
    every sharded evaluation (:class:`RowSplit`), the mesh padding of the
    bucket set and the per-shard balance gauges all take their geometry
    from here, and they must agree or a shard's random stream and its rows
    drift apart."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(axis, 1))


def pad_to_shards(n: int, mesh: Optional[Mesh], axis: str = "config") -> int:
    """``n`` rounded up to a multiple of the ``axis`` shard count."""
    m = shard_count(mesh, axis)
    return ((int(n) + m - 1) // m) * m


def _by_shard(mesh: Mesh, axis: str) -> np.ndarray:
    """Positions of ``mesh`` grouped by shard of ``axis``: ``[S, rest]``."""
    i = list(mesh.axis_names).index(axis)
    n = shard_count(mesh, axis)
    return np.moveaxis(np.arange(mesh.size).reshape(mesh.devices.shape), i, 0).reshape(n, -1)


def mesh_device(mesh: Mesh) -> torch.device:
    """The mesh's home device in this process: its first device this
    process owns. Rows between stages, the rung ranking and the incumbent
    live there."""
    flat = list(mesh.devices.flat)
    if mesh.ranks is None:
        return flat[0]
    me = _this_rank(mesh)
    for dev, r in zip(flat, mesh.ranks.flat):
        if int(r) == me:
            return dev
    raise ValueError(f"rank {me} owns no device of {mesh!r}")


def single_device(mesh: Optional[Mesh]) -> bool:
    """Whether every shard of ``mesh`` runs on one device of this one
    process (a repeated card, or one card): the case a captured CUDA graph
    can hold."""
    if mesh is None:
        return True
    return mesh.process_group is None and len({str(d) for d in mesh.devices.flat}) == 1


class RowSplit(NamedTuple):
    """The row split of one mesh axis (:func:`batch_sharding`): ``devices[s]``
    is shard ``s``'s device, ``owners[s]`` the rank that computes it (None in
    one process), ``group`` the process group."""

    n_shards: int
    devices: tuple
    owners: Optional[tuple]
    group: object

    def blocks(self, n: int) -> Optional[List[range]]:
        """The shards' contiguous row ranges of an ``n``-row batch, or None
        when the batch is not split (one shard, or ``n`` not a multiple of
        the shard count: it then runs whole, as the reference leaves an
        indivisible batch unconstrained)."""
        if self.n_shards <= 1 or n % self.n_shards:
            return None
        per = n // self.n_shards
        return [range(s * per, (s + 1) * per) for s in range(self.n_shards)]

    def owned(self) -> List[int]:
        """The shards this process computes."""
        if self.owners is None:
            return list(range(self.n_shards))
        import torch.distributed as dist

        me = dist.get_rank(self.group)
        return [s for s in range(self.n_shards) if self.owners[s] == me]

    def gather(self, parts: Dict[int, object], home: torch.device):
        """Every shard's output (a tensor, or a dict, tuple or list of them
        with the rows on the leading axis), in shard order, concatenated
        on ``home``. ``parts`` holds the outputs of :meth:`owned`'s shards;
        across processes the other shards' come from an ``all_gather``."""
        from hpbandster_tpu_torch.ops.fused import tree_leaves, tree_map

        order = sorted(parts)
        columns = list(zip(*(tree_leaves(parts[s]) for s in order)))
        if self.owners is None:
            merged = [torch.cat([leaf.to(home) for leaf in col]) for col in columns]
        else:
            merged = [self._all_gather(torch.cat([leaf.to(home) for leaf in col]))
                      for col in columns]
        it = iter(merged)
        return tree_map(lambda _: next(it), parts[order[0]])

    def _all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's ``local`` rows, rank by rank (the shard order: a
        group mesh lists its devices rank by rank, as many per rank)."""
        import torch.distributed as dist

        wire = local.to(torch.uint8) if local.dtype == torch.bool else local.contiguous()
        out = [torch.empty_like(wire) for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(out, wire, group=self.group)
        full = torch.cat(out)
        return full.to(torch.bool) if local.dtype == torch.bool else full

    def generate(self, fn: Callable[[int, int], object], n: int, home: torch.device):
        """``fn(s, rows)`` for each shard this process owns, on shard ``s``'s
        device, gathered on ``home`` in shard order: ``n`` rows in all
        (``n`` must split evenly)."""
        if n % self.n_shards:
            raise ValueError(f"{n} rows do not split over {self.n_shards} shards")
        per = n // self.n_shards
        return self.gather({s: fn(s, per) for s in self.owned()}, home)

    def map(self, fn: Callable, *trees):
        """``fn(*trees)`` computed block by block: each shard's rows of
        every tensor leaf of ``trees`` (all with the same leading size) on
        that shard's device, the outputs gathered back in row order on the
        first leaf's device. Equal in value to ``fn(*trees)`` for a
        row-wise ``fn``; an unsplit batch (:meth:`blocks`) calls it
        whole."""
        from hpbandster_tpu_torch.ops.fused import tree_leaves, tree_map

        first = tree_leaves(trees)[0]
        spans = self.blocks(first.shape[0])
        if spans is None:
            return fn(*trees)
        parts = {}
        for s in self.owned():
            dev, span = self.devices[s], spans[s]
            parts[s] = fn(*tree_map(lambda t: t[span.start:span.stop].to(dev), trees))
        return self.gather(parts, first.device)


def batch_sharding(mesh: Mesh, axis: str = "config") -> RowSplit:
    """The row split of ``axis`` (the reference's ``NamedSharding`` over a
    leading batch dim): shard ``s``'s rows on the first device of its slice
    (on a 2-D mesh the other axes replicate the shard)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh!r} has no axis {axis!r}")
    first = _by_shard(mesh, axis)[:, 0]
    flat = list(mesh.devices.flat)
    owners = None
    if mesh.ranks is not None:
        ranks = [int(r) for r in mesh.ranks.flat]
        owners = tuple(ranks[p] for p in first)
        if list(owners) != sorted(owners):
            raise ValueError(f"a group mesh lists its shards rank by rank, got {owners}")
    return RowSplit(n_shards=len(first), devices=tuple(flat[p] for p in first),
                    owners=owners, group=mesh.process_group)
