"""The batched MLP training step split over a ``("config", "model")`` mesh.

The counterpart of the shardings the reference's root entry module gives
``workloads/mlp.py::sgd_train_step_batch`` in its multichip dry run
(``__graft_entry__.py``: ``NamedSharding`` per leaf, XLA inserting the
collectives). PyTorch has no GSPMD, so the split is written out here:

* :func:`shard_mlp_params` lays a lane-stacked MLP tree (``[n, ...]``
  leaves, as ``workloads/mlp.py`` builds them) over the mesh: every leaf's
  lane axis over ``config``; ``w1``, ``b1``, ``w2`` and ``b2`` column-split
  over ``model``, ``w3`` row-split, ``b3`` replicated (:data:`MODEL_SPLIT`).
  :func:`gather_mlp_params` puts the blocks back into one tree.
* :func:`sgd_train_step_batch_tp` is ``sgd_train_step_batch`` on such a
  tree. Model shard ``m`` computes ``tanh(x @ w1_m + b1_m)``; the hidden
  activations are all-gathered over ``model`` before ``w2``; each shard
  computes ``tanh(h @ w2_m + b2_m) @ w3_m``; the partial logits are summed
  over ``model`` and ``b3`` is added once. The momentum, weight-decay and
  update arithmetic is elementwise, per block.

The two collectives are the Megatron pair of autograd functions: the
all-gather, whose backward is a reduce-scatter (each slice's gradient is
the sum of every model shard's gradient of that slice), and the sum, whose
backward is the identity on the replicated upstream (each model shard
computes the same loss from the same logits and back-propagates its own
copy, as each rank does in SPMD). In one process (a mesh whose devices
may repeat one card, or ``cpu``) they move blocks with ``.to()`` and
concatenate or sum them in shard order. On a mesh over a process group
(``config_model_mesh(process_group=)``) a row that spans ranks exchanges
its blocks by ``torch.distributed`` ``all_gather`` and sums them by
``all_reduce``; a row that one rank owns stays in that process.

The row-parallel sum reorders additions against the unsplit product, so a
split of two or more model shards agrees with the unsplit step within
float32 rounding (``rtol 1e-5``, ``atol 1e-6`` with TF32 off), not bit for
bit; a ``(1, 1)`` mesh is the unsplit step bit for bit.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch.parallel.mesh import Mesh, config_model_mesh, mesh_device
from hpbandster_tpu_torch.workloads.mlp import _dense, _xent

__all__ = [
    "MODEL_SPLIT",
    "shard_mlp_params",
    "gather_mlp_params",
    "mlp_grads_tp",
    "sgd_train_step_batch_tp",
]

#: leaf -> the dim split over ``model`` (None: replicated); every leaf
#: splits its lane axis (dim 0) over ``config``. The reference's specs:
#: ``P("config", None, "model")`` for ``w1``/``w2``, ``P("config", "model")``
#: for ``b1``/``b2``, ``P("config", "model", None)`` for ``w3``,
#: ``P("config", None)`` for ``b3``.
MODEL_SPLIT = {"w1": 2, "b1": 1, "w2": 2, "b2": 1, "w3": 1, "b3": None}

Position = Tuple[int, int]
#: a laid-out tree: position ``(c, m)`` -> that block's leaves, for the
#: positions this process owns
Shards = Dict[Position, Dict[str, torch.Tensor]]


class _Plan(NamedTuple):
    """A mesh's geometry as the step uses it: ``C`` config and ``M`` model
    shards, the positions this process owns (row-major), each position's
    device, and whether the model rows span ranks."""

    mesh: Mesh
    C: int
    M: int
    owned: Tuple[Position, ...]
    devices: Dict[Position, torch.device]
    model_across_ranks: bool

    @property
    def grouped(self) -> bool:
        return self.mesh.process_group is not None

    def all_blocks(self, blocks: Dict[Position, torch.Tensor]) -> Dict[Position, torch.Tensor]:
        """Every position's block from the blocks this process owns (all of
        the same shape): in one process they are all here; over a process
        group an ``all_gather`` hands every rank each rank's owned blocks,
        stacked in row-major order on its home device."""
        if not self.grouped:
            return blocks
        import torch.distributed as dist

        home = mesh_device(self.mesh)
        local = torch.stack([blocks[p].to(home) for p in self.owned])
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size(self.mesh.process_group))]
        dist.all_gather(parts, local, group=self.mesh.process_group)
        out, taken = {}, [0] * len(parts)
        for c in range(self.C):
            for m in range(self.M):
                r = int(self.mesh.ranks[c, m])
                out[(c, m)] = parts[r][taken[r]]
                taken[r] += 1
        return out

    def row_sum(self, blocks: Dict[Position, torch.Tensor]) -> Dict[Position, torch.Tensor]:
        """Each owned position's sum over its row of the blocks (each
        position contributes its own), on the position's device: in shard
        order in one process; over ranks each rank's partial row sums
        ``all_reduce``d."""
        if not self.model_across_ranks:
            out = {}
            for c, m in self.owned:
                dev = self.devices[(c, m)]
                acc = blocks[(c, 0)].to(dev)
                for j in range(1, self.M):
                    acc = acc + blocks[(c, j)].to(dev)
                out[(c, m)] = acc
            return out
        import torch.distributed as dist

        home = mesh_device(self.mesh)
        shape = next(iter(blocks.values())).shape
        buf = torch.zeros((self.C,) + tuple(shape), dtype=next(iter(blocks.values())).dtype,
                          device=home)
        for c, m in self.owned:
            buf[c] += blocks[(c, m)].to(home)
        dist.all_reduce(buf, group=self.mesh.process_group)
        return {(c, m): buf[c].to(self.devices[(c, m)]) for c, m in self.owned}


def _plan(mesh: Mesh) -> _Plan:
    if tuple(mesh.axis_names) != ("config", "model"):
        raise ValueError(f"the tensor-parallel step needs a ('config', 'model') mesh, "
                         f"got {mesh!r}")
    C, M = mesh.devices.shape
    devices = {(c, m): mesh.devices[c, m] for c in range(C) for m in range(M)}
    if mesh.ranks is None:
        return _Plan(mesh, C, M, tuple(devices), devices, False)
    import torch.distributed as dist

    me = dist.get_rank(mesh.process_group)
    owned = tuple(p for p in devices if int(mesh.ranks[p]) == me)
    counts = np.bincount(mesh.ranks.ravel())
    if len(set(counts.tolist())) != 1:
        raise ValueError(f"every rank must own as many positions of {mesh!r}")
    across = any(len(set(mesh.ranks[c].tolist())) > 1 for c in range(C))
    return _Plan(mesh, C, M, owned, devices, across)


def _block(leaf: torch.Tensor, name: str, plan: _Plan, pos: Position) -> torch.Tensor:
    """Position ``pos``'s block of a full leaf."""
    c, m = pos
    n = leaf.shape[0]
    if n % plan.C:
        raise ValueError(f"{n} lanes do not split over {plan.C} config shards")
    per = n // plan.C
    out = leaf[c * per:(c + 1) * per]
    dim = MODEL_SPLIT[name]
    if dim is not None:
        size = leaf.shape[dim]
        if size % plan.M:
            raise ValueError(f"{name}'s dim {dim} ({size}) does not split over "
                             f"{plan.M} model shards")
        w = size // plan.M
        out = out.narrow(dim, m * w, w)
    return out.contiguous().to(plan.devices[pos])


def shard_mlp_params(params: Dict[str, torch.Tensor], mesh: Mesh) -> Shards:
    """The blocks of a lane-stacked MLP tree (``w1 [n, d_in, width]``,
    ``b1 [n, width]``, ``w2 [n, width, width]``, ``b2 [n, width]``,
    ``w3 [n, width, n_classes]``, ``b3 [n, n_classes]``) that this process
    owns on ``mesh``, each on its position's device (:data:`MODEL_SPLIT`).
    ``n`` must divide over ``config`` and ``width`` over ``model``."""
    plan = _plan(mesh)
    return {p: {k: _block(params[k], k, plan, p) for k in MODEL_SPLIT} for p in plan.owned}


def gather_mlp_params(shards: Shards, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_mlp_params`: one lane-stacked tree on the
    mesh's home device (over a process group, on every rank)."""
    plan = _plan(mesh)
    home = mesh_device(mesh)
    out = {}
    for k, dim in MODEL_SPLIT.items():
        blocks = plan.all_blocks({p: shards[p][k] for p in plan.owned})
        rows = []
        for c in range(plan.C):
            if dim is None:
                rows.append(blocks[(c, 0)].to(home))
            else:
                rows.append(torch.cat([blocks[(c, m)].to(home) for m in range(plan.M)],
                                      dim=dim))
        out[k] = torch.cat(rows)
    return out


class _GatherOverModel(torch.autograd.Function):
    """The owned positions' hidden slices -> each owned position's whole
    hidden activation, its row's slices concatenated in shard order. The
    backward is the reduce-scatter: slice ``m``'s gradient sums the row's
    gradients of the whole activation at slice ``m``."""

    @staticmethod
    def forward(ctx, plan, *slices):
        ctx.plan = plan
        ctx.width = slices[0].shape[-1]
        blocks = plan.all_blocks(dict(zip(plan.owned, slices)))
        return tuple(torch.cat([blocks[(c, j)].to(plan.devices[(c, m)])
                                for j in range(plan.M)], dim=-1)
                     for c, m in plan.owned)

    @staticmethod
    def backward(ctx, *grads):
        plan, w = ctx.plan, ctx.width
        sliced = {}
        for (c, m), g in zip(plan.owned, grads):
            for k in range(plan.M):
                sliced[(c, m, k)] = g[..., k * w:(k + 1) * w]
        out = []
        if not plan.model_across_ranks:
            for c, m in plan.owned:
                dev = plan.devices[(c, m)]
                acc = sliced[(c, 0, m)].to(dev)
                for j in range(1, plan.M):
                    acc = acc + sliced[(c, j, m)].to(dev)
                out.append(acc)
            return (None, *out)
        import torch.distributed as dist

        home = mesh_device(plan.mesh)
        buf = torch.zeros((plan.C, plan.M) + tuple(sliced[plan.owned[0] + (0,)].shape),
                          dtype=grads[0].dtype, device=home)
        for c, j in plan.owned:
            for m in range(plan.M):
                buf[c, m] += sliced[(c, j, m)].to(home)
        dist.all_reduce(buf, group=plan.mesh.process_group)
        return (None, *(buf[c, m].to(plan.devices[(c, m)]) for c, m in plan.owned))


class _SumOverModel(torch.autograd.Function):
    """The owned positions' partial logits -> each owned position's sum of
    its row's partials. The backward is the identity: the upstream is
    replicated over ``model``, each shard back-propagating its own copy."""

    @staticmethod
    def forward(ctx, plan, *partials):
        if plan.M == 1:
            return tuple(p.view_as(p) for p in partials)
        sums = plan.row_sum(dict(zip(plan.owned, partials)))
        return tuple(sums[p] for p in plan.owned)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


def _forward(plan: _Plan, shards: Shards, x: torch.Tensor) -> Dict[Position, torch.Tensor]:
    """Each owned position's logits ``[n / C, B, n_classes]`` (replicated
    over ``model``)."""
    owned = plan.owned
    h1 = [torch.tanh(_dense(x.to(plan.devices[p]), shards[p]["w1"], shards[p]["b1"]))
          for p in owned]
    h1 = _GatherOverModel.apply(plan, *h1)
    parts = [torch.bmm(torch.tanh(_dense(h, shards[p]["w2"], shards[p]["b2"])), shards[p]["w3"])
             for p, h in zip(owned, h1)]
    sums = _SumOverModel.apply(plan, *parts)
    return {p: s + shards[p]["b3"].unsqueeze(1) for p, s in zip(owned, sums)}


def _losses(plan: _Plan, shards: Shards, x, y) -> Dict[Position, torch.Tensor]:
    logits = _forward(plan, shards, x)
    return {p: _xent(l, y.to(l.device)) for p, l in logits.items()}


def mlp_grads_tp(shards: Shards, x: torch.Tensor, y: torch.Tensor,
                 mesh: Mesh) -> Tuple[Shards, Dict[Position, torch.Tensor]]:
    """Each lane's cross-entropy gradient on ``(x, y)``, laid out as
    ``shards``, and each owned position's per-lane losses ``f32[n / C]``.
    Gathered (:func:`gather_mlp_params`), the gradients are those of the
    unsplit loss."""
    plan = _plan(mesh)
    leaves = {p: {k: t.detach().requires_grad_(True) for k, t in shards[p].items()}
              for p in plan.owned}
    with torch.enable_grad():
        losses = _losses(plan, leaves, x, y)
        flat = [leaves[p][k] for p in plan.owned for k in MODEL_SPLIT]
        outs = [losses[p] for p in plan.owned]
        grads = torch.autograd.grad(outs, flat, [torch.ones_like(o) for o in outs])
    it = iter(grads)
    return ({p: {k: next(it) for k in MODEL_SPLIT} for p in plan.owned},
            {p: l.detach() for p, l in losses.items()})


def _lanes(h: torch.Tensor, plan: _Plan, pos: Position, ndim: int) -> torch.Tensor:
    """Position ``pos``'s lanes of ``f32[n]``, shaped to broadcast against
    ``ndim``-dim leaves."""
    per = h.shape[0] // plan.C
    c = pos[0]
    return h[c * per:(c + 1) * per].to(plan.devices[pos]).reshape((per,) + (1,) * (ndim - 1))


def sgd_train_step_batch_tp(params: Shards, velocity: Shards, x: torch.Tensor,
                            y: torch.Tensor, lrs: torch.Tensor, momenta: torch.Tensor,
                            wds: torch.Tensor, mesh: Optional[Mesh] = None):
    """``workloads/mlp.py::sgd_train_step_batch`` split over ``mesh``:
    ``params`` and ``velocity`` laid out by :func:`shard_mlp_params`,
    ``x [B, d_in]`` and ``y [B]`` shared, ``lrs``, ``momenta`` and ``wds``
    ``f32[n]``. Returns ``(params, velocity, losses)``: the new trees laid
    out the same way and the losses after the step, ``f32[n]`` on the
    mesh's home device (over a process group, on every rank). Without a
    mesh, every visible CUDA device over ``config`` (raises where there is
    none)."""
    mesh = config_model_mesh() if mesh is None else mesh
    plan = _plan(mesh)
    grads, _ = mlp_grads_tp(params, x, y, mesh)
    new_p, new_v = {}, {}
    with torch.no_grad():
        for p in plan.owned:
            new_p[p], new_v[p] = {}, {}
            for k in MODEL_SPLIT:
                pi, vi, g = params[p][k], velocity[p][k], grads[p][k]
                mom, wd, lr = (_lanes(h, plan, p, pi.dim()) for h in (momenta, wds, lrs))
                v = mom * vi + g + wd * pi
                new_v[p][k] = v
                new_p[p][k] = pi - lr * v
        losses = _losses(plan, new_p, x, y)
    blocks = plan.all_blocks(losses)
    home = mesh_device(mesh)
    return new_p, new_v, torch.cat([blocks[(c, 0)].to(home) for c in range(plan.C)])
