"""Ring attention: exact attention with the sequence axis over a device mesh.

Ported from ``hpbandster_tpu/ops/ring_attention.py``. The sequence axis is
split over the mesh's ring of shards; queries stay resident while the K/V
blocks rotate one hop per step, and each (Q block, K/V block) tile folds
into a numerically stable online softmax (running max, normalizer and
accumulator), so a shard holds O(T/P * d) and the result is exactly the
softmax over the whole sequence (the reduction is reordered: last-bit
rounding differs from dense attention). No buffer is quadratic in T.

Causal runs skip the products of a tile that is fully masked: in the
contiguous layout block ``j`` is dead for the queries of block ``i`` when
``j * t_k > i * t_q + t_q - 1``. The block index is known on the host, so a
Python ``if`` skips it where the reference needs ``lax.cond``. The striped
layout (``striped=True``: shard ``i`` holds the positions congruent to
``i`` mod P) makes every tile about half live, which balances the causal
work over the ring; :func:`make_ring_attention` relays global arrays to
stripes and back with a reshape and a transpose.

Training keeps the memory bound: :class:`_RingAttention` is an
``autograd.Function`` whose forward saves only this process's own blocks,
the output and the per-row logsumexp, and whose backward re-rotates K/V
around the ring (flash-attention gradients per tile, recomputed from the
logsumexp), the dK/dV accumulators travelling with their blocks and taking
one final hop home. Autograd never sees the rotated blocks.

Numerics follow the reference, whose tile products take ``compute_dtype``
operands with float32 results: each operand is rounded to
``compute_dtype`` and held as float32, and the products run in float32
(a product of two bfloat16 values is exact in float32; keep TF32 off).
The mask is the additive constant -1e30, not -inf, so a fully masked row
underflows to 0 instead of producing NaN. This is plain torch code, as the
reference's is jnp.

Transport (the reference's ``ppermute``):

* a mesh over devices of one process, a repeated card included: every
  shard steps in lockstep, and a rotation moves each block to the next
  shard's device (``.to()``, a no-op on a repeated device);
* a mesh over a process group (``parallel.mesh.config_mesh(...,
  process_group=)``): each rank computes the shards it owns, and a block
  whose next shard belongs to another rank travels by
  ``torch.distributed.batch_isend_irecv`` (to the next rank, from the
  previous one). This is the counterpart of calling
  ``ring_attention_block`` inside a ``shard_map``: every rank calls it with
  its own blocks.

Public surface: :func:`seq_mesh`, :func:`stripe_indices`,
:func:`ring_attention_block` (this process's blocks), :func:`make_ring_attention`
(global arrays, one process) and :func:`dense_attention` (the plain dense
version the ring is held against). Blocks take leading batch dims:
``[..., T, H, dh]``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "ring_attention_block",
    "make_ring_attention",
    "seq_mesh",
    "stripe_indices",
    "dense_attention",
    "shard_positions",
]

#: additive mask value: large-negative (not -inf) so that a fully masked
#: tile's exp() underflows to exactly 0 instead of NaN arithmetic
_MASK = -1e30
#: the sequence axis of a ``[..., T, H, dh]`` block
_SEQ = -3


def seq_mesh(devices: Optional[Sequence] = None, process_group=None):
    """1-D mesh with a ``"seq"`` axis (``parallel.mesh.config_mesh``'s
    long-context twin): over ``devices`` (which may repeat one), every
    visible card without them, or each rank's devices of
    ``process_group``."""
    from hpbandster_tpu_torch.parallel.mesh import config_mesh

    return config_mesh(devices, axis_name="seq", process_group=process_group)


def stripe_indices(t: int, p_size: int):
    """Index arrays converting a length-``t`` sequence between natural
    order and the striped layout (shard ``i`` holds the positions congruent
    to ``i`` mod P): ``x[to_striped]`` is stripe-ordered, so that a
    contiguous split gives shard ``i`` slots ``s`` holding position
    ``s * P + i``; ``to_natural`` inverts it."""
    if t % p_size:
        raise ValueError(f"T={t} must divide by the ring size {p_size}")
    b = t // p_size
    n = np.arange(t)
    to_striped = (n % b) * p_size + n // b
    to_natural = np.empty(t, np.int64)
    to_natural[to_striped] = n
    return to_striped, to_natural


def _round(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and held as float32 (the
    reference's ``preferred_element_type=float32`` products)."""
    return x.to(compute_dtype).float()


def _tile_scores(q_c, k_blk, scale, compute_dtype, causal, striped, i, j):
    """``[..., H, Tq, Tk]`` tile scores of query block ``i`` against key
    block ``j`` with the global-position causal mask (contiguous or
    striped layout)."""
    t_q, t_k = q_c.shape[_SEQ], k_blk.shape[_SEQ]
    s = torch.einsum("...qhd,...khd->...hqk", q_c, _round(k_blk, compute_dtype)) * scale
    if causal:
        dev = s.device
        if striped:
            # q position = slot*P + i, k position = slot*P + j: the tile's
            # causal set is slot_q > slot_k, plus the diagonal when i >= j
            sq = torch.arange(t_q, device=dev)[:, None]
            sk = torch.arange(t_k, device=dev)[None, :]
            live = (sq > sk) | ((sq == sk) & (i >= j))
        else:
            q_pos = i * t_q + torch.arange(t_q, device=dev)
            k_pos = j * t_k + torch.arange(t_k, device=dev)
            live = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(live, s, _MASK)
    return s


def _dead(causal, striped, i, j, t_q, t_k) -> bool:
    """A contiguous causal tile whose every key position exceeds every
    query position: its probabilities are exactly 0, so its products are
    skipped (striped tiles are about half live by construction)."""
    return causal and not striped and j * t_k > i * t_q + (t_q - 1)


class _Ring:
    """The ring of one mesh axis as this process sees it: shard ``s``'s
    device, the shards this process computes, and for a mesh over a
    process group each shard's owning rank."""

    def __init__(self, mesh, axis: str):
        from hpbandster_tpu_torch.parallel.mesh import batch_sharding

        split = batch_sharding(mesh, axis)
        self.size = split.n_shards
        self.devices = split.devices
        self.owners = split.owners
        self.group = split.group
        self.owned = split.owned()
        if self.owners is not None:
            import torch.distributed as dist

            self.me = dist.get_rank(self.group)

    def rotate(self, blocks: Dict[int, List[torch.Tensor]]) -> Dict[int, List[torch.Tensor]]:
        """One hop: shard ``s``'s tensors move to shard ``s + 1``. Returns,
        for every shard this process owns, the tensors it now holds (those
        of shard ``s - 1``)."""
        p = self.size
        if self.owners is None:
            return {s: [t.to(self.devices[s]) for t in blocks[(s - 1) % p]]
                    for s in self.owned}
        import torch.distributed as dist

        out: Dict[int, List[torch.Tensor]] = {}
        ops = []
        for s in self.owned:
            nxt, prv = (s + 1) % p, (s - 1) % p
            if self.owners[nxt] != self.me:
                peer = dist.get_global_rank(self.group, self.owners[nxt])
                ops += [dist.P2POp(dist.isend, t.contiguous(), peer, self.group, tag)
                        for tag, t in enumerate(blocks[s])]
            if self.owners[prv] == self.me:
                out[s] = [t.to(self.devices[s]) for t in blocks[prv]]
            else:
                peer = dist.get_global_rank(self.group, self.owners[prv])
                out[s] = [torch.empty_like(t, device=self.devices[s]) for t in blocks[s]]
                ops += [dist.P2POp(dist.irecv, t, peer, self.group, tag)
                        for tag, t in enumerate(out[s])]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out


def _split(x: torch.Tensor, ring: _Ring) -> Dict[int, torch.Tensor]:
    """This process's sequence chunk cut into its shards' blocks, each on
    its shard's device."""
    n = len(ring.owned)
    if x.shape[_SEQ] % n:
        raise ValueError(f"{x.shape[_SEQ]} positions do not split over the {n} shards "
                         "this process owns")
    parts = torch.chunk(x, n, dim=_SEQ)
    return {s: part.to(ring.devices[s]) for s, part in zip(ring.owned, parts)}


def _join(blocks: Dict[int, torch.Tensor], ring: _Ring, home: torch.device,
          dim: int = _SEQ) -> torch.Tensor:
    return torch.cat([blocks[s].to(home) for s in ring.owned], dim=dim)


def _forward(ring, causal, striped, scale, compute_dtype, q, k, v):
    """The lockstep forward over this process's shards: ``(out, lse)``,
    ``lse`` the per-row logsumexp ``[..., H, Tq]`` of each block, joined on
    the query axis."""
    qs, ks, vs = _split(q, ring), _split(k, ring), _split(v, ring)
    state = {}
    for i in ring.owned:
        q_c = _round(qs[i], compute_dtype)
        lead = q_c.shape[:_SEQ]
        t_q, n_heads, dh = q_c.shape[_SEQ:]
        state[i] = [q_c,
                    torch.full(lead + (n_heads, t_q), _MASK, device=q_c.device),
                    torch.zeros(lead + (n_heads, t_q), device=q_c.device),
                    torch.zeros(lead + (n_heads, t_q, dh), device=q_c.device)]

    def tile_update(i, j, k_blk, v_blk):
        q_c, m, l, acc = state[i]
        s = _tile_scores(q_c, k_blk, scale, compute_dtype, causal, striped, i, j)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "...hqk,...khd->...hqd", _round(p, compute_dtype), _round(v_blk, compute_dtype))
        state[i][1:] = [m_new, l, acc]

    t_q, t_k = q.shape[_SEQ] // len(ring.owned), k.shape[_SEQ] // len(ring.owned)
    # step 0 (the shard's own block) is hoisted: the loop then rotates and
    # computes, so exactly P-1 hops run and none is thrown away; it also
    # seeds the running max from the never fully masked diagonal block
    for i in ring.owned:
        tile_update(i, i, ks[i], vs[i])
    held = {s: [ks[s], vs[s]] for s in ring.owned}
    for t in range(1, ring.size):
        held = ring.rotate(held)
        for i in ring.owned:
            j = (i - t) % ring.size
            if not _dead(causal, striped, i, j, t_q, t_k):
                tile_update(i, j, *held[i])
    outs, lses = {}, {}
    for i in ring.owned:
        _, m, l, acc = state[i]
        outs[i] = (acc / l[..., None]).transpose(-3, -2).to(q.dtype)
        lses[i] = m + torch.log(l)
    return _join(outs, ring, q.device), _join(lses, ring, q.device, dim=-1)


def _backward(ring, causal, striped, scale, compute_dtype, q, k, v, out, lse, dout):
    """Flash-attention backward per tile, K/V re-rotated around the ring:
    with the saved logsumexp each tile's probabilities are recomputed
    exactly (``p = exp(s - lse)``), and the dK/dV accumulators travel with
    their blocks, so after P-1 hops and one more every block's gradient is
    back on its shard."""
    qs, ks, vs = _split(q, ring), _split(k, ring), _split(v, ring)
    outs, douts = _split(out, ring), _split(dout, ring)
    lses = {s: part.to(ring.devices[s]) for s, part in
            zip(ring.owned, torch.chunk(lse, len(ring.owned), dim=-1))}
    t_q, t_k = q.shape[_SEQ] // len(ring.owned), k.shape[_SEQ] // len(ring.owned)
    local = {}
    for i in ring.owned:
        do_f = douts[i].float()
        # D = rowsum(dO * O), the softmax jacobian's correction, [..., H, Tq]
        d_corr = torch.einsum("...qhd,...qhd->...hq", do_f, outs[i].float())
        local[i] = dict(q_c=_round(qs[i], compute_dtype), do_c=_round(douts[i], compute_dtype),
                        d_corr=d_corr, lse=lses[i], dq=torch.zeros_like(qs[i], dtype=torch.float32))

    def tile_grads(i, j, k_blk, v_blk, dk_blk, dv_blk):
        st = local[i]
        s = _tile_scores(st["q_c"], k_blk, scale, compute_dtype, causal, striped, i, j)
        # exact probabilities; masked entries underflow to exactly 0, so
        # the backward needs no mask of its own
        p = torch.exp(s - st["lse"][..., None])
        dv_blk = dv_blk + torch.einsum("...hqk,...qhd->...khd", _round(p, compute_dtype),
                                       st["do_c"])
        dp = torch.einsum("...qhd,...khd->...hqk", st["do_c"], _round(v_blk, compute_dtype))
        ds = _round(p * (dp - st["d_corr"][..., None]), compute_dtype)
        st["dq"] = st["dq"] + scale * torch.einsum(
            "...hqk,...khd->...qhd", ds, _round(k_blk, compute_dtype))
        dk_blk = dk_blk + scale * torch.einsum("...hqk,...qhd->...khd", ds, st["q_c"])
        return dk_blk, dv_blk

    held = {}
    for i in ring.owned:
        zero = torch.zeros_like(ks[i], dtype=torch.float32)
        held[i] = [ks[i], vs[i], *tile_grads(i, i, ks[i], vs[i], zero, zero.clone())]
    for t in range(1, ring.size):
        held = ring.rotate(held)
        for i in ring.owned:
            j = (i - t) % ring.size
            k_blk, v_blk, dk_blk, dv_blk = held[i]
            if not _dead(causal, striped, i, j, t_q, t_k):
                held[i][2:] = tile_grads(i, j, k_blk, v_blk, dk_blk, dv_blk)
    # after P-1 hops the accumulators hold block (i+1)'s gradients; one
    # more hop returns every block home (identity on a one-shard ring)
    home = ring.rotate({s: held[s][2:] for s in ring.owned})
    dq = _join({i: local[i]["dq"] for i in ring.owned}, ring, q.device).to(q.dtype)
    dk = _join({s: home[s][0] for s in ring.owned}, ring, k.device).to(k.dtype)
    dv = _join({s: home[s][1] for s in ring.owned}, ring, v.device).to(v.dtype)
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """The ring with its own backward: autograd saves this process's own
    blocks, the output and the logsumexp, never a rotated block."""

    @staticmethod
    def forward(ctx, ring, causal, striped, scale, compute_dtype, q, k, v):
        out, lse = _forward(ring, causal, striped, scale, compute_dtype, q, k, v)
        ctx.ring, ctx.args = ring, (causal, striped, scale, compute_dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(ctx.ring, *ctx.args, q, k, v, out, lse, dout)
        return None, None, None, None, None, dq, dk, dv


def ring_attention_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                         axis: str = "seq", *, causal: bool = True,
                         scale: Optional[float] = None,
                         compute_dtype=torch.bfloat16, striped: bool = False) -> torch.Tensor:
    """Exact attention for this process's query blocks over ``mesh[axis]``.

    ``q``/``k``/``v`` are ``[..., T_local, H, dh]``: the concatenation, in
    shard order, of the blocks of the shards this process owns (in one
    process every shard, so the whole sequence in the layout's order; on a
    mesh over a process group each rank passes its own blocks, as each
    device's function sees its block inside the reference's
    ``shard_map``). With ``striped=False`` the global sequence is the
    shards' blocks in axis order; with ``striped=True`` the caller has laid
    the positions out in stripes (:func:`stripe_indices`). The mask uses
    global positions either way, so the result equals dense attention over
    the whole sequence, and so do its gradients. The output is
    ``[..., T_local, H, dh]`` on ``q``'s device."""
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    return _RingAttention.apply(_Ring(mesh, axis), bool(causal), bool(striped), scale,
                                compute_dtype, q, k, v)


def shard_positions(mesh, t_local: int, axis: str = "seq", device=None) -> torch.Tensor:
    """The global positions (contiguous layout) of this process's
    ``t_local`` positions: shard ``i``'s block of ``T_blk`` holds
    ``i * T_blk + arange(T_blk)``, for the shards this process owns."""
    ring = _Ring(mesh, axis)
    n = len(ring.owned)
    if t_local % n:
        raise ValueError(f"{t_local} positions do not split over the {n} shards this "
                         "process owns")
    t_blk = t_local // n
    return torch.cat([s * t_blk + torch.arange(t_blk, device=device) for s in ring.owned])


def make_ring_attention(mesh, axis: str = "seq", *, causal: bool = True,
                        scale: Optional[float] = None, compute_dtype=torch.bfloat16,
                        striped: bool = False):
    """``fn(q, k, v)`` over global ``[..., T, H, dh]`` tensors in natural
    order, the sequence split over ``mesh[axis]``; differentiable.

    ``striped=True`` relayouts the inputs to stripes and the output back
    to natural order with a reshape and a transpose (no index constants);
    q and k/v may differ in length, each using its own block size.
    Non-causal calls drop the stripes (nothing to balance; the result is
    the same). ``T`` must divide by the axis size. On a mesh over a process
    group each rank holds only its blocks: call
    :func:`ring_attention_block` there."""
    if mesh.process_group is not None:
        raise ValueError("make_ring_attention takes global tensors in one process; on a "
                         "mesh over a process group call ring_attention_block with each "
                         "rank's blocks")
    p_size = int(mesh.shape[axis])
    striped = bool(striped) and bool(causal)

    def to_stripes(x):
        # natural -> striped is a (b, P) -> (P, b) transpose of the
        # sequence axis: new index i*b + s holds position s*P + i
        t = x.shape[_SEQ]
        if t % p_size:
            raise ValueError(f"T={t} must divide by the ring size {p_size}")
        lead, rest = x.shape[:_SEQ], x.shape[_SEQ + 1:]
        return x.reshape(*lead, t // p_size, p_size, *rest).transpose(-4, -3).reshape(x.shape)

    def to_natural(x):
        t = x.shape[_SEQ]
        lead, rest = x.shape[:_SEQ], x.shape[_SEQ + 1:]
        return x.reshape(*lead, p_size, t // p_size, *rest).transpose(-4, -3).reshape(x.shape)

    def fn(q, k, v):
        if striped:
            q, k, v = to_stripes(q), to_stripes(k), to_stripes(v)
        out = ring_attention_block(q, k, v, mesh, axis, causal=causal, scale=scale,
                                   compute_dtype=compute_dtype, striped=striped)
        return to_natural(out) if striped else out

    return fn


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    scale: Optional[float] = None,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """Plain dense attention over ``[..., T, H, dh]`` tensors: the scores,
    the -1e30 causal mask, softmax in float32, the mixing product, with
    the ring's rounding of operands to ``compute_dtype``. The version the
    ring is held against; it holds a ``[..., H, Tq, Tk]`` buffer."""
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    s = torch.einsum("...qhd,...khd->...hqk", _round(q, compute_dtype),
                     _round(k, compute_dtype)) * scale
    if causal:
        t_q, t_k = q.shape[_SEQ], k.shape[_SEQ]
        live = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device).tril()
        s = torch.where(live, s, _MASK)
    att = torch.softmax(s, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", _round(att, compute_dtype),
                        _round(v, compute_dtype)).to(q.dtype)
