"""The KDE kernels: hand-written CUDA and their plain twins.

Ported from ``hpbandster_tpu/ops/pallas_kde.py``, built by ``ops/_build.py``:

* the acquisition scorer: the Pallas TPU kernel ``_score_kernel`` becomes
  ``csrc/kde_score.cu``; ``pallas_score_candidates_traced`` becomes
  :func:`score_candidates` and ``pallas_propose_batch`` becomes
  :func:`propose_batch`;
* the bandwidth fit's masked moments: ``_moments_kernel`` becomes
  ``csrc/kde_moments.cu``; ``_masked_moments_padded`` becomes
  :func:`masked_moments` and ``pallas_normal_reference_bandwidths`` becomes
  :func:`moment_bandwidths`.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version (``*_reference``, the reference's math written as tensor ops) for
CPU tensors. Nothing swaps one for the other on failure: a CUDA tensor
either reaches the kernel or raises. ``LAUNCHES[name]`` counts kernel
launches, so a run can show that it went through the kernels; setting
``RECORD`` to a list keeps every launch's ``(name, inputs)``, so a run can
hold each kernel against its plain twin at the shapes it really gave it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from hpbandster_tpu_torch.ops._build import load_library
from hpbandster_tpu_torch.ops.kde import (
    KDE,
    LOG_PDF_FLOOR,
    _discrete_bw_cap,
    generate_candidates,
)

__all__ = [
    "LAUNCHES",
    "RECORD",
    "score_candidates",
    "score_candidates_reference",
    "propose_from_candidates",
    "propose_batch",
    "masked_moments",
    "masked_moments_reference",
    "moment_bandwidths",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

#: kernel launches per kernel name, counted where the kernel is launched
LAUNCHES = {"kde_score": 0, "kde_moments": 0}

#: when a list, each kernel launch appends ``(name, inputs)``: for
#: ``kde_score`` ``(cands, good, bad, vartypes, cards)``, for
#: ``kde_moments`` ``(data, masks)``
RECORD: Optional[list] = None

_LIB = None
_MOMENTS_LIB = None


def _kde_score_lib() -> ctypes.CDLL:
    """The built scorer library with its C signatures declared (first call
    builds it)."""
    global _LIB
    if _LIB is None:
        lib = load_library("kde_score")
        lib.kde_score_launch.argtypes = (
            [ctypes.c_void_p] * 10  # nine inputs and the output, device pointers
            + [ctypes.c_int] * 5    # S, d, n_good, n_bad, tile rows
            + [ctypes.c_float, ctypes.c_void_p]  # floor, stream
        )
        lib.kde_score_launch.restype = ctypes.c_int
        lib.kde_score_error_string.argtypes = [ctypes.c_int]
        lib.kde_score_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _tile_rows(d: int) -> int:
    """Observation rows per shared-memory tile: 128 for the usual HPO
    widths, fewer for very wide spaces so a block stays well inside the
    SM's shared memory."""
    return 128 if d <= 32 else max(16, 4096 // d)


def _side_logpdf_reference(
    cands: torch.Tensor, kde: KDE, vt: torch.Tensor, cards: torch.Tensor
) -> torch.Tensor:
    """Masked mixture log-density of every candidate, ``f32[S]``, summing
    the per-dim log kernels in dim order like the reference kernel."""
    s, d = cands.shape
    acc = torch.zeros((s, kde.data.shape[0]), dtype=torch.float32, device=cands.device)
    for j in range(d):
        diff = cands[:, j:j + 1] - kde.data[None, :, j]
        bw = torch.clamp(kde.bw[j], min=1e-10)
        km1 = torch.clamp(cards[j] - 1.0, min=1.0)
        log_c = -0.5 * torch.square(diff / bw) - torch.log(bw) - _LOG_SQRT_2PI
        same = torch.square(diff) < 0.25
        lam = torch.clamp(bw, 1e-10, 1.0 - 1e-7)
        l1m = torch.log1p(-lam)
        log_u = torch.where(same, l1m, torch.log(lam) - torch.log(km1))
        log_o = torch.where(
            same, l1m, math.log(0.5) + l1m + torch.abs(diff) * torch.log(lam)
        )
        code = vt[j]
        term = torch.where(
            code == 0.0, log_c,
            torch.where(code == 1.0, log_u,
                        torch.where(code == 2.0, log_o, torch.zeros_like(log_c))),
        )
        acc = acc + term
    log_w = torch.where(kde.mask > 0.0, 0.0, -math.inf)
    ll = acc + log_w[None, :]
    m = ll.max(dim=1, keepdim=True).values
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ssum = torch.exp(ll - m_safe).sum(dim=1, keepdim=True)
    n_eff = torch.clamp(kde.mask.sum(), min=1.0)
    out = m_safe + torch.log(torch.clamp(ssum, min=1e-38)) - torch.log(n_eff)
    return out[:, 0]


def _prep(good: KDE, bad: KDE, vartypes, cards, device):
    f32 = torch.float32

    def side(kde: KDE):
        return KDE(
            kde.data.to(device, f32).contiguous(),
            kde.mask.to(device, f32).contiguous(),
            kde.bw.to(device, f32).contiguous(),
        )

    vt = torch.as_tensor(vartypes).to(device, f32).contiguous()
    cd = torch.as_tensor(cards).to(device, f32).contiguous()
    return side(good), side(bad), vt, cd


def score_candidates_reference(
    cands: torch.Tensor, good: KDE, bad: KDE, vartypes, cards
) -> torch.Tensor:
    """Plain PyTorch scorer: ``max(log l, F) - max(log g, F)``, ``f32[S]``.

    Vartype codes: 0 Gaussian, 1 Aitchison–Aitken, 2 Wang–van Ryzin (any
    other code contributes 0, the reference's inert pad). The discrete
    match test is ``diff**2 < 0.25``, as in the Pallas kernel.
    """
    cands = cands.to(torch.float32)
    good, bad, vt, cd = _prep(good, bad, vartypes, cards, cands.device)
    lg = _side_logpdf_reference(cands, good, vt, cd)
    lb = _side_logpdf_reference(cands, bad, vt, cd)
    return torch.clamp(lg, min=LOG_PDF_FLOOR) - torch.clamp(lb, min=LOG_PDF_FLOOR)


def score_candidates(
    cands: torch.Tensor, good: KDE, bad: KDE, vartypes, cards
) -> torch.Tensor:
    """Acquisition scores of ``f32[S, d]`` candidates, ``f32[S]``.

    CUDA tensors launch ``csrc/kde_score.cu``; CPU tensors take
    :func:`score_candidates_reference`. Any other device raises.
    """
    dev = cands.device
    if dev.type == "cpu":
        return score_candidates_reference(cands, good, bad, vartypes, cards)
    if dev.type != "cuda":
        raise ValueError(f"score_candidates runs on cuda or cpu, not {dev}")
    if cands.dim() != 2:
        raise ValueError(f"cands must be [S, d], got shape {tuple(cands.shape)}")
    cands = cands.to(torch.float32).contiguous()
    good, bad, vt, cd = _prep(good, bad, vartypes, cards, dev)
    s, d = cands.shape
    for name, kde in (("good", good), ("bad", bad)):
        n = kde.data.shape[0]
        if kde.data.dim() != 2 or kde.data.shape[1] != d:
            raise ValueError(f"{name}.data must be [N, {d}], got {tuple(kde.data.shape)}")
        if kde.mask.shape != (n,) or kde.bw.shape != (d,):
            raise ValueError(
                f"{name}: mask must be [{n}] and bw [{d}], got "
                f"{tuple(kde.mask.shape)} and {tuple(kde.bw.shape)}"
            )
    if vt.shape != (d,) or cd.shape != (d,):
        raise ValueError(f"vartypes and cards must be [{d}]")
    out = torch.empty(s, dtype=torch.float32, device=dev)
    if s == 0:
        return out
    lib = _kde_score_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kde_score_launch(
            cands.data_ptr(), good.data.data_ptr(), good.mask.data_ptr(),
            good.bw.data_ptr(), bad.data.data_ptr(), bad.mask.data_ptr(),
            bad.bw.data_ptr(), vt.data_ptr(), cd.data_ptr(), out.data_ptr(),
            s, d, good.data.shape[0], bad.data.shape[0], _tile_rows(d),
            LOG_PDF_FLOOR, stream,
        )
    if rc != 0:
        msg = lib.kde_score_error_string(rc).decode()
        raise RuntimeError(f"kde_score launch failed: CUDA error {rc} ({msg})")
    LAUNCHES["kde_score"] += 1
    if RECORD is not None:
        RECORD.append(("kde_score", (cands, good, bad, vt, cd)))
    return out


def propose_from_candidates(
    cands: torch.Tensor, good: KDE, bad: KDE, vartypes, cards, n: int
) -> torch.Tensor:
    """The best of each proposal's ``S/n`` candidates by acquisition score,
    ``f32[n, d]``. ``torch.argmax`` keeps the first maximum, like
    ``jnp.argmax``."""
    scores = score_candidates(cands, good, bad, vartypes, cards).reshape(n, -1)
    best = torch.argmax(scores, dim=1)
    return cands.reshape(n, scores.shape[1], -1)[
        torch.arange(n, device=cands.device), best
    ]


def propose_batch(
    generator: torch.Generator,
    good: KDE,
    bad: KDE,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    n: int,
    num_samples: int = 64,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
) -> torch.Tensor:
    """A whole stage of BOHB proposals: one flat draw of ``n * num_samples``
    candidates around the good points, the scorer, then the per-proposal
    argmax. Returns ``f32[n, d]``."""
    cands = generate_candidates(
        generator, good, vartypes, cards, n * num_samples,
        bandwidth_factor, min_bandwidth,
    )
    return propose_from_candidates(cands, good, bad, vartypes, cards, n)


# ------------------------------------------------------------ bandwidth fit
def _kde_moments_lib() -> ctypes.CDLL:
    """The built masked-moments library with its C signatures declared
    (first call builds it)."""
    global _MOMENTS_LIB
    if _MOMENTS_LIB is None:
        lib = load_library("kde_moments")
        lib.kde_moments_row_blocks.argtypes = [ctypes.c_int]
        lib.kde_moments_row_blocks.restype = ctypes.c_int
        lib.kde_moments_launch.argtypes = (
            [ctypes.c_void_p] * 4   # data, masks, partial scratch, output
            + [ctypes.c_int] * 3    # C, d, sides
            + [ctypes.c_void_p]     # stream
        )
        lib.kde_moments_launch.restype = ctypes.c_int
        lib.kde_moments_error_string.argtypes = [ctypes.c_int]
        lib.kde_moments_error_string.restype = ctypes.c_char_p
        _MOMENTS_LIB = lib
    return _MOMENTS_LIB


#: rows of one reference grid step, and of one sequential block inside it
_MOMENT_TILE_ROWS = 512
_MOMENT_BLOCK_ROWS = 32


def _ordered_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x [S, C_pad, d]`` over rows in the reference's order:
    512-row tiles accumulated in turn (the Pallas grid), each tile summed
    in sequential 32-row blocks, the blocks then summed in turn (the order
    XLA's CPU backend gives ``jnp.sum`` over a tile's rows). Float32 all
    the way, so on the CPU the sums equal the reference's bit for bit; the
    one-pass variance downstream turns a last-bit difference in a sum into
    a visible difference in a bandwidth."""
    s, c_pad, d = x.shape
    blocks = x.reshape(s, c_pad // _MOMENT_BLOCK_ROWS, _MOMENT_BLOCK_ROWS, d)
    acc = blocks[:, :, 0]
    for r in range(1, _MOMENT_BLOCK_ROWS):
        acc = acc + blocks[:, :, r]
    per_tile = _MOMENT_TILE_ROWS // _MOMENT_BLOCK_ROWS
    acc = acc.reshape(s, c_pad // _MOMENT_TILE_ROWS, per_tile, d)
    tiles = acc[:, :, 0]
    for k in range(1, per_tile):
        tiles = tiles + acc[:, :, k]
    total = tiles[:, 0]
    for t in range(1, tiles.shape[1]):
        total = total + tiles[:, t]
    return total


def masked_moments_reference(data: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch masked moments: for ``data f32[C, d]`` and ``masks
    f32[S, C]``, ``f32[S, 3, d]`` holding per side the masked sum, the
    masked sum of squares (``(x * m) * x``, as the reference forms it) and
    the mask's sum (repeated over the dims, as the reference's lanes hold
    it), summed in the reference's order (:func:`_ordered_row_sum`)."""
    data = data.to(torch.float32)
    masks = masks.to(torch.float32)
    c, d = data.shape
    pad = -c % _MOMENT_TILE_ROWS
    data = torch.nn.functional.pad(data, (0, 0, 0, pad))
    masks = torch.nn.functional.pad(masks, (0, pad))
    dm = masks[:, :, None] * data[None]
    return torch.stack([
        _ordered_row_sum(dm),
        _ordered_row_sum(dm * data[None]),
        _ordered_row_sum(masks[:, :, None].expand_as(dm)),
    ], dim=1)


def masked_moments(data: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Masked moments ``f32[S, 3, d]`` of ``data f32[C, d]`` under ``masks
    f32[S, C]`` (S = 1 or 2 sides), as :func:`masked_moments_reference`.

    CUDA tensors launch ``csrc/kde_moments.cu`` (two passes, no atomics:
    the same inputs give the same bits on every run); CPU tensors take the
    plain version. Any other device raises.
    """
    dev = data.device
    if dev.type == "cpu":
        return masked_moments_reference(data, masks)
    if dev.type != "cuda":
        raise ValueError(f"masked_moments runs on cuda or cpu, not {dev}")
    if data.dim() != 2 or masks.dim() != 2 or masks.shape[1] != data.shape[0]:
        raise ValueError(
            f"data must be [C, d] and masks [S, C], got {tuple(data.shape)} "
            f"and {tuple(masks.shape)}"
        )
    c, d = data.shape
    sides = masks.shape[0]
    if sides not in (1, 2):
        raise ValueError(f"masked_moments takes 1 or 2 masks, got {sides}")
    if masks.device != dev:
        raise ValueError(f"masks on {masks.device}, data on {dev}")
    data = data.to(torch.float32).contiguous()
    masks = masks.to(torch.float32).contiguous()
    if c == 0 or d == 0:
        return torch.zeros((sides, 3, d), dtype=torch.float32, device=dev)
    lib = _kde_moments_lib()
    partial = torch.empty(
        (lib.kde_moments_row_blocks(c), sides, 3, d), dtype=torch.float32,
        device=dev,
    )
    out = torch.empty((sides, 3, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kde_moments_launch(
            data.data_ptr(), masks.data_ptr(), partial.data_ptr(),
            out.data_ptr(), c, d, sides, stream,
        )
    if rc != 0:
        msg = lib.kde_moments_error_string(rc).decode()
        raise RuntimeError(f"kde_moments launch failed: CUDA error {rc} ({msg})")
    LAUNCHES["kde_moments"] += 1
    if RECORD is not None:
        RECORD.append(("kde_moments", (data, masks)))
    return out


def moment_bandwidths(
    data: torch.Tensor,
    masks: torch.Tensor,
    cards: torch.Tensor,
    min_bandwidth: float = 1e-3,
) -> torch.Tensor:
    """Normal-reference bandwidths from one masked-moment pass: the port of
    ``pallas_normal_reference_bandwidths``. ``masks`` is ``f32[C]`` (returns
    ``f32[d]``) or ``f32[S, C]`` (returns ``f32[S, d]``, all sides from one
    launch).

    One-pass variance ``max(s2/n - mean^2, 0)`` with ``n = max(count, 1)``,
    then ``1.06 * sigma * n^(-1/(4+d))`` clipped to ``[min_bandwidth,
    (k-1)/k]``: a distinct numeric consumer from the two-pass
    ``ops.kde.normal_reference_bandwidths``, exactly as in the reference.
    """
    one_side = masks.dim() == 1
    mom = masked_moments(data, masks[None] if one_side else masks)
    s1, s2, cnt = mom[:, 0], mom[:, 1], mom[:, 2]
    d = data.shape[-1]
    n = torch.clamp(cnt, min=1.0)
    mean = s1 / n
    var = torch.clamp(s2 / n - torch.square(mean), min=0.0)
    bw = 1.06 * torch.sqrt(var) * n ** (-1.0 / (4.0 + d))
    bw = torch.minimum(
        torch.clamp(bw, min=min_bandwidth),
        _discrete_bw_cap(torch.as_tensor(cards, device=data.device)),
    )
    return bw[0] if one_side else bw
