"""BOHB acquisition scorer: the hand-written CUDA kernel and its plain twin.

Ported from ``hpbandster_tpu/ops/pallas_kde.py``. The Pallas TPU kernel
``_score_kernel`` becomes ``csrc/kde_score.cu`` (built by ``ops/_build.py``);
``pallas_score_candidates_traced`` becomes :func:`score_candidates` and
``pallas_propose_batch`` becomes :func:`propose_batch`.

:func:`score_candidates` launches the kernel for CUDA tensors and runs
:func:`score_candidates_reference`, the reference's math written as tensor
ops, for CPU tensors. Nothing swaps one for the other on failure: a CUDA
tensor either reaches the kernel or raises. ``LAUNCHES["kde_score"]`` counts
kernel launches, so a run can show that its proposals went through the
kernel; setting ``RECORD`` to a list keeps every launch's inputs, so a run
can hold the kernel against its plain twin at the shapes it really gave it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from hpbandster_tpu_torch.ops._build import load_library
from hpbandster_tpu_torch.ops.kde import KDE, LOG_PDF_FLOOR, generate_candidates

__all__ = [
    "LAUNCHES",
    "RECORD",
    "score_candidates",
    "score_candidates_reference",
    "propose_from_candidates",
    "propose_batch",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

#: kernel launches per kernel name, counted where the kernel is launched
LAUNCHES = {"kde_score": 0}

#: when a list, each kernel launch appends its inputs
#: ``(cands, good, bad, vartypes, cards)``
RECORD: Optional[list] = None

_LIB = None


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
        RECORD.append((cands, good, bad, vt, cd))
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
