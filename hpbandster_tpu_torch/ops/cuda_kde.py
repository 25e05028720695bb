"""The KDE kernels: hand-written CUDA and their plain twins.

Ported from ``hpbandster_tpu/ops/pallas_kde.py``, built by ``ops/_build.py``:

* the acquisition scorer: the Pallas TPU kernel ``_score_kernel`` becomes
  ``csrc/kde_score.cu``; ``pallas_score_candidates_traced`` becomes
  :func:`score_candidates`, ``pallas_propose_batch`` becomes
  :func:`propose_batch`, ``pallas_propose_batch_seeded`` becomes
  :func:`propose_batch_seeded` and ``pallas_refit_propose_batch_seeded``
  becomes :func:`refit_propose_batch_seeded` (the flat candidate layout;
  ``ops/kde.py`` has the per-proposal twins, which score here too);
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
A launch made while the current stream captures a CUDA graph only records
the kernel into the graph: it counts in ``CAPTURED`` and in the capture's
own record (:func:`counting_capture`, per thread), and the graph runner
(``ops/graphs.py``) adds a graph's captured launches to ``LAUNCHES`` at
every replay (:func:`add_launches`). The counts take a lock, so launches
from several host threads at once are neither lost nor attributed to
another thread's capture. A recorded input of a captured launch holds the
values of the graph's latest replay.

Each kernel's launch geometry comes from shapes alone
(:func:`kde_score_geometry`, :func:`kde_moments_geometry`): the wrappers
pass it to the C entry points, the tests read it, and no mask or count ever
changes it, so the same inputs give the same bits on every run. Each
kernel's work is a shape-only formula too (:func:`kde_score_cost`,
:func:`kde_moments_cost`): the entry points count it in the open cost
windows (``obs.runtime.count_cost``) with every buffer row live, in place
of the ops their plain version dispatches, so a program counts the same on
the CPU and on the card. The
wrappers keep their host work small: inputs that are already contiguous
float32 on the launch device pass as they are, the device context is
entered only when it is not the current one, and nothing is queried from
the library per call.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from hpbandster_tpu_torch.obs.runtime import kernel_cost
from hpbandster_tpu_torch.ops._build import load_library
from hpbandster_tpu_torch.ops.kde import (
    KDE,
    LOG_PDF_FLOOR,
    SeededDraws,
    _discrete_bw_cap,
    generate_candidates,
    refit_pair,
)

__all__ = [
    "LAUNCHES",
    "CAPTURED",
    "RECORD",
    "ScoreGeometry",
    "kde_score_geometry",
    "MomentsGeometry",
    "kde_moments_geometry",
    "KernelCost",
    "kde_score_cost",
    "kde_moments_cost",
    "score_candidates",
    "score_candidates_reference",
    "propose_from_candidates",
    "propose_scored",
    "propose_batch",
    "propose_batch_seeded",
    "refit_propose_batch_seeded",
    "masked_moments",
    "masked_moments_reference",
    "moment_bandwidths",
    "bandwidths_from_moments",
    "noop_launch",
    "prepare_capture",
    "counting_capture",
    "add_launches",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

#: kernel launches per kernel name, counted where the kernel is launched
LAUNCHES = {"kde_score": 0, "kde_moments": 0}

#: launches recorded into CUDA graphs under capture, per kernel name: they
#: run when a graph replays, and the runner counts them in LAUNCHES then
CAPTURED = {"kde_score": 0, "kde_moments": 0}

#: when a list, each kernel launch appends ``(name, inputs)``: for
#: ``kde_score`` ``(cands, good, bad, vartypes, cards)``, for
#: ``kde_moments`` ``(data, masks, cards, min_bandwidth)`` (``cards`` None
#: for a plain-moments call)
RECORD: Optional[list] = None

_LIB = None
_MOMENTS_LIB = None


#: guards every count above and the RECORD list: host threads launch at once
_COUNT_LOCK = threading.Lock()
#: this thread's open capture record (:func:`counting_capture`)
_CAPTURE = threading.local()


def _count_launch(name: str, inputs) -> None:
    """Count one launch of ``name``: in ``LAUNCHES`` when it runs now; in
    ``CAPTURED`` and this thread's capture record when the current stream
    records it into a graph."""
    capturing = torch.cuda.is_current_stream_capturing()
    record = getattr(_CAPTURE, "counts", None)
    with _COUNT_LOCK:
        if capturing:
            CAPTURED[name] += 1
            if record is not None:
                record[name] += 1
        else:
            LAUNCHES[name] += 1
        if RECORD is not None:
            RECORD.append((name, inputs))


@contextlib.contextmanager
def counting_capture() -> Iterator[Dict[str, int]]:
    """A fresh per-kernel record of the launches this thread captures
    inside the ``with`` block: what one replay of that graph launches,
    whatever other threads launch or capture meanwhile."""
    counts = {name: 0 for name in CAPTURED}
    outer = getattr(_CAPTURE, "counts", None)
    _CAPTURE.counts = counts
    try:
        yield counts
    finally:
        _CAPTURE.counts = outer


def add_launches(counts: Dict[str, int]) -> None:
    """Count a replayed graph's launches (its :func:`counting_capture`
    record) in ``LAUNCHES``."""
    with _COUNT_LOCK:
        for name, n in counts.items():
            LAUNCHES[name] += n


def _kde_score_lib() -> ctypes.CDLL:
    """The built scorer library with its C signatures declared (first call
    builds it)."""
    global _LIB
    if _LIB is None:
        lib = load_library("kde_score")
        lib.kde_score_launch.argtypes = (
            [ctypes.c_void_p] * 10  # nine inputs and the output, device pointers
            + [ctypes.c_int] * 10   # S, d, n_good, n_bad, log2 lanes, blocks,
                                    # list rows, rows per thread, dmax, smem
            + [ctypes.c_float, ctypes.c_void_p]  # floor, stream
        )
        lib.kde_score_launch.restype = ctypes.c_int
        lib.kde_score_noop_launch.argtypes = [ctypes.c_void_p]
        lib.kde_score_noop_launch.restype = ctypes.c_int
        lib.kde_score_error_string.argtypes = [ctypes.c_int]
        lib.kde_score_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


#: the scorer's block (``kThreads`` in ``csrc/kde_score.cu``)
_SCORE_THREADS = 128
#: blocks the lane count aims for: two per SM of an H100 (132 SMs)
_SCORE_TARGET_BLOCKS = 2 * 132
#: live-list rows a lane should walk at most, where the lanes allow it
_SCORE_ROWS_PER_LANE = 32
#: rows of a side one thread loads per compaction pass (``kMaxRowsPerThread``)
_SCORE_MAX_ROWS_PER_THREAD = 2
#: shared memory the compacted rows of one side may take
_SCORE_ROW_BYTES = 20 * 1024
#: register widths of the kernel's instances; wider spaces use 0 (shared)
_REGISTER_DIMS = (8, 16, 32)


class ScoreGeometry(NamedTuple):
    """Launch geometry of ``csrc/kde_score.cu``."""

    #: threads per candidate (K), a power of two <= 32
    lanes: int
    blocks: int
    threads: int
    #: dynamic shared memory of a block, bytes
    smem_bytes: int
    #: rows the compacted list holds before the block scores them
    row_chunk: int
    #: mask rows a thread loads per compaction pass
    rows_per_thread: int
    #: register width of the kernel instance (0: coordinates in shared memory)
    dmax: int


@functools.lru_cache(maxsize=256)
def kde_score_geometry(s: int, d: int, n_good: int, n_bad: int) -> ScoreGeometry:
    """The scorer's launch geometry for ``s`` candidates of ``d`` dims
    against ``n_good`` and ``n_bad`` buffer rows: shapes only, never a mask.

    Lanes per candidate: enough that ``s`` candidates fill
    ``_SCORE_TARGET_BLOCKS`` blocks, and that a lane walks at most
    ``_SCORE_ROWS_PER_LANE`` rows of a full buffer (at least 4 where the
    coordinates sit in shared memory, to keep them small). Each side's
    compacted list holds up to that side's rows, within
    ``_SCORE_ROW_BYTES``, and at least one compaction pass."""
    n_max = max(n_good, n_bad, 1)
    want = max(
        -(-_SCORE_TARGET_BLOCKS * _SCORE_THREADS // max(s, 1)),
        -(-n_max // _SCORE_ROWS_PER_LANE),
    )
    dmax = next((w for w in _REGISTER_DIMS if d <= w), 0)
    lanes = min(32, 1 << max(want - 1, 0).bit_length())
    if dmax == 0:
        lanes = max(lanes, 4)
    per_block = _SCORE_THREADS // lanes
    stride = d | 1
    slices = -(-n_max // _SCORE_THREADS)  # 128-row slices of the larger side
    budget = max(1, _SCORE_ROW_BYTES // (4 * stride) // _SCORE_THREADS)
    rpt = min(_SCORE_MAX_ROWS_PER_THREAD, slices, budget)
    cap = _SCORE_THREADS * max(rpt, min(slices, budget))
    # code [d], two sides of [6d + 1] constants, a flag, 2 x 2 x 8 pass
    # counters, the block's candidates (shared-memory instance only), the
    # two lists
    floats = 13 * d + 35 + (per_block * d if dmax == 0 else 0) + 2 * cap * stride
    return ScoreGeometry(
        lanes=lanes, blocks=-(-s // per_block), threads=_SCORE_THREADS,
        smem_bytes=4 * floats, row_chunk=cap, rows_per_thread=rpt, dmax=dmax,
    )


class KernelCost(NamedTuple):
    """What one launch's function needs: float32 operations, bytes moved
    (each input read once, each output written once) and exponentials."""

    flops: int
    bytes_accessed: int
    transcendentals: int


def kde_score_cost(s: int, d: int, n_good: int, n_bad: int,
                   live_good: Optional[int] = None,
                   live_bad: Optional[int] = None) -> KernelCost:
    """The scorer's work for ``s`` candidates of ``d`` dims against
    ``n_good`` and ``n_bad`` buffer rows, of which ``live_*`` are masked in
    (default: all). Bytes: the candidates, both sides' rows, masks and
    bandwidths, the vartypes and cards, the scores. Per live (candidate,
    row) pair: 4 float32 operations a dim (continuous: difference, scale,
    square, accumulate; discrete: difference, square, compare,
    accumulate), 3 for the logsumexp update (max, subtract, add) and one
    exponential. The per-side constants (``log bw``, ``log sqrt(2 pi)``,
    ``log n_eff``) factor out of the logsumexp and are not counted."""
    n = n_good + n_bad
    pairs = s * ((n_good if live_good is None else live_good)
                 + (n_bad if live_bad is None else live_bad))
    return KernelCost(pairs * (4 * d + 3), 4 * (s * d + n * d + n + 4 * d + s), pairs)


def kde_moments_cost(c: int, d: int, sides: int) -> KernelCost:
    """The moments kernel's work for ``c`` rows of ``d`` dims under
    ``sides`` masks: bytes for the data, the masks and the cards read once,
    the ``[sides, 3, d]`` moments and ``[sides, d]`` bandwidths written
    once; per side, row and dim the masked value, its square and two
    additions, per side and row the count's addition (the bandwidths' few
    per (side, dim) are not counted). No exponentials."""
    return KernelCost(sides * c * (4 * d + 1),
                      4 * (c * d + sides * c + d + sides * 3 * d + sides * d), 0)


def _f32_on(t, device: torch.device) -> torch.Tensor:
    """``t`` as a contiguous float32 tensor on ``device``; a tensor that
    already is one passes as it is (no copy, no launch)."""
    if (
        isinstance(t, torch.Tensor) and t.dtype == torch.float32
        and t.device == device and t.is_contiguous()
    ):
        return t
    return torch.as_tensor(t).to(device, torch.float32).contiguous()


def _on_device(dev: torch.device):
    """The device context a launch needs: none when ``dev`` is current."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


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
    def side(kde: KDE):
        return KDE(_f32_on(kde.data, device), _f32_on(kde.mask, device),
                   _f32_on(kde.bw, device))

    return side(good), side(bad), _f32_on(vartypes, device), _f32_on(cards, device)


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
    if cands.dim() != 2:
        raise ValueError(f"cands must be [S, d], got shape {tuple(cands.shape)}")
    with kernel_cost("kde_score", kde_score_cost, cands.shape[0], cands.shape[1],
                     good.data.shape[0], bad.data.shape[0]):
        return _score_candidates(cands, good, bad, vartypes, cards)


def _score_candidates(cands, good, bad, vartypes, cards):
    dev = cands.device
    if dev.type == "cpu":
        return score_candidates_reference(cands, good, bad, vartypes, cards)
    if dev.type != "cuda":
        raise ValueError(f"score_candidates runs on cuda or cpu, not {dev}")
    cands = _f32_on(cands, dev)
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
    ng, nb = good.data.shape[0], bad.data.shape[0]
    geo = kde_score_geometry(s, d, ng, nb)
    with _on_device(dev):
        rc = lib.kde_score_launch(
            cands.data_ptr(), good.data.data_ptr(), good.mask.data_ptr(),
            good.bw.data_ptr(), bad.data.data_ptr(), bad.mask.data_ptr(),
            bad.bw.data_ptr(), vt.data_ptr(), cd.data_ptr(), out.data_ptr(),
            s, d, ng, nb, geo.lanes.bit_length() - 1, geo.blocks,
            geo.row_chunk, geo.rows_per_thread, geo.dmax, geo.smem_bytes,
            LOG_PDF_FLOOR, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.kde_score_error_string(rc).decode()
        raise RuntimeError(f"kde_score launch failed: CUDA error {rc} ({msg})")
    _count_launch("kde_score", (cands, good, bad, vt, cd))
    return out


def noop_launch(device) -> None:
    """Launch the scorer library's empty kernel on ``device``'s current
    stream, through the same ctypes route as the scorer: what any launch
    costs at least. Not counted in ``LAUNCHES``."""
    dev = torch.device(device)
    lib = _kde_score_lib()
    with _on_device(dev):
        rc = lib.kde_score_noop_launch(torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.kde_score_error_string(rc).decode()
        raise RuntimeError(f"kde_score_noop launch failed: CUDA error {rc} ({msg})")


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


def propose_scored(
    cands: torch.Tensor, good: KDE, bad: KDE, vartypes, cards, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`propose_from_candidates` with each proposal's winning score:
    ``(f32[n, d], f32[n])``, one scorer launch."""
    scores = score_candidates(cands, good, bad, vartypes, cards).reshape(n, -1)
    best = torch.argmax(scores, dim=1, keepdim=True)
    vecs = torch.take_along_dim(
        cands.reshape(n, scores.shape[1], -1), best[:, :, None], dim=1)[:, 0]
    return vecs, torch.take_along_dim(scores, best, dim=1)[:, 0]


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


def propose_batch_seeded(
    seed: int,
    good: KDE,
    bad: KDE,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    n: int,
    num_samples: int = 64,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
    draws: Optional[SeededDraws] = None,
) -> torch.Tensor:
    """:func:`propose_batch` keyed from one host seed through a draw source
    (``ops.kde.SeededDraws`` by default): ``f32[n, d]``."""
    draws = draws or SeededDraws(good.data.device)
    cands = draws.candidates(seed, good, vartypes, cards, n, num_samples,
                             bandwidth_factor, min_bandwidth, flat=True)
    return propose_from_candidates(cands, good, bad, vartypes, cards, n)


def refit_propose_batch_seeded(
    seed: int,
    obs_v: torch.Tensor,
    obs_l: torch.Tensor,
    count: int,
    n_good: int,
    n_bad: int,
    vartypes: torch.Tensor,
    cards: torch.Tensor,
    n: int,
    num_samples: int = 64,
    bandwidth_factor: float = 3.0,
    min_bandwidth: float = 1e-3,
    min_bandwidth_fit: float = 1e-3,
    impute_seed: Optional[int] = None,
    draws: Optional[SeededDraws] = None,
) -> torch.Tensor:
    """The KDE refit over raw observation buffers (``ops.kde.refit_pair``,
    floored at ``min_bandwidth_fit``) and :func:`propose_batch_seeded` with
    no host step between them: ``f32[n, d]`` proposals, no scores."""
    draws = draws or SeededDraws(obs_v.device)
    good, bad = refit_pair(obs_v, obs_l, count, n_good, n_bad, cards,
                           min_bandwidth_fit, impute_seed, draws)
    return propose_batch_seeded(seed, good, bad, vartypes, cards, n, num_samples,
                                bandwidth_factor, min_bandwidth, draws)


# ------------------------------------------------------------ bandwidth fit
def _kde_moments_lib() -> ctypes.CDLL:
    """The built masked-moments library with its C signatures declared
    (first call builds it)."""
    global _MOMENTS_LIB
    if _MOMENTS_LIB is None:
        lib = load_library("kde_moments")
        lib.kde_moments_launch.argtypes = (
            [ctypes.c_void_p] * 7   # data, masks, partial, counter,
                                    # moments, cards, bandwidths
            + [ctypes.c_int] * 7    # C, d, sides, dmax, row blocks, dim
                                    # chunks, 16-byte loads
            + [ctypes.c_float] * 2  # min bandwidth, bandwidth exponent
            + [ctypes.c_void_p]     # stream
        )
        lib.kde_moments_launch.restype = ctypes.c_int
        lib.kde_moments_error_string.argtypes = [ctypes.c_int]
        lib.kde_moments_error_string.restype = ctypes.c_char_p
        _MOMENTS_LIB = lib
    return _MOMENTS_LIB


#: the moments kernel's block (``kThreads`` in ``csrc/kde_moments.cu``)
_MOMENTS_THREADS = 256
#: row blocks at most: one wave on an H100's 132 SMs, two blocks per SM
#: for the 8-dim instance and one for the wider ones
_MOMENTS_MAX_ROW_BLOCKS = {8: 2 * 132, 16: 132, 32: 132}


class MomentsGeometry(NamedTuple):
    """Launch geometry of ``csrc/kde_moments.cu``."""

    #: dims a thread holds in registers (the kernel instance: 8, 16, 32)
    dmax: int
    row_blocks: int
    #: second grid axis: dim chunks of ``dmax`` (1 for d <= 32)
    dim_chunks: int
    threads: int
    #: rows a thread has in flight before it adds them (``kUnroll``)
    unroll: int
    #: floats of the partial buffer (0: a single block needs none)
    partial_floats: int


@functools.lru_cache(maxsize=256)
def kde_moments_geometry(c: int, d: int, sides: int) -> MomentsGeometry:
    """The masked moments' launch geometry for ``c`` rows of ``d`` dims and
    ``sides`` masks: from shapes only. Enough row blocks that each thread
    has at least ``unroll`` rows, up to one wave of the card."""
    dmax = next((w for w in _REGISTER_DIMS if d <= w), 8)
    unroll = 2 if dmax == 32 else 4
    dim_chunks = -(-d // dmax)
    row_blocks = max(1, min(_MOMENTS_MAX_ROW_BLOCKS[dmax],
                            -(-c // (_MOMENTS_THREADS * unroll))))
    multi = row_blocks * dim_chunks > 1
    return MomentsGeometry(
        dmax=dmax, row_blocks=row_blocks, dim_chunks=dim_chunks,
        threads=_MOMENTS_THREADS, unroll=unroll,
        partial_floats=row_blocks * sides * 3 * d if multi else 0,
    )


#: per (device index, stream): the ticket counter, int32, zero between
#: launches (the last block resets it)
_MOMENTS_COUNTERS: dict = {}


def _moments_counter(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    if key not in _MOMENTS_COUNTERS:
        _MOMENTS_COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _MOMENTS_COUNTERS[key]


def prepare_capture(device, stream: "torch.cuda.Stream") -> None:
    """Make the kernels capturable on ``stream``: build and load both
    libraries (neither a build nor a library load may happen inside a
    capture), and make the moments kernel's ticket counter for that stream
    now, outside the graph's memory pool. The kernel's last block resets
    the counter, so every replay finds it at zero."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    _kde_score_lib()
    _kde_moments_lib()
    _moments_counter(dev, stream.cuda_stream)


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


def _launch_moments(
    data: torch.Tensor,
    masks: torch.Tensor,
    cards: Optional[torch.Tensor] = None,
    min_bandwidth: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/kde_moments.cu`` on CUDA tensors: the moments
    ``f32[S, 3, d]`` and the bandwidths ``f32[S, d]`` (every dim continuous
    when ``cards`` is None)."""
    dev = data.device
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
    data = _f32_on(data, dev)
    masks = _f32_on(masks, dev)
    out = torch.empty((sides, 3, d), dtype=torch.float32, device=dev)
    bw = torch.empty((sides, d), dtype=torch.float32, device=dev)
    if cards is not None:
        cards = _f32_on(cards, dev)
        if cards.shape != (d,):
            raise ValueError(f"cards must be [{d}], got {tuple(cards.shape)}")
    if c == 0 or d == 0:
        out.zero_()
        bw.copy_(bandwidths_from_moments(
            out, torch.zeros(d, device=dev) if cards is None else cards, min_bandwidth))
        return out, bw
    lib = _kde_moments_lib()
    geo = kde_moments_geometry(c, d, sides)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = counter = None
    if geo.partial_floats:
        # the caching allocator orders reuse of this memory after the launch
        partial = torch.empty(geo.partial_floats, dtype=torch.float32, device=dev)
        counter = _moments_counter(dev, stream)
    with _on_device(dev):
        rc = lib.kde_moments_launch(
            data.data_ptr(), masks.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if counter is None else counter.data_ptr(),
            out.data_ptr(), None if cards is None else cards.data_ptr(),
            bw.data_ptr(), c, d, sides, geo.dmax, geo.row_blocks, geo.dim_chunks,
            int(d % 4 == 0 and data.data_ptr() % 16 == 0),
            min_bandwidth, -1.0 / (4.0 + d), stream,
        )
    if rc != 0:
        msg = lib.kde_moments_error_string(rc).decode()
        raise RuntimeError(f"kde_moments launch failed: CUDA error {rc} ({msg})")
    _count_launch("kde_moments", (data, masks, cards, min_bandwidth))
    return out, bw


def masked_moments(data: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Masked moments ``f32[S, 3, d]`` of ``data f32[C, d]`` under ``masks
    f32[S, C]`` (S = 1 or 2 sides), as :func:`masked_moments_reference`.

    CUDA tensors launch ``csrc/kde_moments.cu`` once, the same launch as
    :func:`moment_bandwidths` with its bandwidths unused (no float atomics:
    the same inputs give the same bits on every run); CPU tensors take the
    plain version. Any other device raises.
    """
    dev = data.device
    with kernel_cost("kde_moments", kde_moments_cost, *data.shape, masks.shape[0]):
        if dev.type == "cpu":
            return masked_moments_reference(data, masks)
        if dev.type != "cuda":
            raise ValueError(f"masked_moments runs on cuda or cpu, not {dev}")
        return _launch_moments(data, masks)[0]


def bandwidths_from_moments(
    mom: torch.Tensor, cards: torch.Tensor, min_bandwidth: float = 1e-3
) -> torch.Tensor:
    """Normal-reference bandwidths ``f32[S, d]`` from masked moments ``f32[S,
    3, d]``, in plain tensor ops: one-pass variance ``max(s2/n - mean^2, 0)``
    with ``n = max(count, 1)``, then ``1.06 * sigma * n^(-1/(4+d))``
    clipped to ``[min_bandwidth, (k-1)/k]``. The kernel's fused epilogue
    computes the same float32 steps."""
    s1, s2, cnt = mom[:, 0], mom[:, 1], mom[:, 2]
    d = mom.shape[-1]
    n = torch.clamp(cnt, min=1.0)
    mean = s1 / n
    var = torch.clamp(s2 / n - torch.square(mean), min=0.0)
    bw = 1.06 * torch.sqrt(var) * n ** (-1.0 / (4.0 + d))
    return torch.minimum(
        torch.clamp(bw, min=min_bandwidth),
        _discrete_bw_cap(torch.as_tensor(cards, device=mom.device)),
    )


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

    One-pass variance, a distinct numeric consumer from the two-pass
    ``ops.kde.normal_reference_bandwidths``, exactly as in the reference
    (:func:`bandwidths_from_moments`). On CUDA tensors the moments kernel
    computes the bandwidths itself and nothing else runs; on CPU
    tensors the plain moments are followed by the plain epilogue, bit for
    bit the reference's.
    """
    one_side = masks.dim() == 1
    masks2 = masks[None] if one_side else masks
    dev = data.device
    with kernel_cost("kde_moments", kde_moments_cost, *data.shape, masks2.shape[0]):
        if dev.type == "cuda":
            bw = _launch_moments(data, masks2, cards, min_bandwidth)[1]
        else:
            bw = bandwidths_from_moments(masked_moments(data, masks2), cards, min_bandwidth)
        return bw[0] if one_side else bw
