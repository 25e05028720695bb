"""On-demand profiling and the roofline over the capture ledger.

Ported from ``hpbandster_tpu/obs/profile.py``:

* :class:`ProfileSession` — a thread-safe start/stop wrapper over
  ``torch.profiler`` with a process-wide default instance. Its methods
  return JSON-serializable dicts and report errors as ``{"ok": False,
  "error": ...}``, never as exceptions: a profiling request must not take
  a serving process down.
* :func:`roofline_report` — walks the capture ledger
  (:class:`~hpbandster_tpu_torch.obs.runtime.CompileTracker`), whose rows
  carry each captured program's FLOPs and bytes as
  :func:`~hpbandster_tpu_torch.obs.runtime.count_cost` counted them at the
  capture, and attributes arithmetic intensity per program: which
  programs are compute-bound and which memory-bound on this card, the
  floor time the card's edges allow, and, given measured seconds (a
  graph's replay time), the achieved FLOP/s and utilization of the peak.
  Peak FLOP/s is the dense bf16 peak (``workloads/flops.py``), the HBM
  bandwidth from the table below. The CPU has neither, so ``bound`` and
  utilization are None there; the intensities stay exact.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from hpbandster_tpu_torch.obs.metrics import get_metrics

__all__ = [
    "ProfileSession",
    "get_profile_session",
    "device_peaks",
    "roofline_report",
    "format_roofline",
    "transfer_summary",
]

#: HBM bandwidth (bytes/s) by ``torch.cuda.get_device_name`` prefix: the
#: memory edge of the roofline. H100 SXM: 3.35 TB/s (NVIDIA's data sheet).
_PEAK_HBM_BYTES_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


class ProfileSession:
    """One process's on-demand ``torch.profiler`` capture.

    At most one trace is live at a time; a second ``start`` reports the
    active capture instead of raising. ``stop`` writes the trace into the
    session's directory as a Chrome trace JSON file."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._log_dir: Optional[str] = None
        self._t0_mono: Optional[float] = None
        self._prof = None
        self._captures = 0

    def start(self, log_dir: Optional[str] = None) -> Dict[str, Any]:
        """Begin capturing a trace into ``log_dir`` (a fresh temp dir by
        default, reported back)."""
        with self._lock:
            if self._log_dir is not None:
                return {"ok": False, "error": "profile already active",
                        "log_dir": self._log_dir}
            if log_dir is None:
                log_dir = tempfile.mkdtemp(prefix="hpb_profile_")
            try:
                import torch

                from hpbandster_tpu_torch.utils.profiling import _activities

                os.makedirs(log_dir, exist_ok=True)
                prof = torch.profiler.profile(activities=_activities())
                prof.start()
            except Exception as e:
                # the profiler failing must never look like the process
                # failing: report and keep serving
                return {"ok": False, "error": f"{type(e).__name__}: {e}"}
            self._prof = prof
            self._log_dir = log_dir
            self._t0_mono = time.monotonic()
            get_metrics().counter("profile.captures_started").inc()
            return {"ok": True, "log_dir": log_dir}

    def stop(self) -> Dict[str, Any]:
        """End the live capture; reports the trace dir and duration."""
        with self._lock:
            if self._log_dir is None:
                return {"ok": False, "error": "no profile active"}
            log_dir, t0 = self._log_dir, self._t0_mono
            try:
                self._prof.stop()
                self._prof.export_chrome_trace(os.path.join(
                    log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
            except Exception as e:
                # keep the session marked active so a later stop can retry
                return {"ok": False, "error": f"{type(e).__name__}: {e}",
                        "log_dir": log_dir}
            self._prof = None
            self._log_dir = None
            self._t0_mono = None
            self._captures += 1
            get_metrics().counter("profile.captures_completed").inc()
            return {
                "ok": True,
                "log_dir": log_dir,
                "duration_s": round(time.monotonic() - t0, 3) if t0 is not None else None,
                "files": _count_trace_files(log_dir),
            }

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active": self._log_dir is not None,
                "log_dir": self._log_dir,
                "elapsed_s": (round(time.monotonic() - self._t0_mono, 3)
                              if self._t0_mono is not None else None),
                "captures_completed": self._captures,
            }


def _count_trace_files(log_dir: str) -> int:
    return sum(len(files) for _, _, files in os.walk(log_dir))


_SESSION = ProfileSession()


def get_profile_session() -> ProfileSession:
    """The process-wide session."""
    return _SESSION


# ------------------------------------------------------------------ roofline
def device_peaks(device: Any = None) -> Dict[str, Optional[float]]:
    """``{"kind", "flops_per_s", "bytes_per_s", "ridge_flops_per_byte"}``
    for one device (default: CUDA device 0 where there is one, else the
    CPU); values are None for devices without table entries, the CPU
    among them. ``device`` is a ``torch.device`` or a device name as
    ``torch.cuda.get_device_name`` gives it."""
    import torch

    from hpbandster_tpu_torch.workloads.flops import peak_bf16_flops

    if device is None:
        device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    if isinstance(device, torch.device):
        kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    else:
        kind = str(device)
    flops = peak_bf16_flops(kind)
    bw = next((v for prefix, v in _PEAK_HBM_BYTES_S.items() if kind.startswith(prefix)), None)
    return {
        "kind": kind,
        "flops_per_s": flops,
        "bytes_per_s": bw,
        "ridge_flops_per_byte": (flops / bw) if flops and bw else None,
    }


def transfer_summary(registry: Any = None) -> Optional[Dict[str, Any]]:
    """Host-link view for the roofline report: the process-lifetime
    transfer counters (``obs.runtime.note_transfer``) and the last sweep's
    gauges (``obs.runtime.publish_sweep_transfers``), or None when the
    process never counted a transfer."""
    reg = registry if registry is not None else get_metrics()
    snap = reg.snapshot()
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    total = {
        k: int(counters.get(f"runtime.{k}", 0) or 0)
        for k in ("transfer_bytes_h2d", "transfer_bytes_d2h",
                  "transfers_h2d", "transfers_d2h")
    }
    if not any(total.values()) and "sweep.transfer_bytes.d2h" not in gauges:
        return None
    out: Dict[str, Any] = {"process_total": total}
    last_sweep = {
        "h2d_bytes": gauges.get("sweep.transfer_bytes.h2d"),
        "d2h_bytes": gauges.get("sweep.transfer_bytes.d2h"),
        "host_syncs": gauges.get("sweep.host_syncs"),
    }
    if any(v is not None for v in last_sweep.values()):
        out["last_sweep"] = last_sweep
    return out


def roofline_report(
    tracker: Any = None,
    peaks: Optional[Dict[str, Optional[float]]] = None,
    seconds_by_program: Optional[Dict[str, float]] = None,
    transfers: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Attribute FLOPs and bytes per costed program in the capture ledger.

    ``peaks`` defaults to :func:`device_peaks` of the default device (read
    only when the ledger has costed programs). ``seconds_by_program`` maps
    ``"fn"`` or ``"fn@signature"`` to measured execution seconds (a
    graph's replay time): where given, the program's achieved FLOP/s and
    utilization of the peak are estimated (the measured half of the
    roofline; without it only the counted half renders).

    A program captured uncosted (the obs layer off) has no row; a caveat
    counts them. Deterministic: rows sort by (fn, signature)."""
    from hpbandster_tpu_torch.obs.runtime import get_compile_tracker

    trk = tracker if tracker is not None else get_compile_tracker()
    costed = trk.program_costs()
    # captures taken with the obs layer off carry no count: no row, but
    # the report says how many it left out
    uncosted = len(trk.programs()) - len(costed)
    if peaks is None and costed:
        peaks = device_peaks()
    peaks = peaks or {"kind": None, "flops_per_s": None, "bytes_per_s": None,
                      "ridge_flops_per_byte": None}
    peak_f = peaks.get("flops_per_s")
    peak_b = peaks.get("bytes_per_s")
    ridge = peaks.get("ridge_flops_per_byte")
    programs: List[Dict[str, Any]] = []
    for entry in costed:
        flops = entry.get("flops")
        nbytes = entry.get("bytes_accessed")
        intensity = round(flops / nbytes, 4) if flops and nbytes else None
        bound = None
        if intensity is not None and ridge:
            bound = "compute" if intensity >= ridge else "memory"
        # the least execution time the card's edges allow: what measured
        # seconds are judged against
        floor_s = None
        if flops is not None and peak_f:
            floor_s = flops / peak_f
        if nbytes is not None and peak_b:
            mem_s = nbytes / peak_b
            floor_s = mem_s if floor_s is None else max(floor_s, mem_s)
        row = {
            "fn": entry["fn"],
            "signature": entry.get("signature"),
            "compiles": entry.get("compiles"),
            "compile_s": entry.get("compile_s"),
            "flops": flops,
            "bytes_accessed": nbytes,
            "intensity_flops_per_byte": intensity,
            "bound": bound,
            "roofline_floor_s": round(floor_s, 9) if floor_s is not None else None,
        }
        seconds = None
        if seconds_by_program:
            seconds = seconds_by_program.get(f"{entry['fn']}@{entry.get('signature')}")
            if seconds is None:
                seconds = seconds_by_program.get(entry["fn"])
        if seconds and flops:
            achieved = flops / seconds
            row["measured_s"] = round(float(seconds), 6)
            row["achieved_flops_per_s"] = round(achieved, 2)
            if peak_f:
                row["utilization_vs_peak"] = round(achieved / peak_f, 4)
        programs.append(row)
    programs.sort(key=lambda r: (r["fn"], str(r["signature"])))
    if transfers is None:
        transfers = transfer_summary()
    caveats = [] if peak_f else [
        "no peak FLOP/s table entry for this device kind "
        "(CPU backends especially): intensities are exact, but "
        "bound/utilization columns cannot be computed"
    ]
    if uncosted:
        caveats.append(f"{uncosted} program(s) in the capture ledger are uncosted "
                       "(captured with the obs layer off): no row")
    return {
        "peak": peaks,
        "programs": programs,
        "program_count": len(programs),
        # the host-link half: FLOPs and bytes above are what the card did,
        # this is what crossed the host link doing it
        "transfers": transfers,
        "caveats": caveats,
    }


def format_roofline(report: Dict[str, Any]) -> str:
    """Human rendering of :func:`roofline_report`."""
    peak = report.get("peak") or {}
    lines = [
        "roofline — device: {} (peak {} FLOP/s, {} B/s, ridge {} FLOP/B)".format(
            peak.get("kind") or "?",
            _si(peak.get("flops_per_s")), _si(peak.get("bytes_per_s")),
            _fmtnum(peak.get("ridge_flops_per_byte")),
        )
    ]
    header = (
        f"{'program':<38} {'flops':>10} {'bytes':>10} {'FLOP/B':>8} "
        f"{'bound':<8} {'floor_s':>11} {'util':>6}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for row in report.get("programs") or []:
        name = row["fn"]
        if row.get("signature"):
            name = f"{name}[{row['signature']}]"
        util = row.get("utilization_vs_peak")
        lines.append(
            f"{name[:38]:<38} {_si(row.get('flops')):>10} "
            f"{_si(row.get('bytes_accessed')):>10} "
            f"{_fmtnum(row.get('intensity_flops_per_byte')):>8} "
            f"{str(row.get('bound') or '-'):<8} "
            f"{_fmtnum(row.get('roofline_floor_s')):>11} "
            f"{(f'{100 * util:.1f}%' if util is not None else '-'):>6}"
        )
    if not report.get("programs"):
        lines.append("(no costed programs in the capture ledger — run a captured "
                     "path first, e.g. a chunked or resident sweep on a card)")
    transfers = report.get("transfers")
    if transfers:
        total = transfers.get("process_total") or {}
        lines.append(
            "host link (process): h2d {} / {} buffers, d2h {} / {} buffers".format(
                _si(total.get("transfer_bytes_h2d")), _si(total.get("transfers_h2d")),
                _si(total.get("transfer_bytes_d2h")), _si(total.get("transfers_d2h")),
            )
        )
        last = transfers.get("last_sweep")
        if last:
            lines.append(
                "host link (last sweep): h2d {}, d2h {}, {} host sync(s)".format(
                    _si(last.get("h2d_bytes")), _si(last.get("d2h_bytes")),
                    _si(last.get("host_syncs")),
                )
            )
    for c in report.get("caveats") or []:
        lines.append(f"note: {c}")
    return "\n".join(lines)


def _si(v: Any) -> str:
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return "-"
    v = float(v)
    for div, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= div:
            return f"{v / div:.2f}{suffix}"
    return f"{v:.0f}"


def _fmtnum(v: Any) -> str:
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return "-"
    return f"{float(v):.3g}"
