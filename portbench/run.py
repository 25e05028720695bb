"""Run one cell of ``BENCHMARK.json`` once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the card, kernels from the checkout's cache, the cell's
warm-up) runs from the process's start to the window's; the window
measures for ``--seconds``; then the outputs are held against the plain
reference. The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and a ``breakdown``. The numbers compared, each beside
its limit, close standard error and the result line (``checks``).

Exits 2 without a CUDA card (or with fewer than the cell asks for) and 3
if JAX or the JAX package was loaded; neither prints a result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "hpbandster_tpu")
#: one process with few threads: the host path is Python over small arrays,
#: and idle worker pools only add jitter to its timings
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
ROOT = Path(__file__).resolve().parents[1]


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``hpbandster_tpu_torch`` is the port, not the JAX
    package)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def pin_environment(config: Dict[str, Any]) -> None:
    """The program's switches as the configuration states them, whatever
    the caller's environment holds, and its kernel cache at a fixed
    directory inside the checkout."""
    for key, value in config.get("environment", {}).items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(value)
    os.environ.pop("HPB_XLA_CACHE", None)
    os.environ["HPB_XLA_CACHE_DIR"] = str(ROOT / "build" / "torch_kernels")


def metrics_line(spec, out, trace: bool, readers) -> Dict[str, Any]:
    metrics: Dict[str, Any] = {}
    if not trace:
        window = out["t1"] - out["t0"]
        values = {"setup_s": out["setup_s"], "evals_per_s": out["evals"] / window}
        if "latency_s" in out and out["latency_s"]:
            import numpy as np

            values["request_p95_ms"] = 1000.0 * float(np.percentile(out["latency_s"], 95))
        for m in spec["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    else:
        for m in spec["per_layer"]:
            v = readers[m["name"]](out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return metrics


def main(argv: Optional[List[str]] = None, device: Optional[str] = None) -> int:
    """One run. ``device`` (tests only) skips the look for a card and runs
    the rest on the device given."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, value in THREADS.items():
        os.environ.setdefault(key, value)

    from portbench.harness import check, manifest

    spec = manifest.resolve(args.workload)
    pin_environment(spec["config_data"])
    readers = {m["name"]: manifest.load_reader(m["reader"]) for m in spec["per_layer"]}

    import torch

    chips = int(spec["cell"]["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    driver = manifest.load_driver(spec)
    setup = {}

    def stamp():
        setup["s"] = process_age_s()

    out = driver(spec, args.seed, args.seconds, bool(args.trace), device, on_window=stamp)
    out["setup_s"] = setup["s"]
    print(f"portbench: window {out['t1'] - out['t0']:.3f}s, then the check "
          f"{time.perf_counter() - out['t1']:.3f}s", file=sys.stderr)
    limits = spec["config_data"]["limits"]
    judged = check.judge(out["numbers"], limits)
    correct = check.passed(judged) and out["failed"] == 0
    result: Dict[str, Any] = {
        "correct": bool(correct),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics_line(spec, out, bool(args.trace), readers),
        "device": {
            "platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(0) if torch.device(device).type == "cuda"
                     else "cpu"),
            "count": chips,
            "memory_peak_bytes": int(out["memory_peak_bytes"]),
        },
    }
    if args.trace:
        t = out["ctx"]["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    if out.get("window_captures"):
        print(f"portbench: {out['window_captures']} graph capture(s) inside the window",
              file=sys.stderr)
    if out.get("gc"):
        print(f"portbench: window garbage collections {out['gc']}", file=sys.stderr)
    if out.get("durations_s"):
        print("portbench: sweep seconds " + " ".join(f"{d:.4f}" for d in out["durations_s"]),
              file=sys.stderr)
    if out.get("latency_s"):
        import numpy as np

        lat = np.asarray(out["latency_s"])
        print(f"portbench: requests {len(lat)} latency ms p50 {1e3 * np.median(lat):.2f} "
              f"p95 {1e3 * np.percentile(lat, 95):.2f} max {1e3 * lat.max():.2f}", file=sys.stderr)
    for err in out.get("errors", ()):
        print(f"portbench: request failed: {err}", file=sys.stderr)
    result["checks"] = judged
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    for name, j in judged.items():
        print(f"check {name} {j['value']!r} limit {j['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
