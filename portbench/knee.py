"""The knee of an open-loop serving mix: the highest rate it sustains
without a backlog that grows through the window, found once by a sweep of
rates on the card (a cell's traffic file then holds a rate below it).
``--workload`` names a serving cell whose configuration serves, and
``--traffic`` the open-loop mix sent to it in place of the cell's own.

    python -m portbench.knee --workload serve1_h6_b9_closed --traffic tenants_open_poisson \
        --rates 10 20 40 --seconds 60

One JSON line per rate: requests, evaluations per second, the median and
95th percentile of request latency, and ``growth``, the median latency of
the window's last third of requests over its first third (a backlog that
grows reads well above 1).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from portbench.harness import manifest
from portbench.run import pin_environment


def main(argv: Optional[List[str]] = None, device: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    spec = manifest.resolve(args.workload)
    spec["traffic"] = manifest.load_traffic(args.traffic)
    if spec["traffic"].get("arrivals") != "open":
        raise SystemExit("the knee is an open loop's")
    pin_environment(spec["config_data"])
    if device is None:
        if not torch.cuda.is_available():
            print("portbench.knee: no CUDA card", file=sys.stderr)
            return 2
        device = "cuda:0"
    driver = manifest.load_driver(spec)
    for rate in args.rates:
        spec["traffic"]["rate_per_s"] = rate
        out = driver(spec, args.seed, args.seconds, False, device)
        lat = np.asarray(out["latency_s"])
        third = max(len(lat) // 3, 1)
        line = {
            "rate_per_s": rate, "requests": out["attempted"], "failed": out["failed"],
            "evals_per_s": out["evals"] / (out["t1"] - out["t0"]),
            "window_s": out["t1"] - out["t0"],
            "p50_ms": 1000 * float(np.median(lat)), "p95_ms": 1000 * float(np.percentile(lat, 95)),
            "growth": float(np.median(lat[-third:]) / np.median(lat[:third])),
            "gc": out["gc"],
            "correct_numbers": out["numbers"],
        }
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
