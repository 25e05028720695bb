"""The control of ``correct``: for each seed, one short window of a cell
at its own load, then every number the check compares, twice: once for
the program (what the benchmark's runs compare) and once with the
reference itself, computed in bfloat16, in the program's place (the
nearest precision below the configuration's float32 for element-wise
work). A limit lies above the program's readings and below the control's.

    python -m portbench.control --workload <cell> --seeds 1 2 3 --seconds 4

One JSON line per seed on standard output (``program``, ``control``);
the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import torch

from portbench.harness import check, manifest
from portbench.harness.manifest import load_callable
from portbench.run import pin_environment

LOW = torch.bfloat16


def control_numbers(spec: Dict[str, Any], inputs: Dict[str, Any]) -> Dict[str, float]:
    """The numbers the check compares, with the reference in ``LOW`` in
    the program's place."""
    ref_fn = load_callable(spec["config_data"]["objective"]["reference"])
    settings, dims = inputs["settings"], inputs["dims"]
    exs = inputs["exs"]
    if isinstance(exs, dict):  # serving: one Result per request
        gap, lg = 0.0, 0.0
        for i, e in exs.items():
            gap = max(gap, check.loss_gap(check.losses(e, ref_fn, LOW), check.losses(e, ref_fn)))
            m = check.host_model(e, inputs["sizes"][i], settings, dims, inputs["device"], LOW)
            lg = max(lg, m["lg_score_gap"])
        return {"loss_gap": gap, "lg_score_gap": lg}
    low = [check.losses(e, ref_fn, LOW) for e in exs]
    ref = [check.losses(e, ref_fn) for e in exs]
    out = {"loss_gap": max(check.loss_gap(a, b) for a, b in zip(low, ref))}
    if inputs["records"] is not None:
        m = check.fused_model(exs[-1], inputs["records"], settings, dims, LOW)
        out.update(kde_bandwidth_gap=m["kde_bandwidth_gap"], pick_score_gap=m["pick_score_gap"])
    return out


def main(argv: Optional[List[str]] = None, device: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    spec = manifest.resolve(args.workload)
    pin_environment(spec["config_data"])
    if device is None:
        if not torch.cuda.is_available():
            print("portbench.control: no CUDA card", file=sys.stderr)
            return 2
        device = "cuda:0"
    driver = manifest.load_driver(spec)
    for seed in args.seeds:
        out = driver(spec, seed, args.seconds, False, device)
        line = {"workload": args.workload, "seed": seed, "attempted": out["attempted"],
                "failed": out["failed"], "program": out["numbers"],
                "control": control_numbers(spec, out["control_inputs"])}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
