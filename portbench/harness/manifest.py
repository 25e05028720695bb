"""``BENCHMARK.json`` and the files its names lead to.

A cell names a configuration (``configs[].file``), a traffic mix
(``traffic/<name>.json``, which names its driver) and, through the metrics
that list it, the per-layer readers (``metrics/<name>.py``). A later cell,
mix, driver or metric is one more file and one more entry: nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List

#: the checkout's root: ``BENCHMARK.json`` sits there, beside ``portbench/``
ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]


def load_manifest(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _by_name(entries: List[Dict[str, Any]], name: str, what: str) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _covers(metric: Dict[str, Any], cell: Dict[str, Any]) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    names the cell. An end-to-end metric without the list is every cell's;
    a per-layer metric must list its cells."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" in metric:
        raise ValueError(f"per-layer metric {metric['name']!r} lists no workloads")
    return True


def resolve(workload: str, root: Path = ROOT) -> Dict[str, Any]:
    """Everything one run of ``workload`` needs, by name: the cell, its
    configuration and traffic (parsed, its ``driver`` loaded by
    ``load_driver`` once the environment is pinned), its end-to-end
    metrics and its per-layer metrics with their readers' paths."""
    manifest = load_manifest(root)
    cell = _by_name(manifest["workloads"], workload, "workload")
    config = _by_name(manifest["configs"], cell["config"], "config")
    with open(root / config["file"]) as fh:
        config_data = json.load(fh)
    traffic = load_traffic(cell["traffic"], root)
    end_to_end = [m for m in manifest["end_to_end"] if _covers(m, cell)]
    per_layer = [dict(m, reader=root / "portbench" / "metrics" / f"{m['name']}.py")
                 for m in manifest["per_layer"] if _covers(m, cell)]
    return {
        "cell": cell, "config": config, "config_data": config_data,
        "traffic": traffic, "end_to_end": end_to_end, "per_layer": per_layer,
        "run_seconds": manifest["run_seconds"],
    }


def load_traffic(name: str, root: Path = ROOT) -> Dict[str, Any]:
    """The traffic mix ``traffic/<name>.json``, parsed."""
    with open(root / "portbench" / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def load_reader(path: Path) -> Callable[[Dict[str, Any]], Any]:
    """A per-layer metric's ``read(ctx)``, loaded from its file by path (a
    metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_callable(spec: str) -> Callable:
    """``"package.module:name"`` -> the object."""
    module, _, name = spec.partition(":")
    return getattr(importlib.import_module(module), name)


def load_driver(spec: Dict[str, Any]) -> Callable:
    """The cell's driver, ``run(spec, seed, seconds, trace, device,
    on_window)``, as its traffic mix names it."""
    return load_callable(spec["traffic"]["driver"])
