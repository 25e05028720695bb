"""``BENCHMARK.json`` against the contract's shape, every name resolving
to its file, and a new configuration, mix and metric taken in by adding
files and entries alone."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = manifest.load_manifest()


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"]
    assert M["command"][:1] == ["python3"] and len(M["command"]) <= 32
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + M["end_to_end"] + M["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_names_are_unique_and_pairs_appear_once():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert "bound" not in m and m["moves"] in names
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    spec = manifest.resolve(cell)
    assert spec["cell"]["chips"] in (1, 4)
    assert (manifest.ROOT / spec["config"]["file"]).is_file()
    assert spec["config_data"]["name"] == spec["config"]["name"]
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["reader"].is_file() and callable(manifest.load_reader(m["reader"]))
        moved = next(x for x in M["end_to_end"] if x["name"] == m["moves"])
        assert moved["name"] in e2e


def test_every_config_is_used_and_every_file_is_its_own():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files)) and all(f.startswith("portbench/") for f in files)


def test_a_new_config_mix_and_metric_are_taken_in_by_files_and_entries(tmp_path: Path):
    root = tmp_path
    shutil.copytree(manifest.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(M)
    cfg = json.loads((root / M["configs"][0]["file"]).read_text())
    cfg["name"] = "hartmann6_eta3_b243"
    cfg["optimizer"]["max_budget"] = 243
    (root / "portbench/configs/hartmann6_eta3_b243.json").write_text(json.dumps(cfg))
    mix = {"driver": "portbench.harness.fused:run",
           "optimizer": "hpbandster_tpu_torch.optimizers:FusedBOHB",
           "model": True, "n_iterations": 10, "chunk_brackets": 5}
    (root / "portbench/traffic/fused_sweep_short.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/sweeps_in_window.sweep.py").write_text(
        "def read(ctx):\n    return float(len(ctx.get('sweeps', ()))) or None\n")
    bench["configs"] = M["configs"] + [dict(M["configs"][0], name=cfg["name"],
                                            file="portbench/configs/hartmann6_eta3_b243.json")]
    bench["workloads"] = M["workloads"] + [
        {"name": "h6_b243_short", "config": cfg["name"], "traffic": "fused_sweep_short",
         "chips": 1, "why": "a test cell"}]
    bench["per_layer"] = M["per_layer"] + [
        {"name": "sweeps_in_window.sweep", "unit": "sweeps", "better": "higher",
         "source": "host_clock", "layer": "optimizer: chunk pipeline and replay",
         "moves": "evals_per_s", "workloads": ["h6_b243_short"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = manifest.resolve("h6_b243_short", root=root)
    assert spec["config_data"]["optimizer"]["max_budget"] == 243
    assert spec["traffic"] == mix
    names = [m["name"] for m in spec["per_layer"]]
    assert names == ["sweeps_in_window.sweep"]
    read = manifest.load_reader(spec["per_layer"][0]["reader"])
    assert read({"sweeps": [{}, {}]}) == 2.0
    assert manifest.resolve("h6_b729_bohb", root=root)["cell"] == manifest.resolve("h6_b729_bohb")["cell"]
    assert manifest.load_driver(spec) is manifest.load_callable("portbench.harness.fused:run")


def test_a_new_traffic_shape_is_a_driver_module_and_a_mix(tmp_path: Path, monkeypatch):
    """A mix whose ``driver`` names a module that no file of the harness
    knows is run through it: a new shape edits nothing that is there."""
    (tmp_path / "replay_driver_for_test.py").write_text(
        "def run(spec, seed, seconds, trace, device, on_window=lambda: None):\n"
        "    on_window()\n"
        "    return {'seed': seed, 'shape': spec['traffic']['shape']}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    spec = {"traffic": {"driver": "replay_driver_for_test:run", "shape": "trace replay"}}
    assert manifest.load_driver(spec)(spec, 7, 1.0, False, "cpu") == {
        "seed": 7, "shape": "trace replay"}


def test_a_per_layer_metric_must_list_its_cells():
    cell = M["workloads"][0]
    with pytest.raises(ValueError):
        manifest._covers({"name": "x", "moves": "evals_per_s"}, cell)
    assert manifest._covers({"name": "setup_s"}, cell)
