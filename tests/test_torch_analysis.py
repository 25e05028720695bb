"""graftlint on the PyTorch package (``hpbandster_tpu_torch/analysis``),
held against the reference's (``hpbandster_tpu/analysis``).

The generic rules, the report formats, suppressions, the baseline ratchet,
``--changed`` and the call graph must behave as the reference's do on the
reference's own fixtures. Each torch rule flags exactly the ``# BAD``
lines of its fixture in ``hpbandster_tpu_torch/analysis/analysis_fixtures``
and passes its good fixture; the capture rules see the port's real
captured round (a copy of ``ops/sweep.py`` with a sync or a rebind put
in); and the port's own tree is clean. The reference's analysis is
imported only through the harness's ``ref`` window.
"""

from __future__ import annotations

import ast
import importlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from hpbandster_tpu_torch.analysis import all_rules, default_paths, format_report, graph, run
from hpbandster_tpu_torch.analysis.__main__ import main
from tests.test_torch_harness import ref  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parent.parent
REF_FIXTURES = REPO / "tests" / "analysis_fixtures"
FIXTURES = REPO / "hpbandster_tpu_torch" / "analysis" / "analysis_fixtures"

#: the rules both packages share, by the reference fixture they are held on
GENERIC = {
    "exceptions": "swallowed-exception",
    "locks": "lock-coverage",
    "lockorder": "lock-order",
    "lockblock": "lock-blocking",
    "retry": "retry-backoff",
    "wallclock": "wallclock-duration",
    "obs_reserved": "obs-reserved-fields",
}

#: every JAX rule and the port rule in its place
JAX_TO_PORT = {
    "jit-host-sync": "capture-host-sync",
    "trace-escape": "capture-escape",
    "obs-emit-in-jit": "obs-emit-in-capture",
    "prng-reuse": "generator-seeding",
    "jit-donation": "capture-rebind",
    "jit-in-loop": "capture-in-loop",
    "pytest-marker": "pytest-marker",
}

#: the torch rules' fixtures
TORCH_FIXTURES = {
    "capture-host-sync": ("capture_host_sync_bad.py", "capture_host_sync_good.py"),
    "capture-escape": ("capture_escape_bad.py", "capture_escape_good.py"),
    "obs-emit-in-capture": ("obs_emit_in_capture_bad.py", "obs_emit_in_capture_good.py"),
    "generator-seeding": ("generator_seeding_bad.py", "generator_seeding_good.py"),
    "capture-rebind": ("capture_rebind_bad.py", "capture_rebind_good.py"),
    "capture-in-loop": ("capture_in_loop_bad.py", "capture_in_loop_good.py"),
    "pytest-marker": ("test_pytest_marker_bad.py", "test_pytest_marker_good.py"),
}


@pytest.fixture(scope="module")
def ref_lint(ref):  # noqa: F811
    """The reference's graftlint (core, graph, CLI), inside ``ref``'s window."""
    names = {"analysis": "analysis", "graph": "analysis.graph", "cli": "analysis.__main__"}
    return SimpleNamespace(**{
        k: importlib.import_module(f"hpbandster_tpu.{m}") for k, m in names.items()})


def rows(findings, root):
    """What both packages must agree on: rule, relative path, line, message."""
    return [(f.rule, os.path.relpath(f.path, root), f.line, f.message) for f in findings]


def bad_lines(path: Path) -> set:
    return {i for i, line in enumerate(path.read_text().splitlines(), start=1)
            if line.rstrip().endswith("# BAD")}


def port_copy(src: Path, dst_dir: Path) -> Path:
    """``src`` with the reference's package name pointed at the port's (the
    obs prefix the port's rules resolve), at the same lines."""
    dst = dst_dir / src.name
    dst.write_text(src.read_text().replace("hpbandster_tpu", "hpbandster_tpu_torch"))
    return dst


# ------------------------------------------------------------ generic rules
@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("stem", sorted(GENERIC))
def test_generic_rules_match_the_reference(ref_lint, tmp_path, stem, kind):
    """On each generic fixture pair both packages report the same findings.
    The port's lock-blocking sinks are the card's, not jax's: a finding the
    reference reaches through ``jax.device_get`` is the one it drops
    (:func:`test_lock_blocking_sinks_are_the_cards` holds the port's)."""
    src = REF_FIXTURES / f"{stem}_{kind}.py"
    rules = sorted(GENERIC.values())
    want = rows(ref_lint.analysis.run([str(src)], rules=rules), src.parent)
    target = port_copy(src, tmp_path) if stem == "obs_reserved" else src
    got = rows(run([str(target)], rules=rules), target.parent)
    if stem == "lockblock" and kind == "bad":
        dropped = [w for w in want if "jax.device_get" in w[3]]
        assert len(dropped) == 1, want
        want = [w for w in want if w not in dropped]
    assert got == want
    if kind == "bad":
        assert got, f"{src.name} tripped nothing"


def test_lock_blocking_sinks_are_the_cards(ref_lint, tmp_path):
    """Where the reference's fixture syncs with ``jax.device_get``, a copy
    syncing with the card (``.cpu()``, ``torch.cuda.synchronize()``, a
    blocking collective, a work handle's ``.wait()``) is flagged at the
    same line; ``block_until_ready`` is no sink of the port's."""
    src = (REF_FIXTURES / "lockblock_bad.py").read_text()
    line = next(i for i, s in enumerate(src.splitlines(), 1) if "_sync(self._carry)" in s)
    cases = {
        "carry.cpu()": ".cpu()",
        "torch.cuda.synchronize()": "torch.cuda.synchronize()",
        "torch.distributed.barrier()": "torch.distributed.barrier()",
        "torch.distributed.all_reduce(carry, async_op=True).wait()": ".wait()",
    }
    for expr, label in cases.items():
        path = tmp_path / "lockblock_card.py"
        path.write_text(src.replace("import jax\n", "import torch\n")
                        .replace("jax.device_get(carry)", expr))
        got = [f for f in run([str(path)], rules=["lock-blocking"]) if f.line == line]
        assert len(got) == 1 and label in got[0].message, (expr, got)
    path.write_text(src.replace("jax.device_get(carry)", "carry.block_until_ready()"))
    assert line not in {f.line for f in run([str(path)], rules=["lock-blocking"])}
    ref_found = ref_lint.analysis.run([str(path)], rules=["lock-blocking"])
    assert line in {f.line for f in ref_found}


# ------------------------------------------------------- formats and modes
def _both(ref_lint, argv, capsys):
    """``(exit code, stdout)`` of each package's CLI on ``argv``."""
    out = []
    for cli in (main, ref_lint.cli.main):
        code = cli(list(argv))
        out.append((code, capsys.readouterr().out))
    return out


def test_text_json_and_sarif_reports_match(ref_lint, tmp_path, capsys):
    """The text, JSON and SARIF reports of a tree with one-location and
    two-location findings are the same in both packages (SARIF's rule
    catalogue aside: each lists its own rules)."""
    tree = tmp_path / "tree"
    tree.mkdir()
    for name in ("lockorder_bad.py", "exceptions_bad.py", "wallclock_bad.py"):
        shutil.copy(REF_FIXTURES / name, tree / name)
    generic = ",".join(sorted(GENERIC.values()))
    (pc, port_text), (rc, ref_text) = _both(ref_lint, ["--rules", generic, str(tree)], capsys)
    assert pc == rc == 1
    assert port_text == ref_text and "    -> " in port_text
    (pc, port_json), (rc, ref_json) = _both(
        ref_lint, ["--format=json", "--rules", generic, str(tree)], capsys)
    assert pc == rc == 1
    assert json.loads(port_json) == json.loads(ref_json)
    assert any("related" in r for r in json.loads(port_json))
    (pc, port_sarif), (rc, ref_sarif) = _both(
        ref_lint, ["--format=sarif", "--rules", generic, str(tree)], capsys)
    assert pc == rc == 1
    port_s, ref_s = json.loads(port_sarif), json.loads(ref_sarif)
    assert port_s["version"] == ref_s["version"] == "2.1.0"
    assert port_s["$schema"] == ref_s["$schema"]
    assert port_s["runs"][0]["tool"]["driver"]["name"] == "graftlint"
    assert port_s["runs"][0]["results"] == ref_s["runs"][0]["results"]
    assert any("relatedLocations" in r for r in port_s["runs"][0]["results"])
    assert {r["id"] for r in port_s["runs"][0]["tool"]["driver"]["rules"]} == set(all_rules())
    clean = tmp_path / "ok.py"
    clean.write_text("def f():\n    return 1\n")
    for fmt in ("text", "json", "sarif"):
        (pc, pout), (rc, rout) = _both(ref_lint, [f"--format={fmt}", str(clean)], capsys)
        assert pc == rc == 0
        if fmt == "text":
            assert pout == rout == "graftlint: clean\n"
        elif fmt == "json":
            assert json.loads(pout) == json.loads(rout) == []
        else:
            assert json.loads(pout)["runs"][0]["results"] == []


def test_format_report_matches(ref_lint):
    src = REF_FIXTURES / "lockorder_bad.py"
    rules = sorted(GENERIC.values())
    assert format_report(run([str(src)], rules=rules)) == ref_lint.analysis.format_report(
        ref_lint.analysis.run([str(src)], rules=rules))


def test_suppressions_match(ref_lint, tmp_path):
    mod = tmp_path / "suppressed.py"
    mod.write_text(
        "import threading\n"
        "import time\n"
        "\n"
        "\n"
        "def swallow_twice():\n"
        "    try:\n"
        "        pass\n"
        "    except Exception:  # graftlint: disable=swallowed-exception — probe\n"
        "        pass\n"
        "    try:\n"
        "        pass\n"
        "    except Exception:\n"
        "        pass\n"
        "\n"
        "\n"
        "class Box:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "\n"
        "    def nap(self):\n"
        "        with self._lock:\n"
        "            # graftlint: disable=lock-blocking — settle\n"
        "            time.sleep(0.001)\n"
        "            time.sleep(0.001)  # graftlint: disable=all — settle\n"
        "            time.sleep(0.001)\n"
    )
    got = rows(run([str(mod)]), tmp_path)
    want = rows(ref_lint.analysis.run([str(mod)], rules=sorted(GENERIC.values())), tmp_path)
    assert got == want
    assert [(r[0], r[2]) for r in got] == [("swallowed-exception", 12), ("lock-blocking", 25)]


def test_baseline_ratchet_matches(ref_lint, tmp_path, capsys):
    codes = {}
    for name, cli in (("port", main), ("ref", ref_lint.cli.main)):
        tree = tmp_path / name / "tree"
        tree.mkdir(parents=True)
        legacy = tree / "legacy.py"
        legacy.write_text((REF_FIXTURES / "lockblock_bad.py").read_text()
                          .replace("jax.device_get(carry)", "carry.cpu()"))
        baseline = tmp_path / name / "baseline.json"
        seq = [cli([str(tree), "--rules", "lock-blocking,lock-order",
                    "--write-baseline", str(baseline)])]
        capsys.readouterr()
        seq.append(cli([str(tree), "--rules", "lock-blocking,lock-order",
                        "--baseline", str(baseline)]))
        capsys.readouterr()
        shutil.copy(REF_FIXTURES / "lockorder_bad.py", tree / "fresh.py")
        seq.append(cli([str(tree), "--rules", "lock-blocking,lock-order",
                        "--baseline", str(baseline)]))
        out = capsys.readouterr().out
        assert "[lock-order]" in out and "legacy.py" not in out
        seq.append(cli([str(tree), "--baseline", str(tmp_path / "nope.json")]))
        capsys.readouterr()
        codes[name] = seq
    assert codes["port"] == codes["ref"] == [0, 0, 1, 2]


def test_changed_mode_matches(ref_lint, tmp_path, capsys, monkeypatch):
    """``--changed`` reports on the named file but builds the call graph
    over the package, in both packages; a missing path is a usage error."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "helpers.py").write_text("import time\n\n\ndef settle():\n    time.sleep(1)\n")
    (pkg / "entry.py").write_text(
        "import threading\n"
        "\n"
        "from pkg.helpers import settle\n"
        "\n"
        "\n"
        "class Box:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "\n"
        "    def stop(self):\n"
        "        with self._lock:\n"
        "            settle()\n"
    )
    kw = dict(graph_roots=[str(pkg)], rules=["lock-blocking"])
    got = run([str(pkg / "entry.py")], **kw)
    want = ref_lint.analysis.run([str(pkg / "entry.py")], **kw)
    assert rows(got, tmp_path) == rows(want, tmp_path)
    assert len(got) == 1 and got[0].related_path == str(pkg / "helpers.py")
    monkeypatch.chdir(REPO)
    (pc, _), (rc, _) = _both(ref_lint, ["--changed", "no/such/file.py"], capsys)
    assert pc == rc == 2
    assert main(["--changed", str(REPO / "hpbandster_tpu_torch" / "serve" / "pool.py")]) == 0
    assert ref_lint.cli.main(["--changed", str(REPO / "hpbandster_tpu" / "serve" / "pool.py")]) == 0
    capsys.readouterr()


def test_call_graph_matches_the_reference(ref_lint):
    """Both packages' ``graph.Project`` over ``hpbandster_tpu/serve`` have
    the same functions and the same resolved call edges."""
    files = sorted(str(p) for p in (REPO / "hpbandster_tpu" / "serve").glob("*.py"))

    def edges(project):
        return sorted(
            (s.caller, s.callee.qname, s.line, s.bound, s.via_partial, s.is_init)
            for sites in project.calls.values() for s in sites)

    port, reference = graph.get_project(files), ref_lint.graph.get_project(files)
    assert sorted(port.functions) == sorted(reference.functions)
    assert sorted(port.locks) == sorted(reference.locks)
    assert edges(port) == edges(reference)
    assert len(edges(port)) > 50


# ---------------------------------------------------------------- torch rules
@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule", sorted(TORCH_FIXTURES))
def test_torch_rule_fixtures(rule, kind, tmp_path, capsys):
    """Each torch rule flags exactly its bad fixture's ``# BAD`` lines (and
    the CLI exits 1 on it, naming the rule) and passes its good fixture."""
    bad, good = TORCH_FIXTURES[rule]
    path = FIXTURES / (bad if kind == "bad" else good)
    findings = run([str(path)], rules=[rule])
    assert all(f.rule == rule and f.path == str(path) for f in findings)
    got = {f.line for f in findings}
    if kind == "good":
        assert not bad_lines(path)
        assert findings == [], "\n".join(map(str, findings))
        return
    want = bad_lines(path)
    assert want, f"{path.name} has no # BAD markers"
    assert got == want, (sorted(want - got), sorted(got - want))
    tree = tmp_path / "tree"
    tree.mkdir()
    shutil.copy(path, tree / path.name)
    assert main([str(tree)]) == 1
    assert f"[{rule}]" in capsys.readouterr().out


def test_every_jax_rule_has_a_port_rule(ref_lint, capsys):
    """``--list-rules`` shows a port rule in the place of every JAX rule,
    and the generic rules under their own names."""
    ref_rules = set(ref_lint.analysis.all_rules())
    assert set(JAX_TO_PORT) | set(GENERIC.values()) == ref_rules
    assert main(["--list-rules"]) == 0
    listed = {line.split()[0] for line in capsys.readouterr().out.splitlines() if line.strip()}
    assert set(JAX_TO_PORT.values()) | set(GENERIC.values()) == listed == set(all_rules())


SWEEP = REPO / "hpbandster_tpu_torch" / "ops" / "sweep.py"
CARRY_UPDATE = "            r_idx.add_(1)\n"


def _sweep_copy(tmp_path: Path, text: str) -> Path:
    ops = tmp_path / "ops"
    ops.mkdir(exist_ok=True)
    path = ops / "sweep.py"
    path.write_text(text)
    return path


def test_capture_rules_see_the_resident_round(tmp_path):
    """The capture rules find the port's real captured round: a copy of
    ``ops/sweep.py`` is clean, a ``.item()`` put into the resident
    ``round_body`` trips capture-host-sync at that line, and so does a
    helper it calls (capture-escape)."""
    src = SWEEP.read_text()
    assert src.count(CARRY_UPDATE) == 1
    assert run([str(_sweep_copy(tmp_path, src))]) == []
    synced = src.replace(CARRY_UPDATE, CARRY_UPDATE + "            print(r_idx.item())\n")
    path = _sweep_copy(tmp_path, synced)
    line = synced.splitlines().index("            print(r_idx.item())") + 1
    found = [(f.rule, f.line) for f in run([str(path)])]
    assert found == [("capture-host-sync", line)]
    helper = src.replace(
        "    def best_row(losses: torch.Tensor) -> torch.Tensor:\n",
        "    def best_row(losses: torch.Tensor) -> torch.Tensor:\n"
        "        assert losses.sum().item() == losses.sum().item()\n")
    path = _sweep_copy(tmp_path, helper)
    found = run([str(path)], rules=["capture-escape"])
    assert found and {f.rule for f in found} == {"capture-escape"}
    sink = helper.splitlines().index(
        "        assert losses.sum().item() == losses.sum().item()") + 1
    assert {f.related_line for f in found} == {sink}


def test_capture_rebind_sees_the_resident_round(tmp_path):
    """A copy of ``ops/sweep.py`` whose round rebinds its carried round
    index (``r_idx = r_idx + 1`` in place of ``r_idx.add_(1)``) trips
    capture-rebind there."""
    src = SWEEP.read_text()
    rebound = src.replace(
        "        def round_body(r=None):\n",
        "        def round_body(r=None):\n            nonlocal r_idx\n",
    ).replace(CARRY_UPDATE, "            r_idx = r_idx + 1\n")
    path = _sweep_copy(tmp_path, rebound)
    line = rebound.splitlines().index("            r_idx = r_idx + 1") + 1
    assert [(f.rule, f.line) for f in run([str(path)])] == [("capture-rebind", line)]


def test_capture_roots_cover_the_port():
    """Every body the port captures is a root of the capture rules: the
    sweep's resident round and chunk, ``RoundGraph``'s own capture block,
    and the bodies of the bucket, megabatch and continuous programs."""
    from hpbandster_tpu_torch.analysis.core import collect_files

    project = graph.get_project(list(collect_files(default_paths(str(REPO)))))
    # the port's roots (a test may capture a stand-in body of its own)
    roots = {info.qname.split("hpbandster_tpu_torch.", 1)[1] for info, _ in
             project.captured_roots() if info.qname.startswith("hpbandster_tpu_torch.")}
    assert roots >= {
        "ops.sweep.make_fused_sweep_fn.<locals>.make_round.<locals>.round_body",
        "ops.sweep.make_fused_sweep_fn.<locals>.capture.<locals>.chunk_body",
        "ops.graphs.RoundGraph.__init__",
        "ops.buckets.StaticProgram._ensure_locked.<locals>.capture",
        "ops.buckets._BucketRunner.__init__.<locals>.body",
        "serve.megabatch.MegaRunner.__init__.<locals>.body",
        "serve.continuous.ContinuousRunner.__init__.<locals>.body",
    }, sorted(roots)


# ----------------------------------------------------------- the port's gate
def test_port_tree_is_clean():
    """The port's graftlint over its default paths finds nothing. The cold
    scan's time is printed, not bounded (a wall-clock bound flakes under a
    loaded machine)."""
    paths = default_paths(str(REPO))
    assert str(REPO / "hpbandster_tpu_torch") in paths
    assert str(REPO / "chip_smoke.py") in paths
    assert str(REPO / "tests" / "test_torch_analysis.py") in paths
    graph.clear_caches()
    t0 = time.perf_counter()
    findings = run(paths)
    print(f"port graftlint cold scan: {time.perf_counter() - t0:.2f}s over {len(paths)} paths")
    assert findings == [], "\n" + format_report(findings)


def test_cli_gates_the_port(monkeypatch, capsys):
    """``python -m hpbandster_tpu_torch.analysis`` exits 0 on its default
    paths, 1 on a bad fixture, 2 on an unknown rule."""
    monkeypatch.chdir(REPO)
    assert main([]) == 0
    assert "clean" in capsys.readouterr().out
    assert main(["--rules", "no-such-rule", str(FIXTURES)]) == 2
    proc = subprocess.run(
        [sys.executable, "-m", "hpbandster_tpu_torch.analysis",
         str(FIXTURES / "capture_rebind_bad.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert "[capture-rebind]" in proc.stdout


def test_analysis_is_stdlib_only():
    """The port's analysis imports the standard library and itself, never
    torch, numpy or jax."""
    allowed = set(sys.stdlib_module_names) | {"hpbandster_tpu_torch"}
    for path in (REPO / "hpbandster_tpu_torch" / "analysis").rglob("*.py"):
        if "analysis_fixtures" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)
                if name.startswith("hpbandster_tpu_torch"):
                    assert name.startswith("hpbandster_tpu_torch.analysis"), (path.name, name)
