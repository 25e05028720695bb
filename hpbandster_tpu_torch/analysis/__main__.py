"""CLI: ``python -m hpbandster_tpu_torch.analysis [paths...]``.

Ported from ``hpbandster_tpu/analysis/__main__.py``. Exit codes: 0 clean,
1 findings, 2 usage error. Default paths are what the port gates itself on
(``hpbandster_tpu_torch``, ``tests/test_torch_*.py`` and ``chip_smoke.py``),
resolved relative to the current directory.

CI-adoption flags:

* ``--format=text|json|sarif`` — machine-readable output (``--json`` is
  kept as an alias for ``--format=json``); SARIF 2.1.0 uploads straight
  into code-scanning UIs, related locations included.
* ``--baseline findings.json`` — ratchet mode: findings fingerprinted in
  the baseline are tolerated (per-fingerprint count), anything NEW gates.
  ``--write-baseline findings.json`` freezes the current state. Adopting
  graftlint on a legacy tree is two commands, no cleanup prerequisite.
* ``--changed`` — the named paths (or stdin lines with ``-``) are the
  files to REPORT on, but the whole-program call graph is still built
  over the package tree (plus the port's tests, or ``chip_smoke.py``,
  when one of them changed), so
  interprocedural rules keep seeing callees outside the changed set.
  This is the pre-commit-hook mode: one changed file scans in a fraction
  of the full-scan time.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Dict, List, Optional

from hpbandster_tpu_torch.analysis.core import (
    Finding,
    all_rules,
    default_paths,
    format_report,
    run,
)


def _changed_graph_roots(paths: List[str]) -> List[str]:
    """Graph context for ``--changed``: the package tree always (callee
    bodies live there), plus the port's tests when a test file changed and
    ``chip_smoke.py`` when it changed. Test modules and the script are
    never imported by the package, so they cannot contribute call edges
    INTO a changed source file, and skipping their parse is what keeps the
    pre-commit hook under the latency bar."""
    package, *extras = default_paths()
    roots = [package]
    changed = {os.path.abspath(p) for p in paths}
    tests_dir = os.path.join(os.getcwd(), "tests") + os.sep
    for extra in extras:
        extra = os.path.abspath(extra)
        if extra in changed or (
            extra.startswith(tests_dir)
            and any(p.startswith(tests_dir) for p in changed)
        ):
            roots.append(extra)
    return roots


def _fingerprint(finding: Finding, root: str) -> str:
    """Stable identity for ratcheting: rule + repo-relative path + message.

    Line numbers are deliberately excluded — unrelated edits above a
    baselined finding must not resurrect it."""
    rel = os.path.relpath(finding.path, root)
    digest = hashlib.sha1(
        f"{finding.rule}\x00{rel}\x00{finding.message}".encode()
    ).hexdigest()
    return digest[:16]


def _apply_baseline(
    findings: List[Finding], baseline: Dict[str, int], root: str
) -> List[Finding]:
    """Drop findings covered by the baseline; each fingerprint tolerates
    as many occurrences as were frozen (a count ratchet: fixing one of
    three dupes then regressing it re-gates)."""
    budget = dict(baseline)
    fresh: List[Finding] = []
    for finding in findings:
        fp = _fingerprint(finding, root)
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
        else:
            fresh.append(finding)
    return fresh


def _as_json(findings: List[Finding]) -> str:
    rows = []
    for f in findings:
        row: Dict[str, object] = {
            "rule": f.rule, "path": f.path, "line": f.line, "message": f.message,
        }
        if f.related_path is not None:
            row["related"] = {
                "path": f.related_path,
                "line": f.related_line,
                "note": f.related_note,
            }
        rows.append(row)
    return json.dumps(rows, indent=2)


def _as_sarif(findings: List[Finding]) -> str:
    def location(path: str, line: int, message: str = "") -> Dict[str, object]:
        loc: Dict[str, object] = {
            "physicalLocation": {
                "artifactLocation": {"uri": path},
                "region": {"startLine": max(line, 1)},
            }
        }
        if message:
            loc["message"] = {"text": message}
        return loc

    results = []
    for f in findings:
        result: Dict[str, object] = {
            "ruleId": f.rule,
            "level": "warning",
            "message": {"text": f.message},
            "locations": [location(f.path, f.line)],
        }
        if f.related_path is not None:
            result["relatedLocations"] = [
                location(f.related_path, f.related_line, f.related_note)
            ]
        results.append(result)
    sarif = {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
            "Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "graftlint",
                        "rules": [
                            {
                                "id": name,
                                "shortDescription": {"text": cls.description},
                            }
                            for name, cls in sorted(all_rules().items())
                        ],
                    }
                },
                "results": results,
            }
        ],
    }
    return json.dumps(sarif, indent=2)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hpbandster_tpu_torch.analysis",
        description="graftlint: CUDA-graph-, generator- and concurrency-aware "
        "static analysis of the PyTorch package",
    )
    parser.add_argument(
        "paths", nargs="*", default=None,
        help="files/directories to scan (default: hpbandster_tpu_torch, "
        "tests/test_torch_*.py, chip_smoke.py); "
        "with --changed, '-' reads newline-separated paths from stdin",
    )
    parser.add_argument(
        "--rules", default=None,
        help="comma-separated subset of rules to run (default: all)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalogue and exit"
    )
    parser.add_argument(
        "--format", default="text", choices=("text", "json", "sarif"),
        help="report format (default: text)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="alias for --format=json",
    )
    parser.add_argument(
        "--changed", action="store_true",
        help="report only on the named files, but build the call graph "
        "over the full default trees (pre-commit mode)",
    )
    parser.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="ratchet mode: tolerate findings fingerprinted in FILE, "
        "gate only on new ones",
    )
    parser.add_argument(
        "--write-baseline", default=None, metavar="FILE",
        help="write the current findings' fingerprints to FILE and exit 0",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for name, cls in sorted(all_rules().items()):
            print(f"{name:24s} {cls.description}")
        return 0

    paths = args.paths or default_paths()
    if args.changed:
        if paths == ["-"]:
            paths = [ln.strip() for ln in sys.stdin if ln.strip()]
        if not paths:
            return 0  # nothing changed, nothing to scan
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            print(f"error: no such path: {', '.join(missing)}", file=sys.stderr)
            return 2

    rules = None
    if args.rules is not None:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    graph_roots = _changed_graph_roots(paths) if args.changed else None
    try:
        findings = run(paths, rules=rules, graph_roots=graph_roots)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    root = os.getcwd()
    if args.write_baseline is not None:
        counts: Dict[str, int] = {}
        for f in findings:
            fp = _fingerprint(f, root)
            counts[fp] = counts.get(fp, 0) + 1
        with open(args.write_baseline, "w") as fh:
            json.dump(
                {"version": 1, "fingerprints": counts}, fh, indent=2, sort_keys=True
            )
            fh.write("\n")
        print(
            f"baseline: froze {len(findings)} finding(s) "
            f"({len(counts)} fingerprint(s)) -> {args.write_baseline}"
        )
        return 0

    if args.baseline is not None:
        try:
            with open(args.baseline) as fh:
                data = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"error: cannot read baseline {args.baseline}: {e}", file=sys.stderr)
            return 2
        findings = _apply_baseline(
            findings, dict(data.get("fingerprints", {})), root
        )

    fmt = "json" if args.as_json else args.format
    if fmt == "json":
        print(_as_json(findings))
    elif fmt == "sarif":
        print(_as_sarif(findings))
    else:
        print(format_report(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
