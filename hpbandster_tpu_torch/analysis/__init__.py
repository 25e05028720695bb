"""graftlint for the PyTorch package: the repo's static analysis with a
rule pack for CUDA-graph captures, ``torch.Generator`` seeding and locks.

Ported from ``hpbandster_tpu/analysis/``. The core (findings, suppression
comments, the text/JSON/SARIF reports, the call graph, the CLI) and the
generic rules are the reference's; each JAX rule has a torch counterpart
(``capture-host-sync``, ``capture-escape``, ``obs-emit-in-capture``,
``generator-seeding``, ``capture-rebind``, ``capture-in-loop``,
``pytest-marker``). Stdlib only: importing it imports neither torch nor
jax.

Usage::

    python -m hpbandster_tpu_torch.analysis [paths...]      # exit 1 on findings

    from hpbandster_tpu_torch.analysis import run, format_report
    findings = run(default_paths())

README's section on the port lists the rules, the suppression syntax
(``# graftlint: disable=<rule> — why``) and the mapping from the JAX rules.
"""

from hpbandster_tpu_torch.analysis.core import (
    DEFAULT_EXCLUDE_DIRS,
    Finding,
    ProjectRule,
    Rule,
    SourceModule,
    all_rules,
    collect_files,
    default_paths,
    format_report,
    register,
    run,
)

__all__ = [
    "DEFAULT_EXCLUDE_DIRS",
    "Finding",
    "ProjectRule",
    "Rule",
    "SourceModule",
    "all_rules",
    "collect_files",
    "default_paths",
    "format_report",
    "register",
    "run",
]
