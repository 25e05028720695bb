"""graftlint core — rule registry, suppression handling, runner, report.

Ported from ``hpbandster_tpu/analysis/core.py``, unchanged but for the
imports and :func:`default_paths`. Generic linters (flake8, pylint) are
blind to the port's bug-prone idioms: device programs captured as CUDA
graphs (``ops/graphs.py``, the sweep's round, the buckets' programs), where
a host sync or a rebound tensor shows only on a card; ``torch.Generator``
plumbing, where an unseeded draw makes a run irreproducible; and
hand-rolled threading (``parallel/``, ``serve/``), where a lock held over a
device sync stalls every waiter. ``graftlint`` is an AST-level pass tuned
to exactly those failure modes.

Design:

* a :class:`Rule` inspects one parsed :class:`SourceModule` at a time and
  returns :class:`Finding` objects with exact ``file:line`` locations;
* rules self-register via the :func:`register` decorator — adding a rule is
  dropping a module into ``analysis/rules/`` and importing it in
  ``rules/__init__.py``;
* per-rule suppression comments::

      risky_line()  # graftlint: disable=<rule>[,<rule2>] — justification

  A directive on a code line suppresses that line; a directive on a
  comment-only line suppresses the next line. ``disable=all`` mutes every
  rule. Suppressions are expected to carry a justification after the rule
  list — the analyzer does not parse it, reviewers do;
* :func:`run` walks files/directories (skipping ``analysis_fixtures``,
  caches, VCS dirs) and returns sorted findings; the CLI in ``__main__``
  exits non-zero when any survive, so the port gates itself in
  ``tests/test_torch_analysis.py``.

Everything here is stdlib-only (``ast`` + ``tokenize``): the pass must stay
in the fast test lane, so importing it must not drag in torch.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple, Type

__all__ = [
    "Finding",
    "Rule",
    "ProjectRule",
    "SourceModule",
    "register",
    "all_rules",
    "collect_files",
    "run",
    "format_report",
    "default_paths",
    "DEFAULT_EXCLUDE_DIRS",
]

#: directory basenames the walker never descends into. ``analysis_fixtures``
#: holds deliberately-bad rule fixtures; they are only scanned when named
#: explicitly (the rule tests do exactly that).
DEFAULT_EXCLUDE_DIRS = frozenset(
    {"__pycache__", ".git", ".pytest_cache", "analysis_fixtures", ".ipynb_checkpoints"}
)

#: what the port gates itself on, relative to the repo root: the package,
#: the port's tests and the card's smoke script
DEFAULT_PATHS = ("hpbandster_tpu_torch", "tests/test_torch_*.py", "chip_smoke.py")


def default_paths(root: Optional[str] = None) -> List[str]:
    """:data:`DEFAULT_PATHS` under ``root`` (default: the current
    directory), the test glob expanded in sorted order."""
    import glob

    root = os.getcwd() if root is None else root
    out: List[str] = []
    for pattern in DEFAULT_PATHS:
        full = os.path.join(root, pattern)
        out.extend(sorted(glob.glob(full)) if "*" in pattern else [full])
    return out


_DIRECTIVE_RE = re.compile(r"graftlint:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: ``path:line: [rule] message``.

    Interprocedural findings carry a second location: the *primary*
    location is where the bug is entered (the call site a reviewer must
    judge), ``related_*`` is the sink it reaches (where the damage
    happens). A suppression directive at EITHER location mutes the
    finding — the call site owns "this caller is safe", the sink owns
    "this operation is safe from anywhere".
    """

    rule: str
    path: str
    line: int
    message: str
    related_path: Optional[str] = None
    related_line: int = 0
    related_note: str = ""

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    @property
    def related_location(self) -> Optional[str]:
        if self.related_path is None:
            return None
        return f"{self.related_path}:{self.related_line}"

    def __str__(self) -> str:
        text = f"{self.location}: [{self.rule}] {self.message}"
        if self.related_path is not None:
            note = f" ({self.related_note})" if self.related_note else ""
            text += f"\n    -> {self.related_location}{note}"
        return text


class SourceModule:
    """A parsed source file plus its suppression table."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        #: built lazily — graph-context modules that never host a finding
        #: skip the tokenize pass entirely (it is ~10% of a cold scan)
        self._suppressions: Optional[Dict[int, Set[str]]] = None
        #: scratch memo shared by rules (e.g. the resolved import map) so
        #: per-module derived structures are built once, not once per rule
        self.cache: Dict[str, object] = {}

    def _index(self) -> "Tuple[Tuple[ast.AST, ...], Dict[int, int], Dict[int, int]]":
        """One DFS-preorder traversal of :attr:`tree`, memoized:
        ``(order, id(node) -> position, position -> subtree-end)``.

        A subtree is contiguous in preorder, so every :meth:`subtree` call
        is an O(1) slice of ``order`` instead of a fresh ``ast.walk`` —
        re-walking subtrees per rule was the dominant term of a full scan
        (the selfcheck pins the gate under 5 s as the tree keeps growing).
        """
        idx = self.cache.get("dfs")
        if idx is None:
            order: List[ast.AST] = []
            pos: Dict[int, int] = {}
            end: Dict[int, int] = {}
            # explicit stack (deep expression trees outlive any recursion
            # limit); an int entry marks "subtree rooted at order[i] done"
            stack: List[object] = [self.tree]
            while stack:
                top = stack.pop()
                if type(top) is int:
                    end[top] = len(order)
                    continue
                i = len(order)
                order.append(top)  # type: ignore[arg-type]
                pos[id(top)] = i
                stack.append(i)
                stack.extend(reversed(tuple(ast.iter_child_nodes(top))))  # type: ignore[arg-type]
            idx = (tuple(order), pos, end)
            self.cache["dfs"] = idx
        return idx  # type: ignore[return-value]

    def walk(self) -> "Tuple[ast.AST, ...]":
        """Every node of :attr:`tree` in DFS preorder (source order),
        computed once and memoized. Rules treat this as an unordered node
        census; the preorder contract only matters to forward passes,
        which it serves better than ``ast.walk``'s BFS."""
        return self._index()[0]

    def subtree(self, node: ast.AST) -> Iterator[ast.AST]:
        """``node`` and all its descendants in preorder — an O(1) slice of
        the memoized index. Nodes not in the index (synthesized outside
        :attr:`tree`) fall back to a live ``ast.walk``, so the iterator is
        total either way."""
        order, pos, end = self._index()
        start = pos.get(id(node))
        if start is None:
            return ast.walk(node)
        return iter(order[start : end[start]])

    @property
    def suppressions(self) -> Dict[int, Set[str]]:
        """line -> set of rule names muted on that line ("all" mutes any)."""
        if self._suppressions is None:
            self._suppressions = _parse_suppressions(self.text)
        return self._suppressions

    def is_suppressed(self, rule: str, line: int) -> bool:
        muted = self.suppressions.get(line, ())
        return "all" in muted or rule in muted


def _parse_suppressions(text: str) -> Dict[int, Set[str]]:
    """Scan comments with ``tokenize`` (immune to '#' inside strings).

    A directive inside a statement applies to every physical line of that
    *logical* line — findings anchor to a statement's first line, so a
    trailing comment on the closing paren of a wrapped call still
    suppresses it. A directive on a comment-only line applies to the
    following line (room for a longer justification above the code).
    """
    table: Dict[int, Set[str]] = {}
    # tokenizing every file dominated suppression parsing; files without a
    # directive (the vast majority) can skip it on a substring probe
    if "graftlint:" not in text:
        return table
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, IndentationError):  # half-written file
        return table
    _NONCODE = (
        tokenize.COMMENT,
        tokenize.NL,
        tokenize.NEWLINE,
        tokenize.INDENT,
        tokenize.DEDENT,
        tokenize.ENCODING,
    )
    logical_start: Optional[int] = None
    for tok in tokens:
        if tok.type == tokenize.NEWLINE:
            logical_start = None
            continue
        if tok.type not in _NONCODE and logical_start is None:
            logical_start = tok.start[0]
        if tok.type != tokenize.COMMENT:
            continue
        m = _DIRECTIVE_RE.search(tok.string)
        if m is None:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        line = tok.start[0]
        if logical_start is None:
            targets = [line + 1]  # comment-only line: excuse what follows
        else:
            targets = range(logical_start, line + 1)
        for target in targets:
            table.setdefault(target, set()).update(rules)
    return table


# --------------------------------------------------------------------- rules
class Rule:
    """Base class: subclass, set ``name``/``description``, implement
    :meth:`check`, decorate with :func:`register`."""

    name: str = ""
    description: str = ""
    #: "module" rules see one file at a time; "project" rules (subclass
    #: :class:`ProjectRule`) see the whole-program call graph
    scope: str = "module"

    def check(self, module: SourceModule) -> List[Finding]:
        raise NotImplementedError

    def finding(self, module: SourceModule, node: "ast.AST | int", message: str) -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        return Finding(rule=self.name, path=module.path, line=line, message=message)


class ProjectRule(Rule):
    """A rule that inspects the whole program at once, through the call
    graph (``analysis/graph.py``). Subclasses implement
    :meth:`check_project`; ``check`` is a no-op so the per-module loop
    skips them."""

    scope = "project"

    def check(self, module: SourceModule) -> List[Finding]:
        return []

    def check_project(self, project) -> List[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Type[Rule]] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    if not cls.name:
        raise ValueError(f"rule class {cls.__name__} has no name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate rule name {cls.name!r}")
    _REGISTRY[cls.name] = cls
    return cls


def all_rules() -> Dict[str, Type[Rule]]:
    """Name -> rule class, importing the bundled rule pack on first use."""
    from hpbandster_tpu_torch.analysis import rules  # noqa: F401  (side-effect: register)

    return dict(_REGISTRY)


# -------------------------------------------------------------------- runner
def collect_files(
    paths: Sequence[str], exclude_dirs: Iterable[str] = DEFAULT_EXCLUDE_DIRS
) -> Iterator[str]:
    """Yield .py files under ``paths`` deterministically. Explicit file paths
    bypass the exclusion list — that is how the fixture tests scan known-bad
    modules the default walk skips."""
    exclude = set(exclude_dirs)
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames if d not in exclude)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def run(
    paths: Sequence[str],
    rules: Optional[Sequence[str]] = None,
    exclude_dirs: Iterable[str] = DEFAULT_EXCLUDE_DIRS,
    graph_roots: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Run ``rules`` (default: all registered) over ``paths``; returns
    suppression-filtered findings sorted by location.

    Module-scope rules see exactly the files under ``paths``. Project-scope
    rules see the whole-program call graph built over ``graph_roots``
    (default: the same ``paths``) *plus* ``paths``, but only report
    findings whose primary location is inside ``paths`` — that split is
    what makes ``--changed`` mode sound: a pre-commit hook scans two files
    against the full graph and still sees every interprocedural finding
    entered from them.

    Unreadable/unparseable files surface as ``parse-error`` findings rather
    than crashing the pass: a syntax error must fail the gate, not hide."""
    from hpbandster_tpu_torch.analysis import graph as graph_mod

    registry = all_rules()
    if rules is None:
        selected = [cls() for cls in registry.values()]
    else:
        unknown = [r for r in rules if r not in registry]
        if unknown:
            raise KeyError(f"unknown rule(s): {', '.join(unknown)}")
        selected = [registry[r]() for r in rules]
    module_rules = [r for r in selected if r.scope == "module"]
    project_rules = [r for r in selected if r.scope == "project"]

    findings: List[Finding] = []
    # absolute paths throughout: the process-wide module cache and the
    # project tables key on them, so a relative and an absolute spelling
    # of one file must collapse to one parse
    paths = [os.path.abspath(p) for p in paths]
    # a typo'd path must trip the gate, not scan zero files and pass
    for path in paths:
        if not os.path.exists(path):
            findings.append(
                Finding("parse-error", path, 1, "path does not exist — nothing was scanned")
            )
    report_files = list(collect_files(paths, exclude_dirs))
    for path in report_files:
        try:
            module = graph_mod.load_module(path)
        except (OSError, SyntaxError, ValueError) as e:
            findings.append(
                Finding("parse-error", path, getattr(e, "lineno", None) or 1, repr(e))
            )
            continue
        for rule in module_rules:
            for f in rule.check(module):
                if not module.is_suppressed(f.rule, f.line):
                    findings.append(f)

    if project_rules:
        graph_files = list(report_files)
        if graph_roots is not None:
            graph_files.extend(
                collect_files([os.path.abspath(p) for p in graph_roots], exclude_dirs)
            )
        project = graph_mod.get_project(graph_files)
        report_set = {os.path.abspath(p) for p in report_files}
        for rule in project_rules:
            for f in rule.check_project(project):
                if os.path.abspath(f.path) not in report_set:
                    continue
                if _project_finding_suppressed(project, f):
                    continue
                findings.append(f)

    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


def _project_finding_suppressed(project, f: Finding) -> bool:
    """A two-location finding is muted by a directive at either end."""
    module = project.modules.get(os.path.abspath(f.path))
    if module is not None and module.is_suppressed(f.rule, f.line):
        return True
    if f.related_path is not None:
        related = project.modules.get(os.path.abspath(f.related_path))
        if related is not None and related.is_suppressed(f.rule, f.related_line):
            return True
    return False


def format_report(findings: Sequence[Finding]) -> str:
    if not findings:
        return "graftlint: clean"
    lines = [str(f) for f in findings]
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    summary = ", ".join(f"{n}× {r}" for r, n in sorted(by_rule.items()))
    lines.append(f"graftlint: {len(findings)} finding(s) ({summary})")
    return "\n".join(lines)
