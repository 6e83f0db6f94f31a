"""torchlint driver: walk files, run the checkers, format reports.

The module scoping mirrors the rule definitions: J003's host-sync rule
only fires in the hot data-path packages (``HOT_SEGMENTS``), J010's
wall-clock rule only in VirtualClock-domain packages
(``VCLOCK_SEGMENTS``), J016's crash-consistency rule only in
durable-write modules (``DURABLE_SEGMENTS``); every other rule applies
everywhere.  ``lint_source`` is the unit-test entry (fixtures pass
source strings), ``lint_paths`` the CLI/test-gate entry (it first
collects every ``consumes=`` contract of the files, so J018 sees a
consuming callee defined in another module), and ``lint_fields``
flattens per-rule counts for a benchmark's JSON line.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from .checkers import Analyzer, collect_consumers
from .findings import MARKER, RULES, Finding, Suppressions

#: path segments whose modules are "hot" for J003 (device data path +
#: the CLI progress paths that drive it)
HOT_SEGMENTS = frozenset(
    {"crush", "ec", "recovery", "osdmap", "balancer", "cli", "core",
     "parallel", "obs", "workload", "liveness", "superstep", "fleet",
     "durability", "reconcile", "online", "writepath", "flight",
     "traceexport"}
)

#: path segments whose modules run on the VirtualClock (J010): real
#: wall-clock reads there need a justified suppression
VCLOCK_SEGMENTS = frozenset(
    {"recovery", "workload", "chaos", "liveness", "superstep", "fleet",
     "durability", "reconcile", "online", "writepath", "flight",
     "traceexport"}
)

#: path segments whose modules perform durable writes (J016): the
#: crash-consistency commit discipline is checked there
DURABLE_SEGMENTS = frozenset({"checkpoint", "flight", "traceexport"})


@dataclass
class LintResult:
    """Findings for a set of files, suppression-aware."""

    findings: list[Finding] = field(default_factory=list)
    files: int = 0
    errors: list[str] = field(default_factory=list)
    unused_suppressions: list[tuple[str, int]] = field(default_factory=list)

    @property
    def active(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if f.suppressed]

    def render_text(self, show_suppressed: bool = False) -> str:
        lines = [f.render() for f in self.findings if show_suppressed or not f.suppressed]
        lines.extend(f"{MARKER}: error: {e}" for e in self.errors)
        n = len(self.active)
        lines.append(
            f"{MARKER}: {n} finding{'s' if n != 1 else ''} "
            f"({len(self.suppressed)} suppressed) in {self.files} file"
            f"{'s' if self.files != 1 else ''}"
        )
        return "\n".join(lines)

    def by_rule(self) -> dict[str, dict[str, int]]:
        """Per-rule active/suppressed counts (every rule present)."""
        out = {rule: {"active": 0, "suppressed": 0} for rule in sorted(RULES)}
        for f in self.findings:
            slot = out.setdefault(f.rule, {"active": 0, "suppressed": 0})
            slot["suppressed" if f.suppressed else "active"] += 1
        return out

    def to_json(self) -> dict:
        return {
            "tool": MARKER,
            "files": self.files,
            "findings": [f.to_json() for f in self.findings],
            "n_active": len(self.active),
            "n_suppressed": len(self.suppressed),
            "by_rule": self.by_rule(),
            "errors": list(self.errors),
            "unused_suppressions": [{"path": p, "line": ln} for p, ln in self.unused_suppressions],
        }


def _segments(path: str) -> list[str]:
    parts = os.path.normpath(path).split(os.sep)
    if parts and parts[-1].endswith(".py"):
        # module names count as segments (``superstep`` is hot wherever
        # the file lives)
        parts[-1] = parts[-1][:-3]
    return parts


def is_hot(path: str) -> bool:
    return any(seg in HOT_SEGMENTS for seg in _segments(path))


def is_vclock(path: str) -> bool:
    return any(seg in VCLOCK_SEGMENTS for seg in _segments(path))


def is_durable(path: str) -> bool:
    return any(seg in DURABLE_SEGMENTS for seg in _segments(path))


def lint_source(
    source: str,
    path: str = "<string>",
    hot: bool = True,
    select: frozenset[str] | None = None,
    vclock: bool = True,
    durable: bool = True,
    consumers: dict | None = None,
) -> LintResult:
    """Lint one source string (the fixture/test entry point)."""
    res = LintResult(files=1)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        res.errors.append(f"{path}: syntax error: {e.msg} (line {e.lineno})")
        return res
    findings = Analyzer(path, tree, hot=hot, vclock=vclock, durable=durable,
                        consumers=consumers).run()
    if select is not None:
        findings = [f for f in findings if f.rule in select]
    supp = Suppressions.parse(source)
    res.findings = supp.apply(findings)
    res.unused_suppressions = [(path, ln) for ln in supp.unused()]
    return res


def iter_py_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in {"__pycache__", ".git", "build", "_build"})
                out.extend(os.path.join(root, f) for f in sorted(files) if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


def lint_paths(paths: list[str], select: frozenset[str] | None = None) -> LintResult:
    """Lint every ``.py`` under ``paths`` (the CLI/gate entry point)."""
    res = LintResult()
    sources: list[tuple[str, str]] = []
    consumers: dict = {}
    for path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            res.errors.append(f"{path}: unreadable: {e}")
            continue
        sources.append((path, source))
        try:
            consumers.update(collect_consumers(ast.parse(source, filename=path)))
        except SyntaxError:
            pass  # reported by lint_source below
    for path, source in sources:
        one = lint_source(source, path=path, hot=is_hot(path), select=select,
                          vclock=is_vclock(path), durable=is_durable(path),
                          consumers=consumers)
        res.files += 1
        res.findings.extend(one.findings)
        res.errors.extend(one.errors)
        res.unused_suppressions.extend(one.unused_suppressions)
    return res


def package_dir() -> str:
    """The ``ceph_tpu_torch`` package: the default lint target."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_fields(paths: list[str] | None = None) -> dict:
    """Flat ``lint_*`` counters for a benchmark's JSON line: total
    files/active/suppressed plus per-rule counts, over the
    ``ceph_tpu_torch`` package by default (every value is an int)."""
    res = lint_paths(paths or [package_dir()])
    out = {
        "lint_files": res.files,
        "lint_active": len(res.active),
        "lint_suppressed": len(res.suppressed),
        "lint_unused_suppressions": len(res.unused_suppressions),
    }
    for rule, counts in res.by_rule().items():
        out[f"lint_{rule}_active"] = counts["active"]
        out[f"lint_{rule}_suppressed"] = counts["suppressed"]
    return out
