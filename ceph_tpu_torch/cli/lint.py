"""``python -m ceph_tpu_torch.cli.lint`` — run torchlint over the tree.

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage/IO error; in
``--baseline`` mode, 3 when findings NOT in the baseline appear (the
CI-blocking condition) and 4 when the only problem is dead
suppressions (every ``# torchlint: disable`` must still silence a real
finding).

::

    python -m ceph_tpu_torch.cli.lint ceph_tpu_torch/                  # text report
    python -m ceph_tpu_torch.cli.lint --format=json ceph_tpu_torch/    # machine-readable
    python -m ceph_tpu_torch.cli.lint --format=github ceph_tpu_torch/  # CI annotations
    python -m ceph_tpu_torch.cli.lint --select J003,J018 ceph_tpu_torch/ec
    python -m ceph_tpu_torch.cli.lint --explain J003
    python -m ceph_tpu_torch.cli.lint --write-baseline lint.json ceph_tpu_torch/
    python -m ceph_tpu_torch.cli.lint --baseline lint.json ceph_tpu_torch/

``--format=github`` emits one GitHub Actions workflow command per
active finding (``::error file=...,line=...``), so a CI step running
the linter annotates the offending lines in the PR diff directly.
``--json`` stays as an alias for ``--format=json``.

``--write-baseline FILE`` snapshots the current active findings as
per-(path, rule) counts; ``--baseline FILE`` then fails only on *new*
findings — a (path, rule) whose active count exceeds the snapshot —
so an adopted-with-debt tree can still gate regressions.  Baselines
are count-based rather than line-based on purpose: unrelated edits
move line numbers, but a count bump in one file under one rule is a
genuinely new instance.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..analysis import RULES, LintResult, lint_paths
from ..analysis.runner import package_dir

#: exit codes (also importable by tests)
EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2
EXIT_NEW_FINDINGS = 3
EXIT_DEAD_SUPPRESSIONS = 4

_BASELINE_VERSION = 1


def _baseline_counts(res: LintResult) -> dict[str, int]:
    """Active findings keyed ``path::rule`` -> count."""
    counts: dict[str, int] = {}
    for f in res.active:
        key = f"{f.path}::{f.rule}"
        counts[key] = counts.get(key, 0) + 1
    return counts


def write_baseline(path: str, res: LintResult) -> None:
    doc = {
        "tool": "torchlint-baseline",
        "version": _BASELINE_VERSION,
        "counts": dict(sorted(_baseline_counts(res).items())),
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def load_baseline(path: str) -> dict[str, int]:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("tool") != "torchlint-baseline":
        raise ValueError(f"{path}: not a torchlint baseline file")
    return {str(k): int(v) for k, v in doc.get("counts", {}).items()}


def diff_baseline(
    res: LintResult, baseline: dict[str, int]
) -> tuple[list, list[str]]:
    """(new findings, retired keys) vs a baseline snapshot.

    New = the last N findings of any ``path::rule`` group whose active
    count exceeds its baselined count (line numbers are unstable;
    counts are the contract).  Retired = baselined keys now at zero —
    reported so the baseline can be re-snapshotted smaller.
    """
    groups: dict[str, list] = {}
    for f in res.active:
        groups.setdefault(f"{f.path}::{f.rule}", []).append(f)
    new = []
    for key, fs in sorted(groups.items()):
        allowed = baseline.get(key, 0)
        if len(fs) > allowed:
            new.extend(fs[allowed:])
    retired = sorted(k for k in baseline if k not in groups)
    return new, retired


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="lint",
        description="torchlint: host-sync, rank and ownership static analysis of the port",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files/directories to lint (default: the "
                        "ceph_tpu_torch package)")
    p.add_argument("--format", choices=("text", "json", "github"),
                   default=None, dest="fmt",
                   help="report format: human text (default), one JSON "
                        "document, or GitHub Actions ::error annotations")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="alias for --format=json")
    p.add_argument("--select", metavar="RULES",
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--show-suppressed", action="store_true",
                   help="also list suppressed findings in the text report")
    p.add_argument("--show-unused", action="store_true",
                   help="report suppression comments that silenced nothing")
    p.add_argument("--explain", metavar="RULE",
                   help="print the rationale for one rule id and exit")
    p.add_argument("--baseline", metavar="FILE",
                   help="compare against a findings snapshot: exit 3 on "
                        "findings not in the baseline, 4 when only dead "
                        "suppressions remain, 0 otherwise")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="snapshot current active findings to FILE and "
                        "exit 0")
    args = p.parse_args(argv)

    if args.baseline and args.write_baseline:
        print("--baseline and --write-baseline are mutually exclusive",
              file=sys.stderr)
        return EXIT_USAGE

    if args.explain:
        rid = args.explain.upper()
        if rid not in RULES:
            print(f"unknown rule {rid}; known: {', '.join(sorted(RULES))}",
                  file=sys.stderr)
            return EXIT_USAGE
        name, why = RULES[rid]
        print(f"{rid} ({name})\n\n{why}")
        return EXIT_CLEAN

    select = None
    if args.select:
        select = frozenset(s.strip().upper() for s in args.select.split(","))
        unknown = select - set(RULES)
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}; "
                  f"known: {', '.join(sorted(RULES))}", file=sys.stderr)
            return EXIT_USAGE

    paths = args.paths or [package_dir()]
    missing = [p_ for p_ in paths if not os.path.exists(p_)]
    if missing:
        print(f"no such path(s): {', '.join(missing)}", file=sys.stderr)
        return EXIT_USAGE

    fmt = args.fmt or ("json" if args.as_json else "text")

    res = lint_paths(paths, select=select)

    if args.write_baseline:
        try:
            write_baseline(args.write_baseline, res)
        except OSError as e:
            print(f"cannot write baseline: {e}", file=sys.stderr)
            return EXIT_USAGE
        print(f"torchlint: baselined {len(res.active)} finding(s) from "
              f"{res.files} file(s) -> {args.write_baseline}")
        return EXIT_USAGE if res.errors else EXIT_CLEAN

    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"cannot read baseline: {e}", file=sys.stderr)
            return EXIT_USAGE
        new, retired = diff_baseline(res, baseline)
        for f in new:
            print(f.render())
        for key in retired:
            print(f"torchlint: baseline entry retired (now clean): {key}")
        for path, line in res.unused_suppressions:
            print(f"{path}:{line}: unused `torchlint: disable` comment")
        print(f"torchlint: {len(new)} new finding(s) vs baseline, "
              f"{len(res.active)} total active, "
              f"{len(res.unused_suppressions)} dead suppression(s) in "
              f"{res.files} file(s)")
        if res.errors:
            return EXIT_USAGE
        if new:
            return EXIT_NEW_FINDINGS
        if res.unused_suppressions:
            return EXIT_DEAD_SUPPRESSIONS
        return EXIT_CLEAN

    if fmt == "json":
        print(json.dumps(res.to_json(), indent=1, sort_keys=True))
    elif fmt == "github":
        for f in res.active:
            name = RULES[f.rule][0]
            # workflow-command escaping: the message rides in the data
            # section, where %, CR and LF must be %-encoded
            msg = (f.message.replace("%", "%25")
                   .replace("\r", "%0D").replace("\n", "%0A"))
            print(f"::error file={f.path},line={f.line},col={f.col},"
                  f"title=torchlint {f.rule} ({name})::{msg}")
        print(f"torchlint: {len(res.active)} finding(s) in {res.files} "
              "file(s)", file=sys.stderr)
    else:
        print(res.render_text(show_suppressed=args.show_suppressed))
        if args.show_unused and res.unused_suppressions:
            for path, line in res.unused_suppressions:
                print(f"{path}:{line}: unused `torchlint: disable` comment")
    if res.errors:
        return EXIT_USAGE
    return EXIT_FINDINGS if res.active else EXIT_CLEAN


if __name__ == "__main__":
    sys.exit(main())
