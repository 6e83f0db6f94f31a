"""torchlint's finding model: rule registry, findings, suppressions.

A finding is one (rule, file, line) diagnostic.  Suppression follows
the flake8/pylint convention, scoped to this tool's namespace::

    x = t.item()  # torchlint: disable=J003
    # torchlint: disable=J003,J009   <- standalone: applies to next line
    for k in keys:
        ...

``disable=all`` silences every rule for the line.  Suppressions are
parsed from the raw source (comments never reach the AST), so the
runner reports *which* suppressions actually fired: one that silences
nothing is a dead suppression, which the CLI's ``--baseline`` mode and
the clean-tree test refuse.

The rules keep the reference linter's codes where they keep its
meaning; the ones that have no meaning in eager PyTorch are not ported
(ROADMAP, "Not ported on purpose").
"""

from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field

#: rule id -> (title, rationale shown in --explain / README)
RULES: dict[str, tuple[str, str]] = {
    "J003": (
        "host-sync-in-loop",
        "A device->host read inside a host loop of a hot module — "
        "`.item()`, `.cpu()`, `.tolist()`, `.numpy()`, `bool(t)`/`int(t)`/"
        "`float(t)` on a tensor, `torch.nonzero` (its size is data), or "
        "`torch.cuda.synchronize()` — waits for the card every "
        "iteration: the next launch cannot be queued until the read "
        "returns.  Read once after the loop, keep the loop's decision on "
        "the device, or suppress with the reason the read is needed.",
    ),
    "J008": (
        "rank-divergent-control-flow",
        "Branching on rank-local state — `dist.get_rank()`, a mesh's "
        "`rank`/`axis_index()`, the pid or hostname, the wall clock — on "
        "a path that runs a `torch.distributed` or `Mesh` collective is "
        "the classic deadlock: the ranks that take the other branch never "
        "enter the collective the rest wait in.  Make the predicate "
        "rank-identical, or keep collectives out of both branches.",
    ),
    "J009": (
        "nondeterministic-iteration",
        "Iterating an unordered set to build ordered output (appends, "
        "journal events, yields) gives each rank — and each "
        "PYTHONHASHSEED — its own ordering, so serialized state and "
        "collective operands silently diverge across ranks.  Iterate "
        "sorted(...) instead (dict iteration is insertion-ordered and "
        "fine when the insertions themselves are deterministic).",
    ),
    "J010": (
        "wall-clock-in-vclock-domain",
        "time.time()/perf_counter() inside the VirtualClock domain "
        "(recovery/chaos/liveness/workload) mixes host wall time into "
        "simulated time: results stop being reproducible and ranks "
        "disagree on timelines.  Use the VirtualClock (clock.now()) "
        "for simulated time; real-rate measurement sites must carry a "
        "justified suppression.",
    ),
    "J011": (
        "unseeded-randomness",
        "np.random.default_rng() / random.Random() with no seed, the "
        "global random.*/np.random.* functions, torch's sampling "
        "functions (`torch.rand*`, `randint`, `randperm`, `normal`, "
        "`bernoulli`, `multinomial`, the in-place `.uniform_()` family) "
        "without `generator=`, and `torch.manual_seed` (which reseeds "
        "every user of the global generator at once) make workloads "
        "unreproducible and rank-divergent.  Thread an explicit seed: "
        "`torch.Generator(device).manual_seed(seed)` passed as "
        "`generator=`.",
    ),
    "J016": (
        "durable-io-crash-consistency",
        "A durable-write module (checkpoint/flight/traceexport) "
        "violating the commit discipline: writing a tmp file and "
        "os.replace-ing it without an os.fsync (contents can vanish "
        "across the rename), os.replace without a directory fsync (the "
        "rename itself is not durable), or opening a JSONL in append "
        "mode without repairing a torn tail first (a crash-torn final "
        "line glues onto the new record and corrupts both).  Follow the "
        "write -> flush -> fsync -> os.replace -> dir-fsync -> "
        "repaired-append chain checkpoint.py's save() documents.",
    ),
    "J018": (
        "consumed-buffer-reuse",
        "Reading an argument after passing it to a call that consumes it "
        "— `ec/online.py::stripe_buffer_step`'s buffer, or any parameter "
        "a `consumes=` docstring contract names: the callee updates the "
        "buffer in place, so the name no longer holds the values it held "
        "before the call.  Rebind the name to the call's result, or pass "
        "a `.clone()` where the old buffer is read again.",
    ),
}

#: the marker a suppression comment carries
MARKER = "torchlint"

_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*disable=([A-Za-z0-9_,\s]+?)\s*(?:#|$)"
)


@dataclass(frozen=True)
class Finding:
    """One diagnostic, pre-suppression."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{tag}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "suppressed": self.suppressed,
            "name": RULES.get(self.rule, ("", ""))[0],
        }


@dataclass
class Suppressions:
    """Per-file suppression map parsed from raw source lines."""

    by_line: dict[int, frozenset[str]] = field(default_factory=dict)
    used: set[int] = field(default_factory=set)

    @classmethod
    def parse(cls, source: str) -> "Suppressions":
        by_line: dict[int, frozenset[str]] = {}

        def add(line: int, text: str) -> None:
            m = _SUPPRESS_RE.search(text)
            if not m:
                return
            codes = frozenset(
                c.strip().upper() for c in m.group(1).split(",") if c.strip()
            )
            if codes:
                by_line[line] = codes

        # tokenize so a suppression *example* inside a docstring is not
        # a suppression; fall back to raw lines when the source does
        # not tokenize
        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    add(tok.start[0], tok.string)
        except (tokenize.TokenizeError, IndentationError, SyntaxError, ValueError):
            for i, raw in enumerate(source.splitlines(), start=1):
                add(i, raw)
        return cls(by_line=by_line)

    def _match(self, line: int, rule: str) -> int | None:
        """The suppressing line for (line, rule), if any.

        A comment suppresses its own line; a standalone comment line
        also suppresses the line after it.
        """
        for cand in (line, line - 1):
            codes = self.by_line.get(cand)
            if codes and (rule in codes or "ALL" in codes):
                return cand
        return None

    def apply(self, findings: list[Finding]) -> list[Finding]:
        """Mark suppressed findings; record which comments fired."""
        out = []
        for f in findings:
            hit = self._match(f.line, f.rule)
            if hit is not None:
                self.used.add(hit)
                f = Finding(f.rule, f.path, f.line, f.col, f.message, suppressed=True)
            out.append(f)
        return out

    def unused(self) -> list[int]:
        return sorted(set(self.by_line) - self.used)
