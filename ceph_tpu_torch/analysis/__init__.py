"""torchlint — the port's static analysis of its hot paths, plus the
runtime guard that measures what the rules claim.

Static half (AST, nothing imported from the linted code).  The rules
keep the reference linter's codes where they keep its meaning:

====  ========================  ============================================
J003  host-sync-in-loop         .item()/.cpu()/.tolist()/.numpy(),
                                bool/int/float of a tensor, torch.nonzero,
                                torch.cuda.synchronize (or a local helper
                                that makes one) in host loops of hot modules
J008  rank-divergent-control-   branching on dist.get_rank()/a mesh's rank/
      flow                      pid/wall clock on a path that runs a
                                torch.distributed or Mesh collective
J009  nondeterministic-         unordered set iteration building ordered
      iteration                 output (appends, journal events, yields)
J010  wall-clock-in-vclock-     time.time()/perf_counter() inside
      domain                    VirtualClock-domain modules
J011  unseeded-randomness       default_rng()/Random() with no seed, the
                                global random.*/np.random.* functions,
                                torch sampling without generator=,
                                torch.manual_seed
J016  durable-io-crash-         replace without fsync/dir-fsync, append
      consistency               without torn-tail repair, in durable
                                modules (checkpoint/flight/traceexport)
J018  consumed-buffer-reuse     reading an argument after passing it to a
                                call that consumes it (stripe_buffer_step,
                                or a ``consumes=`` docstring contract)
====  ========================  ============================================

Runtime half (:mod:`.runtime_guard`): builds, kernel calls and host
reads counted on a live run, ``CompileBudget``, and the bucket, fsync
and rank guards behind the ``debug_*`` knobs.

Suppress a finding with ``# torchlint: disable=J00x`` on (or directly
above) the flagged line, with the reason beside it.
"""

from .findings import RULES, Finding, Suppressions
from .runner import (
    DURABLE_SEGMENTS,
    HOT_SEGMENTS,
    VCLOCK_SEGMENTS,
    LintResult,
    is_durable,
    is_hot,
    is_vclock,
    iter_py_files,
    lint_fields,
    lint_paths,
    lint_source,
)
from .runtime_guard import (
    CompileBudget,
    CompileCounter,
    FsyncAudit,
    FsyncAuditError,
    GuardStats,
    LaunchCounter,
    RankDivergenceError,
    RankStalledError,
    TransferCounter,
    UnbucketedShapeError,
    assert_bucketed,
    assert_no_recompile,
    assert_rank_identical,
    bucket_checks_enabled,
    fsync_audit_enabled,
    is_pow2,
    rank_checks_enabled,
    rank_fingerprint,
    track,
)

__all__ = [
    "RULES",
    "Finding",
    "Suppressions",
    "DURABLE_SEGMENTS",
    "HOT_SEGMENTS",
    "VCLOCK_SEGMENTS",
    "LintResult",
    "is_durable",
    "is_hot",
    "is_vclock",
    "iter_py_files",
    "lint_fields",
    "lint_paths",
    "lint_source",
    "CompileBudget",
    "CompileCounter",
    "FsyncAudit",
    "FsyncAuditError",
    "GuardStats",
    "LaunchCounter",
    "RankDivergenceError",
    "RankStalledError",
    "TransferCounter",
    "UnbucketedShapeError",
    "assert_bucketed",
    "assert_no_recompile",
    "assert_rank_identical",
    "bucket_checks_enabled",
    "fsync_audit_enabled",
    "is_pow2",
    "rank_checks_enabled",
    "rank_fingerprint",
    "track",
]
