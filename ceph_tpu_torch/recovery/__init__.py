"""Failure-driven recovery: fault injection -> peering -> batched repair.

The counterpart of the reference package's ``recovery`` subsystem, on
one device:

- :mod:`~ceph_tpu_torch.recovery.failure`  — inject OSD/host/rack
  down/out events (and flapping) as ordinary epoch-stamped
  ``Incremental``s (a copy of the reference's).
- :mod:`~ceph_tpu_torch.recovery.peering`  — one batched device pass
  maps both epochs, diffs up/acting and classifies every PG.
- :mod:`~ceph_tpu_torch.recovery.planner`  — degraded PGs grouped by
  survivor bitmask; one host matrix inversion per unique erasure
  pattern (a copy of the reference's).
- :mod:`~ceph_tpu_torch.recovery.executor` — one batched device decode
  launch per pattern (K4 table product, K6 XOR schedule or K5 dense
  bitmatrix), under a token-bucket bandwidth throttle, with perf
  counters, profiler spans and Prometheus wired in.

``recover_pool(m_prev, m_cur, pool_id, codec, read_shard,
device="cuda")`` runs the whole pipeline.
"""

from .executor import (
    RecoveryExecutor,
    RecoveryResult,
    TokenBucket,
    recover_pool,
    recovery_counters,
)
from .failure import (
    FailureSpec,
    FlapRecord,
    build_incremental,
    flap,
    inject,
    normalize,
    parse_spec,
    resolve_targets,
)
from .peering import (
    PG_STATE_BACKFILL,
    PG_STATE_CLEAN,
    PG_STATE_DEGRADED,
    PG_STATE_INACTIVE,
    PG_STATE_REMAPPED,
    PG_STATE_UNDERSIZED,
    PeeringEngine,
    PeeringResult,
    classify_rows,
    peer_pool,
)
from .planner import PatternGroup, RecoveryPlan, build_plan, invalidated_groups

__all__ = [
    "FailureSpec",
    "FlapRecord",
    "PG_STATE_BACKFILL",
    "PG_STATE_CLEAN",
    "PG_STATE_DEGRADED",
    "PG_STATE_INACTIVE",
    "PG_STATE_REMAPPED",
    "PG_STATE_UNDERSIZED",
    "PatternGroup",
    "PeeringEngine",
    "PeeringResult",
    "RecoveryExecutor",
    "RecoveryPlan",
    "RecoveryResult",
    "TokenBucket",
    "build_incremental",
    "build_plan",
    "classify_rows",
    "flap",
    "inject",
    "invalidated_groups",
    "normalize",
    "parse_spec",
    "peer_pool",
    "recover_pool",
    "recovery_counters",
    "resolve_targets",
]
