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
  counters, profiler spans and Prometheus wired in; the supervised
  variant (:class:`~ceph_tpu_torch.recovery.executor.SupervisedRecovery`)
  survives epochs advancing mid-plan.
- :mod:`~ceph_tpu_torch.recovery.chaos`    — timeline engine driving
  multi-epoch failure schedules (flapping, cascades, mid-repair loss,
  silent bit rot) on a seeded virtual clock (a copy of the
  reference's).
- :mod:`~ceph_tpu_torch.recovery.scrub`    — batched CRC32C scrub on
  the device (kernel K8, ``csrc/scrub.cu``; inconsistent-PG detection)
  and decode-verify (checksums recomputed before any repair commits).
- :mod:`~ceph_tpu_torch.recovery.liveness` — mon-style failure
  detection on the virtual clock: heartbeat grace, the markdown flap
  damper, down→out policy, and the cluster flag set.
- :mod:`~ceph_tpu_torch.recovery.superstep` — the epoch loop: an event
  tape, liveness, peering (with the dirty-set ladder), PG states,
  traffic and scrub windows over one resident
  :class:`~ceph_tpu_torch.core.cluster_state.ClusterState`.

``recover_pool(m_prev, m_cur, pool_id, codec, read_shard,
device="cuda")`` runs the whole pipeline once;
``SupervisedRecovery(codec, ChaosEngine(m, build_scenario(name, m),
device=...), device=...).run(m_prev, pool_id, read_shard)`` runs it
under a chaos timeline; ``run_epochs(m, timeline, n_epochs,
device=...)`` runs the epoch loop.
"""

from .chaos import (
    SCENARIOS,
    AppliedChipSpec,
    AppliedCorruption,
    AppliedCrashSpec,
    AppliedEvent,
    AppliedRankSpec,
    ChaosEngine,
    ChaosEvent,
    ChaosTimeline,
    VirtualClock,
    build_scenario,
)
from .executor import (
    LaunchError,
    RecoveryExecutor,
    RecoveryResult,
    SupervisedRecovery,
    SupervisedResult,
    TokenBucket,
    recover_pool,
    recovery_counters,
)
from .failure import (
    ACTIONS,
    KNOWN_SCOPES,
    NET_ACTIONS,
    NET_SCOPES,
    BitrotEvent,
    FailureSpec,
    FlapRecord,
    UnknownSpecKeyError,
    build_incremental,
    flap,
    inject,
    normalize,
    osds_in_subtree,
    parse_spec,
    resolve_targets,
)
from .liveness import (
    KNOWN_FLAGS,
    ClusterFlags,
    Detection,
    LivenessDetector,
    heartbeat_step,
)
from .peering import (
    FLAG_NAMES,
    PG_STATE_BACKFILL,
    PG_STATE_CLEAN,
    PG_STATE_DEGRADED,
    PG_STATE_INACTIVE,
    PG_STATE_INCONSISTENT,
    PG_STATE_REMAPPED,
    PG_STATE_SCRUBBING,
    PG_STATE_UNDERSIZED,
    PeeringEngine,
    PeeringResult,
    classify_rows,
    peer_pool,
)
from .planner import (
    PatternGroup,
    RecoveryPlan,
    build_plan,
    invalidated_groups,
    mask_to_shards,
)
from .superstep import (
    EpochDriver,
    EpochSeries,
    EventTape,
    build_epoch_driver,
    compile_epoch_superstep,
    compile_event_tape,
    epoch_superstep_enabled,
    run_epochs,
)
from .scrub import (
    DecodeVerifier,
    ScrubResult,
    Scrubber,
    VerifyReport,
    apply_bitrot,
    crc32c,
    crc32c_rows,
    crc_rows,
    crc_rows_plain,
    scrub_counters,
    scrub_step,
)

__all__ = [
    "ACTIONS",
    "FLAG_NAMES",
    "KNOWN_FLAGS",
    "KNOWN_SCOPES",
    "NET_ACTIONS",
    "NET_SCOPES",
    "PG_STATE_BACKFILL",
    "PG_STATE_CLEAN",
    "PG_STATE_DEGRADED",
    "PG_STATE_INACTIVE",
    "PG_STATE_INCONSISTENT",
    "PG_STATE_REMAPPED",
    "PG_STATE_SCRUBBING",
    "PG_STATE_UNDERSIZED",
    "SCENARIOS",
    "AppliedChipSpec",
    "AppliedCorruption",
    "AppliedCrashSpec",
    "AppliedEvent",
    "AppliedRankSpec",
    "BitrotEvent",
    "ChaosEngine",
    "ChaosEvent",
    "ChaosTimeline",
    "ClusterFlags",
    "DecodeVerifier",
    "Detection",
    "EpochDriver",
    "EpochSeries",
    "EventTape",
    "FailureSpec",
    "FlapRecord",
    "LaunchError",
    "LivenessDetector",
    "PatternGroup",
    "PeeringEngine",
    "PeeringResult",
    "RecoveryExecutor",
    "RecoveryPlan",
    "RecoveryResult",
    "ScrubResult",
    "Scrubber",
    "SupervisedRecovery",
    "SupervisedResult",
    "TokenBucket",
    "UnknownSpecKeyError",
    "VerifyReport",
    "VirtualClock",
    "apply_bitrot",
    "build_epoch_driver",
    "build_incremental",
    "build_plan",
    "build_scenario",
    "classify_rows",
    "compile_epoch_superstep",
    "compile_event_tape",
    "crc32c",
    "crc32c_rows",
    "crc_rows",
    "crc_rows_plain",
    "epoch_superstep_enabled",
    "flap",
    "heartbeat_step",
    "inject",
    "invalidated_groups",
    "mask_to_shards",
    "normalize",
    "osds_in_subtree",
    "parse_spec",
    "peer_pool",
    "recover_pool",
    "recovery_counters",
    "resolve_targets",
    "run_epochs",
    "scrub_counters",
    "scrub_step",
]
