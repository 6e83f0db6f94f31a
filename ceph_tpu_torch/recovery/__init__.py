"""Failure-driven recovery: fault injection -> peering -> batched repair.

The counterpart of the reference package's ``recovery`` subsystem, on
one device or the ranks of a mesh:

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
- :mod:`~ceph_tpu_torch.recovery.fleet` — scenario fleets: N seeded
  chaos timelines advanced together along a leading lane axis.
- :mod:`~ceph_tpu_torch.recovery.durability` — Monte Carlo durability
  (survival, MTTDL, availability, time to zero degraded) over a fleet.
- :mod:`~ceph_tpu_torch.recovery.reconcile` — divergent rank views in
  one process, merged by lattice joins under a stall-tolerant protocol.
- :mod:`~ceph_tpu_torch.recovery.sharded` — pattern-group decodes split
  over the ranks of a mesh (K4 on each rank's byte slice).
- :mod:`~ceph_tpu_torch.recovery.dispatch` — the fault-tolerant
  work-stealing dispatcher: sub-shards over a list of chips (devices,
  possibly one device repeated), hedging, retry, conviction, and
  :class:`~ceph_tpu_torch.recovery.dispatch.ChipLostError`.
- :mod:`~ceph_tpu_torch.recovery.checkpoint` — crash-consistent
  snapshots in the reference's file format (lane CRCs through K8), a
  write-ahead log, and the checkpointed epoch loop, fleet and divergent
  runs that resume bit-equal after a kill.

``recover_pool(m_prev, m_cur, pool_id, codec, read_shard,
device="cuda")`` runs the whole pipeline once;
``SupervisedRecovery(codec, ChaosEngine(m, build_scenario(name, m),
device=...), device=...).run(m_prev, pool_id, read_shard)`` runs it
under a chaos timeline; ``run_epochs(m, timeline, n_epochs,
device=...)`` runs the epoch loop; ``FleetDriver(m, device=...)
.run_fleet(n_epochs, timelines)`` a fleet, and ``DivergentDriver(m,
timeline, n_ranks, device=...).run(n_epochs)`` divergent ranks.
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
from .checkpoint import (
    CheckpointError,
    CheckpointStore,
    CrashPoint,
    SimulatedCrash,
    WriteAheadLog,
    checkpointed_fleet,
    checkpointed_superstep,
    crash_points,
    diff_states,
    restore_divergent,
    save_divergent,
    strip_crash_specs,
)
from .dispatch import (
    ChipFaultSchedule,
    ChipLostError,
    DispatchStats,
    WorkStealingDispatcher,
    strip_chip_specs,
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
from .fleet import (
    FleetDriver,
    FleetSeries,
    FleetTape,
    run_fleet,
    sample_timelines,
    stack_tapes,
)
from .durability import DurabilityEstimate, estimate_durability
from .reconcile import (
    DivergentDriver,
    DivergentResult,
    RankReconciler,
    RankSchedule,
    RankStalledError,
    RoundResult,
    ViewMerger,
    merge_stacked,
    merge_views,
    normalize_view,
    rank_schedule,
    rank_view_timeline,
    strip_rank_specs,
    view_fingerprint,
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
    sharded_scrub_step,
)
from .sharded import ShardedDecoder, sharded_decode_step

__all__ = [
    "ChipFaultSchedule",
    "ChipLostError",
    "DispatchStats",
    "WorkStealingDispatcher",
    "strip_chip_specs",
    "ShardedDecoder",
    "sharded_decode_step",
    "sharded_scrub_step",
    "CheckpointError",
    "CheckpointStore",
    "CrashPoint",
    "SimulatedCrash",
    "WriteAheadLog",
    "checkpointed_fleet",
    "checkpointed_superstep",
    "crash_points",
    "diff_states",
    "restore_divergent",
    "save_divergent",
    "strip_crash_specs",
    "ACTIONS",
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
    "DivergentDriver",
    "DivergentResult",
    "DurabilityEstimate",
    "EpochDriver",
    "EpochSeries",
    "EventTape",
    "FLAG_NAMES",
    "FailureSpec",
    "FlapRecord",
    "FleetDriver",
    "FleetSeries",
    "FleetTape",
    "KNOWN_FLAGS",
    "KNOWN_SCOPES",
    "LaunchError",
    "LivenessDetector",
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
    "PatternGroup",
    "PeeringEngine",
    "PeeringResult",
    "RankReconciler",
    "RankSchedule",
    "RankStalledError",
    "RecoveryExecutor",
    "RecoveryPlan",
    "RecoveryResult",
    "RoundResult",
    "SCENARIOS",
    "ScrubResult",
    "Scrubber",
    "SupervisedRecovery",
    "SupervisedResult",
    "TokenBucket",
    "UnknownSpecKeyError",
    "VerifyReport",
    "ViewMerger",
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
    "estimate_durability",
    "flap",
    "heartbeat_step",
    "inject",
    "invalidated_groups",
    "mask_to_shards",
    "merge_stacked",
    "merge_views",
    "normalize",
    "normalize_view",
    "osds_in_subtree",
    "parse_spec",
    "peer_pool",
    "rank_schedule",
    "rank_view_timeline",
    "recover_pool",
    "recovery_counters",
    "resolve_targets",
    "run_epochs",
    "run_fleet",
    "sample_timelines",
    "scrub_counters",
    "scrub_step",
    "stack_tapes",
    "strip_rank_specs",
    "view_fingerprint",
]
