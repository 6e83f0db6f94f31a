"""Recovery executor: run a repair plan under a bandwidth throttle.

The device work is the planner's promise made real: per pattern group,
the survivor chunks of every PG are concatenated along the byte axis
into one ``[k, n_pgs * chunk]`` operand and pushed through ONE device
launch of the group's repair: K4 (:class:`~ceph_tpu_torch.ec.backend.
TableEncoder`, the GF(2^8) table product) for byte-level groups, the
CSE-shrunk XOR schedule (K6, :class:`~ceph_tpu_torch.ec.schedule.
XorScheduleEncoder`) for bit-level ones — or for every group under
``recovery_xor_schedule=on`` — and the dense bitmatrix product (K5)
under ``off``.  A rack failure on a 1k-OSD map becomes a few dozen
launches instead of thousands of per-PG decode setups.

Robustness comes from the token-bucket throttle (upstream bounds
recovery with ``osd_recovery_max_active`` / ``osd_recovery_sleep``;
here the knob is bytes/s — ``recovery_max_bytes_per_sec`` and
``recovery_burst_bytes`` in :mod:`ceph_tpu_torch.common.config`), so
bulk repair cannot starve client traffic.  Clock and sleep are
injectable for deterministic tests.

Observability: a ``recovery`` :class:`PerfCounters` component tracks
per-phase times (peering / plan / decode), launch and byte counters,
and the degraded-PG gauge — all scrape-able through
:func:`ceph_tpu_torch.common.prometheus.render`; each decode launch is
also a named profiler span (:func:`ceph_tpu_torch.common.tracing.
trace_annotation`).

:class:`SupervisedRecovery` drives the executor under a chaos timeline:
epochs advancing mid-plan, launch retries with seeded backoff, the
scrubber's damage map and decode-verify, the liveness detector's
reporter pool, and the health timeline, journal and op tracker.

With a :class:`~ceph_tpu_torch.parallel.mesh.Mesh`, large byte-level
groups decode split over the ranks (:mod:`~ceph_tpu_torch.recovery.
sharded`: K4 on each rank's slice, the progress counters summed over
the ranks), the supervised loop dispatches windows of up to
``recovery_coschedule_max`` small groups, and under
``recovery_work_stealing`` byte-level groups go through the
work-stealing dispatcher (:mod:`~ceph_tpu_torch.recovery.dispatch`) over
the rank's chips, with its chip faults.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..common.config import Config, global_config
from ..common.perf_counters import PerfCounters, PerfCountersBuilder, registry
from ..common.tracing import timed_block, trace_annotation
from ..ec.backend import TableEncoder
from ..ec.schedule import ScheduleCache, encoder_for_group
from ..osdmap.map import OSDMap
from ..osdmap.mapping import build_pool_state
from .dispatch import ChipFaultSchedule, WorkStealingDispatcher
from .peering import (
    PG_STATE_BACKFILL,
    PG_STATE_DEGRADED,
    PG_STATE_INCONSISTENT,
    PG_STATE_SCRUBBING,
    PeeringEngine,
    PeeringResult,
    peer_pool,
)
from .planner import PatternGroup, RecoveryPlan, build_plan, invalidated_groups
from .scrub import DecodeVerifier
from .sharded import ShardedDecoder


class TokenBucket:
    """Byte-rate throttle; ``rate <= 0`` disables.

    Debt model: a request always proceeds, driving the bucket negative
    if oversized, and the caller sleeps until the debt is refilled —
    so a single burst larger than the bucket is delayed, not deadlocked.
    ``max_debt`` clamps how far negative a pathological burst can drive
    the bucket, bounding the worst-case stall to ``max_debt / rate``
    seconds (default 4x burst; ``recovery_max_debt_bytes`` at the
    executor surface).  ``clock``/``sleep`` are injectable so tests
    advance virtual time.
    """

    def __init__(
        self,
        rate_bytes_per_sec: float,
        burst_bytes: float,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        max_debt: float | None = None,
    ):
        self.rate = float(rate_bytes_per_sec)
        self.burst = max(float(burst_bytes), 1.0)
        self.max_debt = (
            max(float(max_debt), 1.0) if max_debt is not None
            else 4.0 * self.burst
        )
        self._clock = clock
        self._sleep = sleep
        self._tokens = self.burst
        self._last = clock()
        self.waited_s = 0.0

    def take(self, nbytes: int) -> float:
        """Account ``nbytes``; blocks until the rate allows. Returns
        the seconds slept."""
        if self.rate <= 0:
            return 0.0
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate
        )
        self._last = now
        self._tokens = max(self._tokens - nbytes, -self.max_debt)
        if self._tokens >= 0:
            return 0.0
        wait = -self._tokens / self.rate
        self._sleep(wait)
        self._last = self._clock()
        self._tokens = 0.0
        self.waited_s += wait
        return wait


def _build_counters() -> PerfCounters:
    return (
        PerfCountersBuilder("recovery")
        .add_time_avg("l_peering", "whole-cluster peering pass time")
        .add_time_avg("l_plan", "pattern grouping + matrix inversion time")
        .add_time_avg("l_decode", "batched device decode time per launch")
        .add_u64_counter("decode_launches", "device decode launches")
        .add_u64_counter("bytes_recovered", "shard bytes rebuilt")
        .add_u64_counter("shards_rebuilt", "shard chunks rebuilt")
        .add_u64_counter("pgs_recovered", "degraded PGs repaired")
        .add_u64_counter("throttle_waits", "throttle sleep events")
        .add_u64_counter("launch_retries",
                         "decode launches retried after a failure")
        .add_u64_counter("stale_launches",
                         "decode launches discarded: epoch advanced "
                         "mid-flight and killed a source shard")
        .add_u64_counter("plan_revisions",
                         "mid-flight plan revisions (epoch advances "
                         "that invalidated pattern groups)")
        .add_u64_counter("epochs_observed",
                         "map epochs observed during supervised runs")
        .add_u64_counter("sharded_launches",
                         "decode launches routed through the "
                         "mesh-sharded step")
        .add_u64_counter("coscheduled_windows",
                         "supervised scheduling windows that dispatched "
                         "more than one group")
        .add_u64_counter("salvaged_pgs",
                         "PGs committed from a stale launch because "
                         "their own sources all survived the epoch")
        .add_u64_counter("schedule_launches",
                         "decode launches executed as CSE-shrunk XOR "
                         "schedules (bit-level pattern groups)")
        .add_u64_counter("verify_retries",
                         "decode outputs re-derived through the dense "
                         "reference path after checksum verification "
                         "rejected a compiled-schedule launch")
        .add_u64_counter("worksteal_launches",
                         "pattern groups routed through the "
                         "work-stealing dispatcher")
        .add_u64_counter("stolen_subshards",
                         "sub-shards committed by a chip other than "
                         "their static round-robin owner")
        .add_u64_counter("hedged_launches",
                         "overdue sub-shards hedge-redispatched to an "
                         "idle chip")
        .add_u64_counter("chip_convictions",
                         "mesh chips convicted after consecutive "
                         "dispatch deadline misses")
        .add_gauge("degraded_pgs", "degraded PGs in the last plan")
        .add_gauge("unrecoverable_pgs", "PGs below k survivors")
        .add_gauge("failed_pgs",
                   "PGs abandoned after decode-retry exhaustion")
        .create_perf_counters()
    )


def recovery_counters() -> PerfCounters:
    """The process-wide ``recovery`` perf-counter component."""
    return registry().get("recovery") or _build_counters()


@dataclass
class RecoveryResult:
    """What one executor run rebuilt."""

    shards: dict[int, dict[int, np.ndarray]]  # pg -> shard id -> chunk
    launches: int = 0
    bytes_recovered: int = 0
    shards_rebuilt: int = 0
    decode_s: float = 0.0
    throttle_wait_s: float = 0.0
    unrecoverable: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64)
    )
    # mesh-sharded path: launch count plus the byte/shard totals summed
    # over the ranks (zero when no launch routed through the mesh)
    sharded_launches: int = 0
    psum_bytes_rebuilt: int = 0
    psum_shards_rebuilt: int = 0
    # launches that ran as CSE-shrunk XOR schedules (bit-level groups)
    schedule_launches: int = 0
    # work-stealing dispatch (ceph_tpu_torch.recovery.dispatch): groups
    # routed through the dispatcher plus its steal/hedge/conviction
    # telemetry and the per-chip idle fractions (with the static-
    # sharding counterfactual for the same work)
    worksteal_launches: int = 0
    stolen_subshards: int = 0
    hedged_launches: int = 0
    hedge_wasted_bytes: int = 0
    chip_convictions: int = 0
    idle_fraction_per_chip: list[float] = field(default_factory=list)
    static_idle_fraction_per_chip: list[float] = field(default_factory=list)
    # decode-verify: launches re-derived through the dense reference
    # path after the compiled schedule's output failed checksum, and
    # PGs whose rebuilt bytes failed verification on EVERY engine —
    # those are reported, never committed (bad bytes must not land)
    verify_retries: int = 0
    inconsistent_unrecoverable: set[int] = field(default_factory=set)

    @property
    def bytes_per_sec(self) -> float:
        return self.bytes_recovered / self.decode_s if self.decode_s else 0.0


@dataclass
class _Inflight:
    """A dispatched-but-unsynced decode launch.

    ``out`` is a device tensor whose bytes are still in flight (or a
    dispatcher job); :meth:`RecoveryExecutor._finalize_group`
    materializes it.  The supervised loop dispatches a window of these
    back-to-back, then syncs once.
    """

    group: PatternGroup
    out: object  # torch.Tensor
    chunk: int
    t_dispatch: float
    # schedule/bit-level launches: host-side materializer (unpack word
    # rows + trim padding back to [n_missing, width] bytes)
    post: Callable | None = None
    # which decode engine produced the output: "schedule" (compiled
    # XOR), "dense" (bitmatrix reference), "table" (byte LUT).
    # "sharded" (mesh), "worksteal" (dispatcher).  Decode-verify keys
    # its retry policy on this: only a "schedule" miss is a compiler
    # bug worth a quarantine.
    engine: str = "table"
    # mesh-sharded launches: the un-padded width and the (bytes,
    # shards) counters summed over the ranks
    sharded: bool = False
    valid: int | None = None
    counters: tuple | None = None


class RecoveryExecutor:
    """Drive a :class:`RecoveryPlan` through the device codec.

    ``on_decode_launch(group, nbytes)`` fires immediately before each
    device launch — the launch-count hook the tests assert against
    (exactly one call per unique survivor pattern).  With an mclock
    ``arbiter``, recovery bytes admit through its ``"recovery"`` class
    instead of the solo token bucket.

    With a ``mesh`` (every rank runs the same plan), pattern groups
    whose operand moves at least ``recovery_shard_min_bytes`` route
    through the mesh-sharded decode (:class:`~ceph_tpu_torch.recovery.
    sharded.ShardedDecoder`: byte axis split over the ranks, progress
    counters summed); smaller groups stay on the rank's device.  The
    work-stealing dispatcher (``recovery_work_stealing``: ``on``, or
    ``auto`` with more than one CUDA chip) runs byte-level groups over
    ``dispatch_devices`` (default: the rank's device), which may repeat
    one device as virtual chips; its chip ids are ``rank *
    len(dispatch_devices) + i`` of ``size * len(dispatch_devices)``, the
    space ``chip_faults`` specs name.  Without a mesh the behavior is
    the single-device executor's.
    """

    def __init__(
        self,
        codec,
        config: Config | None = None,
        on_decode_launch: Callable[[PatternGroup, int], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        mesh=None,
        arbiter=None,
        chip_faults=None,
        dispatch_seed: int = 0,
        dispatch_devices=None,
        device="cuda",
    ):
        self.codec = codec
        self.device = mesh.device if mesh is not None else resolve_device(device)
        cfg = config or global_config()
        self.arbiter = arbiter
        self.throttle = TokenBucket(
            cfg.get("recovery_max_bytes_per_sec"),
            cfg.get("recovery_burst_bytes"),
            clock=clock,
            sleep=sleep,
            max_debt=cfg.get("recovery_max_debt_bytes"),
        )
        self.on_decode_launch = on_decode_launch
        self.pc = recovery_counters()
        # one table encoder per erasure pattern, reused across runs
        self._encoders: dict[int, TableEncoder] = {}
        # bit-level pattern groups: compiled XOR schedules (or the
        # dense bitmatrix product when the knob is "off"), cached per
        # pattern; "on" forces table groups onto the schedule path too
        # (bit-plane layout)
        self.xor_mode = str(cfg.get("recovery_xor_schedule"))
        self._schedules = ScheduleCache(
            max_entries=int(cfg.get("recovery_schedule_cache_max"))
        )
        # decode-verify seam: a ceph_tpu_torch.recovery.scrub.
        # DecodeVerifier (attached by SupervisedRecovery when a Scrubber
        # is wired in, or directly by tests).  None keeps commits
        # unverified.
        self.verifier = None
        self.retry_max = int(cfg.get("recovery_retry_max"))
        self.mesh = mesh
        self.shard_min_bytes = int(cfg.get("recovery_shard_min_bytes"))
        self._sharded: ShardedDecoder | None = None
        if mesh is not None and bool(cfg.get("recovery_shard_groups")):
            self._sharded = ShardedDecoder(mesh)
        # work-stealing dispatch: "auto" activates only when this rank
        # drives more than one CUDA chip; "on" forces it (tests, and
        # virtual chips on one device)
        chips = [torch.device(d) for d in dispatch_devices] if dispatch_devices else [self.device]
        ws = str(cfg.get("recovery_work_stealing"))
        self._dispatcher: WorkStealingDispatcher | None = None
        if ws == "on" or (ws == "auto" and len(chips) > 1
                          and all(c.type == "cuda" for c in chips)):
            rank, size = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
            chip_ids = [rank * len(chips) + i for i in range(len(chips))]
            faults = chip_faults
            if faults is not None and not isinstance(faults, ChipFaultSchedule):
                faults = ChipFaultSchedule.from_specs(faults, size * len(chips))
            self._dispatcher = WorkStealingDispatcher(
                chips, cfg, chip_ids=chip_ids, faults=faults, seed=dispatch_seed)
        elif chip_faults:
            raise ValueError(
                "chip_faults need the work-stealing dispatcher "
                "(recovery_work_stealing=on)")

    def _dispatch_group(
        self,
        g: PatternGroup,
        read_shard: Callable[[int, int], np.ndarray],
        result: RecoveryResult,
    ) -> _Inflight:
        """Read survivors, throttle, and dispatch the batched decode
        for one group WITHOUT waiting for the device."""
        src = np.stack(
            [
                np.concatenate([read_shard(int(pg), s) for pg in g.pgs])
                for s in g.rows
            ]
        )
        chunk = src.shape[1] // g.n_pgs
        nbytes = (len(g.rows) + len(g.missing)) * g.n_pgs * chunk
        if self.arbiter is not None:
            if self.arbiter.request("recovery", nbytes) > 0:
                self.pc.inc("throttle_waits")
        elif self.throttle.take(nbytes):
            self.pc.inc("throttle_waits")
        if self.on_decode_launch is not None:
            self.on_decode_launch(g, nbytes)
        # torchlint: disable=J010  # the decode's real rate, kept beside simulated time, never mixed
        t0 = time.perf_counter()
        # bit-level groups decode over GF(2) bit rows (their chunks are
        # packet-interleaved, so the byte-wise LUT path would corrupt
        # them); "on" forces table groups bit-level too — unless
        # decode-verify quarantined this pattern's bit-plane schedule,
        # in which case the byte LUT reference path takes over
        bit_level = g.repair_matrix is None or (
            self.xor_mode == "on"
            and not self._schedules.is_quarantined(("bitplane", g.mask))
        )
        # byte-level groups route through the work-stealing dispatcher
        # when it is active (it subsumes the sharded and the table
        # paths); bit-level groups keep the schedule engines — their
        # packet-interleaved chunks are not byte-column sliceable
        worksteal = self._dispatcher is not None and not bit_level
        sharded = (
            not worksteal
            and self._sharded is not None
            and nbytes >= self.shard_min_bytes
            and not bit_level
        )
        with trace_annotation(f"recovery:decode:{g.mask:#x}"):
            if worksteal:
                job = self._dispatcher.submit(self._table_encoder(g), src)
                self.pc.inc("worksteal_launches")
                result.worksteal_launches += 1
                fl = _Inflight(g, job, chunk, t0, post=self._dispatcher.result,
                               engine="worksteal")
            elif sharded:
                out, nb, sh, valid = self._sharded.decode_async(
                    self._table_encoder(g), src, chunk)
                self.pc.inc("sharded_launches")
                result.sharded_launches += 1
                fl = _Inflight(g, out, chunk, t0, engine="sharded", sharded=True,
                               valid=valid, counters=(nb, sh))
            elif bit_level:
                enc = encoder_for_group(self._schedules, g, self.xor_mode, self.device)
                width = src.shape[1]
                engine = "dense"
                if getattr(enc, "schedule", None) is not None:
                    self.pc.inc("schedule_launches")
                    result.schedule_launches += 1
                    engine = "schedule"
                fl = _Inflight(
                    g, enc.encode_async(src), chunk, t0,
                    post=lambda o, _e=enc, _w=width: _e.finalize(o, _w),
                    engine=engine,
                )
            else:
                fl = _Inflight(g, self._table_encoder(g).encode_async(src), chunk, t0)
        result.launches += 1
        self.pc.inc("decode_launches")
        return fl

    def _table_encoder(self, g: PatternGroup) -> TableEncoder:
        """The group's K4 encoder on this executor's device, cached by
        erasure pattern."""
        enc = self._encoders.get(g.mask)
        if enc is None:
            enc = self._encoders[g.mask] = TableEncoder(g.repair_matrix, self.device)
        return enc

    def _finalize_group(
        self, fl: _Inflight, result: RecoveryResult
    ) -> tuple[np.ndarray, int]:
        """Materialize one in-flight launch's output on the host."""
        with timed_block(self.pc, "l_decode"):
            if fl.post is not None:
                out = fl.post(fl.out)  # schedule/dispatcher: unpack + trim
            elif fl.sharded:
                out = self._sharded.fetch(fl.out, fl.valid)  # gathered, trimmed
            else:
                out = fl.out.cpu().numpy()  # [n_missing, width]
        if fl.sharded:
            nb, sh = fl.counters
            result.psum_bytes_rebuilt += int(nb)
            result.psum_shards_rebuilt += int(sh)
        # torchlint: disable=J010  # the decode's real rate, kept beside simulated time, never mixed
        result.decode_s += time.perf_counter() - fl.t_dispatch
        return out, fl.chunk

    def _dispatch_stats_begin(self):
        """Snapshot the dispatcher's cumulative stats (None when the
        work-stealing path is inactive) so a run reports deltas."""
        if self._dispatcher is None:
            return None
        return self._dispatcher.stats.copy()

    def _dispatch_stats_end(self, before, result: RecoveryResult) -> None:
        """Fold this run's dispatcher telemetry into the result and the
        perf counters."""
        if self._dispatcher is None or before is None:
            return
        d = self._dispatcher.stats.delta(before)
        result.stolen_subshards += d.stolen_subshards
        result.hedged_launches += d.hedged_launches
        result.hedge_wasted_bytes += d.hedge_wasted_bytes
        result.chip_convictions += d.chip_convictions
        result.idle_fraction_per_chip = d.idle_fraction_per_chip()
        result.static_idle_fraction_per_chip = d.static_idle_fraction_per_chip()
        self.pc.inc("stolen_subshards", d.stolen_subshards)
        self.pc.inc("hedged_launches", d.hedged_launches)
        self.pc.inc("chip_convictions", d.chip_convictions)

    def _launch_group(
        self,
        g: PatternGroup,
        read_shard: Callable[[int, int], np.ndarray],
        result: RecoveryResult,
    ) -> tuple[np.ndarray, int]:
        """Dispatch + sync one group's decode (the serial path)."""
        return self._finalize_group(
            self._dispatch_group(g, read_shard, result), result
        )

    def _commit_group(
        self,
        g: PatternGroup,
        out: np.ndarray,
        chunk: int,
        result: RecoveryResult,
        only_pgs: set[int] | None = None,
    ) -> int:
        """Record a launched group's rebuilt shards into the result.

        ``only_pgs`` restricts the commit to a PG subset — valid because
        per-PG byte columns are independent in the batched operand.
        Returns the number of PGs committed."""
        committed = 0
        for i, pg in enumerate(g.pgs):
            if only_pgs is not None and int(pg) not in only_pgs:
                continue
            result.shards[int(pg)] = {
                s: out[j, i * chunk:(i + 1) * chunk]
                for j, s in enumerate(g.missing)
            }
            committed += 1
        rebuilt = len(g.missing) * committed
        result.shards_rebuilt += rebuilt
        result.bytes_recovered += rebuilt * chunk
        self.pc.inc("shards_rebuilt", rebuilt)
        self.pc.inc("bytes_recovered", rebuilt * chunk)
        self.pc.inc("pgs_recovered", committed)
        return committed

    def _verified_commit(
        self,
        g: PatternGroup,
        out: np.ndarray,
        chunk: int,
        engine: str,
        result: RecoveryResult,
        read_shard: Callable[[int, int], np.ndarray],
        only_pgs: set[int] | None = None,
        jevent: Callable | None = None,
    ) -> tuple[set[int], set[int]]:
        """Commit a launch's output AFTER checksum verification.

        With a ``verifier`` attached, a mismatch from a compiled XOR
        schedule is treated as a schedule-compiler bug: the pattern's
        cached schedule is quarantined (journaled
        ``scrub.schedule_quarantined`` exactly once through ``jevent``)
        and the decode re-derived through the dense / byte-LUT
        reference engines, bounded by ``recovery_retry_max``.  PGs that
        still fail on a reference engine are reported
        ``inconsistent_unrecoverable`` and never committed.  With no
        verifier this is exactly :meth:`_commit_group`.

        Returns ``(committed_pgs, bad_pgs)``.
        """
        want = {int(p) for p in g.pgs}
        if only_pgs is not None:
            want &= only_pgs
        if self.verifier is None:
            self._commit_group(g, out, chunk, result, only_pgs=only_pgs)
            return want, set()
        bad = self.verifier.bad_pgs(g, out, chunk, read_shard=read_shard)
        attempt = 0
        while bad and engine == "schedule" and attempt < self.retry_max:
            attempt += 1
            result.verify_retries += 1
            self.pc.inc("verify_retries")
            first = self._schedules.quarantine(("packet", g.mask))
            first |= self._schedules.quarantine(("bitplane", g.mask))
            if first and jevent is not None:
                jevent(
                    "scrub.schedule_quarantined",
                    mask=g.mask,
                    attempt=attempt,
                )
            fl = self._dispatch_group(g, read_shard, result)
            # a group's rebuilt chunks are read back to be verified and committed
            # torchlint: disable=J003
            out, chunk = self._finalize_group(fl, result)
            engine = fl.engine
            bad = self.verifier.bad_pgs(g, out, chunk, read_shard=read_shard)
        if not bad:
            self._commit_group(g, out, chunk, result, only_pgs=only_pgs)
            return want, set()
        newly_bad = bad & want
        result.inconsistent_unrecoverable.update(newly_bad)
        if jevent is not None and newly_bad:
            jevent(
                "scrub.verify_failed",
                mask=g.mask,
                engine=engine,
                pgs=sorted(newly_bad),
            )
        ok = want - bad
        if ok:
            self._commit_group(g, out, chunk, result, only_pgs=ok)
        return ok, newly_bad

    def run(
        self,
        plan: RecoveryPlan,
        read_shard: Callable[[int, int], np.ndarray],
    ) -> RecoveryResult:
        """Execute the plan.  ``read_shard(pg_seed, shard_id)`` returns
        that shard's chunk bytes (u8); chunk sizes must agree within a
        group (they do in practice: chunk size is an object/stripe
        property, constant per pool)."""
        result = RecoveryResult(shards={}, unrecoverable=plan.unrecoverable)
        snap = self._dispatch_stats_begin()
        for g in plan.groups:
            fl = self._dispatch_group(g, read_shard, result)
            # a group's rebuilt chunks are read back to be verified and committed
            # torchlint: disable=J003
            out, chunk = self._finalize_group(fl, result)
            # torchlint: disable=J003  # the verify reads its checksums once a group
            self._verified_commit(g, out, chunk, fl.engine, result, read_shard)
        result.throttle_wait_s = self.throttle.waited_s
        self._dispatch_stats_end(snap, result)
        return result


def recover_pool(
    m_prev,
    m_cur,
    pool_id: int,
    codec,
    read_shard: Callable[[int, int], np.ndarray],
    config: Config | None = None,
    on_decode_launch: Callable[[PatternGroup, int], None] | None = None,
    device="cuda",
) -> tuple[PeeringResult, RecoveryPlan, RecoveryResult]:
    """The full failure-response pipeline for one pool on ``device``:
    peer the two epochs, group degraded PGs by pattern, decode batched
    under the throttle.  Per-phase timings land in the ``recovery``
    counters."""
    dev = resolve_device(device)
    pc = recovery_counters()
    with timed_block(pc, "l_peering"), trace_annotation("recovery:peering"):
        peering = peer_pool(m_prev, m_cur, pool_id, device=dev)
    with timed_block(pc, "l_plan"), trace_annotation("recovery:plan"):
        plan = build_plan(peering, codec)
    pc.set("degraded_pgs", plan.n_pgs)
    pc.set("unrecoverable_pgs", int(len(plan.unrecoverable)))
    executor = RecoveryExecutor(
        codec, config=config, on_decode_launch=on_decode_launch, device=dev
    )
    result = executor.run(plan, read_shard)
    return peering, plan, result


class LaunchError(RuntimeError):
    """A decode launch failed (injected by a fault hook, or a real
    device error surfaced as RuntimeError); retried with backoff."""


@dataclass
class SupervisedResult:
    """Outcome of one supervised (chaos-tolerant) recovery run.

    The mesh fields (sharded, work-stealing, psum) stay 0 without a
    mesh or a dispatcher."""

    shards: dict[int, dict[int, np.ndarray]]
    epochs: list[int] = field(default_factory=list)
    launches: int = 0
    retries: int = 0  # failed-launch retries (backoff path)
    stale_launches: int = 0  # discarded: epoch killed a source mid-flight
    salvaged_pgs: int = 0  # committed out of a stale launch anyway
    sharded_launches: int = 0  # routed through the mesh-sharded step
    schedule_launches: int = 0  # executed as CSE-shrunk XOR schedules
    coscheduled_windows: int = 0  # windows that dispatched >1 group
    # work-stealing dispatch telemetry (zero unless the dispatcher ran)
    worksteal_launches: int = 0
    stolen_subshards: int = 0
    hedged_launches: int = 0
    hedge_wasted_bytes: int = 0
    chip_convictions: int = 0
    idle_fraction_per_chip: list[float] = field(default_factory=list)
    static_idle_fraction_per_chip: list[float] = field(
        default_factory=list
    )
    psum_bytes_rebuilt: int = 0  # collective-reduced byte progress
    plan_revisions: int = 0
    completed_pgs: set[int] = field(default_factory=set)
    failed_pgs: list[int] = field(default_factory=list)
    unrecoverable: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64)
    )
    converged: bool = False
    time_to_zero_degraded_s: float = 0.0
    bytes_recovered: int = 0
    shards_rebuilt: int = 0
    decode_s: float = 0.0
    throttle_wait_s: float = 0.0
    final_counts: dict[str, int] = field(default_factory=dict)
    # data-integrity loop (zero unless a Scrubber is attached)
    scrub_passes: int = 0
    scrubbed_bytes: int = 0
    inconsistencies_found: int = 0  # PG damage detections (cumulative)
    verify_retries: int = 0  # schedule outputs re-derived via dense
    inconsistent_unrecoverable: set[int] = field(default_factory=set)
    time_to_zero_inconsistent_s: float = 0.0
    # degraded-mode gating (zero unless cluster flags blocked work)
    flag_gated_groups: int = 0  # pattern groups held back by flags

    def summary(self) -> dict:
        """Structured run report (the ``ceph status`` analog for a
        chaos run): never a crash, never a silent drop — every PG is
        accounted for as completed, failed, or unrecoverable."""
        return {
            "converged": self.converged,
            "time_to_zero_degraded_s": round(
                self.time_to_zero_degraded_s, 6
            ),
            "epochs_observed": len(self.epochs),
            "launches": self.launches,
            "retries": self.retries,
            "stale_launches": self.stale_launches,
            "salvaged_pgs": self.salvaged_pgs,
            "sharded_launches": self.sharded_launches,
            "schedule_launches": self.schedule_launches,
            "worksteal_launches": self.worksteal_launches,
            "stolen_subshards": self.stolen_subshards,
            "hedged_launches": self.hedged_launches,
            "hedge_wasted_bytes": self.hedge_wasted_bytes,
            "chip_convictions": self.chip_convictions,
            "plan_revisions": self.plan_revisions,
            "completed_pgs": len(self.completed_pgs),
            "failed_pgs": sorted(self.failed_pgs),
            "unrecoverable_pgs": sorted(int(p) for p in self.unrecoverable),
            "bytes_recovered": self.bytes_recovered,
            "scrub_passes": self.scrub_passes,
            "scrubbed_bytes": self.scrubbed_bytes,
            "inconsistencies_found": self.inconsistencies_found,
            "verify_retries": self.verify_retries,
            "inconsistent_unrecoverable_pgs": sorted(
                self.inconsistent_unrecoverable
            ),
            "time_to_zero_inconsistent_s": round(
                self.time_to_zero_inconsistent_s, 6
            ),
            "flag_gated_groups": self.flag_gated_groups,
        }


class SupervisedRecovery:
    """Chaos-tolerant recovery driver: the executor's run loop made
    safe against epochs advancing *while the plan executes*.

    Per iteration the loop (a) polls the chaos engine — due failure
    events become ordinary epochs; (b) on epoch advance, re-peers the
    delta (:meth:`PeeringEngine.repeer`, zero recompiles) and re-plans
    ONLY invalidated pattern groups (:func:`invalidated_groups` — valid
    groups keep their matrices and cached device encoders); (c) retries
    failed decode launches with bounded exponential backoff + seeded
    jitter (``recovery_retry_max`` / ``recovery_backoff_base_ms``); (d)
    checkpoints per-PG completion (acting-row snapshot) so a revision
    never re-decodes a PG the chaos left untouched; and (e) reports
    below-k PGs as ``unrecoverable`` — the run always terminates with a
    structured summary, never a crash or an infinite retry.

    Scheduling is reservation-style (upstream's
    ``osd_max_backfills``): pattern groups whose PGs are all
    backfill-flagged (remap-induced) interleave with pure-repair groups
    at a ratio of ``osd_max_backfills`` backfill groups per repair
    group, sharing the one token bucket, so neither class starves the
    other.

    All time is the chaos engine's virtual clock (launches occupy
    ``launch_duration_s`` of it; backoff and throttle sleep on it), and
    the only randomness is the seeded jitter generator — two runs of
    one scenario are bit-identical, on the card or on the CPU.

    Peering, decodes, the scrubber's CRCs and the verifier run on
    ``device`` (the card by default; a mesh's rank device with
    ``mesh=``).  With a mesh, up to ``recovery_coschedule_max`` small
    groups dispatch back-to-back per scheduling window and large ones
    decode sharded over the ranks (every rank runs the same loop);
    ``chip_faults`` (chip specs, :func:`~ceph_tpu_torch.recovery.
    dispatch.strip_chip_specs`) reach the work-stealing dispatcher over
    ``dispatch_devices``.
    """

    def __init__(
        self,
        codec,
        chaos,
        config: Config | None = None,
        on_decode_launch: Callable[[PatternGroup, int], None] | None = None,
        fault_hook: Callable[[PatternGroup, int], bool] | None = None,
        seed: int = 0,
        launch_duration_s: float = 0.5,
        max_items: int = 8,
        mesh=None,
        journal=None,
        health=None,
        op_tracker=None,
        traffic=None,
        arbiter=None,
        scrubber=None,
        write_shard=None,
        chip_faults=None,
        dispatch_devices=None,
        device="cuda",
    ):
        self.codec = codec
        self.chaos = chaos
        self.cfg = config or global_config()
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.fault_hook = fault_hook
        # data-integrity loop (ceph_tpu_torch.recovery.scrub): with a Scrubber
        # attached, every chaos bit-rot burst triggers a device scrub
        # pass, inconsistent PGs re-enter planning with their damaged
        # shards struck from the survivor mask, and EVERY commit is
        # checksum-verified (DecodeVerifier) before it lands.
        # ``write_shard(pg, shard, bytes)`` writes verified repairs back
        # to the shard store so the closing scrub pass can confirm the
        # cluster converged to zero inconsistencies.
        self.scrubber = scrubber
        self.write_shard = write_shard
        # observability seams (ceph_tpu_torch.obs): the event journal
        # records phase spans + launch/retry/salvage events, the health
        # timeline snapshots the PG-state histogram at every observed
        # epoch, and the op tracker (on the virtual clock) keeps
        # per-launch lifecycle dumps — all optional, all no-ops when
        # None.  With a traffic engine (ceph_tpu_torch.workload.
        # TrafficEngine) attached, every health snapshot ALSO drives a
        # foreground-traffic step against the live degraded state and
        # records the resulting latency/outcome sample; an mclock
        # arbiter makes recovery and that client traffic share
        # bandwidth under policy.
        self.journal = journal
        self.health = health
        self.op_tracker = op_tracker
        self.traffic = traffic
        self.arbiter = arbiter
        # degraded-mode gating: the chaos engine's cluster flags
        # (norecover / nobackfill / norebalance) hold pattern groups
        # back instead of letting the loop over-repair a cluster an
        # operator deliberately froze
        self.flags = getattr(chaos, "flags", None)
        self.launch_duration_s = float(launch_duration_s)
        self.max_items = max_items
        self._rng = np.random.default_rng(seed)
        self.retry_max = int(self.cfg.get("recovery_retry_max"))
        self.backoff_base_s = (
            float(self.cfg.get("recovery_backoff_base_ms")) / 1000.0
        )
        self.max_backfills = int(self.cfg.get("osd_max_backfills"))
        # with a mesh, up to recovery_coschedule_max small groups are
        # dispatched back-to-back per scheduling window (one clock
        # advance, one chaos poll for the whole window); without one
        # the window is 1
        self.window = (
            int(self.cfg.get("recovery_coschedule_max")) if mesh is not None else 1
        )
        self.ex = RecoveryExecutor(
            codec,
            config=self.cfg,
            on_decode_launch=on_decode_launch,
            clock=chaos.clock.now,
            sleep=chaos.clock.sleep,
            mesh=mesh,
            arbiter=arbiter,
            chip_faults=chip_faults,
            dispatch_seed=seed,
            dispatch_devices=dispatch_devices,
            device=self.device,
        )
        if self.ex._dispatcher is not None:
            self.ex._dispatcher.journal = journal
        self.pc = self.ex.pc

    def _jevent(self, name: str, **attrs) -> None:
        if self.journal is not None:
            self.journal.event(name, **attrs)

    def _jspan(self, name: str, **attrs):
        if self.journal is not None:
            return self.journal.span(name, **attrs)
        return nullcontext()

    def _snapshot(self, peering: PeeringResult, bytes_recovered: int) -> None:
        sample = None
        if self.traffic is not None:
            sample = self.traffic.observe(
                peering,
                epoch=self.chaos.epoch,
                bytes_recovered=bytes_recovered,
            )
        if self.health is not None:
            liveness = getattr(self.chaos, "liveness", None)
            kw = {}
            if liveness is not None and hasattr(
                self.health, "note_detection"
            ):
                # drain completed failure detections into the timeline
                # (detection-latency SLO feed), and surface the
                # detector's down/laggy counts on this sample
                for det in liveness.pop_detections():
                    self.health.note_detection(det.latency)
                kw["liveness"] = liveness
            self.health.snapshot(
                peering,
                epoch=self.chaos.epoch,
                bytes_recovered=bytes_recovered,
                traffic=sample,
                **kw,
            )

    def _schedule(
        self, groups: list[PatternGroup], peering: PeeringResult
    ) -> list[PatternGroup]:
        """Priority order with backfill fair-share: most-missing first
        within each class, then ``osd_max_backfills`` backfill groups
        admitted after each repair group."""
        groups = sorted(groups, key=lambda g: (-len(g.missing), g.mask))
        backfill = [
            g for g in groups
            if all(peering.flags[pg] & PG_STATE_BACKFILL for pg in g.pgs)
        ]
        # partition by identity, not mask: a revision can carry two
        # groups with the same erasure pattern (a still-valid backfill
        # group plus a freshly re-planned repair group) and both must
        # survive the split
        bf_ids = {id(g) for g in backfill}
        repair = [g for g in groups if id(g) not in bf_ids]
        out: list[PatternGroup] = []
        bi = 0
        for r in repair:
            out.append(r)
            out.extend(backfill[bi:bi + self.max_backfills])
            bi += self.max_backfills
        out.extend(backfill[bi:])
        return out

    def _flag_gated(
        self, g: PatternGroup, peering: PeeringResult
    ) -> bool:
        """Is this pattern group held back by a cluster flag?
        ``norecover`` blocks repair groups, ``nobackfill`` blocks
        backfill groups, ``norebalance`` blocks backfill groups with
        no data at risk (pure remap churn)."""
        flags = self.flags
        if not flags:
            return False
        backfill = all(
            peering.flags[pg] & PG_STATE_BACKFILL for pg in g.pgs
        )
        if backfill:
            if "nobackfill" in flags:
                return True
            return "norebalance" in flags and not any(
                peering.flags[pg] & PG_STATE_DEGRADED for pg in g.pgs
            )
        return "norecover" in flags

    @staticmethod
    def _finalize_order(fl: _Inflight) -> tuple:
        """Deterministic finalize key for a co-schedule window:
        (erasure pattern, PG set).  The window used to finalize in
        scheduling-insertion order, which depended on how the pending
        dict/list happened to be built — two identical scenarios could
        commit (and journal) in different orders.  Sorting by the
        group's content keys makes window finalization replay-stable
        regardless of construction order (the J009 discipline applied
        to the window seam)."""
        g = fl.group
        return (int(g.mask), tuple(int(p) for p in g.pgs))

    @staticmethod
    def _stale_pgs(
        g: PatternGroup, peering: PeeringResult, m: OSDMap
    ) -> set[int]:
        """The group's PGs whose launch read from an OSD the epoch
        advance killed.  Per-PG (not group-level) liveness: the batched
        operand's byte columns are independent, so every OTHER PG's
        slice of the output is still exact and can be salvaged."""
        stale: set[int] = set()
        for pg in g.pgs:
            for s in g.rows:
                if not m.is_up(int(peering.acting[int(pg), s])):
                    stale.add(int(pg))
                    break
        return stale

    @staticmethod
    def _is_stale(
        g: PatternGroup, peering: PeeringResult, m: OSDMap
    ) -> bool:
        """Did the epoch advance kill any OSD this launch read from?"""
        return bool(SupervisedRecovery._stale_pgs(g, peering, m))

    def run(
        self,
        m_prev: OSDMap,
        pool_id: int,
        read_shard: Callable[[int, int], np.ndarray],
    ) -> SupervisedResult:
        """Drive recovery of one pool to convergence under the chaos
        timeline.  ``m_prev`` is the pre-failure epoch (where the data
        lives); the chaos engine owns the live map."""
        chaos = self.chaos
        clock = chaos.clock
        dev = self.device
        engine = PeeringEngine(chaos.osdmap, pool_id, device=dev)
        state_prev = build_pool_state(
            m_prev, m_prev.pools[pool_id], self.max_items, dev
        )

        def cur_state():
            return build_pool_state(
                chaos.osdmap, chaos.osdmap.pools[pool_id], self.max_items,
                dev,
            )

        inner = RecoveryResult(shards={})
        res = SupervisedResult(shards=inner.shards)
        dispatch_snap = self.ex._dispatch_stats_begin()
        scrubber = self.scrubber
        if scrubber is not None:
            # checksums must come from a clean store — build them now
            # (pre-corruption: chaos bit-rot only lands via poll())
            # unless the caller already did
            if scrubber.checksums is None:
                scrubber.build_checksums(read_shard)
            self.ex.verifier = DecodeVerifier(
                scrubber.checksums, codec=self.codec, device=dev
            )
        with self._jspan(
            "recovery.peer", epoch_prev=m_prev.epoch, epoch=chaos.epoch
        ):
            peering = engine.run(
                state_prev, cur_state(), m_prev.epoch, chaos.epoch
            )
        res.epochs.append(chaos.epoch)

        def feed_reporters() -> None:
            # the failure detector's reporter pool is the peering
            # adjacency: only co-serving OSDs heartbeat each other, so
            # only they can report a silence
            liveness = getattr(chaos, "liveness", None)
            if liveness is not None:
                liveness.set_reporters(
                    peering.peer_counts(chaos.osdmap.max_osd)
                )

        feed_reporters()
        # per-PG damage bitmask from the last scrub pass (bit s = shard
        # s failed its checksum); all-zero until bit rot lands
        inconsistent = np.zeros(peering.pg_num, np.uint32)
        seen_rot = len(getattr(chaos, "corruptions", ()))
        # checkpoint: pg -> acting row at completion time.  A later
        # epoch that moves/kills anything in the row voids the entry.
        completed: dict[int, np.ndarray] = {}
        # retry-exhausted PGs and the mask they failed under: re-planned
        # only if a later epoch changes the pattern (a fresh chance),
        # never retried identically forever.
        failed: dict[int, int] = {}

        def eff_mask() -> np.ndarray:
            """Survivor mask with corrupt shards struck: a shard that
            failed its checksum can never be a decode source."""
            if scrubber is None:
                return peering.survivor_mask
            return peering.survivor_mask & ~inconsistent

        def flags() -> np.ndarray:
            """``peering.flags``, made writable — peering hands back a
            read-only view of the device array, and the integrity bits
            are host-annotated on top of it."""
            if not peering.flags.flags.writeable:
                peering.flags = peering.flags.copy()
            return peering.flags

        def annotate() -> None:
            # integrity flags are host-annotated (the device classifier
            # sees placement, never shard bytes); re-applied after
            # every re-peer replaces the flags array
            if scrubber is not None:
                flags()[np.flatnonzero(inconsistent)] |= (
                    PG_STATE_INCONSISTENT
                )

        def note_unrecoverable(unrec: np.ndarray) -> None:
            """A below-k PG whose damage contributed: explicit
            ``inconsistent-unrecoverable`` — reported, never silent."""
            if scrubber is None:
                return
            for p in unrec:
                p = int(p)
                if inconsistent[p] and (
                    p not in inner.inconsistent_unrecoverable
                ):
                    inner.inconsistent_unrecoverable.add(p)
                    self._jevent(
                        "scrub.unrecoverable",
                        pg=p,
                        clean_survivors=int(eff_mask()[p]),
                    )

        stagger_s = float(self.cfg.get("osd_scrub_stagger_period"))

        def scrub_now(final: bool = False) -> bool:
            """One device scrub pass; True if the damage map changed."""
            nonlocal inconsistent
            flags()[:] |= PG_STATE_SCRUBBING
            if stagger_s > 0 and not final:
                # staggered pass: only phase-due PGs verify (the final
                # pass always covers the whole pool — convergence must
                # confirm every write-back, not a phase slice)
                sr = scrubber.scrub(
                    read_shard, now=chaos.clock.now(), period_s=stagger_s
                )
            else:
                sr = scrubber.scrub(read_shard)
            res.scrub_passes += 1
            res.scrubbed_bytes += sr.scrubbed_bytes
            new = np.asarray(sr.inconsistent_mask, np.uint32).copy()
            if sr.due is not None:
                # non-due PGs did not vote: keep their old damage bits
                new[~sr.due] = inconsistent[~sr.due]
            fresh = np.flatnonzero(new & ~inconsistent)
            res.inconsistencies_found += int(len(fresh))
            changed = not np.array_equal(new, inconsistent)
            inconsistent = new
            for p in sr.pgs:
                # damage voids the checkpoint: the PG must re-plan
                completed.pop(int(p), None)
                # ...and a retry-exhausted PG gets a fresh chance — but
                # only mid-run: the CLOSING pass has no re-plan after
                # it, so clearing ``failed`` there would erase the
                # report's accounting of the still-damaged PG
                if not final:
                    failed.pop(int(p), None)
            annotate()
            if self.health is not None and hasattr(
                self.health, "note_scrub"
            ):
                self.health.note_scrub()
            self._snapshot(peering, inner.bytes_recovered)
            flags()[:] &= ~np.int32(PG_STATE_SCRUBBING)
            if len(fresh):
                res.time_to_zero_inconsistent_s = 0.0
            return changed

        def poll_rot() -> bool:
            """Scrub iff the chaos engine corrupted anything new."""
            nonlocal seen_rot
            if scrubber is None:
                return False
            n = len(getattr(chaos, "corruptions", ()))
            if n == seen_rot:
                return False
            seen_rot = n
            return scrub_now()

        def commit(
            g: PatternGroup, out, chunk: int, engine: str,
            only_pgs: set[int] | None = None,
        ) -> set[int]:
            """Verified commit + write-back + damage-bit clearing."""
            ok, _bad = self.ex._verified_commit(
                g, out, chunk, engine, inner, read_shard,
                only_pgs=only_pgs, jevent=self._jevent,
            )
            for p in ok:
                completed[p] = peering.acting[p].copy()
                failed.pop(p, None)
                if scrubber is not None:
                    if self.write_shard is not None:
                        for s, buf in inner.shards[p].items():
                            self.write_shard(p, int(s), buf)
                    inconsistent[p] = 0
                    flags()[p] &= ~np.int32(PG_STATE_INCONSISTENT)
            return ok

        plan = build_plan(
            peering, self.codec,
            inconsistent=inconsistent if scrubber is not None else None,
        )
        pending = self._schedule(plan.groups, peering)
        unrecoverable = plan.unrecoverable
        note_unrecoverable(unrecoverable)
        self._snapshot(peering, 0)

        def revise() -> None:
            nonlocal peering, pending, unrecoverable
            res.plan_revisions += 1
            self.pc.inc("plan_revisions")
            with self._jspan("recovery.revise", epoch=chaos.epoch):
                peering, _changed = engine.repeer(
                    peering, state_prev, cur_state(), chaos.epoch
                )
                feed_reporters()
                annotate()
                for pg in list(completed):
                    if not np.array_equal(
                        peering.acting[pg], completed[pg]
                    ):
                        del completed[pg]
                # groups stay valid against the EFFECTIVE mask: a scrub
                # hit strikes a planned source shard exactly like an
                # epoch advance killing it would
                eff = eff_mask()
                valid, _invalid_pgs = invalidated_groups(pending, eff)
                for pg in list(failed):
                    if int(eff[pg]) != failed[pg]:
                        del failed[pg]  # pattern changed: worth a new try
                covered = set(completed) | set(failed)
                for g in valid:
                    covered.update(int(p) for p in g.pgs)
                degraded_set = {
                    int(pg)
                    for pg in peering.pgs_with(PG_STATE_DEGRADED)
                }
                if scrubber is not None:
                    degraded_set |= {
                        int(p) for p in np.flatnonzero(inconsistent)
                    }
                need = np.array(
                    sorted(
                        pg for pg in degraded_set if pg not in covered
                    ),
                    dtype=np.int64,
                )
                sub = build_plan(
                    peering, self.codec, pgs=need,
                    inconsistent=(
                        inconsistent if scrubber is not None else None
                    ),
                )
                pending = self._schedule(valid + sub.groups, peering)
                unrecoverable = sub.unrecoverable
                note_unrecoverable(unrecoverable)
            self._snapshot(peering, inner.bytes_recovered)

        def observe(incs) -> None:
            res.epochs.extend(i.epoch for i in incs)
            self.pc.inc("epochs_observed", len(incs))

        while True:
            incs = chaos.poll()
            rot = poll_rot()
            if incs:
                observe(incs)
            if incs or rot:
                revise()
            if not pending:
                res.time_to_zero_degraded_s = clock.now()
                if (
                    scrubber is not None
                    and res.time_to_zero_inconsistent_s == 0.0
                ):
                    live = {int(p) for p in np.flatnonzero(inconsistent)}
                    if live <= inner.inconsistent_unrecoverable:
                        res.time_to_zero_inconsistent_s = clock.now()
                if chaos.advance_to_next():
                    continue
                break
            if self.flags and all(
                self._flag_gated(g, peering) for g in pending
            ):
                # every pending group is held back by cluster flags:
                # idle forward to the next chaos event / liveness
                # deadline (the flags may outlive them), else stop and
                # report the gated work as outstanding — a frozen
                # cluster must terminate, not spin
                res.flag_gated_groups = max(
                    res.flag_gated_groups, len(pending)
                )
                if chaos.advance_to_next():
                    continue
                self._jevent(
                    "recovery.gated",
                    groups=len(pending),
                    flags=list(self.flags),
                )
                break
            # dispatch a window of up to self.window groups back-to-back
            # (async device work overlaps); a mesh-sharded group closes
            # its window — it already occupies every chip.  A retry-
            # exhausted group also closes the window so the next poll
            # happens before anything else dispatches (matching the
            # serial loop's ordering).
            window: list[_Inflight] = []
            gated: list[PatternGroup] = []
            ops: dict[int, object] = {}
            while pending and len(window) < self.window:
                g = pending.pop(0)
                if self._flag_gated(g, peering):
                    gated.append(g)
                    res.flag_gated_groups = max(
                        res.flag_gated_groups, len(gated)
                    )
                    continue
                attempt = 0
                fl = None
                op = (
                    self.op_tracker.create_op(f"decode:{g.mask:#x}")
                    if self.op_tracker is not None
                    else None
                )
                while True:
                    try:
                        if self.fault_hook is not None and self.fault_hook(
                            g, attempt
                        ):
                            raise LaunchError(
                                f"injected launch failure {g.mask:#x}"
                            )
                        fl = self.ex._dispatch_group(g, read_shard, inner)
                    except (LaunchError, RuntimeError):
                        attempt += 1
                        if attempt > self.retry_max:
                            for pg in g.pgs:
                                failed[int(pg)] = g.mask
                            self._jevent(
                                "decode.failed",
                                mask=g.mask,
                                pgs=sorted(int(p) for p in g.pgs),
                            )
                            if op is not None:
                                op.mark_event("failed")
                                op.finish()
                            break
                        res.retries += 1
                        self.pc.inc("launch_retries")
                        self._jevent(
                            "decode.retry", mask=g.mask, attempt=attempt
                        )
                        if op is not None:
                            op.mark_event(f"retry:{attempt}")
                        # bounded exponential backoff + seeded jitter
                        clock.sleep(
                            self.backoff_base_s
                            * (2 ** (attempt - 1))
                            * (1.0 + self._rng.random())
                        )
                        continue
                    break
                if fl is None:
                    break
                self._jevent(
                    "decode.launch",
                    mask=g.mask,
                    n_pgs=g.n_pgs,
                    attempt=attempt,
                    sharded=fl.sharded,
                )
                if op is not None:
                    op.mark_event("dispatched")
                    ops[id(fl)] = op
                window.append(fl)
                if fl.sharded:
                    break
            if gated:
                # gated groups keep their place at the head of the
                # queue; a flag clear or revision re-admits them
                pending[:0] = gated
            if not window:
                continue
            if len(window) > 1:
                res.coscheduled_windows += 1
                self.pc.inc("coscheduled_windows")
            # the window occupies virtual time; chaos may land inside it
            clock.advance(self.launch_duration_s)
            incs = chaos.poll()
            if incs:
                observe(incs)
            # finalize in deterministic (pattern, PG-set) order — the
            # dispatch order above already consumed the schedule's
            # priority; commit order must not depend on it
            window.sort(key=self._finalize_order)
            for fl in window:
                g = fl.group
                out, chunk = self.ex._finalize_group(fl, inner)
                op = ops.pop(id(fl), None)
                stale = (
                    self._stale_pgs(g, peering, chaos.osdmap)
                    if incs
                    else set()
                )
                if stale:
                    # a source shard died under the launch: those PGs'
                    # outputs may mix pre/post-failure reads — drop
                    # them; revise() below re-plans.  Every PG whose
                    # OWN sources all survived is salvaged from the
                    # same device output (byte columns are independent)
                    res.stale_launches += 1
                    self.pc.inc("stale_launches")
                    self._jevent(
                        "decode.stale",
                        mask=g.mask,
                        stale_pgs=sorted(stale),
                    )
                    fresh = {int(pg) for pg in g.pgs} - stale
                    if fresh:
                        ok = commit(
                            g, out, chunk, fl.engine, only_pgs=fresh
                        )
                        res.salvaged_pgs += len(ok)
                        self.pc.inc("salvaged_pgs", len(ok))
                        if ok:
                            self._jevent(
                                "decode.salvage",
                                mask=g.mask,
                                pgs=sorted(ok),
                            )
                    if op is not None:
                        op.mark_event("stale")
                        op.finish()
                    continue
                # commit against the pre-event acting rows, THEN
                # revise: if the event touched this PG, the snapshot
                # mismatch un-checkpoints it right there
                commit(g, out, chunk, fl.engine)
                if op is not None:
                    op.mark_event("committed")
                    op.finish()
            rot = poll_rot()
            if incs or rot:
                revise()
            elif self.traffic is not None:
                # no epoch advance, but the window still carried client
                # load: sample traffic every scheduling window so the
                # series is dense enough to catch transient overload
                self._snapshot(peering, inner.bytes_recovered)

        if scrubber is not None:
            # closing pass: confirm the STORE (not just the in-memory
            # result) converged — verified write-backs must scrub clean,
            # and anything still damaged is surfaced, never dropped
            with self._jspan("scrub.final", epoch=chaos.epoch):
                scrub_now(final=True)
            live = {int(p) for p in np.flatnonzero(inconsistent)}
            accounted = inner.inconsistent_unrecoverable | {
                int(p) for p in unrecoverable
            }
            if not (live - accounted):
                if res.time_to_zero_inconsistent_s == 0.0:
                    res.time_to_zero_inconsistent_s = clock.now()
            else:
                res.time_to_zero_inconsistent_s = 0.0
        if self.health is not None:
            last = self.health.latest
            # close the series with the end state (skip only an exact
            # duplicate of the sample the final revise already took)
            if (
                last is None
                or clock.now() > last.t
                or chaos.epoch != last.epoch
                or inner.bytes_recovered != last.bytes_recovered
                # a scrub pass snapshots mid-scrub; close with the
                # settled (scrubbing-flag-cleared) state
                or last.counts.get("scrubbing", 0)
            ):
                self._snapshot(peering, inner.bytes_recovered)
        self.ex._dispatch_stats_end(dispatch_snap, inner)
        res.launches = inner.launches
        res.sharded_launches = inner.sharded_launches
        res.schedule_launches = inner.schedule_launches
        res.worksteal_launches = inner.worksteal_launches
        res.stolen_subshards = inner.stolen_subshards
        res.hedged_launches = inner.hedged_launches
        res.hedge_wasted_bytes = inner.hedge_wasted_bytes
        res.chip_convictions = inner.chip_convictions
        res.idle_fraction_per_chip = list(inner.idle_fraction_per_chip)
        res.static_idle_fraction_per_chip = list(inner.static_idle_fraction_per_chip)
        res.psum_bytes_rebuilt = inner.psum_bytes_rebuilt
        res.bytes_recovered = inner.bytes_recovered
        res.shards_rebuilt = inner.shards_rebuilt
        res.decode_s = inner.decode_s
        res.throttle_wait_s = self.ex.throttle.waited_s
        if self.arbiter is not None:
            res.throttle_wait_s += self.arbiter.waited("recovery")
        res.verify_retries = inner.verify_retries
        res.inconsistent_unrecoverable = set(
            inner.inconsistent_unrecoverable
        )
        res.completed_pgs = set(completed)
        res.failed_pgs = sorted(failed)
        res.unrecoverable = unrecoverable
        res.final_counts = peering.counts()
        degraded = {int(p) for p in peering.pgs_with(PG_STATE_DEGRADED)}
        outstanding = (
            degraded
            - set(completed)
            - set(failed)
            - {int(p) for p in unrecoverable}
        )
        if scrubber is not None:
            # a PG still scrubbing dirty is outstanding unless it is
            # explicitly accounted unrecoverable — damage is NEVER
            # silently dropped from the report
            outstanding |= (
                {int(p) for p in np.flatnonzero(inconsistent)}
                - inner.inconsistent_unrecoverable
                - set(failed)
                - {int(p) for p in unrecoverable}
            )
        res.converged = not failed and not outstanding
        self.pc.set("degraded_pgs", len(outstanding))
        self.pc.set("unrecoverable_pgs", int(len(unrecoverable)))
        self.pc.set("failed_pgs", len(failed))
        return res
