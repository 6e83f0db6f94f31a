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

This is the single-device executor: the reference's mesh-sharded
decode, work-stealing dispatcher, QoS arbiter and supervised loop are
not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .. import resolve_device
from ..common.config import Config, global_config
from ..common.perf_counters import PerfCounters, PerfCountersBuilder, registry
from ..common.tracing import timed_block, trace_annotation
from ..ec.backend import TableEncoder
from ..ec.schedule import ScheduleCache, encoder_for_group
from .peering import PeeringResult, peer_pool
from .planner import PatternGroup, RecoveryPlan, build_plan


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
        .add_u64_counter("schedule_launches",
                         "decode launches executed as CSE-shrunk XOR "
                         "schedules (bit-level pattern groups)")
        .add_u64_counter("verify_retries",
                         "decode outputs re-derived through the dense "
                         "reference path after checksum verification "
                         "rejected a compiled-schedule launch")
        .add_gauge("degraded_pgs", "degraded PGs in the last plan")
        .add_gauge("unrecoverable_pgs", "PGs below k survivors")
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
    # launches that ran as CSE-shrunk XOR schedules (bit-level groups)
    schedule_launches: int = 0
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

    ``out`` is a device tensor whose bytes are still in flight;
    :meth:`RecoveryExecutor._finalize_group` materializes it.
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
    # Decode-verify keys its retry policy on this: only a "schedule"
    # miss is a compiler bug worth a quarantine.
    engine: str = "table"


class RecoveryExecutor:
    """Drive a :class:`RecoveryPlan` through the device codec on one
    device.

    ``on_decode_launch(group, nbytes)`` fires immediately before each
    device launch — the launch-count hook the tests assert against
    (exactly one call per unique survivor pattern).
    """

    def __init__(
        self,
        codec,
        config: Config | None = None,
        on_decode_launch: Callable[[PatternGroup, int], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        device="cuda",
    ):
        self.codec = codec
        self.device = resolve_device(device)
        cfg = config or global_config()
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
        # decode-verify seam: an object with ``bad_pgs(group, out,
        # chunk, read_shard=...) -> set[int]`` (scrub's DecodeVerifier
        # in the reference).  None keeps commits unverified.
        self.verifier = None
        self.retry_max = int(cfg.get("recovery_retry_max"))

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
        if self.throttle.take(nbytes):
            self.pc.inc("throttle_waits")
        if self.on_decode_launch is not None:
            self.on_decode_launch(g, nbytes)
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
        with trace_annotation(f"recovery:decode:{g.mask:#x}"):
            if bit_level:
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
                enc = self._encoders.get(g.mask)
                if enc is None:
                    enc = self._encoders[g.mask] = TableEncoder(
                        g.repair_matrix, self.device
                    )
                fl = _Inflight(g, enc.encode_async(src), chunk, t0)
        result.launches += 1
        self.pc.inc("decode_launches")
        return fl

    def _finalize_group(
        self, fl: _Inflight, result: RecoveryResult
    ) -> tuple[np.ndarray, int]:
        """Materialize one in-flight launch's output on the host."""
        with timed_block(self.pc, "l_decode"):
            if fl.post is not None:
                out = fl.post(fl.out)  # schedule path: unpack + trim
            else:
                out = fl.out.cpu().numpy()  # [n_missing, width]
        result.decode_s += time.perf_counter() - fl.t_dispatch
        return out, fl.chunk

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
    ) -> tuple[set[int], set[int]]:
        """Commit a launch's output AFTER checksum verification.

        With a ``verifier`` attached, a mismatch from a compiled XOR
        schedule is treated as a schedule-compiler bug: the pattern's
        cached schedule is quarantined and the decode re-derived through
        the dense / byte-LUT reference engines, bounded by
        ``recovery_retry_max``.  PGs that still fail on a reference
        engine are reported ``inconsistent_unrecoverable`` and never
        committed.  With no verifier this is exactly
        :meth:`_commit_group`.

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
            self._schedules.quarantine(("packet", g.mask))
            self._schedules.quarantine(("bitplane", g.mask))
            fl = self._dispatch_group(g, read_shard, result)
            out, chunk = self._finalize_group(fl, result)
            engine = fl.engine
            bad = self.verifier.bad_pgs(g, out, chunk, read_shard=read_shard)
        if not bad:
            self._commit_group(g, out, chunk, result, only_pgs=only_pgs)
            return want, set()
        newly_bad = bad & want
        result.inconsistent_unrecoverable.update(newly_bad)
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
        for g in plan.groups:
            fl = self._dispatch_group(g, read_shard, result)
            out, chunk = self._finalize_group(fl, result)
            self._verified_commit(g, out, chunk, fl.engine, result, read_shard)
        result.throttle_wait_s = self.throttle.waited_s
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
