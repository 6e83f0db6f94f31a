"""Client workload generator against the live degraded map.

The north star is a cluster *serving* millions of ops/s while chaos and
recovery run — so health must be judged on what clients experience,
not a PG-serviceability proxy (arXiv:1709.05365: the dominant
production cost of online EC is foreground/recovery interference).
One device step routes a fixed-shape batch of object reads/writes end
to end:

- **route**: object id -> ``crush_hash32_2`` -> ``ceph_stable_mod`` ->
  PG (the client-side ``ceph_object_locator_to_pg``), then a gather
  against the peering pass's per-PG survivor mask / acting primary —
  the same CRUSH/OSDMap state recovery works from, at the epoch chaos
  last touched.
- **classify**: every op lands in exactly one outcome from the
  survivor bitmask — *served* (full redundancy), *degraded-served*
  (readable, but below ``size`` survivors: EC reconstruct on the read
  path), or *blocked-on-inactive* (reads below ``k`` survivors, writes
  below ``min_size`` live acting members — the reference stalls both).
- **queue model**: per-OSD load is scatter-added at the acting primary
  (reads 1 unit, degraded reads ``k`` — the reconstruct fan-in — and
  writes ``size``), normalized to per-OSD capacity, plus a uniform
  recovery-utilization term derived from the observed inter-sample
  repair bandwidth (rateless-style load accounting, arXiv:1804.10331).
  Latency is M/D/1-shaped: ``service * amp * (1 + rho/(1-rho))`` with
  rho clipped below saturation.
- **aggregate**: outcome counts, latency and queue-depth log-bucket
  histograms (:mod:`ceph_tpu_torch.workload.histogram`), sums, and the
  peak OSD utilization — O(n_buckets) outputs regardless of batch size.

The step is torch ops on one device (u32 hashes carried in int64, as
in :mod:`ceph_tpu_torch.core.hashes`); it routes the batch once and
uses the route for both the load scatter and the reduce.  Every
per-step input is data, so chaos epochs, overload windows and recovery
interference build nothing new.  The reference's mesh step
(``sharded_traffic_step``) is ROADMAP §1 item 4.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from .. import resolve_device
from ..common.config import Config, global_config
from ..common.perf_counters import PerfCounters, PerfCountersBuilder, registry
from ..core.hashes import M32, ceph_stable_mod, crush_hash32_2
from ..obs.pg_states import popcount32
from .histogram import (
    LAT_MIN_MS,
    N_BUCKETS,
    bucket_edges,
    bucketize,
    count_at_least,
    percentiles,
    scatter_hist,
)
from .qos import MClockArbiter

if TYPE_CHECKING:
    from ..recovery.peering import PeeringResult

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32

#: clip utilization below saturation so the M/D/1 delay stays finite
RHO_MAX = 0.97

_SALT2 = np.uint32(0x9E3779B9)  # decorrelates the read/write coin
_SALT3 = np.uint32(0x85EBCA6B)  # decorrelates the popularity-skew coin

#: what ``mesh=`` and ``sharded_traffic_step`` say when asked for
MULTI_DEVICE = "not ported yet (ROADMAP §1, item 4: multi-device)"


@dataclass(frozen=True)
class TrafficMix:
    """A named client-workload shape, grounded in the arXiv:1709.05365
    characterization of online EC on large SSD arrays: a read/write
    split, a skewed object-popularity remap (``hot_permille`` of ops
    collapse onto a ``hot_objects``-wide hot set), and a bursty-arrival
    duty cycle (capacity headroom divides by ``burst_factor`` for
    ``burst_duty`` of every ``burst_period_s``).  The zero-valued
    defaults are the uniform workload."""

    name: str
    write_fraction: float = 0.25
    hot_permille: int = 0
    hot_objects: int = 64
    burst_period_s: float = 0.0
    burst_duty: float = 0.0
    burst_factor: float = 1.0


#: the named fleet workload mixes (the names pair with the same-named
#: chaos scenarios)
TRAFFIC_MIXES = {
    m.name: m
    for m in (
        # steady-state online EC: read-mostly with a warm working set
        TrafficMix("ssd-steady", write_fraction=0.30,
                   hot_permille=400, hot_objects=256),
        # write-burst ingest: bursty arrivals on a write-heavy split
        TrafficMix("ssd-burst", write_fraction=0.45,
                   hot_permille=300, hot_objects=256,
                   burst_period_s=4.0, burst_duty=0.25,
                   burst_factor=3.0),
        # read-hot-spot serving: most ops collapse onto a small hot set
        TrafficMix("ssd-skew", write_fraction=0.10,
                   hot_permille=800, hot_objects=64),
    )
}


def resolve_mix(mix) -> TrafficMix | None:
    """``None`` | mix name | :class:`TrafficMix` -> the mix (or None)."""
    if mix is None or isinstance(mix, TrafficMix):
        return mix
    try:
        return TRAFFIC_MIXES[mix]
    except KeyError:
        raise ValueError(
            f"unknown traffic mix {mix!r}; known: "
            f"{sorted(TRAFFIC_MIXES)}"
        ) from None


def _u32_scalar(value, device) -> torch.Tensor:
    """A u32 value as a 0-d int64 tensor on ``device`` (a fill, no copy)."""
    return torch.full((), int(value) & M32, dtype=I64, device=device)


def _skew_ids(ids: torch.Tensor, salt, hot_permille: int, hot_objects: int):
    """Skewed object popularity: ``hot_permille``/1000 of the op batch
    remaps onto the first ``hot_objects`` object ids (a seeded hash
    coin, decorrelated from the routing and read/write coins).  ``ids``
    are u32 values in int64; so is the result."""
    coin = crush_hash32_2(ids, _u32_scalar(int(salt) ^ int(_SALT3), ids.device))
    hot = (coin % 1000) < int(hot_permille)
    return torch.where(hot, ids % int(hot_objects), ids)


def _osd_index(prim: torch.Tensor, n_osds: int):
    """The reference's index semantics for a per-OSD array at ``prim``
    (the acting primary, -1 when a PG has none): a negative index counts
    from the end; out of range after that, a gather clamps and a scatter
    drops.  Returns (clamped index, in-range mask)."""
    idx = torch.where(prim < 0, prim + n_osds, prim)
    return idx.clamp(0, n_osds - 1), (idx >= 0) & (idx < n_osds)


def _route(mask, n_alive, acting_primary, ids, salt, pg_b: int, pg_bmask: int,
           k: int, size: int, min_size: int, write_permille: int):
    """Object ids -> (pg, primary, is_write, blocked, degraded, cost)."""
    dev = ids.device
    h = crush_hash32_2(ids, _u32_scalar(salt, dev))
    pg = ceph_stable_mod(h, int(pg_b), int(pg_bmask))
    coin = crush_hash32_2(h, _u32_scalar(int(salt) ^ int(_SALT2), dev))
    is_write = (coin % 1000) < int(write_permille)
    nsurv = popcount32(mask[pg])
    alive = n_alive[pg]
    blocked = torch.where(is_write, alive < min_size, nsurv < k)
    degraded = ~blocked & (nsurv < size)
    # primary-side op cost: a degraded read fans in k shard reads, a
    # write touches all size slots, a clean read is one unit
    cost = torch.where(
        is_write, size, torch.where(degraded, k, 1)
    ).to(F32)
    return pg, acting_primary[pg].to(I64), is_write, blocked, degraded, cost


def _scatter_load(idx, valid, blocked, cost, n_osds: int) -> torch.Tensor:
    """Per-OSD demand [n_osds] float32 at the primaries' indices
    (:func:`_osd_index`; blocked ops never load).  The costs are 1, k and
    size, so every partial sum is an integer; below 2^24 float32 holds
    each one exactly, so the scatter's order does not matter (65,536 ops
    of cost at most 11 reach 720,896)."""
    w = torch.where(valid & ~blocked, cost, 0.0)
    return torch.zeros(n_osds, dtype=F32, device=idx.device).index_add_(0, idx, w)


def _queue_model(load, idx, is_write, degraded, k: int, service_ms,
                 cap_ops, rho_recovery):
    """(rho, qd, lat) per op, float32, one torch op a step of the
    reference's expression in its order (no fused multiply-add), so the
    CPU and the card round each step alike.  ``cap_ops`` divides as a
    tensor on the device: CUDA multiplies by the reciprocal of a host
    scalar divisor."""
    cap = torch.full((), float(np.maximum(np.float32(cap_ops), np.float32(1e-6))),
                     dtype=F32, device=load.device)
    rho = load[idx] / cap
    rho = rho + float(np.float32(rho_recovery))
    rho = rho.clamp(0.0, RHO_MAX)
    qd = rho / (1.0 - rho)
    amp = torch.where(degraded & ~is_write, float(np.float32(k)), 1.0)
    lat = float(np.float32(service_ms)) * amp
    lat = lat * (1.0 + qd)
    return rho, qd, lat


def _traffic_outcomes(idx, is_write, blocked, degraded, load, k: int, service_ms,
                      cap_ops, rho_recovery, n_buckets: int, lat_min: float):
    """``(counts [3], lat_hist, qd_hist, sums [2], max_rho)`` of one
    routed op batch, given the per-OSD load and the primaries' indices
    into it."""
    rho, qd, lat = _queue_model(load, idx, is_write, degraded, k, service_ms,
                                cap_ops, rho_recovery)
    ok = ~blocked
    okw = ok.to(I32)
    counts = torch.stack([
        (ok & ~degraded).sum(), (ok & degraded).sum(), blocked.sum(),
    ]).to(I32)
    lat_hist = scatter_hist(bucketize(lat, n_buckets, lat_min), okw, n_buckets)
    qd_hist = scatter_hist(bucketize(qd, n_buckets, lat_min), okw, n_buckets)
    sums = _pairwise_sum(torch.stack([
        torch.where(ok, lat, 0.0), torch.where(ok, qd, 0.0),
    ])).to(F32)
    return counts, lat_hist, qd_hist, sums, rho.max()


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis in one fixed pairwise order (zero-padded to
    a power of two, then halved by elementwise adds), so the CPU and the
    card round every partial sum alike; ``torch.sum`` orders its partial
    sums differently on each."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _traffic_reduce(pg, idx, is_write, blocked, degraded, load, n_pgs: int,
                    k: int, service_ms, cap_ops, rho_recovery,
                    n_buckets: int, lat_min: float):
    """Outcome counts + histograms for one routed op batch, given the
    per-OSD load and the primaries' indices into it."""
    counts, lat_hist, qd_hist, sums, max_rho = _traffic_outcomes(
        idx, is_write, blocked, degraded, load, k, service_ms, cap_ops, rho_recovery,
        n_buckets, lat_min)
    ok = ~blocked
    # per-PG integrity feed: which PGs took a committed write (their
    # checksum rows must refresh: checksum-at-write) and which served
    # a degraded read (verify against the table before trusting the
    # reconstruct sources)
    zeros = torch.zeros(n_pgs, dtype=I32, device=pg.device)
    written = zeros.index_add(0, pg, (ok & is_write).to(I32))
    deg_read = zeros.index_add(0, pg, (ok & degraded & ~is_write).to(I32))
    return counts, lat_hist, qd_hist, sums, max_rho, written, deg_read


def traffic_step(
    n_ops: int,
    n_osds: int,
    n_buckets: int = N_BUCKETS,
    lat_min: float = LAT_MIN_MS,
):
    """Single-device step: ``f(mask, n_alive, acting_primary, salt,
    pg_b, pg_bmask, k, size, min_size, write_permille, service_ms,
    cap_ops, rho_recovery) -> (counts [3], lat_hist, qd_hist, sums [2],
    max_rho, written [pg], deg_read [pg])``, on the device of ``mask``
    ([pg] int64 holding u32; ``n_alive``, ``acting_primary`` [pg] int32
    there too).  The scalars are host values; outputs are int32 but
    ``sums`` and ``max_rho``, float32."""
    ids_by_device: dict = {}

    def step(
        mask, n_alive, acting_primary, salt, pg_b, pg_bmask,
        k, size, min_size, write_permille,
        service_ms, cap_ops, rho_recovery,
    ):
        dev = mask.device
        ids = ids_by_device.get(dev)
        if ids is None:
            ids = ids_by_device[dev] = torch.arange(n_ops, dtype=I64, device=dev)
        k, size = int(k), int(size)
        pg, prim, is_write, blocked, degraded, cost = _route(
            mask, n_alive, acting_primary, ids, salt, pg_b, pg_bmask,
            k, size, int(min_size), write_permille,
        )
        idx, valid = _osd_index(prim, n_osds)
        load = _scatter_load(idx, valid, blocked, cost, n_osds)
        return _traffic_reduce(
            pg, idx, is_write, blocked, degraded, load, mask.shape[0],
            k, service_ms, cap_ops, rho_recovery, n_buckets, lat_min,
        )

    return step


def sharded_traffic_step(*args, **kwargs):
    """The reference's mesh step (per-device id slices, psum'd load and
    outputs): :data:`MULTI_DEVICE`."""
    raise NotImplementedError(f"sharded_traffic_step is {MULTI_DEVICE}")


def dirty_fraction(series) -> float:
    """Fraction of a run's epochs whose map moved (peering re-ran) —
    the workload-side marker the dirty-set compaction ladder keys on.
    Accepts any series with a per-epoch ``dirty`` lane."""
    n = len(series)
    if not n:
        return 0.0
    return float(np.asarray(series.dirty, dtype=np.int64).sum()) / n


@dataclass
class TrafficSample:
    """One epoch's client-traffic telemetry (host-side)."""

    t: float
    epoch: int
    ops: int
    served: int
    degraded: int
    blocked: int
    p50_ms: float
    p95_ms: float
    p99_ms: float
    mean_ms: float
    qd_p50: float
    qd_p99: float
    slow_ops: int
    slow_fraction: float
    max_osd_utilization: float
    rho_recovery: float
    ops_per_sec: float  # virtual: completed ops / inter-sample dt
    ops_per_sec_wall: float  # device throughput of the step itself

    @property
    def completed(self) -> int:
        return self.served + self.degraded

    @property
    def served_fraction(self) -> float:
        return self.served / self.ops if self.ops else 1.0

    @property
    def degraded_fraction(self) -> float:
        return self.degraded / self.ops if self.ops else 0.0

    @property
    def blocked_fraction(self) -> float:
        return self.blocked / self.ops if self.ops else 0.0

    def to_dict(self) -> dict:
        return {
            "t": round(self.t, 9),
            "epoch": self.epoch,
            "ops": self.ops,
            "served": self.served,
            "degraded": self.degraded,
            "blocked": self.blocked,
            "served_fraction": round(self.served_fraction, 9),
            "degraded_fraction": round(self.degraded_fraction, 9),
            "blocked_fraction": round(self.blocked_fraction, 9),
            "p50_ms": round(self.p50_ms, 6),
            "p95_ms": round(self.p95_ms, 6),
            "p99_ms": round(self.p99_ms, 6),
            "mean_ms": round(self.mean_ms, 6),
            "qd_p50": round(self.qd_p50, 6),
            "qd_p99": round(self.qd_p99, 6),
            "slow_ops": self.slow_ops,
            "slow_fraction": round(self.slow_fraction, 9),
            "max_osd_utilization": round(self.max_osd_utilization, 6),
            "rho_recovery": round(self.rho_recovery, 6),
            "ops_per_sec": round(self.ops_per_sec, 3),
            "ops_per_sec_wall": round(self.ops_per_sec_wall, 3),
        }


def _build_counters(edges: np.ndarray) -> PerfCounters:
    return (
        PerfCountersBuilder("workload")
        .add_u64_counter("ops_served", "client ops served clean")
        .add_u64_counter("ops_degraded",
                         "client ops served from a degraded PG")
        .add_u64_counter("ops_blocked",
                         "client ops blocked on an inactive PG")
        .add_u64_counter("slow_ops",
                         "ops past the slow-op latency threshold")
        .add_gauge("p99_ms", "latest per-epoch p99 op latency (ms)")
        .add_gauge("max_osd_utilization",
                   "latest peak per-OSD utilization (rho)")
        .add_histogram("op_latency_ms",
                       "client op latency distribution (ms)",
                       [float(e) for e in edges[:-1]])
        .create_perf_counters()
    )


def workload_counters(edges: np.ndarray | None = None) -> PerfCounters:
    """The process-wide ``workload`` perf-counter component."""
    return registry().get("workload") or _build_counters(
        bucket_edges() if edges is None else edges
    )


class TrafficEngine:
    """Drive the traffic step per health sample and fold the results
    into the observability stack.

    One engine owns one step (fixed ``ops_per_step`` batch, so chaos
    epochs and overload windows change only data), the virtual clock,
    the latency ladder, and the cumulative totals.  Call :meth:`observe`
    with the live peering result at every health snapshot; the returned
    :class:`TrafficSample` is what
    :class:`~ceph_tpu_torch.obs.timeline.HealthTimeline` attaches to its
    sample and the SLO layer grades.

    ``arbiter`` (an :class:`~ceph_tpu_torch.workload.qos.MClockArbiter`)
    makes client traffic a first-class QoS citizen: each step's bytes
    are admitted through the ``client`` class before the device launch,
    sharing policy with recovery.  ``recovery_capacity_bps`` converts
    observed inter-sample repair bandwidth into the uniform recovery-
    utilization term; an arbiter that caps recovery bandwidth therefore
    visibly caps client tail latency.

    ``overload`` (set via :meth:`set_overload`) divides per-OSD
    capacity by ``factor`` inside a virtual-time window — the induced
    incident the slow-op SLO must grade OK -> WARN -> OK across.

    The step runs on ``device`` (the card by default).  A peering
    result's device tensors (``dev_survivor_mask`` and its twins) feed
    the step directly and must lie on that device; its host arrays are
    copied there otherwise.  One :meth:`observe` brings its outputs back
    in one device-to-host copy, inside the timed window; the per-PG
    integrity feed comes back only when a scrubber is attached.
    ``mesh=`` raises (:data:`MULTI_DEVICE`).
    """

    def __init__(
        self,
        clock: Callable[[], float],
        n_osds: int,
        pg_num: int,
        k: int,
        size: int,
        min_size: int,
        *,
        ops_per_step: int = 65536,
        write_fraction: float | None = None,
        mix=None,
        service_ms: float = 0.5,
        osd_capacity_ops_per_s: float | None = None,
        recovery_capacity_bps: float | None = None,
        op_bytes: int = 4096,
        slow_ms: float | None = None,
        seed: int = 0,
        mesh=None,
        arbiter: MClockArbiter | None = None,
        journal=None,
        config: Config | None = None,
        n_buckets: int = N_BUCKETS,
        lat_min: float = LAT_MIN_MS,
        flags=None,
        scrubber=None,
        read_shard=None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(f"TrafficEngine mesh= is {MULTI_DEVICE}")
        cfg = config or global_config()
        self.device = resolve_device(device)
        self.clock = clock
        self.n_osds = int(n_osds)
        self.pg_num = int(pg_num)
        self.pg_bmask = (1 << max(int(pg_num) - 1, 1).bit_length()) - 1
        self.k = int(k)
        self.size = int(size)
        self.min_size = int(min_size)
        self.ops_per_step = int(ops_per_step)
        # a named mix supplies the default read/write split (the
        # engine's batch is otherwise uniform; the epoch superstep is
        # where the skew/burst knobs land)
        self.mix = resolve_mix(mix)
        if write_fraction is None:
            write_fraction = (
                self.mix.write_fraction if self.mix is not None else 0.25
            )
        self.write_permille = int(round(float(write_fraction) * 1000))
        self.service_ms = float(service_ms)
        # default capacity: 2x a uniform spread of one batch per second
        self.osd_capacity_ops_per_s = float(
            osd_capacity_ops_per_s
            if osd_capacity_ops_per_s is not None
            else 2.0 * self.ops_per_step / self.n_osds
        )
        self.recovery_capacity_bps = (
            float(recovery_capacity_bps)
            if recovery_capacity_bps is not None
            else 0.0
        )
        self.op_bytes = int(op_bytes)
        self.slow_ms = float(
            slow_ms if slow_ms is not None
            else float(cfg.get("osd_op_complaint_time")) * 1000.0
        )
        self.seed = int(seed)
        self.arbiter = arbiter
        self.journal = journal
        # degraded-mode gating + the checksum-at-write loop: with a
        # ClusterFlags set attached, `pause` stalls the whole batch
        # (an all-zero sample, no device step, no admission); with a
        # Scrubber + read_shard attached, written PGs refresh their
        # checksum rows and degraded reads verify before trusting
        # their reconstruct sources
        self.flags = flags
        self.scrubber = scrubber
        self.read_shard = read_shard
        #: per-step bound on PGs CRC'd inline (the write path samples
        #: its integrity work; a full sweep is the scrubber's job)
        self.integrity_max_pgs_per_step = 16
        self.paused_steps = 0
        self.writes_checksummed = 0
        self.degraded_reads_verified = 0
        self.read_verify_failures = 0
        self.n_buckets = int(n_buckets)
        self.lat_min = float(lat_min)
        self.edges = bucket_edges(self.n_buckets, self.lat_min)
        self.pc = workload_counters(self.edges)
        self._step = traffic_step(
            self.ops_per_step, self.n_osds, self.n_buckets, self.lat_min,
        )
        self._steps = 0
        self._last_t: float | None = None
        self._last_bytes = 0
        self._overload: tuple[float, float, float] | None = None
        # cumulative totals (the headline ops/s and the Prometheus
        # histogram are cluster-lifetime aggregates)
        self.total_ops = 0
        self.total_served = 0
        self.total_degraded = 0
        self.total_blocked = 0
        self.total_slow = 0
        self.total_wall_s = 0.0
        self._cum_lat_hist = np.zeros(self.n_buckets, np.int64)
        self._cum_lat_sum_ms = 0.0
        self.samples: list[TrafficSample] = []

    def set_overload(self, t0: float, t1: float, factor: float) -> None:
        """Divide per-OSD capacity by ``factor`` while virtual time is
        inside ``[t0, t1)`` (the induced-incident knob)."""
        self._overload = (float(t0), float(t1), float(factor))

    def _overload_factor(self, t: float) -> float:
        if self._overload is None:
            return 1.0
        t0, t1, f = self._overload
        return f if t0 <= t < t1 else 1.0

    def _router_inputs(self, peering: PeeringResult):
        """(survivor mask int64, n_alive int32, acting primary int32) on
        the engine's device: the peering pass's device tensors when it
        kept them, else its host arrays copied over."""
        if peering.dev_survivor_mask is not None:
            ins = (peering.dev_survivor_mask, peering.dev_n_alive,
                   peering.dev_acting_primary)
            if any(t.device.type != self.device.type
                   or self.device.index not in (None, t.device.index) for t in ins):
                raise ValueError(
                    f"peering tensors on {ins[0].device}, traffic engine on "
                    f"{self.device}")
            return ins
        host = (np.asarray(peering.survivor_mask, np.uint32).astype(np.int64),
                np.asarray(peering.n_alive, np.int32),
                np.asarray(peering.acting_primary, np.int32))
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in host)

    def observe(
        self,
        peering: PeeringResult,
        epoch: int | None = None,
        bytes_recovered: int = 0,
    ) -> TrafficSample:
        """Route one op batch against the current cluster state and
        fold it into the telemetry.  ``bytes_recovered`` is cumulative
        (the same figure the health timeline records) — the delta since
        the last observation becomes the recovery-utilization term."""
        if self.flags is not None and "pause" in self.flags:
            # the `pause` flag stalls all client IO: no admission, no
            # device step — the sample records a zero-op interval so
            # the series shows the outage instead of skipping it
            t = float(self.clock())
            ep = int(peering.epoch_cur if epoch is None else epoch)
            sample = TrafficSample(
                t=t, epoch=ep, ops=0, served=0, degraded=0, blocked=0,
                p50_ms=0.0, p95_ms=0.0, p99_ms=0.0, mean_ms=0.0,
                qd_p50=0.0, qd_p99=0.0, slow_ops=0, slow_fraction=0.0,
                max_osd_utilization=0.0, rho_recovery=0.0,
                ops_per_sec=0.0, ops_per_sec_wall=0.0,
            )
            self.paused_steps += 1
            self._last_t = t
            self._last_bytes = int(bytes_recovered)
            self.samples.append(sample)
            if self.journal is not None:
                self.journal.event("traffic.paused", epoch=ep, t=t)
            return sample
        if self.arbiter is not None:
            self.arbiter.request(
                "client", self.ops_per_step * self.op_bytes
            )
        t = float(self.clock())
        dt = (t - self._last_t) if self._last_t is not None else 0.0
        # the batch is modeled as arriving over the inter-sample
        # interval; floor it (and default the first, interval-less
        # sample to a nominal second) so back-to-back snapshots — a
        # revise landing right after a window — don't read a full
        # batch as an instantaneous demand spike
        dt_eff = max(dt, 0.25) if self._last_t is not None else 1.0
        rec_bps = max(bytes_recovered - self._last_bytes, 0) / dt_eff
        rho_recovery = (
            min(rec_bps / self.recovery_capacity_bps, 0.9)
            if self.recovery_capacity_bps > 0
            else 0.0
        )
        cap_ops = (
            self.osd_capacity_ops_per_s * dt_eff
            / self._overload_factor(t)
        )
        salt = (self.seed * 2654435761 + self._steps * 40503) & M32
        mask_in, alive_in, prim_in = self._router_inputs(peering)
        ep = int(peering.epoch_cur if epoch is None else epoch)
        with self._jspan("traffic.step", epoch=ep, ops=self.ops_per_step):
            # real wall rate for the step: the launches and the one copy
            # back that waits for them
            t0 = time.perf_counter()
            (counts, lat_hist, qd_hist, sums, max_rho, written,
             deg_read) = self._step(
                mask_in, alive_in, prim_in, salt, self.pg_num, self.pg_bmask,
                self.k, self.size, self.min_size, self.write_permille,
                self.service_ms, cap_ops, rho_recovery,
            )
            packed = torch.cat([
                counts, lat_hist, qd_hist, sums.view(I32), max_rho.reshape(1).view(I32),
            ]).cpu().numpy()
            # measured step wall rate, reported next to simulated time
            # and never mixed into it
            wall = time.perf_counter() - t0
        nb = self.n_buckets
        served, degraded, blocked = (int(c) for c in packed[:3])
        lat_hist = packed[3:3 + nb]
        qd_hist = packed[3 + nb:3 + 2 * nb]
        floats = packed[3 + 2 * nb:].view(np.float32)
        sums, max_rho = floats[:2], float(floats[2])
        ok = served + degraded
        p50, p95, p99 = percentiles(lat_hist, self.edges)
        qd_p50, _qd_p95, qd_p99 = percentiles(qd_hist, self.edges)
        slow = count_at_least(lat_hist, self.edges, self.slow_ms)
        sample = TrafficSample(
            t=t,
            epoch=ep,
            ops=self.ops_per_step,
            served=served,
            degraded=degraded,
            blocked=blocked,
            p50_ms=p50,
            p95_ms=p95,
            p99_ms=p99,
            mean_ms=float(sums[0]) / ok if ok else 0.0,
            qd_p50=qd_p50,
            qd_p99=qd_p99,
            slow_ops=slow,
            slow_fraction=slow / self.ops_per_step,
            max_osd_utilization=max_rho,
            rho_recovery=rho_recovery,
            ops_per_sec=ok / dt if dt > 0 else 0.0,
            ops_per_sec_wall=self.ops_per_step / wall if wall > 0 else 0.0,
        )
        self._steps += 1
        self._last_t = t
        self._last_bytes = int(bytes_recovered)
        self.total_ops += sample.ops
        self.total_served += served
        self.total_degraded += degraded
        self.total_blocked += blocked
        self.total_slow += slow
        self.total_wall_s += wall
        self._cum_lat_hist += lat_hist.astype(np.int64)
        self._cum_lat_sum_ms += float(sums[0])
        self.pc.inc("ops_served", served)
        self.pc.inc("ops_degraded", degraded)
        self.pc.inc("ops_blocked", blocked)
        self.pc.inc("slow_ops", slow)
        self.pc.set("p99_ms", p99)
        self.pc.set("max_osd_utilization", max_rho)
        self.pc.hset(
            "op_latency_ms",
            [int(c) for c in self._cum_lat_hist],
            self._cum_lat_sum_ms,
        )
        self.samples.append(sample)
        self._integrity(written, deg_read, peering, ep)
        return sample

    def _integrity(self, written, deg_read, peering, epoch: int) -> None:
        """The checksum-at-write loop (bluestore analog: checksum the
        data in flight, store it with the onode): PGs that took a
        committed write refresh their Scrubber checksum rows, and PGs
        that served a degraded read verify their surviving shards
        against the table before the reconstruct is trusted — rot can
        no longer hide between scrub passes."""
        if self.scrubber is None or self.read_shard is None:
            return
        lim = self.integrity_max_pgs_per_step
        written, deg_read = torch.stack([written, deg_read]).cpu().numpy()
        wpgs = np.flatnonzero(written)[:lim]
        for pg in wpgs:
            self.scrubber.note_write(int(pg), self.read_shard)
        self.writes_checksummed += int(len(wpgs))
        rpgs = np.flatnonzero(deg_read)[:lim]
        for pg in rpgs:
            pg = int(pg)
            bad = self.scrubber.verify_read(
                pg, self.read_shard,
                mask=int(peering.survivor_mask[pg]),
            )
            self.degraded_reads_verified += 1
            if bad:
                self.read_verify_failures += 1
                if self.journal is not None:
                    self.journal.event(
                        "traffic.read_verify_failed",
                        epoch=epoch, pg=pg, shards=sorted(bad),
                    )

    def _jspan(self, name: str, **attrs):
        if self.journal is not None:
            return self.journal.span(name, **attrs)
        return nullcontext()

    @property
    def ops_per_sec_wall(self) -> float:
        """Lifetime device throughput: routed ops per wall second."""
        return self.total_ops / self.total_wall_s if self.total_wall_s else 0.0

    def summary(self) -> dict:
        """Cumulative totals (the bench JSON / client-io panel feed)."""
        total = self.total_ops or 1
        return {
            "steps": self._steps,
            "ops": self.total_ops,
            "served": self.total_served,
            "degraded": self.total_degraded,
            "blocked": self.total_blocked,
            "slow_ops": self.total_slow,
            "degraded_fraction": round(self.total_degraded / total, 9),
            "blocked_fraction": round(self.total_blocked / total, 9),
            "ops_per_sec_wall": round(self.ops_per_sec_wall, 3),
            "paused_steps": self.paused_steps,
            "writes_checksummed": self.writes_checksummed,
            "degraded_reads_verified": self.degraded_reads_verified,
            "read_verify_failures": self.read_verify_failures,
        }
