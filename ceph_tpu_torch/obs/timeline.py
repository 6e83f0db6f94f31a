"""Cluster-health time series keyed on the chaos engine's virtual clock.

``ceph -s`` shows a point-in-time PG histogram; what chaos scenarios
need is the *curve* — how many PGs were degraded or inactive at every
epoch of the timeline, how fast repair bandwidth drained the backlog —
so availability SLOs can be asserted over the whole run, not just the
converged end state (arXiv:1709.05365: online EC's real cost is
system-level degraded-I/O behavior; arXiv:1412.3022: repair *bandwidth*
is the first-class recovery metric).

A :class:`HealthTimeline` snapshots the device-side PG-state histogram
(:class:`~ceph_tpu_torch.obs.pg_states.PGStateClassifier`) at every observed
epoch, stamps each sample with the virtual clock, and derives the
repair-bandwidth estimate from the byte progress between samples.
The histogram is computed on one device (``device=``); the series is
held equal to the reference package's in tests/test_torch_obs.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..recovery.peering import PeeringResult
from .pg_states import N_STATES, STATE_NAMES, PGStateClassifier

HEALTH_OK = "HEALTH_OK"
HEALTH_WARN = "HEALTH_WARN"
HEALTH_ERR = "HEALTH_ERR"

_SEVERITY = {HEALTH_OK: 0, HEALTH_WARN: 1, HEALTH_ERR: 2}


def worst_status(*statuses: str) -> str:
    """The most severe of the given HEALTH_* strings."""
    return max(statuses or (HEALTH_OK,), key=lambda s: _SEVERITY[s])


@dataclass
class HealthSample:
    """One point of the cluster-health series."""

    t: float  # virtual clock seconds
    epoch: int
    counts: dict[str, int]  # state name -> PG count
    total_pgs: int
    degraded_shard_slots: int  # lost shard-slots across degraded PGs
    misplaced_pgs: int  # remapped-but-complete PGs
    degraded_objects: int  # slot estimate x objects_per_pg
    misplaced_objects: int
    bytes_recovered: int  # cumulative at sample time
    repair_bandwidth_bps: float  # since the previous sample
    availability: float  # fraction of PGs able to serve I/O
    health: str = HEALTH_OK  # per-sample status (streaming SLO view)
    # foreground-traffic sample taken against the same epoch (a
    # ceph_tpu_torch.workload.TrafficSample), when a traffic engine rode the
    # run; None for pure-recovery timelines
    traffic: object | None = None
    # failure-detector view at sample time (0 when no detector rode
    # the run): OSDs the detector holds down, OSDs over the laggy
    # probability threshold
    osds_down: int = 0
    osds_laggy: int = 0

    @property
    def inactive_pgs(self) -> int:
        return self.counts["inactive"]

    def unhealthy_pgs(self) -> int:
        """PGs in any state but active+clean."""
        return self.total_pgs - self.counts["active+clean"]

    def to_dict(self) -> dict:
        return {
            "t": round(self.t, 9),
            "epoch": self.epoch,
            "pgs": dict(self.counts),
            "total_pgs": self.total_pgs,
            "degraded_shard_slots": self.degraded_shard_slots,
            "misplaced_pgs": self.misplaced_pgs,
            "degraded_objects": self.degraded_objects,
            "misplaced_objects": self.misplaced_objects,
            "bytes_recovered": self.bytes_recovered,
            "repair_bandwidth_bps": round(self.repair_bandwidth_bps, 3),
            "availability": round(self.availability, 9),
            "health": self.health,
            "traffic": (
                self.traffic.to_dict() if self.traffic is not None else None
            ),
            "osds_down": self.osds_down,
            "osds_laggy": self.osds_laggy,
        }


class HealthTimeline:
    """Per-epoch PG-state series on the virtual clock.

    ``clock`` is any ``() -> float`` (a
    :class:`~ceph_tpu_torch.recovery.chaos.VirtualClock`'s ``now``); ``k`` the
    reconstruction threshold the ``inactive`` state keys on (the EC
    codec's k); ``objects_per_pg`` scales shard-slot counts to the
    degraded/misplaced *object* estimates operators read in ``ceph -s``.
    ``sample_status`` lets an SLO spec grade each sample as it lands
    (:meth:`ceph_tpu_torch.obs.slo.SLOSpec.sample_status`); without one, any
    not-clean PG makes the sample ``HEALTH_WARN``.  ``device`` is where
    the PG-state classifier runs; with a ``mesh`` it runs over the
    mesh's ranks (:func:`~ceph_tpu_torch.obs.pg_states.
    sharded_pg_state_step`), every rank holding the identical series.
    """

    def __init__(
        self,
        clock: Callable[[], float],
        k: int | None = None,
        mesh=None,
        objects_per_pg: int = 1,
        sample_status: Callable[[HealthSample], str] | None = None,
        device="cuda",
    ):
        self.clock = clock
        self.k = k
        self.objects_per_pg = int(objects_per_pg)
        self.sample_status = sample_status
        self.samples: list[HealthSample] = []
        # virtual times of completed scrub passes (note_scrub); the
        # SLO_SCRUB_AGE budget grades the largest gap between them
        self.scrub_times: list[float] = []
        # failure-to-mark-down latencies (note_detection); the
        # SLO_DETECTION_LATENCY budget grades the worst one
        self.detection_latencies: list[float] = []
        # divergent-rank reconciliation series (note_rank_round):
        # per-round (n_live, n_laggy, diverged) triples, and the worst
        # consecutive-stall count per rank (note_rank_stall); the
        # SLO_RANK_STALL budget grades the latter
        self.rank_rounds: list[tuple[int, int, bool]] = []
        self.rank_stalls: dict[int, int] = {}
        # virtual times of committed checkpoints (note_checkpoint);
        # the SLO_CHECKPOINT_AGE budget grades the largest gap — the
        # simulated time a kill at the worst moment would discard
        self.checkpoint_times: list[float] = []
        self._classifier = PGStateClassifier(mesh, device=device)

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def latest(self) -> HealthSample | None:
        return self.samples[-1] if self.samples else None

    def snapshot(
        self,
        peering: PeeringResult,
        epoch: int | None = None,
        bytes_recovered: int = 0,
        traffic=None,
        liveness=None,
    ) -> HealthSample:
        """Record the cluster's health at the current virtual time.
        ``liveness`` is a
        :class:`~ceph_tpu_torch.recovery.liveness.LivenessDetector` whose
        down/laggy view stamps the sample."""
        hist, aux = self._classifier(peering, self.k)
        counts = {
            name: int(hist[i]) for i, name in enumerate(STATE_NAMES)
        }
        total = int(hist.sum())
        t = float(self.clock())
        prev = self.latest
        dt = t - prev.t if prev is not None else 0.0
        dbytes = (
            bytes_recovered - prev.bytes_recovered
            if prev is not None else 0
        )
        sample = HealthSample(
            t=t,
            epoch=int(peering.epoch_cur if epoch is None else epoch),
            counts=counts,
            total_pgs=total,
            degraded_shard_slots=int(aux[0]),
            misplaced_pgs=int(aux[1]),
            degraded_objects=int(aux[0]) * self.objects_per_pg,
            misplaced_objects=int(aux[1]) * self.objects_per_pg,
            bytes_recovered=int(bytes_recovered),
            repair_bandwidth_bps=dbytes / dt if dt > 0 else 0.0,
            availability=(
                1.0 - counts["inactive"] / total if total else 1.0
            ),
            traffic=traffic,
            osds_down=(
                int(liveness.osds_down) if liveness is not None else 0
            ),
            osds_laggy=(
                int(liveness.osds_laggy) if liveness is not None else 0
            ),
        )
        sample.health = (
            self.sample_status(sample)
            if self.sample_status is not None
            else (
                HEALTH_OK if sample.unhealthy_pgs() == 0 else HEALTH_WARN
            )
        )
        self.samples.append(sample)
        return sample

    def series(self) -> dict:
        """Column-oriented series for one JSON line: parallel lists,
        one entry per sample."""
        cols: dict = {
            "t": [round(s.t, 9) for s in self.samples],
            "epoch": [s.epoch for s in self.samples],
            "availability": [
                round(s.availability, 9) for s in self.samples
            ],
            "health": [s.health for s in self.samples],
            "degraded_objects": [s.degraded_objects for s in self.samples],
            "misplaced_objects": [
                s.misplaced_objects for s in self.samples
            ],
            "bytes_recovered": [s.bytes_recovered for s in self.samples],
            "repair_bandwidth_bps": [
                round(s.repair_bandwidth_bps, 3) for s in self.samples
            ],
        }
        for name in STATE_NAMES:
            cols[name] = [s.counts[name] for s in self.samples]
        if any(s.osds_down or s.osds_laggy for s in self.samples):
            cols["osds_down"] = [s.osds_down for s in self.samples]
            cols["osds_laggy"] = [s.osds_laggy for s in self.samples]
        # reconcile-round columns ride along (their own cadence: one
        # entry per round, not per sample)
        cols.update(self.rank_series())
        if any(s.traffic is not None for s in self.samples):
            def _tcol(fn):
                return [
                    fn(s.traffic) if s.traffic is not None else None
                    for s in self.samples
                ]

            cols["traffic_p50_ms"] = _tcol(lambda tr: tr.p50_ms)
            cols["traffic_p99_ms"] = _tcol(lambda tr: tr.p99_ms)
            cols["traffic_served_fraction"] = _tcol(
                lambda tr: round(tr.served_fraction, 9)
            )
            cols["traffic_degraded_fraction"] = _tcol(
                lambda tr: round(tr.degraded_fraction, 9)
            )
            cols["traffic_blocked_fraction"] = _tcol(
                lambda tr: round(tr.blocked_fraction, 9)
            )
            cols["traffic_slow_fraction"] = _tcol(
                lambda tr: round(tr.slow_fraction, 9)
            )
        return cols

    def to_dicts(self) -> list[dict]:
        """Row-oriented dump (the ``timeline`` admin-socket reply)."""
        return [s.to_dict() for s in self.samples]

    # ---- aggregates the SLO evaluator (and bench guards) read -------

    def min_availability(self) -> float:
        return min(
            (s.availability for s in self.samples), default=1.0
        )

    def traffic_samples(self) -> list:
        """The foreground-traffic samples riding this timeline."""
        return [s.traffic for s in self.samples if s.traffic is not None]

    def max_traffic_p99_ms(self) -> float:
        return max(
            (tr.p99_ms for tr in self.traffic_samples()), default=0.0
        )

    def max_slow_op_fraction(self) -> float:
        return max(
            (tr.slow_fraction for tr in self.traffic_samples()),
            default=0.0,
        )

    def note_scrub(self) -> None:
        """Mark a completed scrub pass at the current virtual time."""
        self.scrub_times.append(float(self.clock()))

    def note_checkpoint(self) -> None:
        """Mark a committed (durable, manifest-chained) checkpoint at
        the current virtual time (a checkpoint store calls this when
        given a health timeline)."""
        self.checkpoint_times.append(float(self.clock()))

    def max_checkpoint_age(self) -> float:
        """The longest virtual-time interval the run went without a
        committed checkpoint — run start to first commit, between
        commits, and last commit to the final sample: the worst-case
        simulated time a kill would discard.  With no checkpoints at
        all this is the whole run."""
        if not self.samples:
            return 0.0
        pts = [
            self.samples[0].t,
            *sorted(self.checkpoint_times),
            self.samples[-1].t,
        ]
        return max(b - a for a, b in zip(pts, pts[1:]))

    def note_detection(self, latency_s: float) -> None:
        """Record one failure-detection latency (virtual seconds from
        heartbeat silence to the detector marking the OSD down)."""
        self.detection_latencies.append(float(latency_s))

    def note_rank_round(
        self, *, n_live: int, laggy: int, diverged: bool
    ) -> None:
        """Record one divergent-rank reconciliation round's verdict
        (a reconcile protocol calls this after every round)."""
        self.rank_rounds.append((int(n_live), int(laggy), bool(diverged)))

    def note_rank_stall(self, rank: int, rounds: int) -> None:
        """Record a rank crossing the laggy deadline after ``rounds``
        consecutive no-progress reconcile rounds (worst count kept)."""
        rank = int(rank)
        self.rank_stalls[rank] = max(
            self.rank_stalls.get(rank, 0), int(rounds)
        )

    def max_rank_stall_rounds(self) -> int:
        """The worst consecutive-stall count any rank reached (0 when
        no rank ever went laggy) — the SLO_RANK_STALL budget's input."""
        return max(self.rank_stalls.values(), default=0)

    def rank_series(self) -> dict:
        """Column-oriented reconcile-round series (one entry per
        round), empty dict when no divergent run rode this timeline."""
        if not self.rank_rounds:
            return {}
        return {
            "rank_n_live": [r[0] for r in self.rank_rounds],
            "rank_n_laggy": [r[1] for r in self.rank_rounds],
            "rank_diverged": [r[2] for r in self.rank_rounds],
        }

    def max_detection_latency(self) -> float:
        """The worst failure-to-mark-down latency of the run (0 when
        nothing was detected — an undetected failure shows up as
        degraded PGs, not here)."""
        return max(self.detection_latencies, default=0.0)

    def inconsistent_seconds(self) -> float:
        """Virtual seconds any PG spent scrub-flagged inconsistent:
        the same step-function integral as :meth:`inactive_seconds`."""
        total = 0.0
        for a, b in zip(self.samples, self.samples[1:]):
            if a.counts.get("inconsistent", 0) > 0:
                total += b.t - a.t
        return total

    def max_scrub_age(self) -> float:
        """The longest virtual-time interval the run went without a
        completed scrub pass — run start to first scrub, between
        scrubs, and last scrub to the final sample.  With no scrubs at
        all this is the whole run."""
        if not self.samples:
            return 0.0
        pts = [
            self.samples[0].t,
            *sorted(self.scrub_times),
            self.samples[-1].t,
        ]
        return max(b - a for a, b in zip(pts, pts[1:]))

    def inactive_seconds(self) -> float:
        """Virtual seconds any PG spent inactive: the step-function
        integral between samples (an interval counts when the sample
        OPENING it had inactive PGs — states only change at epochs, and
        epochs always produce a sample)."""
        total = 0.0
        for a, b in zip(self.samples, self.samples[1:]):
            if a.inactive_pgs > 0:
                total += b.t - a.t
        return total

    def time_to_zero_degraded(self) -> float | None:
        """Virtual time of the first sample after which the cluster
        stayed clean of degraded/undersized/inactive PGs; None while
        still dirty (or before any sample)."""
        clean_since = None
        for s in self.samples:
            bad = (
                s.counts["degraded"]
                + s.counts["undersized"]
                + s.counts["inactive"]
            )
            if bad:
                clean_since = None
            elif clean_since is None:
                clean_since = s.t
        return clean_since
