"""Declarative availability SLOs checked against a health timeline.

The reference's mgr grades the cluster with named healthchecks
(``PG_AVAILABILITY``, ``PG_DEGRADED``, ...) rolled up into one
``HEALTH_OK/WARN/ERR`` verdict.  Here the spec is declarative — an
:class:`SLOSpec` names the budgets (seconds of inactivity tolerated,
the availability floor, how fast degraded PGs must drain) — and
:func:`evaluate` checks them against a recorded
:class:`~ceph_tpu_torch.obs.timeline.HealthTimeline`, producing per-check
detail strings a chaos test asserts instead of only final
convergence.

Grading: a check whose observed value exceeds its budget is
``HEALTH_ERR``; past ``warn_fraction`` of the budget it is
``HEALTH_WARN``; the report's overall status is the worst check.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .timeline import (
    HEALTH_ERR,
    HEALTH_OK,
    HEALTH_WARN,
    HealthSample,
    HealthTimeline,
    worst_status,
)


@dataclass(frozen=True)
class SLOSpec:
    """Budgets; ``None`` disables a check.

    - ``max_inactive_seconds`` — virtual seconds any PG may sit below
      k survivors (unable to serve I/O) over the whole timeline.
    - ``min_availability_fraction`` — floor on the fraction of PGs able
      to serve I/O at every sample.
    - ``max_time_to_zero_degraded_s`` — the degraded backlog must have
      drained (and stayed drained) by this virtual time.
    - ``min_repair_bandwidth_bps`` — while degraded PGs remain, the
      inter-sample repair bandwidth must reach this floor at least once
      (arXiv:1412.3022's first-class recovery metric).
    - ``max_p99_latency_ms`` — ceiling on the per-sample client p99
      latency estimate, graded on real routed ops when a traffic
      engine rode the run (``SLO_P99_LATENCY``).
    - ``max_slow_op_fraction`` — ceiling on the per-sample fraction of
      client ops past the complaint time (``SLO_SLOW_OPS``, the ``N
      slow ops`` healthcheck analog).
    - ``max_inconsistent_seconds`` — virtual seconds any PG may sit
      scrub-flagged inconsistent (detected corruption awaiting
      verified repair) over the whole timeline
      (``SLO_DATA_INTEGRITY``, the ``PG_DAMAGED`` analog).
    - ``max_scrub_age_s`` — the longest interval the run may go
      without a completed scrub pass (``SLO_SCRUB_AGE``, the
      ``PG_NOT_SCRUBBED`` analog).
    - ``max_detection_latency_s`` — ceiling on the virtual time between
      an OSD going silent and the failure detector marking it down
      (``SLO_DETECTION_LATENCY``, the ``osd_heartbeat_grace`` +
      reporter-quorum delay an operator actually waits through).
    - ``max_rank_stall_rounds`` — ceiling on the consecutive
      reconcile rounds any simulation rank may sit without progress
      before the divergent-rank run counts as degraded
      (``SLO_RANK_STALL``, the ``MON_DOWN`` analog: the cluster kept
      serving, but on a shrunken quorum).
    - ``max_checkpoint_age_s`` — the longest interval the run may go
      without a committed checkpoint (``SLO_CHECKPOINT_AGE``: the
      worst-case simulated time a process kill would discard — the
      RPO of the run).
    """

    max_inactive_seconds: float | None = None
    min_availability_fraction: float | None = None
    max_time_to_zero_degraded_s: float | None = None
    min_repair_bandwidth_bps: float | None = None
    max_p99_latency_ms: float | None = None
    max_slow_op_fraction: float | None = None
    max_inconsistent_seconds: float | None = None
    max_scrub_age_s: float | None = None
    max_detection_latency_s: float | None = None
    max_rank_stall_rounds: int | None = None
    max_checkpoint_age_s: float | None = None
    warn_fraction: float = 0.8

    def sample_status(self, sample: HealthSample) -> str:
        """Streaming per-sample grade (the timeline calls this as each
        snapshot lands): an availability-floor breach is ERR on the
        spot; any not-clean PG is WARN; else OK."""
        if (
            self.min_availability_fraction is not None
            and sample.availability < self.min_availability_fraction
        ):
            return HEALTH_ERR
        if sample.unhealthy_pgs() > 0:
            return HEALTH_WARN
        tr = sample.traffic
        if tr is not None:
            # traffic breaches grade WARN, like the reference's slow-op
            # healthchecks: the cluster still serves, it serves badly
            if (
                self.max_p99_latency_ms is not None
                and tr.p99_ms > self.max_p99_latency_ms
            ):
                return HEALTH_WARN
            if (
                self.max_slow_op_fraction is not None
                and tr.slow_fraction > self.max_slow_op_fraction
            ):
                return HEALTH_WARN
        return HEALTH_OK


@dataclass
class HealthCheck:
    """One graded check (a mgr healthcheck analog)."""

    name: str
    status: str
    detail: str
    observed: float
    budget: float

    def to_dict(self) -> dict:
        return {
            "status": self.status,
            "detail": self.detail,
            "observed": round(self.observed, 9),
            "budget": self.budget,
        }


@dataclass
class HealthReport:
    """All checks plus the rolled-up verdict."""

    status: str = HEALTH_OK
    checks: list[HealthCheck] = field(default_factory=list)

    def check(self, name: str) -> HealthCheck | None:
        for c in self.checks:
            if c.name == name:
                return c
        return None

    def to_dict(self) -> dict:
        return {
            "status": self.status,
            "checks": {c.name: c.to_dict() for c in self.checks},
        }

    def _add(self, check: HealthCheck) -> None:
        self.checks.append(check)
        self.status = worst_status(self.status, check.status)


def _grade_max(observed: float, budget: float, warn_fraction: float) -> str:
    """Smaller-is-better grading against a ceiling."""
    if observed > budget:
        return HEALTH_ERR
    if budget > 0 and observed > warn_fraction * budget:
        return HEALTH_WARN
    return HEALTH_OK


def evaluate(timeline: HealthTimeline, spec: SLOSpec) -> HealthReport:
    """Grade a recorded timeline against the spec."""
    report = HealthReport()
    if spec.max_inactive_seconds is not None:
        observed = timeline.inactive_seconds()
        report._add(HealthCheck(
            "SLO_INACTIVE",
            _grade_max(
                observed, spec.max_inactive_seconds, spec.warn_fraction
            ),
            f"PGs below k survivors for {observed:g}s of virtual time "
            f"(budget {spec.max_inactive_seconds:g}s)",
            observed, spec.max_inactive_seconds,
        ))
    if spec.min_availability_fraction is not None:
        floor = spec.min_availability_fraction
        observed = timeline.min_availability()
        if observed < floor:
            status = HEALTH_ERR
        elif observed < 1.0:
            status = HEALTH_WARN
        else:
            status = HEALTH_OK
        report._add(HealthCheck(
            "SLO_AVAILABILITY",
            status,
            f"availability dipped to {observed:.6f} "
            f"(floor {floor:g})",
            observed, floor,
        ))
    if spec.max_time_to_zero_degraded_s is not None:
        t0 = timeline.time_to_zero_degraded()
        last = timeline.latest
        # never drained: pin observed past the budget
        observed = (
            t0 if t0 is not None
            else (last.t if last else 0.0) + spec.max_time_to_zero_degraded_s
        )
        detail = (
            f"degraded backlog drained at t={observed:g}s "
            f"(budget {spec.max_time_to_zero_degraded_s:g}s)"
            if t0 is not None
            else "degraded backlog never drained"
        )
        report._add(HealthCheck(
            "SLO_RECOVERY_TIME",
            HEALTH_ERR if t0 is None else _grade_max(
                observed, spec.max_time_to_zero_degraded_s,
                spec.warn_fraction,
            ),
            detail,
            observed, spec.max_time_to_zero_degraded_s,
        ))
    if spec.min_repair_bandwidth_bps is not None:
        repairing = [
            s.repair_bandwidth_bps
            for prev, s in zip(timeline.samples, timeline.samples[1:])
            if prev.unhealthy_pgs() > 0 and s.t > prev.t
        ]
        observed = max(repairing, default=0.0)
        if not repairing:
            status, detail = HEALTH_OK, "no repair intervals to grade"
        elif observed < spec.min_repair_bandwidth_bps:
            status = HEALTH_ERR
            detail = (
                f"peak repair bandwidth {observed:.0f} B/s under the "
                f"{spec.min_repair_bandwidth_bps:.0f} B/s floor"
            )
        else:
            status = HEALTH_OK
            detail = f"peak repair bandwidth {observed:.0f} B/s"
        report._add(HealthCheck(
            "SLO_REPAIR_BANDWIDTH", status, detail,
            observed, spec.min_repair_bandwidth_bps,
        ))
    traffic = timeline.traffic_samples()
    if spec.max_p99_latency_ms is not None and traffic:
        observed = timeline.max_traffic_p99_ms()
        report._add(HealthCheck(
            "SLO_P99_LATENCY",
            _grade_max(
                observed, spec.max_p99_latency_ms, spec.warn_fraction
            ),
            f"worst client p99 {observed:g} ms over "
            f"{len(traffic)} traffic samples "
            f"(budget {spec.max_p99_latency_ms:g} ms)",
            observed, spec.max_p99_latency_ms,
        ))
    if spec.max_slow_op_fraction is not None and traffic:
        observed = timeline.max_slow_op_fraction()
        slow_total = sum(tr.slow_ops for tr in traffic)
        report._add(HealthCheck(
            "SLO_SLOW_OPS",
            _grade_max(
                observed, spec.max_slow_op_fraction, spec.warn_fraction
            ),
            f"{slow_total} client ops past the complaint time; worst "
            f"per-sample slow fraction {observed:g} "
            f"(budget {spec.max_slow_op_fraction:g})",
            observed, spec.max_slow_op_fraction,
        ))
    if spec.max_inconsistent_seconds is not None:
        observed = timeline.inconsistent_seconds()
        report._add(HealthCheck(
            "SLO_DATA_INTEGRITY",
            _grade_max(
                observed, spec.max_inconsistent_seconds,
                spec.warn_fraction,
            ),
            f"PGs scrub-flagged inconsistent for {observed:g}s of "
            f"virtual time (budget {spec.max_inconsistent_seconds:g}s)",
            observed, spec.max_inconsistent_seconds,
        ))
    if spec.max_scrub_age_s is not None:
        observed = timeline.max_scrub_age()
        report._add(HealthCheck(
            "SLO_SCRUB_AGE",
            _grade_max(
                observed, spec.max_scrub_age_s, spec.warn_fraction
            ),
            f"longest interval without a completed scrub pass "
            f"{observed:g}s (budget {spec.max_scrub_age_s:g}s)",
            observed, spec.max_scrub_age_s,
        ))
    if spec.max_detection_latency_s is not None:
        lats = timeline.detection_latencies
        observed = timeline.max_detection_latency()
        if not lats:
            status, detail = HEALTH_OK, "no failures to detect"
        else:
            status = _grade_max(
                observed, spec.max_detection_latency_s, spec.warn_fraction
            )
            detail = (
                f"worst failure-to-mark-down latency {observed:g}s over "
                f"{len(lats)} detections "
                f"(budget {spec.max_detection_latency_s:g}s)"
            )
        report._add(HealthCheck(
            "SLO_DETECTION_LATENCY", status, detail,
            observed, spec.max_detection_latency_s,
        ))
    if spec.max_rank_stall_rounds is not None:
        observed = float(timeline.max_rank_stall_rounds())
        budget = float(spec.max_rank_stall_rounds)
        if not timeline.rank_rounds and not timeline.rank_stalls:
            status, detail = HEALTH_OK, "no divergent-rank run to grade"
        else:
            status = _grade_max(observed, budget, spec.warn_fraction)
            detail = (
                f"worst rank stall {observed:g} consecutive reconcile "
                f"rounds over {len(timeline.rank_rounds)} rounds "
                f"(budget {budget:g})"
            )
        report._add(HealthCheck(
            "SLO_RANK_STALL", status, detail, observed, budget,
        ))
    if spec.max_checkpoint_age_s is not None:
        observed = timeline.max_checkpoint_age()
        if not timeline.checkpoint_times:
            status = HEALTH_ERR if timeline.samples else HEALTH_OK
            detail = (
                "no checkpoint ever committed (a kill discards the "
                "whole run)" if timeline.samples
                else "no samples to grade"
            )
        else:
            status = _grade_max(
                observed, spec.max_checkpoint_age_s, spec.warn_fraction
            )
            detail = (
                f"longest interval without a committed checkpoint "
                f"{observed:g}s over "
                f"{len(timeline.checkpoint_times)} commits "
                f"(budget {spec.max_checkpoint_age_s:g}s)"
            )
        report._add(HealthCheck(
            "SLO_CHECKPOINT_AGE", status, detail,
            observed, spec.max_checkpoint_age_s,
        ))
    return report
