"""``ceph -s`` analog: cluster status view + admin-socket trio.

Bundles the latest :class:`~ceph_tpu_torch.obs.timeline.HealthTimeline`
sample, the SLO report, and the recent event journal into the three
admin-socket commands operators poll (``status`` / ``health`` /
``timeline``), plus the text rendering of the ``status`` reply.
"""

from __future__ import annotations

from .slo import SLOSpec, evaluate
from .timeline import HEALTH_OK, HealthTimeline


def status_dict(
    timeline: HealthTimeline,
    spec: SLOSpec | None = None,
    scrub: dict | None = None,
    liveness: dict | None = None,
    caches: dict | None = None,
) -> dict:
    """The ``status`` reply: latest histogram + rolled-up health.

    ``scrub`` is an optional data-integrity panel (pass counts, bytes
    verified, inconsistencies, verify retries — the shape
    ``cli.status`` builds from a
    :class:`~ceph_tpu_torch.recovery.executor.SupervisedResult`).
    ``liveness`` is an optional failure-detection panel — a
    :meth:`~ceph_tpu_torch.recovery.liveness.LivenessDetector.summary` dict,
    optionally extended with a ``flags`` list of raised cluster
    flags.  ``caches`` is an optional compiled-program cache panel —
    per-cache hit/miss/eviction counters, the shape of
    :func:`~ceph_tpu_torch.ec.schedule.dump_ec_schedules`."""
    latest = timeline.latest
    report = (
        evaluate(timeline, spec).to_dict() if spec is not None else None
    )
    if latest is None:
        return {
            "health": {"status": HEALTH_OK, "checks": {}},
            "pgmap": {"pgs": {}, "total_pgs": 0},
            "samples": 0,
        }
    out = {
        "health": report or {
            "status": latest.health,
            "checks": {},
        },
        "pgmap": {
            "pgs": dict(latest.counts),
            "total_pgs": latest.total_pgs,
            "degraded_objects": latest.degraded_objects,
            "misplaced_objects": latest.misplaced_objects,
            "availability": round(latest.availability, 9),
            "repair_bandwidth_bps": round(
                latest.repair_bandwidth_bps, 3
            ),
        },
        "t": round(latest.t, 9),
        "epoch": latest.epoch,
        "samples": len(timeline),
    }
    # the ``io:`` block — newest traffic sample riding the timeline
    tr = next(
        (s.traffic for s in reversed(timeline.samples)
         if s.traffic is not None),
        None,
    )
    if tr is not None:
        out["client_io"] = {
            "ops_per_sec": round(tr.ops_per_sec, 3),
            "p50_ms": tr.p50_ms,
            "p95_ms": tr.p95_ms,
            "p99_ms": tr.p99_ms,
            "served_fraction": round(tr.served_fraction, 9),
            "degraded_fraction": round(tr.degraded_fraction, 9),
            "blocked_fraction": round(tr.blocked_fraction, 9),
            "slow_ops": tr.slow_ops,
            "max_osd_utilization": round(tr.max_osd_utilization, 9),
        }
    if scrub is not None:
        out["scrub"] = dict(scrub)
    if liveness is not None:
        out["liveness"] = dict(liveness)
    if caches is not None:
        out["caches"] = dict(caches)
    return out


def render_status(status: dict) -> str:
    """Human text for the ``status`` dict (the ``ceph -s`` shape)."""
    lines = [
        "  cluster:",
        f"    health: {status['health']['status']}",
    ]
    for name, check in sorted(status["health"].get("checks", {}).items()):
        lines.append(f"      {name} {check['status']}: {check['detail']}")
    pgmap = status["pgmap"]
    lines.append("  data:")
    lines.append(f"    pgs: {pgmap['total_pgs']}")
    for name, n in pgmap.get("pgs", {}).items():
        if n:
            lines.append(f"      {n} {name}")
    if pgmap.get("degraded_objects"):
        lines.append(
            f"    degraded objects: {pgmap['degraded_objects']}"
        )
    if pgmap.get("misplaced_objects"):
        lines.append(
            f"    misplaced objects: {pgmap['misplaced_objects']}"
        )
    if "availability" in pgmap:
        lines.append(f"    availability: {pgmap['availability']:.6f}")
    if pgmap.get("repair_bandwidth_bps"):
        lines.append(
            "    recovery: "
            f"{pgmap['repair_bandwidth_bps']:.0f} B/s"
        )
    io = status.get("client_io")
    if io is not None:
        lines.append("  io:")
        lines.append(
            f"    client: {io['ops_per_sec']:.0f} op/s, "
            f"p50/p95/p99 {io['p50_ms']:g}/{io['p95_ms']:g}/"
            f"{io['p99_ms']:g} ms"
        )
        lines.append(
            f"    outcomes: {io['served_fraction']:.4f} served, "
            f"{io['degraded_fraction']:.4f} degraded, "
            f"{io['blocked_fraction']:.4f} blocked"
        )
        if io.get("slow_ops"):
            lines.append(f"    slow ops: {io['slow_ops']}")
    scrub = status.get("scrub")
    if scrub is not None:
        lines.append("  scrub:")
        lines.append(
            f"    {scrub.get('passes', 0)} passes, "
            f"{scrub.get('scrubbed_bytes', 0)} bytes verified"
        )
        if scrub.get("inconsistencies_found") or scrub.get("verify_retries"):
            lines.append(
                f"    inconsistencies: {scrub.get('inconsistencies_found', 0)}"
                f" found, {scrub.get('verify_retries', 0)} verify retries"
            )
        unrec = scrub.get("inconsistent_unrecoverable") or ()
        if unrec:
            lines.append(
                "    inconsistent-unrecoverable pgs: "
                + ", ".join(str(p) for p in unrec)
            )
        ttz = scrub.get("time_to_zero_inconsistent_s")
        if ttz:
            lines.append(f"    time to zero inconsistent: {ttz:g}s")
    lv = status.get("liveness")
    if lv is not None:
        lines.append("  osd:")
        n = lv.get("n_osds", 0)
        down = lv.get("osds_down", 0)
        lines.append(f"    {n - down} up, {down} down ({n} total)")
        if lv.get("osds_laggy"):
            lines.append(f"    laggy: {lv['osds_laggy']}")
        if lv.get("flags"):
            lines.append(
                "    flags: " + ",".join(sorted(lv["flags"]))
            )
        if lv.get("auto_out_events") or lv.get("flap_damped_events"):
            lines.append(
                f"    detector: {lv.get('detections', 0)} detections, "
                f"{lv.get('auto_out_events', 0)} auto-out, "
                f"{lv.get('flap_damped_events', 0)} flap-damped"
            )
    caches = status.get("caches")
    if caches is not None:
        lines.append("  caches:")
        for name, c in sorted(caches.items()):
            if not isinstance(c, dict):
                continue
            parts = (
                f"    {name}: {c.get('hits', 0)} hits, "
                f"{c.get('misses', 0)} misses, "
                f"{c.get('evictions', 0)} evictions"
            )
            if "entries" in c:
                parts += f", {c['entries']} entries"
            lines.append(parts)
    return "\n".join(lines)


def register_admin_hooks(
    admin,
    timeline: HealthTimeline,
    spec: SLOSpec | None = None,
    journal=None,
) -> None:
    """Register the ``status``/``health``/``timeline`` trio (and, with
    a journal, ``journal dump``) on an
    :class:`~ceph_tpu_torch.common.admin_socket.AdminSocket`."""
    admin.register(
        "status", lambda cmd: status_dict(timeline, spec)
    )
    admin.register(
        "health",
        lambda cmd: (
            evaluate(timeline, spec).to_dict()
            if spec is not None
            else {
                "status": (
                    timeline.latest.health
                    if timeline.latest is not None
                    else HEALTH_OK
                ),
                "checks": {},
            }
        ),
    )
    admin.register(
        "timeline", lambda cmd: {"series": timeline.to_dicts()}
    )
    if journal is not None:
        admin.register(
            "journal dump", lambda cmd: {"records": journal.records}
        )
