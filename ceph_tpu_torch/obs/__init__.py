"""Cluster-health telemetry: PG-state time series, SLOs, event journal.

The observability layer over the recovery/chaos machinery:

- :mod:`~ceph_tpu_torch.obs.pg_states` — survivor-bitmask -> PG-state
  histogram as torch ops on one device.
- :mod:`~ceph_tpu_torch.obs.timeline` — :class:`HealthTimeline`, the
  per-epoch series on the chaos engine's virtual clock.
- :mod:`~ceph_tpu_torch.obs.slo` — declarative :class:`SLOSpec` budgets
  graded into ``HEALTH_OK/WARN/ERR`` healthchecks.
- :mod:`~ceph_tpu_torch.obs.journal` — correlated JSONL span/event log.
- :mod:`~ceph_tpu_torch.obs.status` — ``ceph -s`` analog + admin-socket
  trio.

- :mod:`~ceph_tpu_torch.obs.flight` — the flight recorder: a ring of
  per-epoch telemetry rows on the device, drains, crash dumps.
- :mod:`~ceph_tpu_torch.obs.traceexport` — Chrome-trace export of
  journal spans and drained flight rows.
"""

from .flight import (
    FLIGHT_LANES,
    FlightState,
    crash_dump_guard,
    drain_flight,
    empty_flight,
    flight_record,
    flight_row,
    journal_drain,
    read_flight_dump,
    resolve_flight_recorder,
    write_flight_dump,
)
from .journal import EventJournal
from .pg_states import (
    N_STATES,
    STATE_NAMES,
    PGStateClassifier,
    pg_state_step,
    sharded_pg_state_step,
)
from .slo import HealthCheck, HealthReport, SLOSpec, evaluate
from .status import register_admin_hooks, render_status, status_dict
from .traceexport import build_trace, export_trace, validate_trace
from .timeline import (
    HEALTH_ERR,
    HEALTH_OK,
    HEALTH_WARN,
    HealthSample,
    HealthTimeline,
    worst_status,
)

__all__ = [
    "FLIGHT_LANES",
    "FlightState",
    "build_trace",
    "crash_dump_guard",
    "drain_flight",
    "empty_flight",
    "export_trace",
    "flight_record",
    "flight_row",
    "journal_drain",
    "read_flight_dump",
    "resolve_flight_recorder",
    "validate_trace",
    "write_flight_dump",
    "EventJournal",
    "HEALTH_ERR",
    "HEALTH_OK",
    "HEALTH_WARN",
    "HealthCheck",
    "HealthReport",
    "HealthSample",
    "HealthTimeline",
    "N_STATES",
    "PGStateClassifier",
    "sharded_pg_state_step",
    "SLOSpec",
    "STATE_NAMES",
    "evaluate",
    "pg_state_step",
    "register_admin_hooks",
    "render_status",
    "status_dict",
    "worst_status",
]
