"""Per-operation event timelines (TrackedOp/OpTracker analog).

Parity with the reference's ``src/common/TrackedOp.{h,cc}``: each
tracked op records named lifecycle events with timestamps; the tracker
keeps in-flight ops, a bounded history of completed ops, flags slow
ops, and answers the admin-socket queries ``dump_ops_in_flight`` /
``dump_historic_ops`` / ``dump_historic_slow_ops`` /
``dump_slow_ops_in_flight``.

The slow threshold is the reference's ``osd_op_complaint_time``
(:mod:`ceph_tpu_torch.common.config`): a completed op at least that old goes
to the slow history, and an op still in flight past it is reported as
slow *now* — the source of the mgr's ``N slow ops, oldest one blocked
for ...`` line, which the traffic SLO layer grades.

For device work, an op's events typically bracket trace/compile/
execute/transfer stages; pair with ``torch.profiler`` for in-kernel
detail (the LTTng/Jaeger analog is :func:`ceph_tpu_torch.common.tracing.
trace_annotation`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from .config import Config, global_config


@dataclass
class TrackedOp:
    tracker: "OpTracker"
    description: str
    # injectable clock: a chaos run passes the VirtualClock's now so op
    # dumps are deterministic and replayable (no wall time in seeded
    # scenarios); default stays the wall-clock perf counter
    clock: Callable[[], float] = time.perf_counter
    start: float | None = None
    events: list[tuple[float, str]] = field(default_factory=list)
    done: float | None = None

    def __post_init__(self) -> None:
        if self.start is None:
            self.start = self.clock()

    def mark_event(self, name: str) -> None:
        self.events.append((self.clock(), name))

    def finish(self) -> None:
        self.done = self.clock()
        self.tracker._finish(self)

    def __enter__(self) -> "TrackedOp":
        return self

    def __exit__(self, *exc) -> bool:
        self.mark_event("error" if exc[0] else "done")
        self.finish()
        return False

    @property
    def duration(self) -> float:
        return (self.done if self.done is not None else self.clock()) - self.start

    def dump(self) -> dict:
        return {
            "description": self.description,
            "duration": round(self.duration, 6),
            "age": round(self.clock() - self.start, 6),
            "events": [
                {"time": round(t - self.start, 6), "event": e}
                for t, e in self.events
            ],
        }


class OpTracker:
    def __init__(
        self,
        history_size: int = 20,
        slow_op_threshold: float | None = None,
        clock: Callable[[], float] = time.perf_counter,
        config: Config | None = None,
    ):
        self.history_size = history_size
        # default follows the reference's osd_op_complaint_time option
        self.slow_op_threshold = float(
            slow_op_threshold
            if slow_op_threshold is not None
            else (config or global_config()).get("osd_op_complaint_time")
        )
        self.clock = clock
        self._lock = threading.Lock()
        self._in_flight: dict[int, TrackedOp] = {}
        self._history: deque[TrackedOp] = deque(maxlen=history_size)
        self._slow: deque[TrackedOp] = deque(maxlen=history_size)
        self.num_slow = 0

    def create_op(self, description: str) -> TrackedOp:
        op = TrackedOp(self, description, clock=self.clock)
        with self._lock:
            self._in_flight[id(op)] = op
        return op

    def _finish(self, op: TrackedOp) -> None:
        with self._lock:
            self._in_flight.pop(id(op), None)
            self._history.append(op)
            if op.duration >= self.slow_op_threshold:
                self._slow.append(op)
                self.num_slow += 1

    def dump_ops_in_flight(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._in_flight.values()]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_ops(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._history]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_slow_ops(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._slow]
        return {"num_slow_ops_found": self.num_slow, "ops": ops}

    def slow_ops_in_flight(self) -> list[TrackedOp]:
        """In-flight ops older than the complaint time — slow *right
        now*, before they ever complete (a blocked op may never)."""
        now = self.clock()
        with self._lock:
            return [
                op for op in self._in_flight.values()
                if now - op.start >= self.slow_op_threshold
            ]

    def dump_slow_ops_in_flight(self) -> dict:
        """The ``N slow ops, oldest one blocked for X sec`` feed."""
        slow = self.slow_ops_in_flight()
        now = self.clock()
        oldest = max((now - op.start for op in slow), default=0.0)
        return {
            "num_slow_ops": len(slow),
            "complaint_time": self.slow_op_threshold,
            "oldest_blocked_for": round(oldest, 6),
            "ops": [op.dump() for op in slow],
        }

    def register_admin_hooks(self, admin) -> None:
        admin.register("dump_ops_in_flight", lambda c: self.dump_ops_in_flight())
        admin.register("dump_historic_ops", lambda c: self.dump_historic_ops())
        admin.register(
            "dump_historic_slow_ops", lambda c: self.dump_historic_slow_ops()
        )
        admin.register(
            "dump_slow_ops_in_flight",
            lambda c: self.dump_slow_ops_in_flight(),
        )
