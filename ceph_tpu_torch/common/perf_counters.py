"""Per-component metrics registry.

Parity with the reference's ``src/common/perf_counters.{h,cc}``
(``PerfCountersBuilder``, u64 counters / gauges / time-averages,
``perf dump`` JSON via the admin socket, mgr aggregation): counters are
built per component, updated lock-free from the hot path (the GIL is
our lock), and dumped as JSON for scraping (the prometheus-module
analog is a textfile emitter).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

TYPE_U64 = "u64"
TYPE_GAUGE = "gauge"
TYPE_TIME_AVG = "time_avg"
TYPE_HISTOGRAM = "histogram"


@dataclass
class _Counter:
    name: str
    type: str
    desc: str = ""
    value: float = 0
    # time_avg: accumulating sum + count
    total: float = 0.0
    count: int = 0
    # histogram: finite upper bounds plus one implicit +Inf overflow
    # slot at the end of bucket_counts
    buckets: tuple = ()
    bucket_counts: list = field(default_factory=list)


class PerfCounters:
    def __init__(self, name: str):
        self.name = name
        self._counters: dict[str, _Counter] = {}
        self._lock = threading.Lock()

    def _add(self, name: str, type_: str, desc: str) -> None:
        self._counters[name] = _Counter(name, type_, desc)

    def inc(self, name: str, amount: int = 1) -> None:
        c = self._counters[name]
        assert c.type == TYPE_U64, (
            f"inc() on non-u64 counter {self.name}.{name} ({c.type})"
        )
        c.value += amount

    def dec(self, name: str, amount: int = 1) -> None:
        c = self._counters[name]
        assert c.type == TYPE_GAUGE
        c.value -= amount

    def set(self, name: str, value: float) -> None:
        c = self._counters[name]
        assert c.type == TYPE_GAUGE, (
            f"set() on non-gauge counter {self.name}.{name} ({c.type})"
        )
        c.value = value

    def hobserve(self, name: str, value: float) -> None:
        """Histogram: drop one observation into its bucket (first
        upper bound >= value; past the last bound, the +Inf slot)."""
        c = self._counters[name]
        assert c.type == TYPE_HISTOGRAM, (
            f"hobserve() on non-histogram {self.name}.{name} ({c.type})"
        )
        with self._lock:
            i = len(c.buckets)
            for j, le in enumerate(c.buckets):
                if value <= le:
                    i = j
                    break
            c.bucket_counts[i] += 1
            c.total += value
            c.count += 1

    def hset(self, name: str, counts, total: float | None = None) -> None:
        """Histogram: wholesale-replace the bucket counts from a
        device-resident histogram (len(buckets) + 1 entries, the last
        being the +Inf overflow slot).  ``total`` is the sum of the
        observed values when known (the Prometheus ``_sum``)."""
        c = self._counters[name]
        assert c.type == TYPE_HISTOGRAM, (
            f"hset() on non-histogram {self.name}.{name} ({c.type})"
        )
        counts = [int(v) for v in counts]
        assert len(counts) == len(c.buckets) + 1, (
            f"{self.name}.{name}: got {len(counts)} bucket counts, "
            f"want {len(c.buckets) + 1}"
        )
        with self._lock:
            c.bucket_counts = counts
            c.count = sum(counts)
            if total is not None:
                c.total = float(total)

    def tinc(self, name: str, seconds: float) -> None:
        c = self._counters[name]
        assert c.type == TYPE_TIME_AVG
        with self._lock:
            c.total += seconds
            c.count += 1

    def time(self, name: str):
        """Context manager: times the block into a time_avg counter."""
        pc = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                pc.tinc(name, time.perf_counter() - self.t0)
                return False

        return _Timer()

    def reset(self) -> None:
        """Zero every counter (test isolation; ``perf reset`` hook)."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
                c.total = 0.0
                c.count = 0
                if c.type == TYPE_HISTOGRAM:
                    c.bucket_counts = [0] * (len(c.buckets) + 1)

    def counters(self) -> list[_Counter]:
        """The typed counter records (the prometheus renderer reads
        types and HELP text from here; ``dump()`` stays value-only for
        ``perf dump`` parity)."""
        return list(self._counters.values())

    def schema(self) -> dict:
        """``perf schema`` analog: name -> {type, desc}."""
        return {
            self.name: {
                c.name: {"type": c.type, "desc": c.desc}
                for c in self._counters.values()
            }
        }

    def dump(self) -> dict:
        out: dict = {}
        for c in self._counters.values():
            if c.type == TYPE_TIME_AVG:
                out[c.name] = {
                    "avgcount": c.count,
                    "sum": round(c.total, 9),
                    "avgtime": round(c.total / c.count, 9) if c.count else 0.0,
                }
            elif c.type == TYPE_HISTOGRAM:
                out[c.name] = {
                    "buckets": {
                        f"{le:g}": n
                        for le, n in zip(c.buckets, c.bucket_counts)
                    },
                    "overflow": c.bucket_counts[-1],
                    "sum": round(c.total, 9),
                    "count": c.count,
                }
            else:
                out[c.name] = c.value
        return {self.name: out}

    def dump_json(self) -> str:
        return json.dumps(self.dump(), sort_keys=True)


class PerfCountersBuilder:
    """Fluent builder (reference ``PerfCountersBuilder`` pattern)."""

    def __init__(self, name: str):
        self._pc = PerfCounters(name)

    def add_u64_counter(self, name: str, desc: str = "") -> "PerfCountersBuilder":
        self._pc._add(name, TYPE_U64, desc)
        return self

    def add_gauge(self, name: str, desc: str = "") -> "PerfCountersBuilder":
        self._pc._add(name, TYPE_GAUGE, desc)
        return self

    def add_time_avg(self, name: str, desc: str = "") -> "PerfCountersBuilder":
        self._pc._add(name, TYPE_TIME_AVG, desc)
        return self

    def add_histogram(
        self, name: str, desc: str = "", buckets=()
    ) -> "PerfCountersBuilder":
        """``buckets`` are the finite upper bounds (``le`` values),
        strictly increasing; one +Inf overflow slot is implicit."""
        self._pc._add(name, TYPE_HISTOGRAM, desc)
        c = self._pc._counters[name]
        c.buckets = tuple(float(b) for b in buckets)
        assert all(
            a < b for a, b in zip(c.buckets, c.buckets[1:])
        ), f"histogram {name}: bucket bounds must be increasing"
        c.bucket_counts = [0] * (len(c.buckets) + 1)
        return self

    def create_perf_counters(self) -> PerfCounters:
        pc = self._pc
        _registry.register(pc)
        return pc


class _Registry:
    """Process-wide collection (the admin socket dumps all of these)."""

    def __init__(self):
        self._all: dict[str, PerfCounters] = {}
        self._lock = threading.Lock()

    def register(self, pc: PerfCounters) -> None:
        with self._lock:
            self._all[pc.name] = pc

    def dump(self) -> dict:
        out: dict = {}
        with self._lock:
            for pc in self._all.values():
                out.update(pc.dump())
        return out

    def schema(self) -> dict:
        out: dict = {}
        with self._lock:
            for pc in self._all.values():
                out.update(pc.schema())
        return out

    def components(self) -> list[PerfCounters]:
        with self._lock:
            return list(self._all.values())

    def reset(self) -> None:
        """Zero every registered component's counters."""
        for pc in self.components():
            pc.reset()

    def get(self, name: str) -> PerfCounters | None:
        return self._all.get(name)


_registry = _Registry()


def registry() -> _Registry:
    return _registry
