"""Prometheus exposition from the perf-counter registry.

The reference exports daemon perf counters through the mgr prometheus
module (``src/pybind/mgr/prometheus/module.py``).  Here the registry
renders to the text exposition format, either to a textfile (node-
exporter textfile-collector pattern) or over an admin-socket hook.
"""

from __future__ import annotations

import re

from .perf_counters import (
    TYPE_HISTOGRAM,
    TYPE_TIME_AVG,
    TYPE_U64,
    registry,
)


def _sanitize(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", name)


def render() -> str:
    """Current registry state in Prometheus text format.

    Counter types carry through from the registry: monotonic ``u64``
    counters emit ``# TYPE ... counter`` (Prometheus semantics — a
    ``rate()`` over a gauge is meaningless), gauges stay ``gauge``,
    ``time_avg`` splits into ``_sum``/``_count`` counters, and
    ``histogram`` renders natively (``# TYPE ... histogram``:
    *cumulative* ``_bucket{le="..."}`` series closed by
    ``le="+Inf"``, plus ``_sum``/``_count``) so latency distributions
    export as one scrape-able histogram instead of N gauges; ``desc``
    becomes the ``# HELP`` line.
    """
    lines: list[str] = []
    for pc in sorted(registry().components(), key=lambda p: p.name):
        comp = _sanitize(pc.name)
        for c in sorted(pc.counters(), key=lambda c: c.name):
            metric = f"ceph_tpu_{comp}_{_sanitize(c.name)}"
            if c.type == TYPE_HISTOGRAM:
                if c.desc:
                    lines.append(f"# HELP {metric} {c.desc}")
                lines.append(f"# TYPE {metric} histogram")
                cum = 0
                for le, n in zip(c.buckets, c.bucket_counts):
                    cum += int(n)
                    lines.append(
                        f'{metric}_bucket{{le="{le:g}"}} {cum}'
                    )
                cum += int(c.bucket_counts[-1])
                lines.append(f'{metric}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{metric}_sum {round(c.total, 9)}")
                lines.append(f"{metric}_count {c.count}")
            elif c.type == TYPE_TIME_AVG:
                for suffix, value in (
                    ("_sum", round(c.total, 9)),
                    ("_count", c.count),
                ):
                    if c.desc:
                        lines.append(
                            f"# HELP {metric}{suffix} {c.desc}"
                        )
                    lines.append(f"# TYPE {metric}{suffix} counter")
                    lines.append(f"{metric}{suffix} {value}")
            else:
                kind = "counter" if c.type == TYPE_U64 else "gauge"
                if c.desc:
                    lines.append(f"# HELP {metric} {c.desc}")
                lines.append(f"# TYPE {metric} {kind}")
                lines.append(f"{metric} {c.value}")
    return "\n".join(lines) + "\n"


def write_textfile(path: str) -> None:
    """Atomic write for the node-exporter textfile collector."""
    import os
    import tempfile

    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".prom.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(render())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def register_admin_hook(admin) -> None:
    admin.register("prometheus", lambda cmd: {"text": render()})
