"""Host-side plumbing shared by the port's subsystems: layered
configuration (``config``), perf counters (``perf_counters``), their
Prometheus rendering (``prometheus``) and profiler spans (``tracing``).
``config``, ``perf_counters`` and ``prometheus`` are copies of the
reference package's; ``tracing`` speaks ``torch.profiler``."""

from .config import OPT_BOOL, OPT_FLOAT, OPT_INT, OPT_STR, Config, Option
from .perf_counters import PerfCounters, PerfCountersBuilder

__all__ = [
    "Config",
    "Option",
    "OPT_INT",
    "OPT_FLOAT",
    "OPT_STR",
    "OPT_BOOL",
    "PerfCounters",
    "PerfCountersBuilder",
]
