"""Foreground client traffic: workload generation, per-op outcome
classification, device-resident latency percentiles, and the mclock QoS
arbiter that shares bandwidth between clients and recovery.

- :mod:`~ceph_tpu_torch.workload.traffic` — the traffic step (route via
  CRUSH hash -> classify from survivor bitmasks -> queue model ->
  log-bucket histograms) as torch ops on one device, and the
  :class:`TrafficEngine` that drives it per health sample.
- :mod:`~ceph_tpu_torch.workload.qos` — :class:`MClockArbiter`, the
  reservation/weight/limit admission gate (dmClock analog).
- :mod:`~ceph_tpu_torch.workload.histogram` — the log2 bucket ladder
  and the host-side percentile merge.

- :mod:`~ceph_tpu_torch.workload.writepath` — the online EC write path:
  each epoch's committed writes absorbed by the stripe buffer
  (:mod:`ceph_tpu_torch.ec.online`, K9 and K6).

``sharded_traffic_step`` is the traffic step over the ranks of a mesh.
"""

from .histogram import (
    LAT_MIN_MS,
    N_BUCKETS,
    bucket_edges,
    count_at_least,
    percentile,
    percentiles,
)
from .qos import MClockArbiter, QoSClass
from .traffic import (
    TRAFFIC_MIXES,
    TrafficEngine,
    TrafficMix,
    TrafficSample,
    resolve_mix,
    sharded_traffic_step,
    traffic_step,
    workload_counters,
)
from .writepath import (
    WritepathDriver,
    WritepathSeries,
    checkpointed_writepath,
    default_bitmatrix,
)

__all__ = [
    "WritepathDriver",
    "WritepathSeries",
    "checkpointed_writepath",
    "default_bitmatrix",
    "LAT_MIN_MS",
    "MClockArbiter",
    "N_BUCKETS",
    "QoSClass",
    "TRAFFIC_MIXES",
    "TrafficEngine",
    "TrafficMix",
    "TrafficSample",
    "bucket_edges",
    "count_at_least",
    "percentile",
    "percentiles",
    "resolve_mix",
    "sharded_traffic_step",
    "traffic_step",
    "workload_counters",
]
