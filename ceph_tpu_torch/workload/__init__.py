"""Foreground-client workload pieces.

- :mod:`~ceph_tpu_torch.workload.qos` — :class:`MClockArbiter`, the
  reservation/weight/limit admission gate (dmClock analog) that the
  recovery executor and the scrubber take (a copy of the reference
  package's).

The traffic model (``histogram``, ``traffic``) and the online write
path are not ported yet (ROADMAP §1, items 1b and 3).
"""

from .qos import MClockArbiter, QoSClass

__all__ = ["MClockArbiter", "QoSClass"]
