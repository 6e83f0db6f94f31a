"""The rank guard: typed rank errors and the view fingerprint.

A copy of the pieces of the reference package's
``analysis/runtime_guard.py`` that the divergent-rank layer
(:mod:`~ceph_tpu_torch.recovery.reconcile`) reads.  The port has no
``analysis/`` package until ROADMAP §1 item 5, so they live here.
:func:`assert_rank_identical` takes a device mesh, which waits for
multi-device (item 4): it raises.
"""

from __future__ import annotations

import zlib

import numpy as np

#: fingerprints are folded into this many bits so n * h^2 stays far
#: inside int64 for any plausible device count
_HASH_BITS = 20


class RankDivergenceError(AssertionError):
    """Ranks disagree on data that must be rank-identical."""


class RankStalledError(RuntimeError):
    """A rank stopped advancing and exhausted the reconcile retry
    budget.

    Raised by the reconcile protocol at the same round on every rank:
    the verdict is computed from the per-rank progress vector every rank
    sees, so each evaluates the identical condition and raises in
    lockstep instead of the live ranks waiting on the dead one.
    """


def rank_fingerprint(*arrays) -> int:
    """Order-sensitive CRC of (shape, dtype, bytes) per operand, folded
    to ``_HASH_BITS`` bits and never zero (an accidental all-zero sum
    cannot fake a pass)."""
    h = 0
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h = zlib.crc32(repr((a.shape, str(a.dtype))).encode(), h)
        h = zlib.crc32(a.tobytes(), h)
    return (h % ((1 << _HASH_BITS) - 3)) + 1


def rank_checks_enabled() -> bool:
    """The ``debug_rank_checks`` config knob (env:
    ``CEPH_TPU_DEBUG_RANK_CHECKS=1``)."""
    from .config import global_config

    return bool(global_config().get("debug_rank_checks"))


def assert_rank_identical(tag: str, *arrays, mesh, axis=None) -> None:
    """The reference's cross-rank fingerprint check at a mesh seam: not
    ported (ROADMAP §1, item 4: multi-device)."""
    raise NotImplementedError(
        f"assert_rank_identical({tag!r}): the mesh-seam rank check is not "
        "ported yet (ROADMAP §1, item 4: multi-device)")
