"""The rank guard: typed rank errors and the view fingerprint.

A copy of the pieces of the reference package's
``analysis/runtime_guard.py`` that the divergent-rank layer
(:mod:`~ceph_tpu_torch.recovery.reconcile`) and the mesh seams read.
The port has no ``analysis/`` package until ROADMAP §1 item 5, so they
live here.  :func:`assert_rank_identical` all-gathers each rank's
:func:`rank_fingerprint` over a :class:`~ceph_tpu_torch.parallel.mesh.
Mesh` and raises on every rank when they differ.
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
    """Raise :class:`RankDivergenceError` (on every rank) when the
    operands' fingerprint differs across ``mesh``'s ranks.

    Call at mesh seams *before* launching sharded work, gated by
    :func:`rank_checks_enabled`.  Every rank all-gathers every rank's
    fingerprint and evaluates the same verdict, so divergence raises
    everywhere at once rather than deadlocking a subset inside a later
    collective.  Tensors are read back to the host to be hashed."""
    import torch

    host = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in arrays]
    h = rank_fingerprint(*host)
    fps = mesh.gather_stack(torch.tensor([h], dtype=torch.int64)).reshape(-1).tolist()
    if len(set(fps)) > 1:
        name = axis or mesh.axis_names[0]
        raise RankDivergenceError(
            f"{tag}: rank-divergent operands at a mesh seam — this rank's "
            f"fingerprint {h} disagrees across the {mesh.size}-rank {name!r} "
            f"axis (fingerprints by rank {fps}).  Some rank observed different "
            "bytes/shape/dtype; the collective that would have followed could "
            "deadlock or silently mix divergent state")
