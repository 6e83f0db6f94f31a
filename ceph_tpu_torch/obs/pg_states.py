"""Device-side PG-state classification for cluster-health telemetry.

The peering pass (:mod:`ceph_tpu_torch.recovery.peering`) emits per-PG
flag bits and survivor bitmasks; operators read ``ceph -s``, which
speaks in *states* — mutually exclusive buckets whose counts make up the
PG histogram (``200 active+clean, 40 degraded, 16 inactive``).  This
module maps bitmask -> state with torch ops over the whole pool on one
device and reduces the per-state histogram there too, so a health
snapshot copies back one [N_STATES]-sized histogram regardless of
pg_num.

States, most severe first (a PG lands in the first that applies):

- ``inactive``      — fewer than ``k`` surviving shards: the data
  cannot be reconstructed, reads stall until an OSD returns.
- ``undersized``    — the acting set has holes (fewer live members
  than ``size``).
- ``inconsistent``  — a scrub pass found shard bytes whose CRC32C
  disagrees with the stored checksum (silent corruption); repair must
  rebuild them.  Flag-driven: only the scrubber can see shard bytes,
  so the supervised loop annotates the peering flags host-side.
- ``degraded``      — every slot is alive but some hold no data yet
  (remap-induced survivor loss); redundancy is reduced.
- ``scrubbing``     — a scrub pass is running over the PG (also
  flag-driven).
- ``backfilling``   — data complete, but the up set has new members
  still being copied to.
- ``active+clean``  — none of the above.

The survivor masks are u32 carried in int64 (CPU PyTorch has no u32
arithmetic), and their popcount is a SWAR reduction in int64.  Under a
mesh (:func:`sharded_pg_state_step`) the PG axis splits over the ranks
and the counts are summed over them, so every rank holds the identical
cluster-wide histogram.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..analysis.runtime_guard import assert_rank_identical, rank_checks_enabled
from ..parallel.padding import pad_to_multiple
from ..recovery.peering import (
    PG_STATE_BACKFILL,
    PG_STATE_INCONSISTENT,
    PG_STATE_REMAPPED,
    PG_STATE_SCRUBBING,
    PeeringResult,
)

I32 = torch.int32
I64 = torch.int64

STATE_ACTIVE_CLEAN = 0
STATE_BACKFILLING = 1
STATE_DEGRADED = 2
STATE_UNDERSIZED = 3
STATE_INACTIVE = 4
STATE_INCONSISTENT = 5
STATE_SCRUBBING = 6
N_STATES = 7

#: histogram slot -> the ``ceph -s`` state string (indices are
#: append-only: recorded series/goldens keyed on the first five slots
#: stay valid)
STATE_NAMES = (
    "active+clean",
    "backfilling",
    "degraded",
    "undersized",
    "inactive",
    "inconsistent",
    "scrubbing",
)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 value carried in an int64 tensor (SWAR)."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _classify_rows(mask, n_alive, flags, k: int, size: int):
    """Per-PG state codes [pg] int32: ``mask`` int64 (u32 values),
    ``n_alive``/``flags`` int32, ``k``/``size`` the pool's thresholds.
    The first state that applies wins, as in the reference's nested
    ``where``."""
    nsurv = popcount32(mask)
    codes = torch.full_like(flags, STATE_ACTIVE_CLEAN)
    order = (
        (nsurv < k, STATE_INACTIVE),
        (n_alive < size, STATE_UNDERSIZED),
        ((flags & PG_STATE_INCONSISTENT) != 0, STATE_INCONSISTENT),
        (nsurv < size, STATE_DEGRADED),
        ((flags & PG_STATE_SCRUBBING) != 0, STATE_SCRUBBING),
        ((flags & PG_STATE_BACKFILL) != 0, STATE_BACKFILLING),
    )
    # apply the least severe first, so a more severe state overwrites it
    for cond, state in reversed(order):
        codes = torch.where(cond, torch.full_like(codes, state), codes)
    return codes


def pg_state_step(mask, n_alive, flags, k: int, size: int):
    """``(hist [N_STATES] int32, aux [2] int32)`` of one pool:
    the state histogram, and ``aux = [degraded shard-slots, misplaced
    PGs]`` (lost shard-slots across degraded PGs, the degraded-object
    ratio's numerator in shard units; remapped-but-complete PGs, the
    misplaced-object analog)."""
    return pg_state_reduce(mask, n_alive, flags, k, size)


def _count(codes: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of each value in ``[0, n)`` among ``codes`` (int64)."""
    return torch.zeros(n, dtype=I64, device=codes.device).scatter_add_(
        0, codes, torch.ones_like(codes))


def pg_state_reduce(mask, n_alive, flags, k: int, size: int, in_range=None):
    """:func:`pg_state_step` over the rows where ``in_range`` ([pg] bool;
    None: every row), the reference's ``_reduce``: rows outside it (a
    compacted bucket's pad lanes) count in neither the histogram nor
    ``aux``.  Exact integers, so bucket deltas refold exactly.  Along
    the last axis: ``[lanes, pg]`` rows give ``[lanes, N_STATES]`` and
    ``[lanes, 2]``, each lane reduced on its own."""
    codes = _classify_rows(mask, n_alive, flags, k, size).to(I64)
    nsurv = popcount32(mask)
    degraded = torch.where(nsurv < size, size - nsurv, 0)
    misplaced = (nsurv >= size) & ((flags & PG_STATE_REMAPPED) != 0)
    if in_range is not None:
        # rows outside the range vote into a spare bin that is cut off
        codes = torch.where(in_range, codes, N_STATES)
        degraded = torch.where(in_range, degraded, 0)
        misplaced = misplaced & in_range
    # scatter_add, not bincount: bincount reads its input's maximum back
    # to the host on the card, which a graph capture cannot hold
    if codes.dim() == 1:
        hist = _count(codes, N_STATES + 1)[:N_STATES].to(I32)
    else:
        lanes = codes.shape[0]
        offs = torch.arange(lanes, dtype=I64, device=codes.device)[:, None] * (N_STATES + 1)
        hist = _count((codes + offs).reshape(-1), lanes * (N_STATES + 1))
        hist = hist.view(lanes, N_STATES + 1)[:, :N_STATES].to(I32)
    return hist, torch.stack([degraded.sum(-1), misplaced.sum(-1)], dim=-1).to(I32)


def sharded_pg_state_step(mesh):
    """Mesh snapshot step: ``f(mask, n_alive, flags, k, size, valid) ->
    (hist, aux)`` over the whole pool's rows, padded to a rank multiple
    (every rank passes the same): each rank reduces its slice of PGs and
    the counts are summed over the ranks.  ``valid`` is the un-padded
    PG count; the padded tail never votes."""
    size, rank = mesh.size, mesh.rank

    def step(mask, n_alive, flags, k: int, sz: int, valid: int):
        w = mask.shape[0] // size
        lo = rank * w
        in_range = (torch.arange(w, device=mask.device) + lo) < int(valid)
        hist, aux = pg_state_reduce(mask[lo:lo + w], n_alive[lo:lo + w], flags[lo:lo + w],
                                    k, sz, in_range)
        return mesh.psum(hist), mesh.psum(aux)

    return step


class PGStateClassifier:
    """Peering result -> (PG-state histogram, aux counts), on one
    device (``device``, the card by default) or, with a ``mesh``, over
    its ranks (:func:`sharded_pg_state_step`, each rank on its device)."""

    def __init__(self, mesh=None, device="cuda"):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self._step = sharded_pg_state_step(mesh) if mesh is not None else None

    def __call__(
        self, peering: PeeringResult, k: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Classify one peering pass.  ``k`` is the reconstruction
        threshold (EC: the codec's k; default ``peering.min_size``).
        Returns ``(hist [N_STATES], aux [degraded_slots, misplaced])``
        as host int32 arrays."""
        k = int(peering.min_size if k is None else k)
        dev = self.device
        mask = np.ascontiguousarray(peering.survivor_mask, np.uint32).astype(np.int64)
        alive = np.ascontiguousarray(peering.n_alive, np.int32)
        flags = np.ascontiguousarray(peering.flags, np.int32)
        valid = len(mask)
        if self.mesh is not None:
            mask, alive, flags = (pad_to_multiple(a, self.mesh.size, axis=0)[0]
                                  for a in (mask, alive, flags))
            if rank_checks_enabled():
                assert_rank_identical("pg_state_classify", mask, alive, flags, np.int64(k),
                                      np.int64(peering.size), mesh=self.mesh)
        mask, alive, flags = (torch.from_numpy(a).to(dev) for a in (mask, alive, flags))
        if self.mesh is None:
            hist, aux = pg_state_step(mask, alive, flags, k, int(peering.size))
        else:
            hist, aux = self._step(mask, alive, flags, k, int(peering.size), valid)
        return hist.cpu().numpy(), aux.cpu().numpy()
