"""Device-resident cluster state: one set of tensors, resident across epochs.

The counterpart of the reference package's ``core/cluster_state.py``.
Every epoch-loop consumer (peering, the traffic router, the PG-state
classifier, the liveness detector) reads its slice of one
:class:`ClusterState` that stays on one device across epochs:

- the pool-mapping tables (a nested
  :class:`~ceph_tpu_torch.osdmap.mapping.PoolMapState`: weights,
  up/exists bits, affinity, upmap/temp overrides),
- per-OSD liveness lanes (the :mod:`ceph_tpu_torch.recovery.liveness`
  heartbeat state plus the suppression/slow/out bits),
- per-PG peering outputs (up/acting tables, primaries, flags, survivor
  bitmasks, alive counts),
- the PG-state histogram and aux counts,
- an optional checksum table (the scrubber's stored CRC32Cs),
- scalar clocks and cursors (map epoch, virtual now, last liveness
  tick, event-tape cursor, epoch-loop step) as 0-d tensors.

The state is a frozen dataclass: every update path returns a new one
through :func:`dataclasses.replace` and never writes a tensor another
state holds.  OSDMap :class:`~ceph_tpu_torch.osdmap.map.Incremental`
deltas apply as one O(delta) scatter (:func:`apply_incremental`) with
the pad widths bucketed to powers of two, as in the reference; torch
has no dropping scatter, so the out-of-range pad rows are sent to a
spare row that is cut off (:func:`_put_rows`).  Structural edits go
through :meth:`ClusterState.from_osdmap`.

Fleets stack N states along a leading axis (:func:`stack_states`), and
:func:`apply_incremental_fleet` applies one delta per member as one
batched scatter.

The dirty-set ladder (:func:`compact_dirty_indices`,
:func:`dirty_ladder`, :func:`gather_rows`, :func:`scatter_rows`,
:func:`bucket_valid`) packs the dirty PG indices to the front of a
power-of-two bucket so peering runs on the bucket only.  The reference
picks the rung with ``lax.switch`` on a traced count; here
:func:`ladder_rung` reads the count once on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from .. import resolve_device
from ..crush.map import ITEM_NONE
from ..osdmap.map import EXISTS, UP, Incremental, OSDMap
from ..osdmap.mapping import PoolMapState, build_pool_state

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64

#: reporter count meaning "always enough reporters" (the
#: LivenessDetector default before peering adjacency is known)
ALWAYS_REPORTED = 1 << 16

#: fields of one Incremental the scatter path cannot express without a
#: shape change or a dict rewrite: they route through ``from_osdmap``
_STRUCTURAL_FIELDS = (
    "new_pg_upmap", "old_pg_upmap", "new_pg_upmap_items",
    "old_pg_upmap_items", "new_pg_temp", "new_primary_temp", "new_pools",
)


@dataclass(frozen=True)
class ClusterState:
    """The whole cluster's dynamic state as tensors on one device.

    Dtypes are the reference's leaf dtypes, with the port's carriers:
    the pool's weights in int32 and its affinity in int64 (as
    :func:`~ceph_tpu_torch.osdmap.mapping.build_pool_state` builds
    them), the survivor mask and checksums as u32 values in int64.
    """

    # -- pool mapping (the mapping program's state)
    pool: PoolMapState

    # -- per-OSD liveness lanes
    last_ack: torch.Tensor      # f32 [n_osd]
    laggy: torch.Tensor         # f32 [n_osd]
    markdowns: torch.Tensor     # f32 [n_osd]
    down: torch.Tensor          # bool [n_osd]  detector-marked down
    down_since: torch.Tensor    # f32 [n_osd]
    suppressed: torch.Tensor    # bool [n_osd]  netsplit: heartbeats cut
    slow: torch.Tensor          # bool [n_osd]  slow: acks late
    out: torch.Tensor           # bool [n_osd]  auto-out bookkeeping
    reporters: torch.Tensor     # i32 [n_osd]  failure-reporter pool

    # -- per-PG peering tables
    up: torch.Tensor            # i32 [pg_num, size]  ITEM_NONE padded
    up_primary: torch.Tensor    # i32 [pg_num]
    acting: torch.Tensor        # i32 [pg_num, size]
    acting_primary: torch.Tensor  # i32 [pg_num]
    flags: torch.Tensor         # i32 [pg_num]  PG_STATE_* bits
    survivor_mask: torch.Tensor  # i64 [pg_num]  (u32 values)
    n_alive: torch.Tensor       # i32 [pg_num]

    # -- cluster-wide observability
    pg_hist: torch.Tensor       # i32 [N_STATES]
    pg_aux: torch.Tensor        # i32 [2]  degraded_slots, misplaced

    # -- the scrubber's stored checksums, or None
    checksums: torch.Tensor | None  # i64 [pg_num, n_shards] (u32 values)

    # -- scalars (0-d)
    epoch: torch.Tensor         # i32  map epoch
    now: torch.Tensor           # f64  virtual time
    last_tick: torch.Tensor     # f64  last non-idle liveness tick
    tape_cursor: torch.Tensor   # i32  event-tape position
    step: torch.Tensor          # i32  epoch-loop step index

    @classmethod
    def from_osdmap(
        cls,
        m: OSDMap,
        pool_id: int | None = None,
        *,
        max_items: int = 8,
        now: float = 0.0,
        reporters: np.ndarray | None = None,
        checksums: np.ndarray | None = None,
        device="cuda",
    ) -> "ClusterState":
        """Build the resident state of one pool from a host OSDMap (the
        cold path; epoch deltas after this go through
        :func:`apply_incremental` or the epoch loop's event tape)."""
        # deferred: obs.pg_states imports recovery.peering, whose
        # package loads the epoch loop, which builds on this module
        from ..obs.pg_states import N_STATES

        dev = resolve_device(device)
        pool = m.pools[min(m.pools) if pool_id is None else pool_id]
        pool_state = build_pool_state(m, pool, max_items, dev)
        n = int(pool_state.osd_weight.shape[0])
        pg_num = int(pool.pg_num)
        size = int(pool.size)
        if reporters is None:
            rep = np.full(n, ALWAYS_REPORTED, np.int32)
        else:
            rep = np.asarray(reporters, np.int32)
            if rep.shape != (n,):
                raise ValueError(f"reporters shape {rep.shape} != ({n},)")

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return cls(
            pool=pool_state,
            last_ack=full((n,), float(now), F32),
            laggy=full((n,), 0.0, F32),
            markdowns=full((n,), 0.0, F32),
            down=full((n,), False, torch.bool),
            down_since=full((n,), 0.0, F32),
            suppressed=full((n,), False, torch.bool),
            slow=full((n,), False, torch.bool),
            out=full((n,), False, torch.bool),
            reporters=torch.from_numpy(np.ascontiguousarray(rep)).to(dev),
            up=full((pg_num, size), ITEM_NONE, I32),
            up_primary=full((pg_num,), -1, I32),
            acting=full((pg_num, size), ITEM_NONE, I32),
            acting_primary=full((pg_num,), -1, I32),
            flags=full((pg_num,), 0, I32),
            survivor_mask=full((pg_num,), 0, I64),
            n_alive=full((pg_num,), 0, I32),
            pg_hist=full((N_STATES,), 0, I32),
            pg_aux=full((2,), 0, I32),
            checksums=(
                None if checksums is None
                else torch.from_numpy(
                    np.asarray(checksums, np.uint32).astype(np.int64)).to(dev)
            ),
            epoch=full((), int(m.epoch), I32),
            now=full((), float(now), F64),
            last_tick=full((), float(now), F64),
            tape_cursor=full((), 0, I32),
            step=full((), 0, I32),
        )

    @property
    def n_osds(self) -> int:
        return int(self.pool.osd_weight.shape[-1])

    @property
    def pg_num(self) -> int:
        return int(self.up.shape[-2])

    @property
    def device(self) -> torch.device:
        return self.up.device


# ---------------------------------------------------------------------------
# view deltas: what one resident view advanced past another


@dataclass(frozen=True)
class ViewDelta:
    """Host-side summary of what separates two views of the SAME
    geometry: the audit record the reconcile layer journals when a
    stalled rank replays its missed window.  A *description* of the
    delta, not a patch: replaying the missed steps reproduces the
    target view exactly, so no state is ever injected."""

    epoch_from: int
    epoch_to: int
    step_from: int
    step_to: int
    tape_cursor_from: int
    tape_cursor_to: int
    n_up_changed: int      # osd_up lanes that differ
    n_down_changed: int    # detector down bits that differ
    n_out_changed: int     # out bookkeeping bits that differ
    n_pgs_remapped: int    # PGs whose acting set differs

    @property
    def n_steps(self) -> int:
        return self.step_to - self.step_from

    @property
    def n_tape_rows(self) -> int:
        return self.tape_cursor_to - self.tape_cursor_from

    def to_json(self) -> dict:
        return {
            "epoch_from": self.epoch_from, "epoch_to": self.epoch_to,
            "step_from": self.step_from, "step_to": self.step_to,
            "tape_rows": self.n_tape_rows, "n_steps": self.n_steps,
            "n_up_changed": self.n_up_changed,
            "n_down_changed": self.n_down_changed,
            "n_out_changed": self.n_out_changed,
            "n_pgs_remapped": self.n_pgs_remapped,
        }


def view_delta(old: ClusterState, new: ClusterState) -> ViewDelta:
    """Diff two same-geometry views into a :class:`ViewDelta` (reads
    both views' lanes back to the host; a seam between rounds)."""
    if old.up.shape != new.up.shape or old.down.shape != new.down.shape:
        raise ValueError(
            f"view geometries differ: up {tuple(old.up.shape)} vs "
            f"{tuple(new.up.shape)}, down {tuple(old.down.shape)} vs "
            f"{tuple(new.down.shape)}"
        )

    def host(s: ClusterState):
        return {name: t.cpu().numpy() for name, t in (
            ("osd_up", s.pool.osd_up), ("down", s.down), ("out", s.out),
            ("acting", s.acting), ("epoch", s.epoch), ("step", s.step),
            ("tape_cursor", s.tape_cursor))}

    o, n = host(old), host(new)
    return ViewDelta(
        epoch_from=int(o["epoch"]), epoch_to=int(n["epoch"]),
        step_from=int(o["step"]), step_to=int(n["step"]),
        tape_cursor_from=int(o["tape_cursor"]),
        tape_cursor_to=int(n["tape_cursor"]),
        n_up_changed=int(np.sum(o["osd_up"] != n["osd_up"])),
        n_down_changed=int(np.sum(o["down"] != n["down"])),
        n_out_changed=int(np.sum(o["out"] != n["out"])),
        n_pgs_remapped=int(np.sum(np.any(o["acting"] != n["acting"], axis=-1))),
    )


# ---------------------------------------------------------------------------
# O(delta) incremental application


def _pad_to(n: int) -> int:
    """Pad bucket for a delta of ``n`` rows: next power of two (min 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def _check_bucketed(what: str, *widths: int) -> None:
    """The reference's ``runtime_guard.assert_bucketed``, as a plain
    check: every width a power of two."""
    bad = [w for w in widths if w < 1 or w & (w - 1)]
    if bad:
        raise ValueError(f"{what}: widths {bad} are not powers of two")


def _put_rows(table: torch.Tensor, idx: torch.Tensor, vals, axis: int = 0) -> torch.Tensor:
    """``table`` with ``table[idx] = vals`` along ``axis`` (0, or 1 under a
    leading fleet axis), as a new tensor.  Indices at or past the axis's
    length are the reference's dropped pad rows: they are masked onto a
    spare row, which is cut off."""
    n = table.shape[axis]
    spare = torch.cat([table, table.narrow(axis, 0, 1)], dim=axis)
    idx = torch.where(idx < n, idx, n)
    if axis == 0:
        spare[idx] = vals
    else:
        rows = torch.arange(table.shape[0], device=table.device)[:, None]
        spare[rows, idx] = vals
    return spare.narrow(axis, 0, n)


def incremental_arrays(
    inc: Incremental,
    n_osds: int,
    pads: tuple[int, int, int] | None = None,
    device="cuda",
):
    """One Incremental's per-OSD edits as fixed-shape scatter rows on
    ``device``: ``(s_idx, s_up, s_ex, w_idx, w_val, a_idx, a_val)``, each
    padded to a power of two with the out-of-range index ``n_osds``,
    which the scatter drops.  The rows go to the device as one copy.

    ``pads`` pins the ``(state, weight, affinity)`` pad widths instead
    of deriving them a delta: the fleet path gives every cluster's
    delta the same shape so one batched scatter covers all.

    Raises for structural edits (:data:`_STRUCTURAL_FIELDS`,
    ``new_max_osd``): those take the :meth:`ClusterState.from_osdmap`
    rebuild."""
    if inc.new_max_osd is not None:
        raise ValueError(
            "new_max_osd resizes every per-OSD lane; rebuild via "
            "ClusterState.from_osdmap"
        )
    for f in _STRUCTURAL_FIELDS:
        if getattr(inc, f):
            raise ValueError(
                f"incremental field {f!r} is structural (dict-table "
                "rewrite); rebuild via ClusterState.from_osdmap"
            )
    forced = iter(pads) if pads is not None else None
    cols = []

    def rows(items):
        idx = sorted(int(o) for o in items)
        pad = _pad_to(len(idx)) if forced is None else next(forced)
        if len(idx) > pad:
            raise ValueError(f"delta of {len(idx)} rows exceeds forced pad {pad}")
        out_idx = np.full(pad, n_osds, np.int64)  # out of range -> dropped
        out_idx[: len(idx)] = idx
        vals = np.zeros(pad, np.int64)
        vals[: len(idx)] = [int(items[o]) for o in idx]
        return out_idx, vals

    s_idx, s_val = rows(inc.new_state)
    cols += [s_idx, (s_val & UP) != 0, (s_val & EXISTS) != 0]
    cols += list(rows(inc.new_weight))
    cols += list(rows(inc.new_primary_affinity))
    dev = resolve_device(device)
    packed = torch.from_numpy(np.concatenate([c.astype(np.int64) for c in cols])).to(dev)
    parts = list(torch.split(packed, [len(c) for c in cols]))
    dtypes = (I64, torch.bool, torch.bool, I64, I32, I64, I64)
    return tuple(p.to(d) for p, d in zip(parts, dtypes))


def _apply_delta(pool: PoolMapState, s_idx, s_up, s_ex, w_idx, w_val, a_idx, a_val,
                 axis: int = 0) -> PoolMapState:
    """The scatter of one delta into the pool lanes (``axis`` 1: each
    fleet member's row of a ``[fleet, pad]`` delta into its own lanes).

    The reference xors raw state bits; the resident lanes store the
    *effective* bits (``osd_up = exists & up``), so an UP xor flips the
    stored up bit only while the OSD exists, and an EXISTS flip to
    False forces the effective up bit False."""
    n = pool.osd_up.shape[axis]
    cid = s_idx.clamp(0, n - 1)
    ex = pool.osd_exists.gather(axis, cid)
    new_ex = ex ^ s_ex
    new_up = (pool.osd_up.gather(axis, cid) ^ (s_up & ex)) & new_ex
    return replace(
        pool,
        osd_up=_put_rows(pool.osd_up, s_idx, new_up, axis),
        osd_exists=_put_rows(pool.osd_exists, s_idx, new_ex, axis),
        osd_weight=_put_rows(pool.osd_weight, w_idx, w_val, axis),
        primary_affinity=_put_rows(pool.primary_affinity, a_idx, a_val, axis),
    )


def apply_incremental(state: ClusterState, inc: Incremental) -> ClusterState:
    """Apply one epoch delta to the resident state as an O(delta)
    scatter: the device twin of ``OSDMap.apply_incremental`` for the
    per-OSD hot-loop fields.  The new map epoch comes from the
    incremental itself (nothing is read back from the device)."""
    arrs = incremental_arrays(inc, state.n_osds, device=state.device)
    return replace(
        state,
        pool=_apply_delta(state.pool, *arrs),
        epoch=torch.full((), int(inc.epoch), dtype=I32, device=state.device),
    )


# ---------------------------------------------------------------------------
# fleets: a leading cluster axis over the same dataclass


def _map_state(fn, *states):
    """``fn`` over every tensor of the states, field by field (the nested
    pool too); None fields stay None."""
    def walk(cls, objs):
        out = {}
        for f in fields(cls):
            vals = [getattr(o, f.name) for o in objs]
            if isinstance(vals[0], PoolMapState):
                out[f.name] = walk(PoolMapState, vals)
            elif vals[0] is None:
                out[f.name] = None
            else:
                out[f.name] = fn(*vals)
        return cls(**out)

    return walk(ClusterState, states)


def stack_states(states) -> ClusterState:
    """Stack N independent states into one fleet state: every tensor
    gains a leading ``[fleet, ...]`` axis and the result is still a
    :class:`ClusterState`.  All members must share geometry and agree on
    checksum presence."""
    states = list(states)
    if not states:
        raise ValueError("stack_states needs at least one state")
    with_ck = sum(1 for s in states if s.checksums is not None)
    if with_ck not in (0, len(states)):
        raise ValueError(
            "checksum tables must be attached to every fleet member "
            f"or none ({with_ck}/{len(states)} have one)"
        )
    return _map_state(lambda *xs: torch.stack(xs), *states)


def index_state(fleet: ClusterState, i: int) -> ClusterState:
    """Slice cluster ``i`` back out of a :func:`stack_states` fleet."""
    return _map_state(lambda x: x[i], fleet)


def fleet_incremental_arrays(incs, n_osds: int, device="cuda"):
    """Batch per-cluster Incrementals into stacked scatter rows.

    All clusters share one ``(state, weight, affinity)`` pad triple, the
    power-of-two bucket of the *largest* delta a lane.  Returns
    ``(epochs, arrays, pads)`` where each array is ``[fleet, pad]``."""
    incs = list(incs)
    if not incs:
        raise ValueError("fleet_incremental_arrays needs >= 1 delta")
    pads = (
        _pad_to(max(len(i.new_state) for i in incs)),
        _pad_to(max(len(i.new_weight) for i in incs)),
        _pad_to(max(len(i.new_primary_affinity) for i in incs)),
    )
    _check_bucketed("cluster_state.fleet_incremental_arrays pads", *pads)
    per = [incremental_arrays(i, n_osds, pads=pads, device=device) for i in incs]
    arrays = tuple(torch.stack(col) for col in zip(*per))
    epochs = torch.tensor([int(i.epoch) for i in incs], dtype=I32).to(resolve_device(device))
    return epochs, arrays, pads


def apply_incremental_fleet(fleet: ClusterState, incs) -> ClusterState:
    """Apply one per-cluster epoch delta to every fleet member as one
    batched scatter.  ``incs`` holds exactly one Incremental a member
    (pad clusters take an empty ``Incremental(epoch=...)``)."""
    incs = list(incs)
    fleet_n = int(fleet.epoch.shape[0])
    if len(incs) != fleet_n:
        raise ValueError(f"{len(incs)} incrementals for a fleet of {fleet_n}")
    epochs, arrays, _pads = fleet_incremental_arrays(incs, fleet.n_osds, fleet.device)
    return replace(fleet, pool=_apply_delta(fleet.pool, *arrays, axis=1), epoch=epochs)


# ---------------------------------------------------------------------------
# dirty-set compaction: gather -> compute on a bucket -> scatter
#
# The dense epoch engines peer and classify every PG each dirty epoch,
# even when one OSD flap touched a handful of PGs.  The compacted path
# packs the dirty indices to the front of a power-of-two bucket, runs
# peering on the bucket only, and scatters the results back, the pad
# slots carrying the out-of-range sentinel.  Bucket widths form a small
# ladder; the narrowest rung that holds the dirty count is picked from
# one host read of that count, with the dense full width as the top
# rung (the bit-equality reference and the fallback).


def compact_dirty_indices(dirty: torch.Tensor):
    """Stable-compact a boolean dirty mask into front-packed indices.

    Returns ``(take, n_dirty)``: ``take`` is a length-``n`` int64 tensor
    whose first ``n_dirty`` entries are the dirty row indices in
    ascending order and whose rest is the out-of-range sentinel ``n``;
    ``n_dirty`` a 0-d int32 tensor.  Device arithmetic only (one
    cumsum, one scatter), no host read."""
    n = dirty.shape[0]
    pos = torch.cumsum(dirty.to(I64), 0) - 1
    take = torch.full((n,), n, dtype=I64, device=dirty.device)
    slots = torch.where(dirty, pos, n)
    take = _put_rows(take, slots, torch.arange(n, dtype=I64, device=dirty.device))
    return take, dirty.sum(dtype=I32)


def dirty_ladder(
    total: int, *, min_bucket: int = 32, growth: int = 4, max_rungs: int = 4,
) -> tuple[int, ...]:
    """Compacted bucket widths strictly below ``total``.

    Each rung is the power-of-two bucket (:func:`_pad_to`) of the
    previous rung scaled by ``growth``, starting from ``min_bucket``,
    capped at ``max_rungs`` entries.  The dense full width is NOT
    included: callers append their dense branch as the top rung.  An
    empty tuple means the geometry is too small for any rung below
    dense.  Host ints only."""
    widths: list[int] = []
    w = _pad_to(max(1, int(min_bucket)))
    while w < int(total) and len(widths) < int(max_rungs):
        widths.append(w)
        w = _pad_to(w * max(2, int(growth)))
    _check_bucketed("cluster_state.dirty_ladder widths", *widths)
    return tuple(widths)


def ladder_rung(n_dirty, widths: tuple[int, ...]) -> int:
    """Index of the narrowest rung in ``widths`` that holds ``n_dirty``
    rows, or ``len(widths)`` (the caller's dense branch) when none does.
    A tensor count is read back to the host: the one read that picks
    the rung."""
    n = int(n_dirty)
    return sum(1 for w in widths if n > w)


def gather_rows(table: torch.Tensor, take: torch.Tensor, width: int) -> torch.Tensor:
    """The first ``width`` compacted rows of ``table``; pad slots carry
    the sentinel and clamp to row ``n - 1``: garbage rows that
    :func:`scatter_rows` drops on the way back."""
    n = table.shape[0]
    return table[take[:width].clamp(0, n - 1)]


def scatter_rows(table: torch.Tensor, take: torch.Tensor, width: int, vals) -> torch.Tensor:
    """``table`` with ``width`` computed rows written back to their dirty
    slots, as a new tensor.  The pad slots' sentinel rows are masked off
    (:func:`_put_rows`), so clean rows keep their values bit for bit;
    the dirty indices are unique by construction."""
    return _put_rows(table, take[:width], vals)


def bucket_valid(n_dirty, width: int, device="cuda") -> torch.Tensor:
    """Lane ``j`` of a compacted bucket holds a real dirty row iff
    ``j < n_dirty`` (a tensor, on its device; or a host int, on
    ``device``)."""
    if isinstance(n_dirty, torch.Tensor):
        device = n_dirty.device
    return torch.arange(width, dtype=I32, device=resolve_device(device)) < n_dirty
