"""The epoch loop: the whole per-epoch pipeline over one resident state.

The counterpart of the reference package's ``recovery/superstep.py``.
Each simulated epoch drains the epoch's window of a pre-staged **event
tape** compiled from a :class:`~ceph_tpu_torch.recovery.chaos.
ChaosTimeline`, ticks the liveness detector, re-peers when the map
moved, reclassifies PG states, runs one traffic step and counts the
scrub windows, all over one :class:`~ceph_tpu_torch.core.cluster_state.
ClusterState` on one device.

Event tape
----------

:func:`compile_event_tape` flattens the timeline into ``(t, kind, osd,
bump)`` rows, resolved against the baseline map once, as the
reference does: map actions become :data:`TAPE_DOWN`/:data:`TAPE_UP`/
:data:`TAPE_OUT`/:data:`TAPE_IN` rows (the first map row of each event
carries ``bump=1``, its epoch advance), ``netsplit:``/``slow:`` specs
become NET/SLOW rows, ``bitrot:`` specs are only counted.  An epoch's
window ``(cursor, searchsorted(t, now)]`` is known on the host without
a read from the device, and its rows apply in order as one small device
edit a row: from a host slice in the host-decided loop, from a device
cursor over the tape's kind and OSD columns on the card in the compiled
superstep.

How the loop syncs
------------------

The reference compiles a chunk of epochs into one traced program and
scans it.  So does the port on the card: :class:`SuperstepProgram`
(:meth:`EpochDriver.compile_superstep`, and its flight-recorder twin)
is one CUDA graph a chunk, a WHILE node over the chunk's steps whose
body makes every decision of the epoch on the device, as the
reference's traces do: the tape window a WHILE node over its rows from
a device cursor (each row's edit a SWITCH node on its kind), the
liveness tick an IF node on the device's idle test, the dirty branch an
IF node holding a SWITCH on the compaction ladder's rung, whose top
body is the dense re-peer (the fused pipeline's program inline).  What
depends only on the step (the clock, the tape window's stop, bumps and
map rows, the traffic salt and capacity, the scrub count) is computed
on the host once a run, as the host driver computes it, into per-step
tables the body indexes (:meth:`EpochDriver.step_tables`).  A chunk
reads nothing back; its rows come back as one copy when pulled
(:meth:`EpochSeries.from_device`), with the epoch, dirty and rung lanes
among them.

On the CPU :meth:`EpochDriver.run_superstep` keeps the host-decided
loop (:meth:`EpochDriver._advance_host`), which keeps on the host
everything the host can know without a read: the clock, the tape
cursor, the map epoch, and the suppressed/slow bits (the tape alone sets
them).  So:

- a quiet idle epoch (no map row, no suppressed, slow, down or laggy
  OSD) reads nothing back;
- a non-idle epoch reads one small tensor after the liveness tick (a
  transition happened, any OSD down, any laggy): the dirty decision;
- a dirty epoch makes the CRUSH engine's reads (one a retry round,
  ``interp_batch._any``), and with the ladder on, one read of the
  dirty-PG count picks the rung.

The write path's program adds its stage to this body; the fleet's
sequential baseline and the divergent ranks run :class:`TapeProgram`,
the same body with the tape and the salt as device inputs.  On the CPU
each keeps its host-decided loop.  The compiled programs run on the CPU
as well, eagerly, each decision one read of its predicate (what the CPU
tests hold against the reference).

Two drivers
-----------

:meth:`EpochDriver.run_superstep` is the chunked loop above.
:meth:`EpochDriver.run_staged` calls the same pieces one stage at a
time and replays the reference's per-epoch host round trips: the idle
test decided from the device, the six liveness lanes copied back after
the tick, the dirty decision, dense peering on every dirty epoch, one
host row an epoch.  The two must be equal bit for bit
(:meth:`EpochSeries.diff`).  ``CEPH_TPU_EPOCH_SUPERSTEP=0`` pins the
staged path (:func:`epoch_superstep_enabled`); both paths run on the
card, so the switch hides nothing.

With ``flight_recorder=on`` each epoch also writes one row of telemetry
lanes into a ring on the device (:mod:`ceph_tpu_torch.obs.flight`): the
dirty-set probe of a dirty epoch is read only, so every epoch lane is
the same with the recorder on or off.  :meth:`EpochDriver.advance` runs
any range of epochs from a state and its host view, and
:meth:`EpochDriver.host_view` rebuilds that view from a restored
state's scalars (the checkpointed runs of
:mod:`~ceph_tpu_torch.recovery.checkpoint`).

The dense dirty branch (:meth:`EpochDriver._peer_hist`) is the
current-epoch half of the fused placement->peering program
(:meth:`ceph_tpu_torch.recovery.pipeline.FusedPeering.peer_hist`): the
epoch's pool state mapped, classified against the baseline epoch's
acting table (mapped once when the driver is built) and reduced to the
PG-state histogram; in the host-decided loop on the card one replay of
that program's own graph, inside the compiled superstep's graph inline.
The dirty-set ladder's rungs below dense run the mapping program of
:func:`~ceph_tpu_torch.osdmap.mapping.compile_pool_mapping` on their
buckets.  Under ``CEPH_TPU_FUSED_PIPELINE=0`` the dense branch runs that
program too.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field, fields, replace

import numpy as np
import torch

from .. import resolve_device
from ..common.config import global_config
from ..core.cluster_state import (
    ClusterState,
    bucket_valid,
    compact_dirty_indices,
    dirty_ladder,
    gather_rows,
    ladder_rung,
    scatter_rows,
)
from ..crush.map import ITEM_NONE
from ..osdmap.map import OSDMap
from ..osdmap.mapping import build_pool_state, compile_pool_mapping
from .chaos import ChaosTimeline
from .liveness import heartbeat_step
from .peering import classify_rows
from .pipeline import compile_fused_peering, peer_current
from .scrub import scrub_phases

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64

#: the traffic engine's per-step salt stride (u32 wraparound)
_SALT_STEP = 40503
_M32 = 0xFFFFFFFF


def epoch_superstep_enabled() -> bool:
    """Whether :func:`run_epochs` uses the chunked superstep
    (``CEPH_TPU_EPOCH_SUPERSTEP=0`` pins the staged per-epoch path)."""
    return os.environ.get("CEPH_TPU_EPOCH_SUPERSTEP", "1") != "0"


# ---------------------------------------------------------------------------
# event tape

TAPE_DOWN = 0
TAPE_UP = 1
TAPE_OUT = 2
TAPE_IN = 3
TAPE_NET_DROP = 4
TAPE_NET_RESTORE = 5
TAPE_SLOW_DROP = 6
TAPE_SLOW_RESTORE = 7

#: kinds that edit map lanes (their presence in an epoch's window makes
#: the epoch dirty: peering must re-run)
_MAP_KINDS = (TAPE_DOWN, TAPE_UP, TAPE_OUT, TAPE_IN)

_ACTION_KINDS = {
    "down": (TAPE_DOWN,),
    "up": (TAPE_UP,),
    "out": (TAPE_OUT,),
    "in": (TAPE_IN,),
    "down_out": (TAPE_DOWN, TAPE_OUT),
}

_NET_KINDS = {
    ("netsplit", "drop"): TAPE_NET_DROP,
    ("netsplit", "restore"): TAPE_NET_RESTORE,
    ("slow", "drop"): TAPE_SLOW_DROP,
    ("slow", "restore"): TAPE_SLOW_RESTORE,
}

#: tape kinds whose lane edits conflict when they hit the same OSD
#: inside ONE event (the host engine batches an event into one
#: Incremental where such pairs cancel differently than sequential
#: rows would)
_CONFLICTS = ((TAPE_DOWN, TAPE_UP), (TAPE_OUT, TAPE_IN))


@dataclass(frozen=True)
class EventTape:
    """The compiled chaos schedule: time-sorted rows; ``bump`` marks
    epoch advances (one per event with map specs)."""

    t: np.ndarray      # f64 [rows]
    kind: np.ndarray   # i32 [rows]
    osd: np.ndarray    # i32 [rows]
    bump: np.ndarray   # i32 [rows]
    n_events: int
    n_bitrot: int

    def __len__(self) -> int:
        return int(self.t.shape[0])

    def device(self, dev):
        """The four columns as tensors on ``dev``."""
        dev = resolve_device(dev)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (self.t, self.kind, self.osd, self.bump))


def compile_event_tape(timeline: ChaosTimeline, m: OSDMap) -> EventTape:
    """Flatten a timeline into :class:`EventTape` rows, resolving
    bucket scopes against the map's topology once, up front.  Raises
    when one event carries conflicting map actions for the same OSD
    (down+up or out+in): the host engine folds those into one
    Incremental whose xor semantics a sequential row replay cannot
    reproduce; schedule them as separate events instead."""
    from .failure import resolve_targets

    t_rows: list[float] = []
    kind_rows: list[int] = []
    osd_rows: list[int] = []
    bump_rows: list[int] = []
    n_bitrot = 0
    for ev in timeline.events():
        map_rows: list[tuple[int, int]] = []
        net_rows: list[tuple[int, int]] = []
        for spec in ev.specs:
            if spec.is_rank:
                raise ValueError(
                    f"{spec} is rank-scoped observation skew, not a "
                    "cluster event; strip it with "
                    "recovery.reconcile.rank_view_timeline before "
                    "compiling a per-rank tape"
                )
            if spec.is_chip:
                raise ValueError(
                    f"{spec} faults a device-mesh chip, not the "
                    "simulated cluster; strip it with "
                    "recovery.dispatch.strip_chip_specs (the "
                    "work-stealing dispatcher consumes it) before "
                    "compiling a tape"
                )
            if spec.is_crash:
                raise ValueError(
                    f"{spec} kills the driving process, not the "
                    "simulated cluster; strip it with "
                    "recovery.checkpoint.strip_crash_specs (the "
                    "checkpointed runners consume it) before "
                    "compiling a tape"
                )
            if spec.is_bitrot:
                n_bitrot += 1
                continue
            if spec.is_net:
                net_rows.append(
                    (_NET_KINDS[(spec.scope, spec.action)], int(spec.target))
                )
                continue
            for kind in _ACTION_KINDS[spec.action]:
                for osd in resolve_targets(m, spec):
                    map_rows.append((kind, int(osd)))
        for a, b in _CONFLICTS:
            hit = {o for k, o in map_rows if k == a} & {
                o for k, o in map_rows if k == b
            }
            if hit:
                raise ValueError(
                    f"event at t={ev.t} applies conflicting actions to "
                    f"osd(s) {sorted(hit)}; split them into separate "
                    "events"
                )
        for j, (kind, osd) in enumerate(map_rows + net_rows):
            t_rows.append(float(ev.t))
            kind_rows.append(kind)
            osd_rows.append(osd)
            bump_rows.append(1 if (j == 0 and map_rows) else 0)
    return EventTape(
        t=np.asarray(t_rows, np.float64),
        kind=np.asarray(kind_rows, np.int32),
        osd=np.asarray(osd_rows, np.int32),
        bump=np.asarray(bump_rows, np.int32),
        n_events=len(timeline),
        n_bitrot=n_bitrot,
    )


# Each edit takes int64 indices into the flattened lanes (``osd`` for one
# cluster, ``lane * n_osds + osd`` for a fleet; no index repeats in one
# call) and edits them in place: a few launches, nothing read back.
# ``now32`` is a host float, or a [1] float32 tensor on the device (the
# compiled superstep's step, whose clock is a table entry).


def _stamp(t, i, now32):
    """``t[i] = now32`` in place."""
    if isinstance(now32, torch.Tensor):
        t.index_copy_(0, i, now32.expand(i.shape[0]))
    else:
        t.index_fill_(0, i, now32)


def _edit_down(f, i, now32, exists):
    f["up"].index_fill_(0, i, False)


def _edit_up(f, i, now32, exists):
    # the effective bit becomes exists (a non-existing OSD stays down);
    # an authoritative up re-arms the detector
    f["up"].index_copy_(0, i, exists.index_select(0, i))
    _stamp(f["ack"], i, now32)
    f["sup"].index_fill_(0, i, False)
    f["out"].index_fill_(0, i, False)


def _edit_out(f, i, now32, exists):
    f["w"].index_fill_(0, i, 0)


def _edit_in(f, i, now32, exists):
    w = f["w"].index_select(0, i)
    f["w"].index_copy_(0, i, torch.where(w == 0, 0x10000, w))
    _stamp(f["ack"], i, now32)
    f["sup"].index_fill_(0, i, False)
    f["out"].index_fill_(0, i, False)


def _edit_net_drop(f, i, now32, exists):
    _stamp(f["ack"], i, now32)
    f["sup"].index_fill_(0, i, True)


def _edit_net_restore(f, i, now32, exists):
    _stamp(f["ack"], i, now32)
    f["sup"].index_fill_(0, i, False)


def _edit_slow_drop(f, i, now32, exists):
    f["slow"].index_fill_(0, i, True)


def _edit_slow_restore(f, i, now32, exists):
    f["slow"].index_fill_(0, i, False)


#: one edit a tape kind, in the order of the TAPE_* constants
_LANE_EDITS = (_edit_down, _edit_up, _edit_out, _edit_in, _edit_net_drop,
               _edit_net_restore, _edit_slow_drop, _edit_slow_restore)


def _host_bits(kind: int, suppressed: np.ndarray, slow: np.ndarray, where) -> None:
    """The host's copy of what a tape edit of ``kind`` does to the
    suppressed and slow bits at ``where`` (a numpy index)."""
    if kind in (TAPE_UP, TAPE_IN, TAPE_NET_RESTORE):
        suppressed[where] = False
    elif kind == TAPE_NET_DROP:
        suppressed[where] = True
    elif kind in (TAPE_SLOW_DROP, TAPE_SLOW_RESTORE):
        slow[where] = kind == TAPE_SLOW_DROP


# ---------------------------------------------------------------------------
# the epoch series


_SERIES_FIELDS = (
    "now", "epoch", "dirty", "hist", "aux", "counts", "lat_hist",
    "qd_hist", "sums", "max_rho", "writes", "deg_reads", "down_total",
    "eff_down", "eff_up", "eff_out", "down_checksum", "scrub_due",
)

#: the lanes a host knows without a read (kept in host lists)
_HOST_FIELDS = ("now", "epoch", "dirty")


def _packed_layout() -> list[tuple[str, int, np.dtype]]:
    """(field, width, dtype) of the device row: every lane but the host
    ones, in series order, int32 words (float32 lanes by their bits)."""
    from ..obs.pg_states import N_STATES
    from ..workload.histogram import N_BUCKETS

    widths = {"hist": N_STATES, "aux": 2, "counts": 3, "lat_hist": N_BUCKETS,
              "qd_hist": N_BUCKETS, "sums": 2}
    floats = ("sums", "max_rho")
    return [(f, widths.get(f, 1), np.float32 if f in floats else np.int32)
            for f in _SERIES_FIELDS if f not in _HOST_FIELDS]


def _packed_cols() -> dict[str, int]:
    """Each packed lane's first column in the device row."""
    cols, c = {}, 0
    for f, width, _d in _packed_layout():
        cols[f] = c
        c += width
    return cols


#: the compiled superstep's row lanes after the packed ones (int32 words):
#: the map epoch, dirty, the rung taken (:data:`NO_RUNG` when none) and the
#: clock's float64 in two words
_ROW_LANES = ("epoch", "dirty", "rung", "now_lo", "now_hi")
#: the rung lane of an epoch that took no rung of the ladder (a quiet
#: epoch, or a driver without a ladder)
NO_RUNG = -2


@dataclass
class EpochRows:
    """A run's epoch rows before they are pulled: the host lanes as
    arrays and the rest as one ``[n, width]`` int32 tensor on the
    device (:func:`_packed_layout`).  Rows of the compiled superstep
    keep their host lanes on the device too: ``lanes`` is ``[n, width +
    len(_ROW_LANES)]`` (``packed`` its first ``width`` columns) and
    ``now``/``epoch``/``dirty`` are None until :meth:`host` reads it."""

    now: np.ndarray | None
    epoch: np.ndarray | None
    dirty: np.ndarray | None
    packed: torch.Tensor
    lanes: torch.Tensor | None = None
    _read: np.ndarray | None = field(default=None, repr=False)

    def __len__(self) -> int:
        return int(self.packed.shape[0])

    def host(self) -> np.ndarray:
        """The device rows on the host: one read, kept."""
        if self._read is None:
            self._read = self.lanes.cpu().numpy()
        return self._read

    def rungs(self) -> list[int]:
        """The rungs the rows' dirty epochs took (from the rung lane)."""
        if self.lanes is None:
            return []
        lane = self.host()[:, self.packed.shape[1] + _ROW_LANES.index("rung")]
        return [int(r) for r in lane if r != NO_RUNG]


@dataclass(frozen=True)
class EpochSeries:
    """Per-epoch outputs, host numpy, one leading epoch axis each: the
    journal and snapshot payload and the differential tests' comparison
    surface, with the reference's fields and dtypes."""

    now: np.ndarray          # f64 [n]
    epoch: np.ndarray        # i32 [n]  map epoch after the step
    dirty: np.ndarray        # i32 [n]  1 = peering re-ran
    hist: np.ndarray         # i32 [n, N_STATES]
    aux: np.ndarray          # i32 [n, 2]
    counts: np.ndarray       # i32 [n, 3]  served/degraded/blocked
    lat_hist: np.ndarray     # i32 [n, B]
    qd_hist: np.ndarray      # i32 [n, B]
    sums: np.ndarray         # f32 [n, 2]  lat/qd sums (SLO inputs)
    max_rho: np.ndarray      # f32 [n]
    writes: np.ndarray       # i32 [n]  committed writes
    deg_reads: np.ndarray    # i32 [n]  degraded reads served
    down_total: np.ndarray   # i32 [n]  detector-down OSDs
    eff_down: np.ndarray     # i32 [n]  map transitions this epoch
    eff_up: np.ndarray       # i32 [n]
    eff_out: np.ndarray      # i32 [n]
    down_checksum: np.ndarray  # i32 [n]  sum(osd+1) over the down set
    scrub_due: np.ndarray    # i32 [n]  PGs whose scrub window ticked

    def __len__(self) -> int:
        return int(self.now.shape[0])

    @classmethod
    def from_rows(cls, now, epoch, dirty, packed: np.ndarray) -> "EpochSeries":
        """The series of host lanes and host packed rows
        (:func:`_packed_layout`)."""
        out = {"now": np.asarray(now, np.float64), "epoch": np.asarray(epoch, np.int32),
               "dirty": np.asarray(dirty, np.int32)}
        layout = _packed_layout()
        packed = np.asarray(packed, np.int32).reshape(len(out["now"]),
                                                      sum(w for _f, w, _d in layout))
        col = 0
        for f, width, dtype in layout:
            part = np.ascontiguousarray(packed[:, col:col + width]).view(dtype)
            out[f] = part if f in ("hist", "aux", "counts", "lat_hist", "qd_hist",
                                   "sums") else part[:, 0]
            col += width
        return cls(**out)

    @classmethod
    def from_device(cls, rows: EpochRows) -> "EpochSeries":
        """The series of a chunk's rows: one copy back."""
        if rows.lanes is None:
            return cls.from_rows(rows.now, rows.epoch, rows.dirty, rows.packed.cpu().numpy())
        a = rows.host()
        w = rows.packed.shape[1]
        lane = {name: w + i for i, name in enumerate(_ROW_LANES)}
        now = np.ascontiguousarray(a[:, lane["now_lo"]:lane["now_hi"] + 1]).view(np.float64)
        return cls.from_rows(now[:, 0], a[:, lane["epoch"]], a[:, lane["dirty"]], a[:, :w])

    @classmethod
    def concat(cls, parts: list["EpochSeries"]) -> "EpochSeries":
        if len(parts) == 1:
            return parts[0]
        return cls(**{
            f: np.concatenate([getattr(p, f) for p in parts])
            for f in _SERIES_FIELDS
        })

    def diff(self, other: "EpochSeries") -> list[str]:
        """Field names where the two series differ bit for bit (floats
        compared exactly)."""
        out = []
        for f in _SERIES_FIELDS:
            a, b = getattr(self, f), getattr(other, f)
            if a.shape != b.shape or not np.array_equal(a, b):
                out.append(f)
        return out


# ---------------------------------------------------------------------------
# the driver


@dataclass
class _HostView:
    """What the host knows of a run without reading the device: the
    clock and cursors (the state's scalars), the suppressed and slow
    bits (only tape rows set them), and whether any OSD was down or
    laggy after the last liveness tick (read with the dirty decision)."""

    step: int
    now: float
    last_tick: float
    epoch: int
    cursor: int
    suppressed: np.ndarray
    slow: np.ndarray
    any_down: bool = False
    any_laggy: bool = False
    #: after a compiled chunk only the clock and cursors are the host's
    #: (the step tables'); the epoch, last tick, bits and flags stayed on
    #: the device (:meth:`EpochDriver.host_view` reads them)
    stale: bool = False

    def copy(self) -> "_HostView":
        return replace(self, suppressed=self.suppressed.copy(), slow=self.slow.copy())

    @property
    def idle(self) -> bool:
        return not (self.suppressed.any() or self.slow.any() or self.any_down
                    or self.any_laggy)


class EpochDriver:
    """Owns the pieces of one epoch loop (tape apply, liveness tick,
    peering, classify, traffic, scrub tick) and the two drivers over
    them: the chunked superstep and the staged per-epoch reference.
    Both advance the same :class:`ClusterState` through the same
    functions on ``device`` (the card by default)."""

    def __init__(
        self,
        m: OSDMap,
        timeline: ChaosTimeline,
        *,
        pool_id: int | None = None,
        dt: float = 0.25,
        t0: float = 0.0,
        n_ops: int = 1024,
        k: int | None = None,
        seed: int = 0,
        write_fraction: float | None = None,
        service_ms: float = 0.5,
        osd_capacity_ops_per_s: float | None = None,
        scrub_period_s: float | None = None,
        config=None,
        noout: bool = False,
        reporters: np.ndarray | None = None,
        max_items: int = 8,
        mix=None,
        rho_recovery: float = 0.0,
        device="cuda",
    ):
        from ..workload.traffic import resolve_mix

        cfg = config or global_config()
        dev = self.device = resolve_device(device)
        pool = m.pools[min(m.pools) if pool_id is None else pool_id]
        self.pool = pool
        self.dt = float(dt)
        self.t0 = float(t0)
        self.n_ops = int(n_ops)
        self.seed = int(seed)
        self.salt_base = (self.seed * 2654435761) & _M32
        # named workload mix: the default read/write split and the
        # skew/burst shape; None keeps uniform traffic
        self._mix = resolve_mix(mix)
        if write_fraction is None:
            write_fraction = (
                self._mix.write_fraction if self._mix is not None else 0.25
            )
        self.rho_recovery = float(rho_recovery)
        # the EC reconstruction threshold the traffic router and the
        # PG-state classifier key "inactive" on; replicated pools read
        # from any one survivor
        self.k = int(
            k if k is not None
            else (pool.min_size if pool.kind == "erasure" else 1)
        )
        self.size = int(pool.size)
        self.min_size = int(pool.min_size)
        self.pg_num = int(pool.pg_num)
        self.write_permille = int(round(float(write_fraction) * 1000))
        self.service_ms = float(service_ms)
        self.cap_ops = float(
            osd_capacity_ops_per_s
            if osd_capacity_ops_per_s is not None
            else 2.0 * self.n_ops / max(m.max_osd, 1)
        )
        self.scrub_period_s = float(
            scrub_period_s if scrub_period_s is not None
            else cfg.get("osd_scrub_stagger_period")
        )
        # liveness policy scalars, frozen at build time (as the tape is)
        self.grace = float(cfg.get("osd_heartbeat_grace"))
        self.grace_cap = float(cfg.get("mon_osd_grace_doublings_max"))
        self.adjust = 1.0 if cfg.get("mon_osd_adjust_heartbeat_grace") else 0.0
        self.min_reporters = int(cfg.get("mon_osd_min_down_reporters"))
        self.down_out_interval = float(cfg.get("mon_osd_down_out_interval"))
        self.laggy_weight = float(cfg.get("mon_osd_laggy_weight"))
        self.laggy_halflife = float(cfg.get("mon_osd_laggy_halflife"))
        self.min_in_ratio = float(cfg.get("mon_osd_min_in_ratio"))
        # noout / interval <= 0 gate auto-out entirely
        self.outs_enabled = not noout and self.down_out_interval > 0.0

        from ..crush.engine import runner_signature

        choose_args = m.crush.choose_args_name_for_pool(pool.id)
        dense = m.crush.to_dense(choose_args=choose_args)
        rule = m.crush.rules[pool.crush_rule]
        if runner_signature(dense, rule, pool.size)[0] == "host":
            raise ValueError(
                "the epoch loop needs a device CRUSH tier (maps on the "
                "host C++ tier keep the per-epoch supervised loop)"
            )
        self._crush_arg, self._map_fn = compile_pool_mapping(dense, pool, rule, device=dev)
        self._fused_arg, self._fused = compile_fused_peering(dense, pool, rule, device=dev)
        self._pg_idx = torch.arange(self.pg_num, dtype=I64, device=dev)
        # the dirty-set ladder: 'on' compacts wherever the geometry
        # leaves a rung below dense, 'auto' only when the dense width
        # dwarfs the smallest bucket, 'off' pins the dense reference
        sdc = str(cfg.get("sparse_dirty_compaction"))
        min_bucket = int(cfg.get("sparse_min_bucket"))
        ladder = dirty_ladder(self.pg_num, min_bucket=min_bucket,
                              max_rungs=int(cfg.get("sparse_ladder_rungs")))
        if sdc == "off" or (sdc == "auto" and self.pg_num < 64 * min_bucket):
            ladder = ()
        self._dirty_ladder: tuple[int, ...] = ladder
        self.compaction_enabled = bool(ladder)
        self._rungs: list[int] = []
        self._rung_rows: list[EpochRows] = []
        # the previous epoch of survivor classification: the baseline
        # placement, fixed for the run, mapped once
        self._state_prev = build_pool_state(m, pool, max_items, dev)
        self._prev_acting = self._map_fn(self._crush_arg, self._state_prev, self._pg_idx)[2]

        self.tape = compile_event_tape(timeline, m)
        self._ids = torch.arange(self.n_ops, dtype=I64, device=dev)
        self._zero_live = torch.zeros(5, dtype=I32, device=dev)
        self._zero_i32 = torch.zeros(1, dtype=I32, device=dev)
        self._phases = (
            torch.from_numpy(scrub_phases(self.pg_num, self.scrub_period_s)).to(dev)
            if self.scrub_period_s > 0 else None
        )

        init = ClusterState.from_osdmap(
            m, pool.id, max_items=max_items, now=self.t0, reporters=reporters,
            device=dev,
        )
        # seed the peering tables (and reporter pools, unless given)
        # from the baseline placement so epoch 0 diffs against a real
        # mapping rather than empty tables
        init = self._peer_hist(init)
        if reporters is None:
            counts = _peer_counts(init.acting.cpu().numpy(), init.n_osds)
            init = replace(init, reporters=torch.from_numpy(counts).to(dev))
        self._init_state = init
        n = init.n_osds
        self._init_host = _HostView(
            step=0, now=self.t0, last_tick=self.t0, epoch=int(m.epoch), cursor=0,
            suppressed=np.zeros(n, bool), slow=np.zeros(n, bool),
        )
        self._sparse_mode = sdc
        self._sparse_rungs = int(cfg.get("sparse_ladder_rungs"))
        # the flight recorder: 'on' records a ring row an epoch, 'off'
        # and 'auto' (the port has no bench-decided default) do not
        from ..obs.flight import empty_flight, resolve_flight_recorder

        self.flight_ring_epochs = int(cfg.get("flight_ring_epochs"))
        self.flight_on = resolve_flight_recorder(str(cfg.get("flight_recorder")))
        self._init_flight = (empty_flight(self.flight_ring_epochs, device=dev)
                             if self.flight_on else None)
        #: the recorder's ring after the most recent run or chunk
        self.flight = self._init_flight
        self._probe = None
        # the compiled supersteps (recorder off, on; "tape": the tape program)
        # and the step tables
        self._programs: dict = {}
        self._tables_host: dict | None = None
        self._tables_dev: dict | None = None

    @property
    def rungs_taken(self) -> list[int]:
        """The rung each dirty epoch of the last run took (len(ladder):
        dense; -1: nothing to re-peer), for reports.  A compiled run's
        come from its rows' rung lane, read here unless already pulled."""
        for rows in self._rung_rows:
            self._rungs.extend(rows.rungs())
        self._rung_rows = []
        return self._rungs

    @rungs_taken.setter
    def rungs_taken(self, rungs) -> None:
        self._rungs, self._rung_rows = list(rungs), []

    # -- the pieces (shared by both drivers) ---------------------------

    def _now_of(self, step: int) -> float:
        """Virtual time after epoch ``step`` (f64, the reference's
        expression)."""
        return self.t0 + float(step + 1) * self.dt

    def _tape_apply(self, state: ClusterState, host: _HostView, step: int,
                    tape: EventTape | None = None):
        """Drain the tape window ``(cursor, searchsorted(t, now)]``:
        each row one edit of the OSD lanes, in order.  The window is a
        host slice of the host tape.  Returns ``(state, map rows in the
        window)``."""
        tape = self.tape if tape is None else tape
        now = self._now_of(step)
        stop = int(np.searchsorted(tape.t, now, side="right"))
        lo = host.cursor
        kinds = tape.kind[lo:stop]
        if stop > lo:
            pool = state.pool
            lanes = {"up": pool.osd_up.clone(), "w": pool.osd_weight.clone(),
                     "ack": state.last_ack.clone(), "sup": state.suppressed.clone(),
                     "slow": state.slow.clone(), "out": state.out.clone()}
            now32 = float(np.float32(now))
            dev = pool.osd_exists.device
            for kind, o in zip(kinds, tape.osd[lo:stop]):
                o = int(o)
                # a fill makes the index on the device: no copy, no sync
                i = torch.full((1,), o, dtype=torch.int64, device=dev)
                _LANE_EDITS[kind](lanes, i, now32, pool.osd_exists)
                _host_bits(kind, host.suppressed, host.slow, o)
            state = replace(
                state, pool=replace(pool, osd_up=lanes["up"], osd_weight=lanes["w"]),
                last_ack=lanes["ack"], suppressed=lanes["sup"], slow=lanes["slow"],
                out=lanes["out"])
        host.epoch += int(tape.bump[lo:stop].sum())
        host.now, host.cursor, host.step = now, stop, step
        return state, bool(np.isin(kinds, _MAP_KINDS).any())

    def _live(self, state: ClusterState, host: _HostView, idle: bool):
        """The liveness tick, skipped when ``idle``.  Returns ``(state,
        live, trans)``: ``live`` the epoch's ``[down_total, eff_down,
        eff_up, eff_out, down_checksum]`` on the device, ``trans``
        whether the tick moved the map (read back with whether any OSD
        is down or laggy after it: the one read of a non-idle epoch)."""
        if idle:
            # nothing can transition; last_tick deliberately stays, so
            # the next real tick decays over the whole elapsed window
            return state, self._zero_live, False
        now = host.now
        state, live, flags = self._tick(state, now, self._decay(now, host.last_tick))
        trans, any_down, any_laggy = flags.cpu().tolist()
        host.epoch += int(trans)
        host.last_tick = now
        host.any_down, host.any_laggy = any_down, any_laggy
        return state, live, trans

    def _decay(self, now: float, last_tick: float) -> float:
        """The laggy and markdown decay over ``(last_tick, now]``."""
        return 0.5 ** (max(now - last_tick, 0.0) / max(self.laggy_halflife, 1e-9))

    def _tick(self, state: ClusterState, now: float, decay):
        """``heartbeat_step`` and the out/transition masks, along the last
        axis (one cluster, or a fleet with a ``[lanes, 1]`` decay).
        Returns ``(state, live [..., 5], flags [..., 3])``: ``flags`` is
        whether the tick moved the map, any OSD is down and any is laggy
        after it, on the device."""
        ack, laggy, md, down, dsince, propose = heartbeat_step(
            state.last_ack, state.laggy, state.markdowns, state.down, state.down_since,
            state.suppressed, state.slow, state.reporters, now, self.grace,
            self.grace_cap, self.adjust, self.min_reporters, self.down_out_interval,
            self.laggy_weight, decay,
        )
        newly_down = down & ~state.down
        newly_up = state.down & ~down
        pool = state.pool
        w, exists = pool.osd_weight, pool.osd_exists
        if self.outs_enabled:
            cand = propose & ~state.out
            # the host approves candidates in ascending OSD order until
            # (n_in - approved)/n_exist would drop below the floor; the
            # ratio is monotone in the candidate index, so the approved
            # set is a prefix: one cumsum mask
            c = torch.cumsum(cand.to(I32), -1)
            n_exist = exists.sum(-1, dtype=I32, keepdim=True)
            n_in = (exists & (w > 0)).sum(-1, dtype=I32, keepdim=True)
            ratio = (n_in - c).to(F64) / n_exist.clamp(min=1).to(F64)
            approved = cand & ((n_exist == 0) | (ratio >= self.min_in_ratio))
        else:
            approved = torch.zeros_like(state.out)
        # transitions the map does not already reflect: the epoch's one
        # detection Incremental
        eff_down = newly_down & pool.osd_up
        eff_up = newly_up & exists & ~pool.osd_up
        eff_out = approved & (w > 0)
        live = torch.stack([
            down.sum(-1, dtype=I32), eff_down.sum(-1, dtype=I32), eff_up.sum(-1, dtype=I32),
            eff_out.sum(-1, dtype=I32), _down_checksum(down)], dim=-1)
        flags = torch.stack([live[..., 1:4].sum(-1) > 0, down.any(-1), (laggy != 0).any(-1)],
                            dim=-1)
        state = replace(
            state,
            pool=replace(pool, osd_up=(pool.osd_up & ~eff_down) | eff_up,
                         osd_weight=torch.where(eff_out, 0, w)),
            last_ack=ack, laggy=laggy, markdowns=md, down=down, down_since=dsince,
            out=state.out | approved,
        )
        return state, live, flags

    def _peer_rows(self, state: ClusterState, pgs: torch.Tensor, prev_acting):
        """Map the epoch's pool state at PG seeds ``pgs`` and classify
        against the baseline's acting rows."""
        up, upp, acting, actp = self._map_fn(self._crush_arg, state.pool, pgs)
        flags, mask, n_alive = classify_rows(prev_acting, up, acting, self.min_size)
        return up, upp, acting, actp, flags, mask, n_alive

    def _peer_outs(self, pool) -> tuple:
        """The dense dirty branch's outputs for the pool state ``pool``:
        ``(up, up_primary, acting, acting_primary, flags, survivor_mask,
        n_alive, pg_hist, pg_aux)``, the fused pipeline's current-epoch
        half (eagerly under the lever)."""
        if self._fused is not None:
            return self._fused.peer_hist(self._fused_arg, pool, self._prev_acting,
                                         self._pg_idx, self.min_size, self.k)
        return peer_current(self._map_fn, self._crush_arg, pool, self._prev_acting,
                            self._pg_idx, self.min_size, self.k)

    def _peer_hist(self, state: ClusterState) -> ClusterState:
        """Re-peer and reclassify every PG: the dense dirty branch."""
        up, upp, acting, actp, flags, mask, n_alive, hist, aux = self._peer_outs(state.pool)
        return replace(state, up=up, up_primary=upp, acting=acting, acting_primary=actp,
                       flags=flags, survivor_mask=mask, n_alive=n_alive,
                       pg_hist=hist, pg_aux=aux)

    @staticmethod
    def _dirty_pgs(state: ClusterState, prev_up, prev_w):
        """The dirty-set predicate: ``(dirty_pg [pg_num] bool, heavy)``
        on the device.  Heavy epochs (a weight edit, an OSD coming up)
        dirty every PG; otherwise a PG is dirty when its carried
        ``up``/``acting`` rows or its ``pg_temp``/``primary_temp``
        overrides hold an OSD that went down."""
        pool = state.pool
        cur_up = pool.osd_up
        up_flip = prev_up ^ cur_up
        heavy = (prev_w != pool.osd_weight).any() | (up_flip & cur_up).any()
        down_flip = up_flip & ~cur_up
        n = down_flip.shape[0]
        flip_pad = torch.cat([down_flip, down_flip.new_zeros(1)])

        def member(tbl):
            ids = torch.where((tbl >= 0) & (tbl < n), tbl, n).to(I64)
            return flip_pad[ids].any(dim=-1)

        dirty_pg = (member(state.up) | member(state.acting) | member(pool.pg_temp)
                    | member(pool.primary_temp[:, None]) | heavy)
        return dirty_pg, heavy

    def _peer_hist_compact(self, state: ClusterState, prev_up, prev_w) -> ClusterState:
        """The dirty branch through the dirty-set ladder.

        *Heavy* epochs (any weight edit, or an OSD coming up) can re-rank
        CRUSH draws for any PG, so every PG is dirty and the ladder
        lands on the dense top rung.  *Down-flip-only* epochs can change
        only the PGs whose candidate sets hold a flipped OSD: the
        carried ``up``/``acting`` rows and the static ``pg_temp``/
        ``primary_temp`` overrides.  Those PGs compact onto the
        narrowest rung that holds them (one read of their count),
        peer on the bucket, scatter back, and refold ``pg_hist``/
        ``pg_aux`` by exact integer deltas over the bucket's valid
        lanes."""
        widths = self._dirty_ladder
        dirty_pg, heavy = self._dirty_pgs(state, prev_up, prev_w)
        take, n_dirty = compact_dirty_indices(dirty_pg)
        nd = int(n_dirty)  # the rung read
        self._probe = (nd, heavy)
        rung = ladder_rung(nd, widths)
        if rung == len(widths):
            self._rungs.append(rung)
            return self._peer_hist(state)
        if nd == 0:
            # every lane a pad: the scatters drop all, the refold adds 0
            self._rungs.append(-1)
            return state
        self._rungs.append(rung)
        return self._compact_branch(state, take, n_dirty, widths[rung])

    def _compact_branch(self, state: ClusterState, take, n_dirty, W: int) -> ClusterState:
        """One compacted rung of width ``W``: the first ``W`` dirty PGs
        of ``take`` peered on the bucket, scattered back, ``pg_hist``/
        ``pg_aux`` refolded over the bucket's valid lanes."""
        from ..obs.pg_states import pg_state_reduce

        idx = take[:W].clamp(0, self.pg_num - 1)
        up, upp, acting, actp, flags, mask, n_alive = self._peer_rows(
            state, idx, self._prev_acting[idx])
        valid = bucket_valid(n_dirty, W)
        old_hist, old_aux = pg_state_reduce(
            gather_rows(state.survivor_mask, take, W), gather_rows(state.n_alive, take, W),
            gather_rows(state.flags, take, W), self.k, self.size, valid)
        new_hist, new_aux = pg_state_reduce(mask, n_alive, flags, self.k, self.size, valid)
        return replace(
            state,
            up=scatter_rows(state.up, take, W, up),
            up_primary=scatter_rows(state.up_primary, take, W, upp),
            acting=scatter_rows(state.acting, take, W, acting),
            acting_primary=scatter_rows(state.acting_primary, take, W, actp),
            flags=scatter_rows(state.flags, take, W, flags),
            survivor_mask=scatter_rows(state.survivor_mask, take, W, mask),
            n_alive=scatter_rows(state.n_alive, take, W, n_alive),
            pg_hist=state.pg_hist + new_hist - old_hist,
            pg_aux=state.pg_aux + new_aux - old_aux,
        )

    def _traffic_apply(self, state: ClusterState, step: int, now: float,
                       salt_base=None):
        """One traffic step of ``n_ops`` over the state's peering tables:
        ``(counts, lat_hist, qd_hist, sums, max_rho, writes,
        deg_reads)``.  With a workload mix, object ids are skew-remapped
        and the per-OSD capacity is burst-modulated (the virtual clock
        is a host value, so the burst test is too).  A fleet state
        (``[lanes, ...]`` tables) with a ``[lanes, 1]`` int64 salt-base
        tensor steps every lane at once, each on its own tables and
        salt, each output with a leading lane axis."""
        salt, cap = self._traffic_params(step, now, salt_base)
        return self._traffic_core(state, salt, cap)

    def _traffic_params(self, step: int, now: float, salt_base=None):
        """``(salt, cap)`` of step ``step`` at clock ``now``: the
        TrafficEngine's per-step salt (u32 wraparound; a tensor for a
        tensor salt base) and the per-OSD capacity (float32), which a
        workload mix's burst collapses by ``burst_factor`` for
        ``burst_duty`` of every period."""
        salt_base = self.salt_base if salt_base is None else salt_base
        if not isinstance(salt_base, torch.Tensor):
            salt_base = int(salt_base)
        salt = (salt_base + step * _SALT_STEP) & _M32
        mix = self._mix
        cap = np.float32(self.cap_ops)
        if (mix is not None and mix.burst_factor > 1.0 and mix.burst_period_s > 0.0
                and now % mix.burst_period_s < mix.burst_duty * mix.burst_period_s):
            cap = cap / np.float32(mix.burst_factor)
        return salt, cap

    def _traffic_core(self, state: ClusterState, salt, cap):
        """:meth:`_traffic_apply` given the step's salt and capacity
        (host numbers, or 0-d tensors on the device: the compiled
        superstep's table entries)."""
        from ..workload.histogram import LAT_MIN_MS, N_BUCKETS
        from ..workload.traffic import (
            _osd_index,
            _route,
            _scatter_load,
            _skew_ids,
            _traffic_outcomes,
        )

        mix = self._mix
        ids = self._ids
        if mix is not None and mix.hot_permille > 0:
            ids = _skew_ids(ids, salt, mix.hot_permille, mix.hot_objects)
        pg_bmask = (1 << max(self.pg_num - 1, 1).bit_length()) - 1
        pg, prim, is_write, blocked, degraded, cost = _route(
            state.survivor_mask, state.n_alive, state.acting_primary, ids, salt,
            self.pg_num, pg_bmask, self.k, self.size, self.min_size, self.write_permille)
        n_osds = state.n_osds
        idx, valid = _osd_index(prim, n_osds)
        load = _scatter_load(idx, valid, blocked, cost, n_osds)
        counts, lat_hist, qd_hist, sums, max_rho = _traffic_outcomes(
            idx, is_write, blocked, degraded, load, self.k, np.float32(self.service_ms),
            cap, np.float32(self.rho_recovery), N_BUCKETS, LAT_MIN_MS)
        # the epoch series needs only the committed-write and
        # degraded-read totals, not the per-PG scatters
        ok = ~blocked
        writes = (ok & is_write).sum(-1, dtype=I32)
        deg_reads = (ok & degraded & ~is_write).sum(-1, dtype=I32)
        return counts, lat_hist, qd_hist, sums, max_rho, writes, deg_reads

    def _scrub_due(self, prev_now: float, now: float) -> torch.Tensor:
        """PGs whose staggered scrub window ticked in ``(prev_now,
        now]`` ([1] int32): a full period elapsed -> all; otherwise the
        phase window ``(lo, hi]``, wrapping."""
        if self.scrub_period_s <= 0:
            return self._zero_i32
        in_win = _scrub_window(self._phases, self.scrub_period_s, prev_now, now)
        if in_win is None:
            return torch.full((1,), self.pg_num, dtype=I32, device=self.device)
        return in_win.sum(dtype=I32).reshape(1)

    @staticmethod
    def _row(state: ClusterState, traffic, live, scrub) -> torch.Tensor:
        """The epoch's device lanes as one int32 row (float32 lanes by
        their bits), in :func:`_packed_layout`'s order; a fleet state
        gives one row a lane (``scrub`` is shared: ``[1]``)."""
        counts, lat_hist, qd_hist, sums, max_rho, writes, deg_reads = traffic
        lead = state.pg_hist.shape[:-1]
        return torch.cat([
            state.pg_hist, state.pg_aux, counts, lat_hist, qd_hist, sums.view(I32),
            max_rho.view(I32).unsqueeze(-1), writes.unsqueeze(-1), deg_reads.unsqueeze(-1),
            live, scrub.expand(*lead, 1)], dim=-1)

    # -- one epoch -----------------------------------------------------

    def _epoch_step(self, state: ClusterState, host: _HostView, step: int, *,
                    tape: EventTape | None = None, salt_base: int | None = None,
                    compact: bool = True, traced: bool = False):
        """One epoch of the superstep: ``(state, (dirty, row))``, and
        with ``traced`` the flight recorder's extras ``(step, dirty,
        rung, n_dirty, heavy)`` third: the dirty-set probe of a dirty
        epoch, read only (the compacted branch's own count, or the same
        predicate on the device), so every epoch lane stays as it is."""
        if host.stale:
            raise RuntimeError("the host view is stale after a compiled chunk: rebuild it "
                               "with EpochDriver.host_view(state)")
        prev_now = host.now
        # the pool lanes before this epoch's edits: the compacted dirty
        # branch diffs against them to find the PGs the edits can reach
        prev_up, prev_w = state.pool.osd_up, state.pool.osd_weight
        state, tape_dirty = self._tape_apply(state, host, step, tape)
        state, live, trans = self._live(state, host, host.idle)
        dirty = tape_dirty or trans
        extras = (step, False, -1, 0, False)
        # pg_hist/pg_aux move only when peering moves, so quiet epochs
        # carry them forward
        if dirty:
            if compact and self._dirty_ladder:
                state = self._peer_hist_compact(state, prev_up, prev_w)
                if traced:
                    nd, heavy = self._probe
                    extras = (step, True, ladder_rung(nd, self._dirty_ladder), nd, heavy)
            else:
                if traced:
                    dirty_pg, heavy = self._dirty_pgs(state, prev_up, prev_w)
                    extras = (step, True, 0, dirty_pg.sum(dtype=I64), heavy)
                state = self._peer_hist(state)
        traffic = self._traffic_apply(state, step, host.now, salt_base)
        row = self._row(state, traffic, live, self._scrub_due(prev_now, host.now))
        if traced:
            return state, (dirty, row), extras
        return state, (dirty, row)

    def _flight_row(self, row: torch.Tensor, extras, wrow=None, widths=None,
                    dense: int | None = None) -> torch.Tensor:
        """One int64 lane row for the recorder's ring from the epoch's
        packed row and probe extras (and the write path's stripe lanes
        when it rides the loop).  The cycle proxies are op counts: the
        chosen peering bucket width (the dense width on the top rung),
        the routed ops, the scrub window.  ``widths``/``dense`` name the
        ladder (the fleet's lane ladder; default the PG ladder)."""
        from ..obs.flight import flight_row

        step, dirty, rung, n_dirty, heavy = extras
        widths = self._dirty_ladder if widths is None else widths
        dense = self.pg_num if dense is None else dense
        table = tuple(widths) + (dense,)
        col = _packed_cols()

        def lane(name, i=0):
            return row[..., col[name] + i].to(I64)

        served, degraded, blocked = lane("counts"), lane("counts", 1), lane("counts", 2)
        is_dirty = np.asarray(dirty).any()
        return flight_row(
            device=row.device,
            epoch=step, dirty=np.asarray(dirty, np.int64), rung=rung, dirty_pgs=n_dirty,
            compact=int(rung >= 0 and rung < len(widths) and is_dirty), heavy=heavy,
            served=served, degraded=degraded, blocked=blocked,
            writes=lane("writes"), deg_reads=lane("deg_reads"), eff_down=lane("eff_down"),
            eff_up=lane("eff_up"), eff_out=lane("eff_out"), down_total=lane("down_total"),
            scrub_due=lane("scrub_due"),
            cycles_peer=table[min(max(rung, 0), len(widths))] if is_dirty else 0,
            cycles_traffic=served + degraded + blocked, cycles_scrub=lane("scrub_due"),
            **_stripe_lanes(wrow))

    def _epoch_step_with(self, state: ClusterState, host: _HostView, step: int,
                         tape: EventTape, salt_base: int):
        """The epoch body with the chaos tape and traffic salt as
        arguments and dense peering (the fleet loop's body, one cluster
        at a time)."""
        return self._epoch_step(state, host, step, tape=tape, salt_base=salt_base,
                                compact=False)

    def _with_scalars(self, state: ClusterState, host: _HostView) -> ClusterState:
        """The state with its scalar tensors set from the host's view."""
        dev = self.device

        def full(v, dtype):
            return torch.full((), v, dtype=dtype, device=dev)

        return replace(state, epoch=full(host.epoch, I32), now=full(host.now, F64),
                       last_tick=full(host.last_tick, F64),
                       tape_cursor=full(host.cursor, I32), step=full(host.step, I32))

    def host_view(self, state: ClusterState) -> _HostView:
        """The host view of a state written at a chunk's end (a restored
        snapshot): its scalars, its suppressed and slow bits, and whether
        any OSD is down or laggy (one read).  Exact: ``down`` and
        ``laggy`` move only at a liveness tick, where the host reads the
        same two bits."""
        flags = torch.stack([state.down.any(), (state.laggy != 0).any()]).cpu().tolist()
        return _HostView(
            step=int(state.step), now=float(state.now), last_tick=float(state.last_tick),
            epoch=int(state.epoch), cursor=int(state.tape_cursor),
            suppressed=state.suppressed.cpu().numpy().copy(),
            slow=state.slow.cpu().numpy().copy(), any_down=bool(flags[0]),
            any_laggy=bool(flags[1]))

    def advance(self, state: ClusterState, host: _HostView, start: int, stop: int, fs=None):
        """Epochs ``start .. stop - 1`` from ``state`` and its host view
        (advanced in place); with a flight state ``fs`` the ring records
        each epoch.  Returns ``(state, fs, rows)``: the state with its
        scalars set, the ring, and the epochs' :class:`EpochRows`.  On
        the card the compiled superstep runs them (:meth:`compile_superstep`,
        or its flight twin with ``fs``): the view keeps only the clock
        and cursors then (``host.stale``)."""
        if self.device.type == "cuda":
            prog = self.compile_superstep() if fs is None else self.compile_superstep_flight()
            return prog.advance(state, host, start, stop, fs)
        return self._advance_host(state, host, start, stop, fs)

    def _advance_host(self, state: ClusterState, host: _HostView, start: int, stop: int,
                      fs=None):
        """:meth:`advance` decided on the host, one epoch at a time: the
        tape window a host slice, a busy epoch's one read after the tick,
        the ladder's rung read (the CPU's driver, and the write path's)."""
        now, epoch, dirty, packed = [], [], [], []
        for e in range(start, stop):
            if fs is None:
                # a busy epoch's one read after the tick, and the ladder's rung read
                # torchlint: disable=J003
                state, (d, row) = self._epoch_step(state, host, e)
            else:
                # a busy epoch's one read after the tick, and the ladder's rung read
                # torchlint: disable=J003
                state, (d, row), extras = self._epoch_step(state, host, e, traced=True)
                fs = self._record(fs, row, extras)
            now.append(host.now)
            epoch.append(host.epoch)
            dirty.append(int(d))
            packed.append(row)
        if not packed:
            return self._with_scalars(state, host), fs, self._empty_rows()
        rows = EpochRows(np.asarray(now, np.float64), np.asarray(epoch, np.int32),
                         np.asarray(dirty, np.int32), torch.stack(packed))
        return self._with_scalars(state, host), fs, rows

    def _record(self, fs, row, extras, wrow=None):
        from ..obs.flight import flight_record

        return flight_record(fs, self._flight_row(row, extras, wrow))

    def compile_superstep(self) -> "SuperstepProgram":
        """The ONE program of a chunk of epochs (:class:`SuperstepProgram`,
        built once a driver): on the card one CUDA graph, captured on its
        first chunk and replayed for every later one."""
        if self._programs.get(False) is None:
            self._programs[False] = SuperstepProgram(self, flight=False)
        return self._programs[False]

    def compile_superstep_flight(self) -> "SuperstepProgram":
        """The recorder-carrying twin of :meth:`compile_superstep`: the
        ring rides the chunk and each epoch writes its row in place."""
        if not self.flight_on:
            raise RuntimeError("flight recorder is off for this driver (flight_recorder=on "
                               "enables it)")
        if self._programs.get(True) is None:
            self._programs[True] = SuperstepProgram(self, flight=True)
        return self._programs[True]

    def compile_tape_program(self) -> "TapeProgram":
        """The one-cluster program whose tape and traffic salt are device
        inputs (:class:`TapeProgram`, built once a driver): the fleet's
        sequential baseline and the divergent ranks' epochs on the card."""
        if self._programs.get("tape") is None:
            self._programs["tape"] = TapeProgram(self)
        return self._programs["tape"]

    def drain_flight(self) -> dict:
        """The recorder's ring brought to the host and un-rotated (a pure
        read)."""
        from ..obs.flight import drain_flight

        if self.flight is None:
            raise RuntimeError(
                "flight recorder is off for this driver (flight_recorder=on "
                "enables it)")
        return drain_flight(self.flight)

    # -- the compiled superstep's step tables --------------------------

    def step_tables(self, n_steps: int, tape: EventTape | None = None,
                    salt_base: int | None = None) -> dict[str, np.ndarray]:
        """What each of steps ``0 .. n_steps - 1`` knows before it runs,
        from the step, the tape (the driver's, or ``tape``) and the
        static config alone, each value computed as the host driver
        computes it: the clock (``now``, float64, and ``now32``,
        float32), the tape window's stop, its epoch bumps and whether it
        holds a map row (the window starts where the last one stopped),
        the traffic salt (of ``salt_base``, the driver's by default) and
        capacity (:meth:`_traffic_params`) and the scrub count
        (:meth:`_scrub_due`, from the previous step's clock)."""
        tape = self.tape if tape is None else tape
        n = int(n_steps)
        now = np.array([self._now_of(s) for s in range(n)], np.float64)
        stop = np.searchsorted(tape.t, now, side="right").astype(np.int64)
        lo = np.concatenate([[0], stop[:-1]]).astype(np.int64)
        bumps = np.concatenate([[0], np.cumsum(tape.bump, dtype=np.int64)])
        maps = np.concatenate([[0], np.cumsum(np.isin(tape.kind, _MAP_KINDS), dtype=np.int64)])
        params = [self._traffic_params(s, float(now[s]), salt_base) for s in range(n)]
        scrub = np.zeros(n, np.int32)
        if self.scrub_period_s > 0:
            phases = scrub_phases(self.pg_num, self.scrub_period_s)
            for s in range(n):
                in_win = _scrub_window(phases, self.scrub_period_s, self._now_of(s - 1),
                                       float(now[s]))
                scrub[s] = self.pg_num if in_win is None else int(in_win.sum())
        return {
            "now": now,
            "now32": now.astype(np.float32),
            "stop": stop.astype(np.int32),
            "bump": (bumps[stop] - bumps[lo]).astype(np.int32),
            "map": (maps[stop] - maps[lo]) > 0,
            "salt": np.array([int(salt) for salt, _cap in params], np.int64),
            "cap": np.array([cap for _salt, cap in params], np.float32),
            "scrub": scrub,
        }

    def _tables(self, n_steps: int) -> tuple[dict, dict]:
        """The step tables covering ``n_steps`` (host arrays, tensors on
        the device), made once for a power-of-two bucket of steps and
        kept: a later run as long reads them without a copy."""
        have = 0 if self._tables_host is None else len(self._tables_host["now"])
        if have < n_steps:
            n = 1 << max(int(n_steps) - 1, 63).bit_length()
            self._tables_host = self.step_tables(n)
            self._tables_dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                                for k, v in self._tables_host.items()}
        return self._tables_host, self._tables_dev

    # -- drivers -------------------------------------------------------

    def _empty_rows(self) -> EpochRows:
        width = sum(w for _f, w, _d in _packed_layout())
        return EpochRows(np.zeros(0, np.float64), np.zeros(0, np.int32),
                         np.zeros(0, np.int32),
                         torch.zeros((0, width), dtype=I32, device=self.device))

    def run_superstep(
        self, n_epochs: int, *, snapshot_every: int = 0, on_snapshot=None,
        pull: bool = True, journal=None,
    ):
        """Drive the epoch loop in chunks of ``snapshot_every`` epochs
        (0: one chunk), the rows kept on the device and pulled once a
        chunk.  ``on_snapshot(start_epoch, series_chunk)`` sees each
        pulled chunk (the journaling seam), with :attr:`final_state`
        already the state after it.  With ``pull=False`` and no
        snapshots, returns ``(state, rows)``: the last chunk's
        :class:`EpochRows` still on the device.  On the card a chunk is
        one replay of the compiled superstep's graph, which reads
        nothing back (:meth:`advance`); on the CPU a quiet epoch reads
        the device at most once (the dirty decision).  With the flight
        recorder on, the ring rides the loop (:attr:`flight` afterwards)
        and, given a ``journal``, drains a ``flight.drain`` record at
        every chunk's end."""
        return self._run_chunks(self.advance, self._init_flight, n_epochs,
                                snapshot_every=snapshot_every, on_snapshot=on_snapshot,
                                pull=pull, journal=journal)

    def _run_chunks(self, advance, fs, n_epochs: int, *, snapshot_every: int = 0,
                    on_snapshot=None, pull: bool = True, journal=None):
        """:meth:`run_superstep` over ``advance`` from the initial state
        and the ring ``fs``."""
        from ..obs.flight import journal_drain

        state = self._init_state
        host = self._init_host.copy()
        self.flight = fs
        self.rungs_taken = []
        n_epochs = int(n_epochs)
        if n_epochs <= 0:
            self.final_state = state
            rows = self._empty_rows()
            if not pull and on_snapshot is None:
                return state, rows
            return EpochSeries.from_device(rows)
        chunk = int(snapshot_every) or n_epochs
        parts: list[EpochSeries] = []
        rows = None
        start = 0
        while start < n_epochs:
            size = min(chunk, n_epochs - start)
            state, fs, rows = advance(state, host, start, start + size, fs)
            self.final_state, self.flight = state, fs
            if rows.lanes is not None:
                self._rung_rows.append(rows)
            if fs is not None and journal is not None:
                journal_drain(journal, fs, chunk_start=start)
            if pull or on_snapshot is not None:
                part = EpochSeries.from_device(rows)
                parts.append(part)
                if on_snapshot is not None:
                    on_snapshot(start, part)
            start += size
        if not pull and on_snapshot is None:
            return state, rows
        return EpochSeries.concat(parts)

    def run_staged(self, n_epochs: int, *, snapshot_every: int = 0, on_snapshot=None):
        """The differential reference: the same pieces, one stage at a
        time, with the reference's per-epoch host round trips: the idle
        test read from the device, the liveness lanes copied back after
        the tick, the dirty decision, dense peering on a dirty epoch and
        one host row an epoch."""
        state = self._init_state
        host = self._init_host.copy()
        n_epochs = int(n_epochs)
        if n_epochs <= 0:
            self.final_state = state
            return EpochSeries.from_device(self._empty_rows())
        rows: list[tuple] = []
        parts: list[EpochSeries] = []
        flushed = 0

        def series(chunk) -> EpochSeries:
            now, epoch, dirty, packed = zip(*chunk)
            return EpochSeries.from_rows(now, epoch, dirty, np.stack(packed))

        def flush(upto):
            nonlocal flushed
            if on_snapshot is not None and rows[flushed:upto]:
                part = series(rows[flushed:upto])
                parts.append(part)
                on_snapshot(flushed, part)
                flushed = upto

        for e in range(n_epochs):
            prev_now = host.now
            state, tape_dirty = self._tape_apply(state, host, e)
            # torchlint: disable=J003  # the staged reference path reads its idle test every epoch
            idle = not bool(torch.stack([
                state.suppressed.any(), state.slow.any(), state.down.any(),
                (state.laggy != 0).any()]).any())
            # torchlint: disable=J003  # the staged reference path reads its tick every epoch
            state, live, trans = self._live(state, host, idle)
            # the host detector's per-tick mirror of the heartbeat lanes
            for lane in (state.last_ack, state.laggy, state.markdowns, state.down,
                         state.down_since, state.out):
                # the staged path mirrors the host detector: a lane read a tick
                # torchlint: disable=J003
                lane.cpu()
            dirty = tape_dirty or trans
            if dirty:
                state = self._peer_hist(state)
            traffic = self._traffic_apply(state, e, host.now)
            row = self._row(state, traffic, live, self._scrub_due(prev_now, host.now))
            # torchlint: disable=J003  # the staged reference path reads each epoch's row
            rows.append((host.now, host.epoch, int(dirty), row.cpu().numpy()))
            if snapshot_every and (e + 1) % snapshot_every == 0:
                self.final_state = self._with_scalars(state, host)
                flush(e + 1)
        self.final_state = self._with_scalars(state, host)
        flush(len(rows))
        if parts and flushed == len(rows):
            return EpochSeries.concat(parts)
        return series(rows)

    def run(self, n_epochs: int, *, snapshot_every: int = 0, on_snapshot=None):
        """Switch dispatch (:func:`epoch_superstep_enabled`)."""
        if epoch_superstep_enabled():
            return self.run_superstep(n_epochs, snapshot_every=snapshot_every,
                                      on_snapshot=on_snapshot)
        return self.run_staged(n_epochs, snapshot_every=snapshot_every,
                               on_snapshot=on_snapshot)


# ---------------------------------------------------------------------------
# the compiled superstep


def _get(obj, name: str):
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _state_names(state: ClusterState) -> list[str]:
    """Every tensor of a state, by dotted name (the pool's first)."""
    names = ["pool." + f.name for f in fields(state.pool)]
    return names + [f.name for f in fields(state)
                    if f.name != "pool" and getattr(state, f.name) is not None]


def _clone_state(state: ClusterState) -> ClusterState:
    pool = replace(state.pool, **{f.name: getattr(state.pool, f.name).clone()
                                  for f in fields(state.pool)})
    return replace(state, pool=pool, **{
        f.name: getattr(state, f.name).clone() for f in fields(state)
        if f.name != "pool" and getattr(state, f.name) is not None})


def _assign(dst: ClusterState, src: ClusterState, names) -> None:
    """Copy ``src``'s tensors ``names`` into ``dst``'s, in place."""
    for name in names:
        d, s = _get(dst, name), _get(src, name)
        if d is not s:
            d.copy_(s)


#: the tensors the liveness tick and the dirty branch write
_TICK_NAMES = ("pool.osd_up", "pool.osd_weight", "last_ack", "laggy", "markdowns", "down",
               "down_since", "out")
_PEER_NAMES = ("up", "up_primary", "acting", "acting_primary", "flags", "survivor_mask",
               "n_alive", "pg_hist", "pg_aux")


def _tape_lanes(state: ClusterState) -> dict:
    """The six lanes the tape's edits write, by :data:`_LANE_EDITS`' keys."""
    return {"up": state.pool.osd_up, "w": state.pool.osd_weight, "ack": state.last_ack,
            "sup": state.suppressed, "slow": state.slow, "out": state.out}


class _Carry:
    """The buffers a compiled chunk reads and writes in place: the state
    and the recorder's ring, the rows ``[capacity, width +
    len(_ROW_LANES)]``, the step tables' window ``[capacity]`` (entry
    ``j`` is step ``start + j``), the step counter and its bounds, and
    the epoch's decisions (whether the tick moved the map, dirty, the
    rung, the flight probe) with the tick's liveness lanes."""

    def __init__(self, driver: EpochDriver, state: ClusterState, fs, capacity: int):
        from ..obs.flight import FlightState

        dev = driver.device
        self.capacity = int(capacity)
        self.st = _clone_state(state)
        self.fs = None if fs is None else FlightState(ring=fs.ring.clone(), head=fs.head.clone())
        self.width = sum(w for _f, w, _d in _packed_layout())
        self.rows = torch.zeros((self.capacity, self.width + len(_ROW_LANES)), dtype=I32,
                                device=dev)
        _host, tables = driver._tables(1)
        self.tab = {k: torch.zeros(self.capacity, dtype=v.dtype, device=dev)
                    for k, v in tables.items()}

        def zero(dtype):
            return torch.zeros((), dtype=dtype, device=dev)

        self.start, self.stop, self.step = zero(I64), zero(I64), zero(I64)
        self.live = torch.zeros(5, dtype=I32, device=dev)
        self.trans, self.dirty, self.heavy = zero(torch.bool), zero(torch.bool), zero(torch.bool)
        self.rung, self.frung, self.nd = zero(I32), zero(I32), zero(I64)
        self.prev_up = self.st.pool.osd_up.clone()
        self.prev_w = self.st.pool.osd_weight.clone()

    @property
    def anyd(self) -> torch.Tensor:
        """Whether any lane is dirty (the one lane's dirty bit)."""
        return self.dirty

    def load(self, state: ClusterState, fs) -> None:
        """Copy a chunk's starting state (and ring) in."""
        for name in _state_names(self.st):
            _get(self.st, name).copy_(_get(state, name))
        if self.fs is not None:
            self.fs.ring.copy_(fs.ring)
            self.fs.head.copy_(fs.head)

    def window(self, tables: dict, start: int, stop: int) -> None:
        """Steps ``start .. stop - 1``: their table entries and bounds."""
        for k, t in self.tab.items():
            t[:stop - start].copy_(tables[k][start:stop])
        self.start.fill_(start)
        self.stop.fill_(stop)

    def follow(self, other: "_Carry") -> None:
        """Take ``other``'s window and bounds (a scratch copy's inputs)."""
        for k, t in self.tab.items():
            t.copy_(other.tab[k])
        for t, src in ((self.start, other.start), (self.stop, other.stop),
                       (self.step, other.start)):
            t.copy_(src)

    def take(self, n: int) -> tuple:
        """The first ``n`` steps' output rows, copies of their own."""
        return (self.rows[:n].clone(),)

    def state(self) -> ClusterState:
        return _clone_state(self.st)

    def flight(self):
        from ..obs.flight import FlightState

        if self.fs is None:
            return None
        return FlightState(ring=self.fs.ring.clone(), head=self.fs.head.clone())


class _GraphProgram:
    """What every compiled window shares: the graph captured over a
    carry's buffers (a WHILE node over its steps from :meth:`_begin`,
    after :meth:`_warm` ran the body and its branches once eagerly), its
    replays, and the flight recorder's ring row from the epoch's row and
    the carry's device probe.  A subclass gives the carry (``st``,
    ``fs``, ``start``/``stop``/``step``, ``dirty``, ``anyd``, ``frung``,
    ``nd``, ``heavy``), :meth:`_step`, :meth:`_tick`, :meth:`_at`,
    :meth:`_scratch` and :meth:`_warm_branches`, and sets ``_ladder``
    and ``_peer_widths`` (the ladder the ring's rung and peer-cycle
    lanes name)."""

    def __init__(self, driver: "EpochDriver", *, flight: bool):
        self.driver = driver
        self.flight = bool(flight)
        self.graph = None  # graphs.Graph, on the card
        self.captures = 0
        self.replays = 0
        self._ladder: tuple = ()
        self._peer_widths: torch.Tensor | None = None

    @property
    def compiled(self) -> bool:
        """Whether a window is a graph replay (on the card)."""
        return self.driver.device.type == "cuda"

    def _replay(self, c) -> None:
        from ..core import graphs

        if self.graph is None:
            self._warm(c)

            def window():
                self._begin(c)
                with graphs.while_node(lambda: c.step < c.stop):
                    self._step(c)
                    c.step.add_(1)

            self.graph = graphs.capture(window, self.driver.device)
            self.captures += 1
        self.graph.replay()
        self.replays += 1

    def _begin(self, c) -> None:
        """The window's first step (a subclass resets its own counters)."""
        c.step.copy_(c.start)

    def _warm(self, c) -> None:
        """Run the body and every branch of it once, eagerly, on a copy
        of ``c``: the kernels built, their tables uploaded and their
        launch settings read at every width the graph launches them."""
        w = self._scratch(c)
        self._begin(w)
        self._step(w)
        self._warm_branches(w)
        torch.cuda.synchronize(self.driver.device)

    def _warm_edits(self, w, idx: torch.Tensor) -> None:
        """Every tape edit once on ``w``'s lanes at the flat ``idx``."""
        now32 = self._at(w, "now32")
        lanes = {k: v.view(-1) for k, v in _tape_lanes(w.st).items()}
        for edit in _LANE_EDITS:
            edit(lanes, idx, now32, w.st.pool.osd_exists.view(-1))

    def _record(self, c, row: torch.Tensor, wrow=None) -> None:
        if c.fs is not None:
            from ..obs.flight import flight_record_

            flight_record_(c.fs, self._flight_row(c, row, wrow))

    def _flight_row(self, c, row: torch.Tensor, wrow=None) -> torch.Tensor:
        """:meth:`EpochDriver._flight_row` from the device's probe (and
        the write path's stripe lanes from its row ``wrow``); a fleet's
        rows carry a leading lane axis."""
        from ..obs.flight import flight_row

        n_rungs = len(self._ladder)
        col = _packed_cols()

        def lane(name, i=0):
            return row[..., col[name] + i].to(I64)

        served, degraded, blocked = lane("counts"), lane("counts", 1), lane("counts", 2)
        rung = c.frung
        peer = self._peer_widths.index_select(0, rung.clamp(0, n_rungs).to(I64).reshape(1))
        return flight_row(
            device=row.device, epoch=c.step, dirty=c.dirty, rung=rung, dirty_pgs=c.nd,
            compact=c.anyd & (rung >= 0) & (rung < n_rungs), heavy=c.heavy,
            served=served, degraded=degraded, blocked=blocked, writes=lane("writes"),
            deg_reads=lane("deg_reads"), eff_down=lane("eff_down"), eff_up=lane("eff_up"),
            eff_out=lane("eff_out"), down_total=lane("down_total"),
            scrub_due=lane("scrub_due"),
            cycles_peer=torch.where(c.anyd, peer.reshape(()), 0),
            cycles_traffic=served + degraded + blocked, cycles_scrub=lane("scrub_due"),
            **_stripe_lanes(wrow))


class SuperstepProgram(_GraphProgram):
    """The compiled superstep of one :class:`EpochDriver`: a chunk of
    epochs as one program, every decision of the epoch body made on the
    device (:meth:`EpochDriver.compile_superstep`, and
    :meth:`EpochDriver.compile_superstep_flight` with the recorder's ring
    riding it).

    - On the card it is one CUDA graph (:mod:`ceph_tpu_torch.core.graphs`),
      captured on the first chunk and replayed for every later one: a
      WHILE node over the chunk's steps, whose body is the epoch body
      with the tape window a WHILE node over its rows (each row's edit a
      SWITCH node on its kind), the liveness tick an IF node on the
      device's idle test, the dirty branch an IF node holding a SWITCH on
      the compaction ladder's rung (the dense branch its top body).  A
      chunk copies its bounds and its window of the step tables
      (:meth:`EpochDriver.step_tables`) into the graph's buffers, replays,
      and copies the rows, state and ring out: no wrapper call and no
      read.  A chunk longer than the graph's buffers runs as several
      replays.
    - On the CPU the same body runs eagerly, each decision one host read
      of its predicate (:func:`~ceph_tpu_torch.core.graphs.cond`,
      :func:`~ceph_tpu_torch.core.graphs.switch`,
      :func:`~ceph_tpu_torch.core.graphs.loop`).

    ``program(n_epochs, **kw)`` runs as :meth:`EpochDriver.run_superstep`;
    :meth:`advance` is :meth:`EpochDriver.advance`'s compiled form."""

    def __init__(self, driver: EpochDriver, *, flight: bool):
        super().__init__(driver, flight=flight)
        dev = driver.device
        self._carry: _Carry | None = None
        self._kind = torch.from_numpy(np.ascontiguousarray(driver.tape.kind)).to(dev)
        self._osd = torch.from_numpy(driver.tape.osd.astype(np.int64)).to(dev)
        #: the dirty branch's compaction ladder (none: dense peering only)
        self._ladder = tuple(driver._dirty_ladder)
        widths = self._ladder + (driver.pg_num,)
        self._peer_widths = torch.tensor(widths, dtype=I64).to(dev)

    def __call__(self, n_epochs: int, **kw):
        d = self.driver
        return d._run_chunks(self.advance, d._init_flight if self.flight else None, n_epochs,
                             **kw)

    def run_eager(self, n_epochs: int, **kw):
        """The same body run eagerly on the driver's device, each decision
        read to the host: what the graph is held against on the card."""
        d = self.driver
        return d._run_chunks(functools.partial(self._advance, compiled=False),
                             d._init_flight if self.flight else None, n_epochs, **kw)

    def advance(self, state: ClusterState, host: _HostView, start: int, stop: int, fs=None):
        """Epochs ``start .. stop - 1`` from ``state``: ``(state, fs,
        rows)`` as :meth:`EpochDriver.advance` returns them, the rows'
        host lanes on the device.  ``host`` keeps the clock and cursors
        (the tables'), the rest of it stale."""
        return self._advance(state, host, start, stop, fs, compiled=self.compiled)

    def _advance(self, state, host, start, stop, fs=None, *, compiled: bool):
        start, stop = int(start), int(stop)
        fs = fs if self.flight else None
        if stop <= start:
            return state, fs, self.driver._empty_rows()
        c = self._carry_for(state, fs, stop - start)
        (lanes,) = self._run(c, host, start, stop, compiled)
        return c.state(), c.flight(), self._rows(c, lanes)

    def _run(self, c: _Carry, host: _HostView, start: int, stop: int, compiled: bool) -> list:
        """Steps ``start .. stop - 1`` through the carry, a window of its
        capacity at a time: each output's rows (:meth:`_Carry.take`), the
        host view's clock and cursor moved to ``stop``."""
        tables_host, tables = self._tables(stop)
        parts = []
        for lo in range(start, stop, c.capacity):
            hi = min(stop, lo + c.capacity)
            c.window(tables, lo, hi)
            if compiled:
                # torchlint: disable=J003  # a replay reads nothing (the first's warm-up reads)
                self._replay(c)
            else:
                for step in range(lo, hi):
                    c.step.fill_(step)
                    self._step(c)
            parts.append(c.take(hi - lo))
        host.step, host.now = stop - 1, float(tables_host["now"][stop - 1])
        host.cursor, host.stale = int(tables_host["stop"][stop - 1]), True
        return [p[0] if len(parts) == 1 else torch.cat(p) for p in zip(*parts)]

    def _tables(self, n_steps: int) -> tuple[dict, dict]:
        """The step tables covering ``n_steps`` (the driver's)."""
        return self.driver._tables(n_steps)

    @staticmethod
    def _rows(c: _Carry, lanes: torch.Tensor) -> EpochRows:
        return EpochRows(None, None, None, lanes[:, :c.width], lanes)

    def _new_carry(self, state, fs, capacity: int) -> _Carry:
        """The buffers of a chunk (a subclass's carry adds its own)."""
        return _Carry(self.driver, state, fs, capacity)

    def _carry_for(self, state, fs, n: int) -> _Carry:
        c = self._carry
        if c is None or (not self.compiled and c.capacity < n):
            # the graph's buffers: a power-of-two bucket of the first chunk
            cap = 1 << max(n - 1, 15).bit_length() if self.compiled else n
            c = self._carry = self._new_carry(state, fs, cap)
        c.load(state, fs)
        return c

    # -- the graph -------------------------------------------------------

    def _scratch(self, c: _Carry) -> _Carry:
        """A carry of its own with ``c``'s inputs (the warm-up's)."""
        w = self._new_carry(c.st, c.fs, c.capacity)
        w.follow(c)
        return w

    def _at(self, c: _Carry, name: str) -> torch.Tensor:
        """The step table ``name``'s entry ``[1]`` for ``c.step``."""
        return c.tab[name].index_select(0, (c.step - c.start).reshape(1))

    def _warm_branches(self, w: _Carry) -> None:
        """Every branch the body may take: each tape edit, the tick, each
        compaction rung, the dense peering and the dirty branch."""
        from ..core.cluster_state import compact_dirty_indices as compact

        d = self.driver
        self._warm_edits(w, torch.zeros(1, dtype=I64, device=d.device))
        self._tick(w, self._at(w, "now"), self._at(w, "now32"))
        take, n_dirty = compact(torch.ones(d.pg_num, dtype=torch.bool, device=d.device))
        for width in self._ladder:
            self._compact(w, take, n_dirty, width)
        self._dense(w)
        self._dirty(w)

    # -- the epoch body, its decisions on the device ---------------------

    def _step(self, c: _Carry) -> None:
        """Step ``c.step`` of the epoch loop, in place: the reference's
        fused epoch body."""
        from ..core import graphs

        d, st = self.driver, c.st
        j = (c.step - c.start).reshape(1)

        def at(name):
            return c.tab[name].index_select(0, j)

        now, now32 = at("now"), at("now32")
        c.prev_up.copy_(st.pool.osd_up)
        c.prev_w.copy_(st.pool.osd_weight)
        if self._kind.numel():
            # the tape window: its rows from the device cursor, in order
            stop = at("stop")
            lanes, exists = _tape_lanes(st), st.pool.osd_exists

            def row():
                i = st.tape_cursor.to(I64).reshape(1)
                osd = self._osd.index_select(0, i)
                graphs.switch(self._kind.index_select(0, i),
                              [functools.partial(edit, lanes, osd, now32, exists)
                               for edit in _LANE_EDITS])
                st.tape_cursor.add_(1)

            graphs.loop(lambda: (st.tape_cursor < stop).reshape(()), row)
        st.epoch.add_(at("bump").reshape(()))
        # the liveness tick, skipped when idle (last_tick then stays)
        idle = ~(st.suppressed.any() | st.slow.any() | st.down.any() | (st.laggy != 0).any())
        c.live.zero_()
        c.trans.zero_()
        graphs.cond(~idle, lambda: self._tick(c, now, now32))
        c.dirty.copy_(at("map").reshape(()) | c.trans)
        c.rung.fill_(NO_RUNG)
        c.frung.fill_(-1)
        c.nd.zero_()
        c.heavy.zero_()
        graphs.cond(c.dirty, lambda: self._dirty(c))
        traffic = d._traffic_core(st, at("salt").reshape(()), at("cap").reshape(()))
        row = d._row(st, traffic, c.live, at("scrub"))
        meta = torch.cat([st.epoch.reshape(1), c.dirty.to(I32).reshape(1), c.rung.reshape(1),
                          now.view(I32)])
        c.rows.index_copy_(0, j, torch.cat([row, meta]).unsqueeze(0))
        st.now.copy_(now.reshape(()))
        st.step.copy_(c.step)
        self._epoch_end(c, row)

    def _epoch_end(self, c: _Carry, row: torch.Tensor) -> None:
        """What follows the epoch's row: the ring row, with the recorder
        on (a subclass runs its own stage first and records after it)."""
        self._record(c, row)

    def _tick(self, c: _Carry, now, now32) -> None:
        d, st = self.driver, c.st
        hl = torch.full((), max(d.laggy_halflife, 1e-9), dtype=F64, device=now.device)
        decay = torch.pow(0.5, (now - st.last_tick).clamp_min(0.0) / hl).to(F32).reshape(())
        new, live, flags = d._tick(st, now32.reshape(()), decay)
        _assign(st, new, _TICK_NAMES)
        c.live.copy_(live)
        c.trans.copy_(flags[0])
        st.epoch.add_(flags[0].to(I32))
        st.last_tick.copy_(now.reshape(()))

    def _dirty(self, c: _Carry) -> None:
        """The dirty branch: through the ladder's rung on the device, or
        dense."""
        from ..core import graphs
        from ..core.cluster_state import compact_dirty_indices, ladder_rung_device

        d, st = self.driver, c.st
        widths = self._ladder
        if not widths:
            if c.fs is not None:
                dirty_pg, heavy = d._dirty_pgs(st, c.prev_up, c.prev_w)
                c.frung.zero_()
                c.nd.copy_(dirty_pg.sum(dtype=I64))
                c.heavy.copy_(heavy)
            self._dense(c)
            return
        dirty_pg, heavy = d._dirty_pgs(st, c.prev_up, c.prev_w)
        take, n_dirty = compact_dirty_indices(dirty_pg)
        rung = ladder_rung_device(n_dirty, widths)
        c.frung.copy_(rung)
        c.nd.copy_(n_dirty)
        c.heavy.copy_(heavy)
        # nothing to re-peer: no body (every lane a pad would add 0)
        taken = torch.where(n_dirty == 0, -1, rung)
        c.rung.copy_(taken)
        graphs.switch(taken, [functools.partial(self._compact, c, take, n_dirty, w)
                              for w in widths] + [functools.partial(self._dense, c)])

    def _compact(self, c: _Carry, take, n_dirty, width: int) -> None:
        _assign(c.st, self.driver._compact_branch(c.st, take, n_dirty, width), _PEER_NAMES)

    def _dense(self, c: _Carry) -> None:
        _assign(c.st, self.driver._peer_hist(c.st), _PEER_NAMES)


class TapeProgram(SuperstepProgram):
    """The one-cluster program with the chaos tape and the traffic salt
    as device inputs (the reference's ``FleetDriver._seq_scan_fn`` and
    the divergent ranks' ``_scan_fn``: a scan of ``_epoch_step_with``):
    :class:`SuperstepProgram`'s body with dense peering and no
    compaction ladder, as :meth:`EpochDriver._epoch_step_with` runs it.

    The tape's kind and OSD columns live in buffers of a power-of-two
    row bucket (rows past the tape are never reached: a window stops at
    ``searchsorted`` over the tape's own times), and the step tables
    (:meth:`EpochDriver.step_tables`) are computed from the loaded
    ``(tape, salt_base)``.  :meth:`load` copies both in with no sync, so
    a tape in the same bucket replays the same graph; a longer one
    captures anew.  Run it as :meth:`SuperstepProgram.advance` after a
    :meth:`load` (the host view keeps only the clock and cursor:
    ``host.stale``)."""

    #: loaded tapes whose device step tables are kept
    KEEP_TABLES = 64

    def __init__(self, driver: EpochDriver):
        super().__init__(driver, flight=False)
        self._ladder = ()
        self._kind = self._osd = None
        self._tape: EventTape | None = None
        self._salt = 0
        self._tabs: dict = {}  # (id(tape), salt) -> (tape, host tables, device tables)

    @property
    def rows_pad(self) -> int:
        """The tape buffers' row bucket (0 before the first load)."""
        return 0 if self._kind is None else int(self._kind.numel())

    def load(self, tape: EventTape, salt_base: int) -> None:
        """Make ``tape`` and ``salt_base`` the program's inputs: the
        tape's columns copied into the buffers (new buffers, and a new
        capture, when it outgrows their bucket)."""
        from ..core.cluster_state import _pad_to

        dev = self.driver.device
        rows = _pad_to(max(len(tape), 1))
        if rows > self.rows_pad:
            if self.graph is not None:
                self.graph.release()
                self.graph = None
            self._kind = torch.zeros(rows, dtype=I32, device=dev)
            self._osd = torch.zeros(rows, dtype=I64, device=dev)
        n = len(tape)
        if n:
            upload(self._kind[:n], tape.kind.astype(np.int32))
            upload(self._osd[:n], tape.osd.astype(np.int64))
        self._tape, self._salt = tape, int(salt_base)

    def _tables(self, n_steps: int) -> tuple[dict, dict]:
        """The loaded tape's step tables covering ``n_steps``, made once
        for a power-of-two bucket of steps and kept for the last
        :data:`KEEP_TABLES` tapes loaded."""
        if self._tape is None:
            raise RuntimeError("TapeProgram.load(tape, salt_base) first")
        key = (id(self._tape), self._salt)
        hit = self._tabs.pop(key, None)
        if hit is None or hit[0] is not self._tape or len(hit[1]["now"]) < n_steps:
            n = 1 << max(int(n_steps) - 1, 63).bit_length()
            host = self.driver.step_tables(n, tape=self._tape, salt_base=self._salt)
            hit = (self._tape, host, {k: uploaded(v, self.driver.device)
                                      for k, v in host.items()})
        self._tabs[key] = hit
        while len(self._tabs) > self.KEEP_TABLES:
            self._tabs.pop(next(iter(self._tabs)))
        return hit[1], hit[2]


#: how a caller runs a compiled window: its graph (the card's default),
#: its body eagerly (each decision one read), or the host-decided loop
#: (the CPU's default)
PATHS = ("graph", "eager", "host")


def pick_path(device, path: str | None) -> str:
    """``path`` checked against :data:`PATHS` (``"graph"`` only on the
    card), or the device's default."""
    on_card = torch.device(device).type == "cuda"
    if path is None:
        return "graph" if on_card else "host"
    if path not in PATHS or (path == "graph" and not on_card):
        raise ValueError(f"no path {path!r} on {torch.device(device).type} "
                         f"(one of {PATHS}; 'graph' on the card)")
    return path


def upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """Copy the host array ``src`` into ``dst`` without a sync: on the
    card a non-blocking copy from pinned memory (a graph's inputs,
    copied in between replays)."""
    t = torch.from_numpy(np.ascontiguousarray(src))
    if dst.is_cuda:
        dst.copy_(t.pin_memory(), non_blocking=True)
    else:
        dst.copy_(t)


def uploaded(src: np.ndarray, dev) -> torch.Tensor:
    """The host array ``src`` as a new tensor on ``dev``, copied as
    :func:`upload` copies."""
    t = torch.from_numpy(np.ascontiguousarray(src))
    if torch.device(dev).type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _stripe_lanes(wrow) -> dict:
    """The ring's stripe lanes from the write path's row (none without
    one)."""
    if wrow is None:
        return {}
    from ..ec.online import WP_LANES

    return {f"stripe_{n}": wrow[..., WP_LANES.index(n)]
            for n in ("hits", "misses", "evictions", "delta_words")}


def _scrub_window(phases, period: float, prev_now: float, now: float):
    """The PGs (a mask of ``phases``: a tensor or a numpy array of
    float64 offsets) whose scrub window ticked in ``(prev_now, now]``,
    or None when a whole period elapsed (every PG)."""
    if now - prev_now >= period:
        return None
    lo, hi = prev_now % period, now % period
    return ((phases > lo) & (phases <= hi)) if lo <= hi else ((phases > lo) | (phases <= hi))


def _down_checksum(down: torch.Tensor) -> torch.Tensor:
    """Order-free integer fingerprint of the down set (sum of id+1),
    along the last axis."""
    n = down.shape[-1]
    ids = torch.arange(1, n + 1, dtype=I32, device=down.device)
    return torch.where(down, ids, 0).sum(-1, dtype=I32)


def _peer_counts(acting: np.ndarray, n_osds: int) -> np.ndarray:
    """Distinct co-serving peers per OSD from an acting table: the
    failure-reporter pool (an OSD nobody peers with can never collect
    enough down reports)."""
    adj = np.zeros((n_osds, n_osds), bool)
    for row in np.asarray(acting):
        osds = [int(o) for o in row if o != ITEM_NONE and 0 <= o < n_osds]
        for a in osds:
            for b in osds:
                adj[a, b] = True
    np.fill_diagonal(adj, False)
    return adj.sum(axis=1).astype(np.int32)


def build_epoch_driver(m: OSDMap, timeline: ChaosTimeline, **kwargs) -> EpochDriver:
    """Convenience constructor (the CLI and chip_smoke surface)."""
    return EpochDriver(m, timeline, **kwargs)


def compile_epoch_superstep(driver: EpochDriver) -> "SuperstepProgram":
    """The compiled superstep of a built driver, the recorder-carrying
    one when its flight recorder is on: ``run(n_epochs, **kw)`` as
    :meth:`EpochDriver.run_superstep` takes them."""
    if driver.flight_on:
        return driver.compile_superstep_flight()
    return driver.compile_superstep()


def run_epochs(
    m_or_driver,
    timeline: ChaosTimeline | None = None,
    n_epochs: int = 0,
    *,
    snapshot_every: int = 0,
    on_snapshot=None,
    **kwargs,
) -> EpochSeries:
    """Run an epoch loop end to end.  Accepts a built
    :class:`EpochDriver` or ``(OSDMap, ChaosTimeline)`` plus driver
    kwargs (``device=`` among them); dispatches superstep or staged on
    ``CEPH_TPU_EPOCH_SUPERSTEP``."""
    if isinstance(m_or_driver, EpochDriver):
        driver = m_or_driver
    else:
        if timeline is None:
            raise ValueError("run_epochs(m, timeline, n_epochs, ...)")
        driver = EpochDriver(m_or_driver, timeline, **kwargs)
    return driver.run(n_epochs, snapshot_every=snapshot_every, on_snapshot=on_snapshot)
