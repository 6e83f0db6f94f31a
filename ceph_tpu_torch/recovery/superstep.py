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
become NET/SLOW rows, ``bitrot:`` specs are only counted.  The tape
stays on the host: an epoch's window ``(cursor, searchsorted(t, now)]``
is known there without a read from the device, and its rows apply in
order as one small device edit a row.

How the loop syncs
------------------

The reference compiles an epoch into one traced program and scans it.
The port runs eager torch ops and keeps on the host everything the
host can know without a read: the clock, the tape cursor, the map
epoch, and the suppressed/slow bits (the tape alone sets them).  So:

- a quiet idle epoch (no map row, no suppressed, slow, down or laggy
  OSD) reads nothing back;
- a non-idle epoch reads one small tensor after the liveness tick (a
  transition happened, any OSD down, any laggy): the dirty decision;
- a dirty epoch adds the CRUSH engine's reads (one a retry round,
  ``interp_batch._any``) and, with the dirty-set ladder on, one read
  of the dirty-PG count that picks the rung.

Each epoch's outputs stay on the device as one int32 row; a chunk's
rows come back as one copy (:meth:`EpochSeries.from_device`).  There is
no CUDA graph of an epoch yet: the retry ladders' reads rule out a
capture (ROADMAP §1 item 2a).

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

``compile_fused_peering`` (the reference's fused placement and peering
program) is not ported: peering here is the mapping program of
:func:`~ceph_tpu_torch.osdmap.mapping.compile_pool_mapping` on the
epoch's pool state, diffed by :func:`~ceph_tpu_torch.recovery.peering.
classify_rows` against the baseline epoch's acting table, mapped once
when the driver is built.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

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


# Each edit writes one lane element through a view (``fill_``/``copy_``):
# a launch each, and nothing read back.


def _row_down(lanes, o, now32, exists):
    lanes["up"][o].fill_(False)


def _row_up(lanes, o, now32, exists):
    # the effective bit becomes exists (a non-existing OSD stays down);
    # an authoritative up re-arms the detector
    lanes["up"][o].copy_(exists[o])
    lanes["ack"][o].fill_(now32)
    lanes["sup"][o].fill_(False)
    lanes["out"][o].fill_(False)


def _row_out(lanes, o, now32, exists):
    lanes["w"][o].fill_(0)


def _row_in(lanes, o, now32, exists):
    w = lanes["w"][o]
    w.copy_(torch.where(w == 0, 0x10000, w))
    lanes["ack"][o].fill_(now32)
    lanes["sup"][o].fill_(False)
    lanes["out"][o].fill_(False)


def _row_net_drop(lanes, o, now32, exists):
    lanes["ack"][o].fill_(now32)
    lanes["sup"][o].fill_(True)


def _row_net_restore(lanes, o, now32, exists):
    lanes["ack"][o].fill_(now32)
    lanes["sup"][o].fill_(False)


def _row_slow_drop(lanes, o, now32, exists):
    lanes["slow"][o].fill_(True)


def _row_slow_restore(lanes, o, now32, exists):
    lanes["slow"][o].fill_(False)


#: one edit a tape kind, in the order of the TAPE_* constants
_ROW_EDITS = (_row_down, _row_up, _row_out, _row_in, _row_net_drop,
              _row_net_restore, _row_slow_drop, _row_slow_restore)


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


@dataclass
class EpochRows:
    """A run's epoch rows before they are pulled: the host lanes as
    arrays and the rest as one ``[n, width]`` int32 tensor on the
    device (:func:`_packed_layout`)."""

    now: np.ndarray
    epoch: np.ndarray
    dirty: np.ndarray
    packed: torch.Tensor

    def __len__(self) -> int:
        return int(self.now.shape[0])


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
        return cls.from_rows(rows.now, rows.epoch, rows.dirty, rows.packed.cpu().numpy())

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
        #: the rung each dirty epoch of the last run took (len(ladder):
        #: dense; -1: nothing to re-peer), for reports
        self.rungs_taken: list[int] = []
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
        # the flight recorder (item 3) is not ported: 'on' refuses,
        # 'auto' is off, as the reference resolves it without the
        # bench-decided default file
        if str(cfg.get("flight_recorder")) == "on":
            raise NotImplementedError(
                "flight_recorder=on: the flight recorder (obs/flight.py) is not "
                "ported yet (ROADMAP §1, item 3)"
            )
        self.flight_on = False

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
            for kind, o in zip(kinds, tape.osd[lo:stop]):
                o = int(o)
                _ROW_EDITS[kind](lanes, o, now32, pool.osd_exists)
                if kind in (TAPE_UP, TAPE_IN, TAPE_NET_RESTORE):
                    host.suppressed[o] = False
                elif kind == TAPE_NET_DROP:
                    host.suppressed[o] = True
                elif kind in (TAPE_SLOW_DROP, TAPE_SLOW_RESTORE):
                    host.slow[o] = kind == TAPE_SLOW_DROP
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
        decay = 0.5 ** (max(now - host.last_tick, 0.0) / max(self.laggy_halflife, 1e-9))
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
            c = torch.cumsum(cand.to(I32), 0)
            n_exist = exists.sum(dtype=I32)
            n_in = (exists & (w > 0)).sum(dtype=I32)
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
            down.sum(dtype=I32), eff_down.sum(dtype=I32), eff_up.sum(dtype=I32),
            eff_out.sum(dtype=I32), _down_checksum(down)])
        trans, any_down, any_laggy = torch.stack([
            live[1:4].sum() > 0, down.any(), (laggy != 0).any()]).cpu().tolist()
        state = replace(
            state,
            pool=replace(pool, osd_up=(pool.osd_up & ~eff_down) | eff_up,
                         osd_weight=torch.where(eff_out, 0, w)),
            last_ack=ack, laggy=laggy, markdowns=md, down=down, down_since=dsince,
            out=state.out | approved,
        )
        host.epoch += int(trans)
        host.last_tick = now
        host.any_down, host.any_laggy = any_down, any_laggy
        return state, live, trans

    def _peer_rows(self, state: ClusterState, pgs: torch.Tensor, prev_acting):
        """Map the epoch's pool state at PG seeds ``pgs`` and classify
        against the baseline's acting rows."""
        up, upp, acting, actp = self._map_fn(self._crush_arg, state.pool, pgs)
        flags, mask, n_alive = classify_rows(prev_acting, up, acting, self.min_size)
        return up, upp, acting, actp, flags, mask, n_alive

    def _peer_hist(self, state: ClusterState) -> ClusterState:
        """Re-peer and reclassify every PG: the dense dirty branch."""
        from ..obs.pg_states import pg_state_reduce

        up, upp, acting, actp, flags, mask, n_alive = self._peer_rows(
            state, self._pg_idx, self._prev_acting)
        hist, aux = pg_state_reduce(mask, n_alive, flags, self.k, self.size)
        return replace(state, up=up, up_primary=upp, acting=acting, acting_primary=actp,
                       flags=flags, survivor_mask=mask, n_alive=n_alive,
                       pg_hist=hist, pg_aux=aux)

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
        from ..obs.pg_states import pg_state_reduce

        widths = self._dirty_ladder
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
        take, n_dirty = compact_dirty_indices(dirty_pg)
        nd = int(n_dirty)  # the rung read
        rung = ladder_rung(nd, widths)
        if rung == len(widths):
            self.rungs_taken.append(rung)
            return self._peer_hist(state)
        if nd == 0:
            # every lane a pad: the scatters drop all, the refold adds 0
            self.rungs_taken.append(-1)
            return state
        self.rungs_taken.append(rung)
        W = widths[rung]
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
                       salt_base: int | None = None):
        """One traffic step of ``n_ops`` over the state's peering tables:
        ``(counts, lat_hist, qd_hist, sums, max_rho, writes,
        deg_reads)``.  With a workload mix, object ids are skew-remapped
        and the per-OSD capacity is burst-modulated (the virtual clock
        is a host value, so the burst test is too)."""
        from ..workload.histogram import LAT_MIN_MS, N_BUCKETS
        from ..workload.traffic import (
            _osd_index,
            _route,
            _scatter_load,
            _skew_ids,
            _traffic_outcomes,
        )

        salt_base = self.salt_base if salt_base is None else int(salt_base)
        # the TrafficEngine's per-step salt, u32 wraparound
        salt = (salt_base + step * _SALT_STEP) & _M32
        mix = self._mix
        ids = self._ids
        if mix is not None and mix.hot_permille > 0:
            ids = _skew_ids(ids, salt, mix.hot_permille, mix.hot_objects)
        cap = np.float32(self.cap_ops)
        if (mix is not None and mix.burst_factor > 1.0 and mix.burst_period_s > 0.0
                and now % mix.burst_period_s < mix.burst_duty * mix.burst_period_s):
            # bursty arrivals as capacity collapsing by burst_factor for
            # burst_duty of every period
            cap = cap / np.float32(mix.burst_factor)
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
        writes = (ok & is_write).sum(dtype=I32)
        deg_reads = (ok & degraded & ~is_write).sum(dtype=I32)
        return counts, lat_hist, qd_hist, sums, max_rho, writes, deg_reads

    def _scrub_due(self, prev_now: float, now: float) -> torch.Tensor:
        """PGs whose staggered scrub window ticked in ``(prev_now,
        now]`` ([1] int32): a full period elapsed -> all; otherwise the
        phase window ``(lo, hi]``, wrapping."""
        period = self.scrub_period_s
        if period <= 0:
            return self._zero_i32
        if now - prev_now >= period:
            return torch.full((1,), self.pg_num, dtype=I32, device=self.device)
        lo, hi = prev_now % period, now % period
        ph = self._phases
        in_win = ((ph > lo) & (ph <= hi)) if lo <= hi else ((ph > lo) | (ph <= hi))
        return in_win.sum(dtype=I32).reshape(1)

    @staticmethod
    def _row(state: ClusterState, traffic, live, scrub) -> torch.Tensor:
        """The epoch's device lanes as one int32 row (float32 lanes by
        their bits), in :func:`_packed_layout`'s order."""
        counts, lat_hist, qd_hist, sums, max_rho, writes, deg_reads = traffic
        return torch.cat([
            state.pg_hist, state.pg_aux, counts, lat_hist, qd_hist, sums.view(I32),
            max_rho.view(I32).reshape(1), writes.reshape(1), deg_reads.reshape(1),
            live, scrub])

    # -- one epoch -----------------------------------------------------

    def _epoch_step(self, state: ClusterState, host: _HostView, step: int, *,
                    tape: EventTape | None = None, salt_base: int | None = None,
                    compact: bool = True):
        """One epoch of the superstep: ``(state, (dirty, row))``."""
        prev_now = host.now
        # the pool lanes before this epoch's edits: the compacted dirty
        # branch diffs against them to find the PGs the edits can reach
        prev_up, prev_w = state.pool.osd_up, state.pool.osd_weight
        state, tape_dirty = self._tape_apply(state, host, step, tape)
        state, live, trans = self._live(state, host, host.idle)
        dirty = tape_dirty or trans
        # pg_hist/pg_aux move only when peering moves, so quiet epochs
        # carry them forward
        if dirty:
            if compact and self._dirty_ladder:
                state = self._peer_hist_compact(state, prev_up, prev_w)
            else:
                state = self._peer_hist(state)
        traffic = self._traffic_apply(state, step, host.now, salt_base)
        row = self._row(state, traffic, live, self._scrub_due(prev_now, host.now))
        return state, (dirty, row)

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
        :class:`EpochRows` still on the device.  A quiet epoch reads the
        device at most once (the dirty decision); there is no CUDA
        graph of an epoch yet.  ``journal`` is the flight recorder's
        drain seam, unused while the recorder is not ported."""
        state = self._init_state
        host = self._init_host.copy()
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
            now, epoch, dirty, packed = [], [], [], []
            for e in range(start, start + size):
                state, (d, row) = self._epoch_step(state, host, e)
                now.append(host.now)
                epoch.append(host.epoch)
                dirty.append(int(d))
                packed.append(row)
            rows = EpochRows(np.asarray(now, np.float64), np.asarray(epoch, np.int32),
                             np.asarray(dirty, np.int32), torch.stack(packed))
            self.final_state = state = self._with_scalars(state, host)
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
            idle = not bool(torch.stack([
                state.suppressed.any(), state.slow.any(), state.down.any(),
                (state.laggy != 0).any()]).any())
            state, live, trans = self._live(state, host, idle)
            # the host detector's per-tick mirror of the heartbeat lanes
            for lane in (state.last_ack, state.laggy, state.markdowns, state.down,
                         state.down_since, state.out):
                lane.cpu()
            dirty = tape_dirty or trans
            if dirty:
                state = self._peer_hist(state)
            traffic = self._traffic_apply(state, e, host.now)
            row = self._row(state, traffic, live, self._scrub_due(prev_now, host.now))
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


def _down_checksum(down: torch.Tensor) -> torch.Tensor:
    """Order-free integer fingerprint of the down set (sum of id+1)."""
    n = down.shape[0]
    ids = torch.arange(1, n + 1, dtype=I32, device=down.device)
    return torch.where(down, ids, 0).sum(dtype=I32)


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


def compile_epoch_superstep(driver: EpochDriver):
    """The chunk runner of a built driver: ``run(n_epochs, **kw)`` as
    :meth:`EpochDriver.run_superstep` (eager torch: nothing is compiled
    ahead; the name is the reference's)."""
    return driver.run_superstep


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
