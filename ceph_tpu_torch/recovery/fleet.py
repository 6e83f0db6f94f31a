"""Scenario fleets: N chaos timelines advanced together on one device.

The counterpart of the reference package's ``recovery/fleet.py``.  The
capacity-planning questions (MTTDL per codec, a tuned
``mon_osd_down_out_interval``, mclock shares) need *populations* of
simulated clusters; the epoch body is state -> state, so a fleet is a
leading batch axis over :func:`~ceph_tpu_torch.core.cluster_state.
stack_states`:

- :func:`sample_timelines` draws N seeded, jittered variants of one
  named :func:`~ceph_tpu_torch.recovery.chaos.build_scenario` (start/
  period scale, cycle count, rack rotation), deterministic per ``(seed,
  index)`` (a copy of the reference's).
- :func:`stack_tapes` lowers the per-cluster
  :class:`~ceph_tpu_torch.recovery.superstep.EventTape`\\ s into one
  padded ``[fleet, rows]`` tape, both axes rounded up to powers of two:
  pad rows carry ``t=+inf`` (no epoch's window reaches them), pad
  clusters carry empty tapes and are cropped from every output.
- :class:`FleetDriver` advances every lane together: on the card one
  replay of :class:`FleetProgram`'s CUDA graph a window (the
  reference's one ``lax.scan`` over a vmapped body), on the CPU a host
  loop of epochs (below).

How one fleet epoch runs (the host-decided loop)
------------------------------------------------

Only the clock is shared: ``t0`` and ``dt`` come from one template
:class:`~ceph_tpu_torch.recovery.superstep.EpochDriver`.  Each lane
keeps its own tape cursor, map epoch and suppressed/slow bits on the
host, as the one-cluster driver's ``_HostView`` does, and every piece
is the one-cluster piece along the last axis:

- **tape**: the whole run's tape windows are known on the host before
  the first epoch, so every edit's ``lane * n_osds + osd`` index goes to
  the device in one copy; at window position ``k = 0, 1, ...`` one
  batched edit a row kind covers the lanes that have a ``k``-th row, so
  a lane's rows apply in order (a ``down`` then an ``up`` of one OSD in
  one epoch never lands as one scatter with a repeated index);
- **liveness**: ``heartbeat_step`` over ``[F, n_osds]`` with a decay a
  lane, gathered from a table of the run's ``(now, last tick)`` pairs
  computed on the host as the one-cluster driver computes each (the
  laggy lanes' exact float32 factors); idle lanes keep their state
  (``torch.where``), as the one-cluster driver skips an idle tick; the
  approved outs are a prefix, a ``cumsum`` over ``dim=-1``.  The epoch's
  one read takes ``[F, 3]`` (transition, any down, any laggy) for all
  lanes at once, beside each lane's pool key (below);
- **peering**: only the dirty lanes, each with the dense
  ``EpochDriver._peer_hist`` on :func:`~ceph_tpu_torch.core.
  cluster_state.index_state` and written back into its lane.  A lane's
  peering is a function of its pool lanes alone, and the fleet edits
  only ``osd_up`` and ``osd_weight``; so a run keeps each peered
  result under the bytes of those two lanes (its *pool key*, read with
  the epoch's one read), and a dirty lane whose key a lane already
  peered in this run copies that result (jittered lanes of one
  scenario revisit the same few map states).  The reference's lane
  ladder (``dirty_ladder(min_bucket=1, growth=4)``, a static-shape
  workaround) is not carried over: the host knows the dirty lanes;
- **traffic**: one batched step for all lanes (the traffic helpers
  work on the last axis, salts ``[F, 1]``, the load scattered into a
  flat ``[F * n_osds]`` buffer, the fixed pairwise sums lane by lane);
  the burst test reads the shared clock;
- **scrub windows** are shared and broadcast; the **rows** stay on the
  device as ``[epochs, F_pad, width]`` and come back once a run.

:class:`FleetProgram` makes the same epoch's decisions on the card: the
edits from tables of the host plan's groups, the tick of the active
lanes, the dirty lanes peered through the same memo of pool keys (kept
on the device), all inside one graph.  ``run_fleet(path=...)`` picks the
graph, its body run eagerly, or the host-decided loop.

Every lane equals its own one-cluster run bit for bit
(:meth:`FleetDriver.run_sequential`, the template's tape program on the
card, and a plain ``EpochDriver``):
held in ``tests/test_torch_fleet.py`` over the chaos zoo.  Outputs land
as a :class:`FleetSeries` (the ``EpochSeries`` fields with a second,
fleet axis), which :mod:`~ceph_tpu_torch.recovery.durability` reduces.
With the template driver's flight recorder on, a per-lane ring
(``[F_pad, R, L]``) records every lane's epoch.
"""

from __future__ import annotations

import copy
import functools
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..core.cluster_state import (
    ClusterState,
    _check_bucketed,
    _pad_to,
    dirty_ladder,
    index_state,
    ladder_rung,
    stack_states,
)
from ..osdmap.map import OSDMap
from .chaos import ChaosTimeline, build_scenario
from .superstep import (
    _LANE_EDITS,
    _GraphProgram,
    _MAP_KINDS,
    _M32,
    _SALT_STEP,
    _SERIES_FIELDS,
    _TICK_NAMES,
    EpochDriver,
    EpochRows,
    EpochSeries,
    EventTape,
    _clone_state,
    _get,
    _host_bits,
    _packed_layout,
    _state_names,
    _tape_lanes,
    compile_event_tape,
    pick_path,
    upload,
    uploaded,
)

I32 = torch.int32
I64 = torch.int64

#: the TrafficEngine's seed -> salt-base fold (u32 Knuth multiplicative)
_SALT_MULT = 2654435761

#: the per-PG peering outputs a dirty lane's peering writes back
_PEER_FIELDS = ("up", "up_primary", "acting", "acting_primary", "flags",
                "survivor_mask", "n_alive", "pg_hist", "pg_aux")


def _salt_base(seed: int) -> np.uint32:
    return np.uint32((int(seed) * _SALT_MULT) & 0xFFFFFFFF)


def sample_timelines(
    seed: int,
    n: int,
    scenario: str,
    m: OSDMap,
    *,
    jitter: float = 0.25,
    start_s: float = 0.25,
    period_s: float = 1.0,
    cycles: int = 3,
) -> list[ChaosTimeline]:
    """Draw ``n`` seeded variants of one named chaos scenario.

    Cluster ``i``'s timeline comes from ``default_rng([seed, i])`` —
    deterministic per (seed, index), independent of ``n`` (growing the
    fleet never changes existing members).  ``jitter`` scales the
    scenario's start/period by ``1 ± jitter``, wobbles the cycle count
    by ±1, and rotates the target rack; ``jitter=0`` yields n copies
    of the base scenario.
    """
    racks = sorted(
        b.name for b in m.crush.buckets.values()
        if m.crush.types[b.type_id] == "rack"
    )
    out = []
    for i in range(int(n)):
        rng = np.random.default_rng([int(seed), int(i)])

        def scale(v):
            return float(v) * (1.0 + jitter * (2.0 * rng.random() - 1.0))

        rack = racks[int(rng.integers(len(racks)))] if racks else None
        cyc = int(cycles)
        if jitter > 0:
            cyc = max(1, cyc + int(rng.integers(-1, 2)))
        out.append(build_scenario(
            scenario, m,
            start_s=scale(start_s), period_s=scale(period_s),
            cycles=cyc, rack=rack,
        ))
    return out


def _pad_tape_arrays(tape: EventTape, rows: int):
    """One tape -> fixed ``rows``-wide host arrays; pad rows carry
    ``t=+inf`` so no epoch's window ``searchsorted`` ever includes them
    (the cursor parks below the pad forever)."""
    k = len(tape)
    if k > rows:
        raise ValueError(f"tape of {k} rows exceeds pad {rows}")
    t = np.full(rows, np.inf, np.float64)
    kind = np.zeros(rows, np.int32)
    osd = np.zeros(rows, np.int32)
    bump = np.zeros(rows, np.int32)
    t[:k] = tape.t
    kind[:k] = tape.kind
    osd[:k] = tape.osd
    bump[:k] = tape.bump
    return t, kind, osd, bump


def _empty_tape() -> EventTape:
    return EventTape(
        t=np.zeros(0, np.float64), kind=np.zeros(0, np.int32),
        osd=np.zeros(0, np.int32), bump=np.zeros(0, np.int32),
        n_events=0, n_bitrot=0,
    )


def _padded_tape(tape: EventTape, rows: int) -> EventTape:
    """``tape`` with its rows padded to ``rows`` (pad rows at +inf)."""
    return EventTape(*_pad_tape_arrays(tape, rows), n_events=tape.n_events,
                     n_bitrot=tape.n_bitrot)


@dataclass(frozen=True)
class FleetTape:
    """N event tapes as one padded ``[fleet, rows]`` schedule (both axes
    power-of-two bucketed; pad clusters hold empty tapes)."""

    t: np.ndarray      # f64 [fleet_pad, rows_pad]
    kind: np.ndarray   # i32 [fleet_pad, rows_pad]
    osd: np.ndarray    # i32 [fleet_pad, rows_pad]
    bump: np.ndarray   # i32 [fleet_pad, rows_pad]
    n_clusters: int    # real clusters (<= fleet_pad)

    @property
    def fleet_pad(self) -> int:
        return int(self.t.shape[0])

    @property
    def rows_pad(self) -> int:
        return int(self.t.shape[1])

    def device(self, dev):
        """The four columns as tensors on ``dev``."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (self.t, self.kind, self.osd, self.bump))


def stack_tapes(tapes: list[EventTape]) -> FleetTape:
    """Stack per-cluster tapes into a :class:`FleetTape`, bucketing the
    fleet axis to ``_pad_to(n)`` and the row axis to the power-of-two
    bucket of the longest tape (min 1)."""
    tapes = list(tapes)
    if not tapes:
        raise ValueError("stack_tapes needs at least one tape")
    f_pad = _pad_to(len(tapes))
    r_pad = _pad_to(max(max(len(tp) for tp in tapes), 1))
    _check_bucketed("fleet.stack_tapes fleet/row pads", f_pad, r_pad)
    cols = [_pad_tape_arrays(tp, r_pad) for tp in tapes]
    empty = _pad_tape_arrays(_empty_tape(), r_pad)
    cols.extend([empty] * (f_pad - len(tapes)))
    t, kind, osd, bump = (np.stack(c) for c in zip(*cols))
    return FleetTape(
        t=t, kind=kind, osd=osd, bump=bump, n_clusters=len(tapes)
    )


@dataclass
class FleetRows:
    """A fleet run's epoch rows before they are pulled: the host lanes as
    arrays and the rest as one ``[n, fleet_pad, width]`` int32 tensor on
    the device (:func:`~ceph_tpu_torch.recovery.superstep._packed_layout`).
    Rows of the compiled fleet keep the epoch and dirty lanes on the
    device too: ``lanes`` is ``[n, fleet_pad, width + 2]`` (``packed``
    its first ``width`` columns, then the epoch and dirty lanes) and
    ``epoch``/``dirty`` are None until :meth:`FleetSeries.from_device`
    reads it."""

    now: np.ndarray             # f64 [n]  (the clock is shared)
    epoch: np.ndarray | None    # i32 [n, fleet_pad]
    dirty: np.ndarray | None    # i32 [n, fleet_pad]
    packed: torch.Tensor
    lanes: torch.Tensor | None = None

    def __len__(self) -> int:
        return int(self.now.shape[0])


@dataclass(frozen=True)
class FleetSeries:
    """Per-epoch outputs for every fleet member: the
    :class:`~ceph_tpu_torch.recovery.superstep.EpochSeries` fields with a
    fleet axis second — ``[n_epochs, fleet, ...]`` each."""

    now: np.ndarray
    epoch: np.ndarray
    dirty: np.ndarray
    hist: np.ndarray
    aux: np.ndarray
    counts: np.ndarray
    lat_hist: np.ndarray
    qd_hist: np.ndarray
    sums: np.ndarray
    max_rho: np.ndarray
    writes: np.ndarray
    deg_reads: np.ndarray
    down_total: np.ndarray
    eff_down: np.ndarray
    eff_up: np.ndarray
    eff_out: np.ndarray
    down_checksum: np.ndarray
    scrub_due: np.ndarray

    def __len__(self) -> int:
        return int(self.now.shape[0])

    @property
    def n_clusters(self) -> int:
        return int(self.now.shape[1])

    @classmethod
    def from_rows(cls, now, epoch, dirty, packed: np.ndarray, n_clusters: int) -> "FleetSeries":
        """The series of host lanes and host packed rows ``[n, fleet,
        width]``, cropped to the first ``n_clusters`` lanes."""
        epoch = np.asarray(epoch, np.int32)[:, :n_clusters]
        out = {"now": np.repeat(np.asarray(now, np.float64)[:, None], n_clusters, axis=1),
               "epoch": epoch, "dirty": np.asarray(dirty, np.int32)[:, :n_clusters]}
        packed = np.asarray(packed, np.int32)[:, :n_clusters]
        col = 0
        for f, width, dtype in _packed_layout():
            part = np.ascontiguousarray(packed[:, :, col:col + width]).view(dtype)
            out[f] = part if f in ("hist", "aux", "counts", "lat_hist", "qd_hist",
                                   "sums") else part[:, :, 0]
            col += width
        return cls(**out)

    @classmethod
    def from_device(cls, rows: FleetRows, n_clusters: int) -> "FleetSeries":
        """Pull a run's rows (one copy) and crop the pad clusters."""
        if rows.lanes is None:
            return cls.from_rows(rows.now, rows.epoch, rows.dirty, rows.packed.cpu().numpy(),
                                 n_clusters)
        a = rows.lanes.cpu().numpy()
        w = rows.packed.shape[-1]
        return cls.from_rows(rows.now, a[:, :, w], a[:, :, w + 1], a[:, :, :w], n_clusters)

    def cluster(self, i: int) -> EpochSeries:
        """Cluster ``i``'s lane as a plain :class:`EpochSeries` — the
        exact-diff surface against a sequential run of its timeline."""
        return EpochSeries(**{
            f: np.ascontiguousarray(getattr(self, f)[:, i]) for f in _SERIES_FIELDS
        })


# ---------------------------------------------------------------------------
# the tape, batched across lanes
#
# The edits are superstep's ``_LANE_EDITS`` on the flattened fleet: one
# call a window position and kind, over distinct lanes.


@dataclass
class _TapePlan:
    """A fleet run's tape windows, worked out on the host before its
    first epoch: every edit's flat indices (one copy to the device), the
    edits of each epoch in apply order, and what the host learns from
    each window (map rows, epoch bumps, suppressed and slow bits)."""

    idx: torch.Tensor | None          # int64 flat lane * n_osds + osd, on the device
    flat: np.ndarray                  # the same indices on the host
    edits: list                       # [epoch] -> [(kind, start, stop)]
    stops: np.ndarray                 # int [n, F]: each lane's cursor after each epoch
    tape_dirty: np.ndarray            # bool [n, F]: a map row applied
    bumps: np.ndarray                 # int [n, F]: epoch advances
    sup_any: np.ndarray               # bool [n, F]: any suppressed after
    slow_any: np.ndarray              # bool [n, F]: any slow after
    cursor: np.ndarray                # int [F]: cursors after the run


def _tape_plan(tapes: list[EventTape], nows: np.ndarray, n_osds: int, dev=None) -> _TapePlan:
    lanes_n = len(tapes)
    n = len(nows)
    stops = np.zeros((n, lanes_n), np.int64)
    for i, tp in enumerate(tapes):
        stops[:, i] = np.searchsorted(tp.t, nows, side="right")
    sup = np.zeros((lanes_n, n_osds), bool)
    slow = np.zeros((lanes_n, n_osds), bool)
    tape_dirty = np.zeros((n, lanes_n), bool)
    bumps = np.zeros((n, lanes_n), np.int64)
    sup_any = np.zeros((n, lanes_n), bool)
    slow_any = np.zeros((n, lanes_n), bool)
    flat: list[np.ndarray] = []
    edits: list[list[tuple[int, int, int]]] = []
    used = 0
    lo = np.zeros(lanes_n, np.int64)
    for e in range(n):
        hi = stops[e]
        ep: list[tuple[int, int, int]] = []
        for k in range(int((hi - lo).max(initial=0))):
            lanes = np.nonzero(hi - lo > k)[0]
            rows = lo[lanes] + k
            kinds = np.array([tapes[i].kind[r] for i, r in zip(lanes, rows)], np.int64)
            osds = np.array([tapes[i].osd[r] for i, r in zip(lanes, rows)], np.int64)
            for kind in np.unique(kinds):
                sel = kinds == kind
                ids = lanes[sel] * n_osds + osds[sel]
                ep.append((int(kind), used, used + len(ids)))
                flat.append(ids)
                used += len(ids)
                _host_bits(int(kind), sup, slow, (lanes[sel], osds[sel]))
        for i in np.nonzero(hi > lo)[0]:
            tp = tapes[i]
            tape_dirty[e, i] = bool(np.isin(tp.kind[lo[i]:hi[i]], _MAP_KINDS).any())
            bumps[e, i] = int(tp.bump[lo[i]:hi[i]].sum())
        sup_any[e], slow_any[e] = sup.any(1), slow.any(1)
        edits.append(ep)
        lo = hi
    flat_np = np.concatenate(flat) if flat else np.zeros(0, np.int64)
    idx = torch.from_numpy(flat_np).to(dev) if flat and dev is not None else None
    return _TapePlan(idx=idx, flat=flat_np, edits=edits, stops=stops, tape_dirty=tape_dirty,
                     bumps=bumps, sup_any=sup_any, slow_any=slow_any, cursor=lo.copy())


class FleetDriver:
    """One map geometry, one template driver, N lanes advanced together.

    Owns a template :class:`EpochDriver` built on an empty timeline: it
    contributes the epoch-body pieces and the seeded initial state,
    never a tape.  Every driver kwarg (geometry, knobs, config, mix,
    ``rho_recovery``, ``device``) passes through to the template, so the
    whole fleet shares them; what varies per lane is the timeline and
    the traffic seed.

    - :meth:`run_fleet` advances all ``F_pad`` lanes together (pad lanes
      are cropped): on the card one replay of :meth:`compile_fleet`'s
      graph, on the CPU the host-decided loop;
    - :meth:`run_sequential` runs one lane at a time through the
      template's ``_epoch_step_with`` (on the card its tape program),
      the one-cluster baseline.

    :attr:`stats` counts the last run's reads, dirty lane-epochs,
    peerings and reused peerings.
    """

    def __init__(self, m: OSDMap, *, seed: int = 0, **driver_kwargs):
        self.m = m
        self.seed = int(seed)
        self.driver = EpochDriver(m, ChaosTimeline(), seed=seed, **driver_kwargs)
        self.device = self.driver.device
        self._init_cache: dict[int, ClusterState] = {}
        self._decay_tab: torch.Tensor | None = None
        self._decay_host: np.ndarray | None = None
        self._programs: dict[bool, FleetProgram] = {}
        #: the flight recorder's per-lane ring after the last run (None
        #: with the recorder off)
        self.flight = None
        self.final_state: ClusterState | None = None
        self.stats: dict = {}

    # -- inputs --------------------------------------------------------

    def sample(self, n: int, scenario: str, **kw) -> list[ChaosTimeline]:
        """:func:`sample_timelines` with this driver's seed and map."""
        return sample_timelines(self.seed, n, scenario, self.m, **kw)

    def _seeds(self, n: int, seeds) -> list[int]:
        if seeds is None:
            seeds = [self.seed + i for i in range(n)]
        seeds = [int(s) for s in seeds]
        if len(seeds) != n:
            raise ValueError(f"{len(seeds)} seeds for {n} timelines")
        return seeds

    def _salts(self, n: int, f_pad: int, seeds) -> torch.Tensor:
        """The lanes' traffic salt bases as a ``[f_pad, 1]`` int64 tensor
        (pad lanes 0)."""
        salts = np.zeros((f_pad, 1), np.int64)
        salts[:n, 0] = [int(_salt_base(s)) for s in self._seeds(n, seeds)]
        return uploaded(salts, self.device)

    def _fleet_state(self, f_pad: int) -> ClusterState:
        """The stacked initial fleet state, cached per pad bucket."""
        st = self._init_cache.get(f_pad)
        if st is None:
            st = stack_states([self.driver._init_state] * f_pad)
            self._init_cache[f_pad] = st
        return st

    def _decay_table(self, n_epochs: int) -> torch.Tensor:
        """``[n_epochs, n_epochs + 1]`` float32 on the device: entry ``(e,
        j)`` is the liveness decay of a tick at epoch ``e`` whose lane last
        ticked at column ``j`` (0: ``t0``; ``s + 1``: epoch ``s``),
        computed as the one-cluster driver computes it.  Kept for the
        longest run so far (entries do not depend on the run's length)."""
        tab = self._decay_tab
        if tab is None or tab.shape[0] < n_epochs:
            drv = self.driver
            ticks = [drv.t0] + [drv._now_of(s) for s in range(n_epochs)]
            host = np.ones((n_epochs, n_epochs + 1), np.float32)
            for e in range(n_epochs):
                now = drv._now_of(e)
                host[e, :e + 1] = [drv._decay(now, lt) for lt in ticks[:e + 1]]
            self._decay_host = host
            tab = self._decay_tab = uploaded(host, self.device)
        return tab

    # -- the pieces ------------------------------------------------------

    def _tape_apply(self, fstate: ClusterState, step: int, now: float) -> ClusterState:
        """Epoch ``step``'s tape edits, window position by position."""
        plan = self._plan
        edits = plan.edits[step]
        if not edits:
            return fstate
        pool = fstate.pool
        lanes = {"up": pool.osd_up.clone(), "w": pool.osd_weight.clone(),
                 "ack": fstate.last_ack.clone(), "sup": fstate.suppressed.clone(),
                 "slow": fstate.slow.clone(), "out": fstate.out.clone()}
        flat = {k: v.view(-1) for k, v in lanes.items()}
        exists = pool.osd_exists.reshape(-1)
        now32 = float(np.float32(now))
        for kind, a, b in edits:
            _LANE_EDITS[kind](flat, plan.idx[a:b], now32, exists)
        return replace(
            fstate, pool=replace(pool, osd_up=lanes["up"], osd_weight=lanes["w"]),
            last_ack=lanes["ack"], suppressed=lanes["sup"], slow=lanes["slow"],
            out=lanes["out"])

    def _live(self, fstate: ClusterState, step: int, now: float, any_active: bool,
              need_keys: bool):
        """The liveness tick of every lane that is not idle, and the
        epoch's one read.  Returns ``(state, live [F, 5], read)``:
        ``read`` is None when there is nothing to read, else host int32
        ``[F, 3 + n_osds]``: transition, any down, any laggy, then the
        lane's pool key (zeros but the keys when no lane ticked)."""
        drv = self.driver
        if not any_active:
            if not need_keys:
                return fstate, self._zero_live, None
            keys = self._keys(fstate)
            flags = torch.zeros((keys.shape[0], 3), dtype=I32, device=keys.device)
            return fstate, self._zero_live, torch.cat([flags, keys], dim=-1).cpu().numpy()
        # the idle test from the device's own lanes: they are exactly
        # what the host's suppressed/slow bits and last read say
        active = (fstate.suppressed.any(-1) | fstate.slow.any(-1) | fstate.down.any(-1)
                  | (fstate.laggy != 0).any(-1))
        decay = self._decay_table(self._n_epochs)[step].index_select(0, self._last_tick)
        new, live, flags = drv._tick(fstate, now, decay[:, None])
        a = active[:, None]

        def keep(x, y):
            return torch.where(a, x, y)

        pool, npool = fstate.pool, new.pool
        fstate = replace(
            fstate,
            pool=replace(pool, osd_up=keep(npool.osd_up, pool.osd_up),
                         osd_weight=keep(npool.osd_weight, pool.osd_weight)),
            last_ack=keep(new.last_ack, fstate.last_ack), laggy=keep(new.laggy, fstate.laggy),
            markdowns=keep(new.markdowns, fstate.markdowns), down=keep(new.down, fstate.down),
            down_since=keep(new.down_since, fstate.down_since), out=keep(new.out, fstate.out))
        self._last_tick = torch.where(active, step + 1, self._last_tick)
        read = torch.cat([(flags & a).to(I32), self._keys(fstate)], dim=-1)
        return fstate, torch.where(a, live, 0), read.cpu().numpy()

    @staticmethod
    def _keys(fstate: ClusterState) -> torch.Tensor:
        """Each lane's pool key ``[F, n_osds]`` int32: its weight with its
        up bit above (weights stay below 2^24)."""
        pool = fstate.pool
        return pool.osd_weight | (pool.osd_up.to(I32) << 24)

    def _peer_dirty(self, fstate: ClusterState, lanes, keys) -> ClusterState:
        """Re-peer the dirty ``lanes``, each alone through the template's
        dense ``_peer_hist``, or from this run's result for its pool key,
        and write each into its lane."""
        for i in lanes:
            key = keys[i].tobytes()
            hit = self._memo.get(key)
            if hit is None:
                st = self.driver._peer_hist(index_state(fstate, int(i)))
                hit = self._memo[key] = tuple(getattr(st, f) for f in _PEER_FIELDS)
                self.stats["peered"] += 1
            else:
                self.stats["peer_reused"] += 1
            for f, v in zip(_PEER_FIELDS, hit):
                getattr(fstate, f)[int(i)].copy_(v)
        return fstate

    def _traffic_apply(self, fstate: ClusterState, step: int, now: float):
        """One traffic step for every lane at once."""
        return self.driver._traffic_apply(fstate, step, now, self._salt_dev)

    def _scrub_due(self, prev_now: float, now: float) -> torch.Tensor:
        return self.driver._scrub_due(prev_now, now)

    def _row(self, fstate: ClusterState, traffic, live, scrub) -> torch.Tensor:
        return self.driver._row(fstate, traffic, live, scrub)

    # -- drivers -------------------------------------------------------

    def compile_fleet(self) -> "FleetProgram":
        """The ONE program of a fleet's window (:class:`FleetProgram`,
        built once a driver, the ring riding it with the template's
        flight recorder on): on the card one CUDA graph, captured on the
        first run of a pad bucket and replayed for every later one."""
        flight = bool(self.driver.flight_on)
        if self._programs.get(flight) is None:
            self._programs[flight] = FleetProgram(self, flight=flight)
        return self._programs[flight]

    def _run(self, n_epochs: int, tapes: list[EventTape], salts: torch.Tensor, *,
             start: int = 0, stop: int | None = None, fstate: ClusterState | None = None,
             fs=None, path: str | None = None):
        """Advance ``len(tapes)`` lanes through epochs ``start .. stop -
        1`` of an ``n_epochs`` run (the whole run by default) from
        ``fstate`` (the initial fleet by default, or a state a chunk or a
        restore wrote).  With a flight state ``fs`` the per-lane ring
        records each epoch (:attr:`flight` afterwards).  Returns
        ``(state, FleetRows)``, the state's scalars set for the chunk's
        end, through ``path``: ``"graph"`` (the compiled fleet's replay,
        :meth:`compile_fleet`; the card's default), ``"eager"`` (its body
        run eagerly, each decision read) or ``"host"`` (the host-decided
        loop, :meth:`_run_host`; the CPU's default).  ``stats["path"]``
        names the one taken."""
        path = pick_path(self.device, path)
        if path == "host":
            return self._run_host(n_epochs, tapes, salts, start=start, stop=stop,
                                  fstate=fstate, fs=fs)
        return self.compile_fleet().run(n_epochs, tapes, salts, start=start, stop=stop,
                                        fstate=fstate, fs=fs, compiled=path == "graph")

    def _run_host(self, n_epochs: int, tapes: list[EventTape], salts: torch.Tensor, *,
                  start: int = 0, stop: int | None = None,
                  fstate: ClusterState | None = None, fs=None):
        """:meth:`_run` decided on the host, one epoch at a time: the
        windows a host plan, the busy epoch's one read of every lane's
        flags and pool key, the dirty lanes peered one at a time (a
        restored ``fstate``'s scalars and down/laggy bits rebuild the
        host's view with one read)."""
        drv = self.driver
        dev = self.device
        f_pad = len(tapes)
        stop = n_epochs if stop is None else int(stop)
        n_osds = self.driver._init_state.n_osds
        nows = np.array([drv._now_of(e) for e in range(n_epochs)], np.float64)
        self._plan = plan = _tape_plan(tapes, nows, n_osds, dev)
        self._n_epochs = n_epochs
        self._salt_dev = salts
        self._memo: dict[bytes, tuple] = {}
        self._zero_live = torch.zeros((f_pad, 5), dtype=I32, device=dev)
        self.stats = {"path": "host", "reads": 0, "dirty_lane_epochs": 0, "peered": 0,
                      "peer_reused": 0}
        if n_epochs > 0:
            self._decay_table(n_epochs)
        if fstate is None:
            fstate = self._fleet_state(f_pad)
            epoch = np.full(f_pad, drv._init_host.epoch, np.int64)
            last_tick = np.full(f_pad, drv.t0, np.float64)
            any_down = np.zeros(f_pad, bool)
            any_laggy = np.zeros(f_pad, bool)
            prev_now = drv.t0
        else:
            flags = torch.stack([fstate.down.any(-1), (fstate.laggy != 0).any(-1)]).cpu()
            any_down, any_laggy = flags.numpy()
            epoch = fstate.epoch.cpu().numpy().astype(np.int64)
            last_tick = fstate.last_tick.cpu().numpy()
            prev_now = drv._now_of(start - 1) if start > 0 else drv.t0
        # a lane's last tick as its decay-table column (0: t0; s + 1: epoch s)
        cols = np.rint((last_tick - drv.t0) / drv.dt).astype(np.int64)
        self._last_tick = torch.from_numpy(cols).to(dev)
        # this run's own peering tables: dirty lanes are written in place
        fstate = replace(fstate, **{f: getattr(fstate, f).clone() for f in _PEER_FIELDS})
        epochs_out = np.zeros((stop - start, f_pad), np.int32)
        dirty_out = np.zeros((stop - start, f_pad), np.int32)
        rows: list[torch.Tensor] = []
        lane_widths = self._lane_widths(f_pad)
        for e in range(start, stop):
            now = float(nows[e])
            fstate = self._tape_apply(fstate, e, now)
            epoch += plan.bumps[e]
            active = plan.sup_any[e] | plan.slow_any[e] | any_down | any_laggy
            tape_dirty = plan.tape_dirty[e]
            # a busy fleet epoch's one read after the tick (map moved, keys)
            # torchlint: disable=J003
            fstate, live, read = self._live(fstate, e, now, bool(active.any()),
                                            bool(tape_dirty.any()))
            dirty = tape_dirty
            if read is not None:
                self.stats["reads"] += 1
                trans = read[:, 0] != 0
                any_down = np.where(active, read[:, 1] != 0, any_down)
                any_laggy = np.where(active, read[:, 2] != 0, any_laggy)
                last_tick = np.where(active, now, last_tick)
                epoch += trans
                dirty = tape_dirty | trans
                lanes = np.nonzero(dirty)[0]
                if lanes.size:
                    self.stats["dirty_lane_epochs"] += int(lanes.size)
                    fstate = self._peer_dirty(fstate, lanes, read[:, 3:])
            traffic = self._traffic_apply(fstate, e, now)
            row = self._row(fstate, traffic, live, self._scrub_due(prev_now, now))
            rows.append(row)
            if fs is not None:
                fs = self._record(fs, row, e, dirty, lane_widths)
            epochs_out[e - start] = epoch
            dirty_out[e - start] = dirty
            prev_now = now
        width = sum(w for _f, w, _d in _packed_layout())
        packed = (torch.stack(rows) if rows
                  else torch.zeros((0, f_pad, width), dtype=I32, device=dev))

        def lanes_of(values, dtype):
            return torch.from_numpy(np.asarray(values)).to(dtype).to(dev)

        if stop > start:
            cursor = np.array([int(np.searchsorted(tp.t, nows[stop - 1], side="right"))
                               for tp in tapes], np.int64)
            fstate = replace(
                fstate, epoch=lanes_of(epoch, I32),
                now=lanes_of(np.full(f_pad, prev_now), torch.float64),
                last_tick=lanes_of(last_tick, torch.float64),
                tape_cursor=lanes_of(cursor, I32),
                step=lanes_of(np.full(f_pad, stop - 1), I32))
        self.flight = fs
        return fstate, FleetRows(nows[start:stop], epochs_out, dirty_out, packed)

    def _lane_widths(self, f_pad: int) -> tuple[int, ...]:
        """The reference's lane ladder for a ``f_pad``-lane fleet: the
        port peers each dirty lane alone, but the flight recorder's rung
        and cycle lanes report the rung the reference would take."""
        drv = self.driver
        sdc = drv._sparse_mode
        if sdc == "on" or (sdc == "auto" and f_pad >= 8):
            return dirty_ladder(f_pad, min_bucket=1, growth=4, max_rungs=drv._sparse_rungs)
        return ()

    def _record(self, fs, row: torch.Tensor, step: int, dirty: np.ndarray, widths):
        """One epoch's per-lane ring rows: the lane ladder's stats are one
        value an epoch (the count of dirty lanes), the rest per lane."""
        from ..obs.flight import flight_record

        n_dl = int(np.count_nonzero(dirty))
        rung = ladder_rung(n_dl, widths) if n_dl else -1
        extras = (step, dirty, rung, n_dl, 0)
        return flight_record(fs, self.driver._flight_row(row, extras, widths=widths,
                                                         dense=fs.ring.shape[0]))

    def run_fleet(
        self,
        n_epochs: int,
        timelines,
        *,
        seeds=None,
        pull: bool = True,
        journal=None,
        path: str | None = None,
    ):
        """Advance every timeline ``n_epochs`` epochs together.  Returns a
        cropped :class:`FleetSeries`, or with ``pull=False`` the
        ``(state, rows)`` pair still on the device (:class:`FleetRows`).
        With the template driver's flight recorder on, a per-lane ring
        rides the run (:attr:`flight` afterwards; drained into
        ``journal`` when given) without touching the series lanes.
        ``path`` picks the graph, its eager body or the host-decided loop
        (:meth:`_run`)."""
        from ..obs.flight import empty_flight, journal_drain

        tls = list(timelines)
        tapes = [compile_event_tape(tl, self.m) for tl in tls]
        ftape = stack_tapes(tapes)
        salts = self._salts(len(tls), ftape.fleet_pad, seeds)
        lanes = tapes + [_empty_tape()] * (ftape.fleet_pad - len(tapes))
        fs = (empty_flight(self.driver.flight_ring_epochs, fleet=ftape.fleet_pad,
                           device=self.device) if self.driver.flight_on else None)
        state, rows = self._run(int(n_epochs), lanes, salts, fs=fs, path=path)
        if fs is not None and journal is not None:
            journal_drain(journal, self.flight, fleet=len(tls))
        self.final_state = state
        if not pull:
            return state, rows
        return FleetSeries.from_device(rows, len(tls))

    def run_sequential(
        self,
        n_epochs: int,
        timelines,
        *,
        seeds=None,
        rows_pad: int | None = None,
        path: str | None = None,
    ) -> list[EpochSeries]:
        """N one-cluster runs through the template's ``_epoch_step_with``
        (tape and salt as arguments, dense peering), one at a time.  Equal
        to ``EpochDriver(m, timeline_i, seed=seed_i).run_superstep(
        n_epochs)`` per cluster: the same body, and the pad rows sit past
        every epoch's window.  ``path`` as :meth:`_run`'s: the template's
        tape program replayed (the card's default, :meth:`_sequential_program`)
        or run eagerly, or the host-decided body (the CPU's default,
        :meth:`_sequential_host`)."""
        path = pick_path(self.device, path)
        args = self._sequential_args(timelines, seeds, rows_pad)
        if path == "host":
            return self._sequential_host(int(n_epochs), *args)
        return self._sequential_program(int(n_epochs), *args, compiled=path == "graph")

    def _sequential_args(self, timelines, seeds=None, rows_pad: int | None = None):
        """``(tapes, seeds, rows pad)`` of :meth:`run_sequential`."""
        tls = list(timelines)
        seeds = self._seeds(len(tls), seeds)
        tapes = [compile_event_tape(tl, self.m) for tl in tls]
        r_pad = _pad_to(max(max((len(tp) for tp in tapes), default=1), 1))
        if rows_pad is not None:
            r_pad = max(r_pad, int(rows_pad))
        return tapes, seeds, r_pad

    def _sequential_host(self, n_epochs: int, tapes, seeds, r_pad: int) -> list[EpochSeries]:
        """:meth:`run_sequential` decided on the host, one epoch at a
        time."""
        drv = self.driver
        out = []
        for tp, sd in zip(tapes, seeds):
            tape = _padded_tape(tp, r_pad)
            state, host = drv._init_state, drv._init_host.copy()
            now, epoch, dirty, packed = [], [], [], []
            for e in range(n_epochs):
                state, (d, row) = drv._epoch_step_with(state, host, e, tape, int(_salt_base(sd)))
                now.append(host.now)
                epoch.append(host.epoch)
                dirty.append(int(d))
                packed.append(row)
            if not packed:
                out.append(EpochSeries.from_device(drv._empty_rows()))
                continue
            out.append(EpochSeries.from_device(EpochRows(
                np.asarray(now, np.float64), np.asarray(epoch, np.int32),
                np.asarray(dirty, np.int32), torch.stack(packed))))
        return out

    def _sequential_program(self, n_epochs: int, tapes, seeds, r_pad: int, *,
                            compiled: bool) -> list[EpochSeries]:
        """:meth:`run_sequential` through the template's
        :class:`~ceph_tpu_torch.recovery.superstep.TapeProgram`: one
        ``load`` of a cluster's padded tape and salt, then one chunk of
        replays (eagerly with ``compiled=False``)."""
        drv = self.driver
        prog = drv.compile_tape_program()
        out = []
        for tp, sd in zip(tapes, seeds):
            prog.load(_padded_tape(tp, r_pad), int(_salt_base(sd)))
            _state, _fs, rows = prog._advance(drv._init_state, drv._init_host.copy(), 0,
                                              n_epochs, compiled=compiled)
            out.append(EpochSeries.from_device(rows))
        return out


# ---------------------------------------------------------------------------
# the compiled fleet window


class _FleetCarry:
    """The buffers a compiled fleet window reads and writes in place: the
    fleet state and its per-lane ring, the rows ``[s_pad, f_pad, width +
    2]`` (the epoch and dirty lanes last), the run's tables indexed by
    the absolute step (clock, capacity, scrub count, salt stride, each
    epoch's range of edit groups, bumps, map rows, cursors, the decay
    table ``[s_pad, s_pad + 1]``), the edit groups (a kind, and
    ``f_pad`` flat indices, the group's own padded by its first), the
    lanes' salts, the step and group counters, the epoch's decisions
    and the ring's probe, and the memo of the run's peerings: ``memo``
    pool keys ``[K, n_osds]`` and each key's peering outputs ``[K,
    ...]`` a field, ``memo_n`` the run's peerings (slot ``memo_n % K``
    takes the next), ``n_dirty`` its dirty lane-epochs."""

    def __init__(self, fd: "FleetDriver", f_pad: int, s_pad: int, g_pad: int, flight: bool):
        from ..obs.flight import empty_flight

        drv = fd.driver
        dev = fd.device

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.f_pad, self.s_pad, self.g_pad = f_pad, s_pad, g_pad
        self.st = _clone_state(fd._fleet_state(f_pad))
        self.fs = (empty_flight(drv.flight_ring_epochs, fleet=f_pad, device=dev)
                   if flight else None)
        self.width = sum(w for _f, w, _d in _packed_layout())
        self.rows = z((s_pad, f_pad, self.width + 2), I32)
        self.tab = {"now": z(s_pad, torch.float64), "now32": z(s_pad, torch.float32),
                    "cap": z(s_pad, torch.float32), "scrub": z(s_pad, I32),
                    "ssalt": z(s_pad, I64), "g_lo": z(s_pad, I64), "g_hi": z(s_pad, I64),
                    "bumps": z((s_pad, f_pad), I32), "tdirty": z((s_pad, f_pad), torch.bool),
                    "cursor": z((s_pad, f_pad), I32),
                    "decay": z((s_pad, s_pad + 1), torch.float32)}
        self.g_kind = z(g_pad, I32)
        self.g_idx = z((g_pad, f_pad), I64)
        self.salts = z((f_pad, 1), I64)
        self.start, self.stop, self.step, self.gc = (z(1, I64) for _ in range(4))
        self.lt_col = z(f_pad, I64)
        self.live = z((f_pad, 5), I32)
        self.active, self.trans, self.dirty, self.miss = (z(f_pad, torch.bool)
                                                          for _ in range(4))
        self.anyd, self.heavy = z((), torch.bool), z((), I64)
        self.frung, self.nd = z((), I32), z((), I64)
        k = max(FleetProgram.MEMO_PER_LANE * f_pad, FleetProgram.MEMO_MIN)
        self.memo_key = z((k, self.st.n_osds), I32)
        self.memo = tuple(z((k,) + getattr(self.st, f).shape[1:], getattr(self.st, f).dtype)
                          for f in _PEER_FIELDS)
        self.memo_slots = torch.arange(k, dtype=I64, device=dev)
        self.memo_n, self.n_dirty = z(1, I64), z(1, I64)

    def fits(self, f_pad: int, s_pad: int, g_pad: int) -> bool:
        return f_pad == self.f_pad and s_pad <= self.s_pad and g_pad <= self.g_pad

    def load(self, fstate: ClusterState, fs) -> None:
        """Copy a window's starting state (and ring, when given) in."""
        for name in _state_names(self.st):
            _get(self.st, name).copy_(_get(fstate, name))
        if self.fs is not None and fs is not None:
            self.fs.ring.copy_(fs.ring)
            self.fs.head.copy_(fs.head)

    def scratch(self) -> "_FleetCarry":
        """A copy of every buffer (the warm-up's)."""
        from ..obs.flight import FlightState

        w = copy.copy(self)
        for k, v in vars(self).items():
            if isinstance(v, torch.Tensor):
                setattr(w, k, v.clone())
        w.tab = {k: v.clone() for k, v in self.tab.items()}
        w.memo = tuple(v.clone() for v in self.memo)
        w.st = _clone_state(self.st)
        if self.fs is not None:
            w.fs = FlightState(ring=self.fs.ring.clone(), head=self.fs.head.clone())
        return w


class FleetProgram(_GraphProgram):
    """The compiled fleet window of one :class:`FleetDriver` (the
    reference's vmapped ``lax.scan``, ``_build_fleet_scan``), every
    decision of the fleet epoch made on the device.

    - On the card it is one CUDA graph (:mod:`ceph_tpu_torch.core.graphs`,
      captured and replayed as the one-cluster program's): a WHILE node
      over the window's steps whose body applies the epoch's tape edits
      (a WHILE node over its edit groups, each group's ``_LANE_EDITS``
      edit a SWITCH node on its kind, the groups in the host plan's apply
      order, so a ``down`` and an ``up`` of one OSD in one epoch never
      land in one scatter), ticks the detector under an IF node on any
      lane being active (each lane's decay from the run's decay table at
      its last tick), moves the epoch lanes by the tape's bumps and the
      tick's transitions, peers the dirty lanes under an IF node on any
      being dirty, steps the traffic of every lane, and writes the rows
      (and the per-lane ring) in place.  A run copies its tables in (no
      sync), replays once and copies the rows, state and ring out: no
      wrapper call and no read.  Timelines in the same buckets (the
      fleet pad, the steps, the edit groups) replay the same graph;
      another pad or larger tables capture anew.
    - On the CPU the same body runs eagerly, each decision one host read
      of its predicate.

    **Peering** keeps the host loop's memo on the device: a dirty lane
    whose pool key (:meth:`FleetDriver._keys`) the run already peered
    copies that result from the carry's memo, and a WHILE node peers the
    first lane of each new key through the template's dense peering
    (K3), writes it into every dirty lane of that key and into the memo's
    next slot.  The reference's lane ladder (a batched peering a rung)
    needs a ``_peer_hist`` with a lane axis, which the port's has not:
    the ring's rung and peer-cycle lanes report the reference's rung,
    computed on the device."""

    #: the memo's slots: this many a lane, and at least MEMO_MIN (a run
    #: with more keys reuses the oldest slots, and peers those keys again)
    MEMO_PER_LANE = 2
    MEMO_MIN = 64

    def __init__(self, fd: "FleetDriver", *, flight: bool):
        super().__init__(fd.driver, flight=flight)
        self.fd = fd
        self._carry: _FleetCarry | None = None

    def peer_counts(self) -> dict:
        """The last run's dirty lane-epochs, peerings and reused peerings
        (one read)."""
        c = self._carry
        if c is None:
            return {"dirty_lane_epochs": 0, "peered": 0, "peer_reused": 0}
        n_dirty, peered = torch.cat([c.n_dirty, c.memo_n]).tolist()
        return {"dirty_lane_epochs": n_dirty, "peered": peered,
                "peer_reused": n_dirty - peered}

    # -- a run -------------------------------------------------------------

    def _tables(self, n_epochs: int, tapes: list[EventTape]) -> dict:
        """The run's tables on the host (see :class:`_FleetCarry`), from
        the host plan of its tape windows and the template's step
        tables."""
        fd = self.fd
        drv = fd.driver
        f_pad, n = len(tapes), n_epochs
        nows = np.array([drv._now_of(e) for e in range(n)], np.float64)
        plan = _tape_plan(tapes, nows, drv._init_state.n_osds)
        base, _dev = drv._tables(n)
        groups = [g for ep in plan.edits for g in ep]
        g_kind = np.zeros(len(groups), np.int32)
        g_idx = np.zeros((len(groups), f_pad), np.int64)
        for gi, (kind, a, b) in enumerate(groups):
            g_kind[gi] = kind
            g_idx[gi] = plan.flat[a]
            g_idx[gi, :b - a] = plan.flat[a:b]
        counts = np.array([len(ep) for ep in plan.edits], np.int64)
        fd._decay_table(n)
        return {
            "now": base["now"][:n], "now32": base["now32"][:n], "cap": base["cap"][:n],
            "scrub": base["scrub"][:n],
            "ssalt": np.arange(n, dtype=np.int64) * _SALT_STEP,
            "g_hi": np.cumsum(counts), "g_lo": np.cumsum(counts) - counts,
            "bumps": plan.bumps.astype(np.int32), "tdirty": plan.tape_dirty,
            "cursor": plan.stops.astype(np.int32), "decay": fd._decay_host[:n, :n + 1],
            "g_kind": g_kind, "g_idx": g_idx, "nows": nows,
            "pads": (f_pad, _pad_to(max(n, 16)), _pad_to(max(len(groups), 16))),
        }

    def _carry_for(self, pads) -> _FleetCarry:
        """The carry of the run's buckets, made anew (the graph released)
        for another fleet pad or larger tables."""
        f_pad, s_pad, g_pad = pads
        c = self._carry
        if c is None or not c.fits(*pads):
            if self.graph is not None:
                self.graph.release()
                self.graph = None
            if c is not None and c.f_pad == f_pad:
                s_pad, g_pad = max(s_pad, c.s_pad), max(g_pad, c.g_pad)
            c = self._carry = _FleetCarry(self.fd, f_pad, s_pad, g_pad, self.flight)
            self._ladder = self.fd._lane_widths(f_pad)
            self._peer_widths = uploaded(np.array(self._ladder + (f_pad,), np.int64),
                                         self.fd.device)
        return c

    def run(self, n_epochs: int, tapes: list[EventTape], salts: torch.Tensor, *,
            start: int = 0, stop: int | None = None, fstate: ClusterState | None = None,
            fs=None, compiled: bool | None = None):
        """:meth:`FleetDriver._run` through the program (a replay, or
        with ``compiled=False`` the body eagerly): ``(state,
        FleetRows)``, the rows' epoch and dirty lanes on the device."""
        from ..obs.flight import FlightState

        fd = self.fd
        compiled = self.compiled if compiled is None else bool(compiled)
        n_epochs = int(n_epochs)
        stop = n_epochs if stop is None else int(stop)
        f_pad = len(tapes)
        fs = fs if self.flight else None
        fstate = fd._fleet_state(f_pad) if fstate is None else fstate
        fd.stats = {"path": "graph" if compiled else "eager", "reads": 0}
        if stop <= start:
            fd.flight = fs
            width = sum(w for _f, w, _d in _packed_layout())
            return fstate, FleetRows(np.zeros(0, np.float64), np.zeros((0, f_pad), np.int32),
                                     np.zeros((0, f_pad), np.int32),
                                     torch.zeros((0, f_pad, width), dtype=I32, device=fd.device))
        host = self._tables(n_epochs, tapes)
        c = self._carry_for(host.pop("pads"))
        nows = host.pop("nows")
        decay = np.zeros((n_epochs, c.s_pad + 1), np.float32)
        decay[:, :n_epochs + 1] = host.pop("decay")
        host["decay"] = decay
        g_kind, g_idx = host.pop("g_kind"), host.pop("g_idx")
        if len(g_kind):
            upload(c.g_kind[:len(g_kind)], g_kind)
            upload(c.g_idx[:len(g_idx)], g_idx)
        for k, v in host.items():
            upload(c.tab[k][:n_epochs], v)
        c.salts.copy_(salts)
        c.load(fstate, fs)
        c.start.fill_(start)
        c.stop.fill_(stop)
        if compiled:
            self._replay(c)
        else:
            self._begin(c)
            for e in range(start, stop):
                c.step.fill_(e)
                self._step(c)
        fd.stats.update(captures=self.captures, replays=self.replays)
        lanes = c.rows[start:stop].clone()
        fd.flight = (None if fs is None
                     else FlightState(ring=c.fs.ring.clone(), head=c.fs.head.clone()))
        return _clone_state(c.st), FleetRows(nows[start:stop], None, None,
                                             lanes[..., :c.width], lanes)

    # -- the graph's hooks -------------------------------------------------------

    def _scratch(self, c: _FleetCarry) -> _FleetCarry:
        return c.scratch()

    def _at(self, c: _FleetCarry, name: str) -> torch.Tensor:
        """The table ``name``'s entry for ``c.step`` (absolute)."""
        return c.tab[name].index_select(0, c.step)

    def _warm_branches(self, w: _FleetCarry) -> None:
        """Every branch the body may take: each tape edit, the tick, and
        a dirty lane peered (the memo's hit and new-key paths)."""
        self._warm_edits(w, w.g_idx[0])
        self._tick(w, self._at(w, "now"), self._at(w, "now32"))
        w.dirty.zero_()
        w.dirty.narrow(0, 0, 1).fill_(True)
        self._peer(w)
        self._peer(w)
        self._record(w, torch.zeros((w.f_pad, w.width), dtype=I32, device=self.fd.device))

    # -- the fleet epoch, its decisions on the device -------------------------

    def _begin(self, c: _FleetCarry) -> None:
        """The window's first step, each lane's last tick as its
        decay-table column (0: ``t0``; ``s + 1``: epoch ``s``), and an
        empty memo."""
        drv = self.fd.driver
        super()._begin(c)
        c.lt_col.copy_(torch.round((c.st.last_tick - drv.t0) / drv.dt).to(I64))
        c.memo_n.zero_()
        c.n_dirty.zero_()

    def _step(self, c: _FleetCarry) -> None:
        """Step ``c.step`` of every lane, in place."""
        from ..core import graphs

        drv, st = self.fd.driver, c.st

        def at(name):
            return self._at(c, name)

        now, now32 = at("now"), at("now32")
        # the tape: the epoch's edit groups in apply order
        flat = {k: v.view(-1) for k, v in _tape_lanes(st).items()}
        exists = st.pool.osd_exists.view(-1)
        c.gc.copy_(at("g_lo"))
        hi = at("g_hi")

        def group():
            idx = c.g_idx.index_select(0, c.gc).reshape(-1)
            graphs.switch(c.g_kind.index_select(0, c.gc),
                          [functools.partial(edit, flat, idx, now32, exists)
                           for edit in _LANE_EDITS])
            c.gc.add_(1)

        graphs.loop(lambda: c.gc < hi, group)
        # the liveness tick of the active lanes (the others keep their state)
        c.active.copy_(st.suppressed.any(-1) | st.slow.any(-1) | st.down.any(-1)
                       | (st.laggy != 0).any(-1))
        c.live.zero_()
        c.trans.zero_()
        graphs.cond(c.active.any().reshape(1), lambda: self._tick(c, now, now32))
        st.epoch.add_(at("bumps").reshape(-1) + c.trans.to(I32))
        c.dirty.copy_(at("tdirty").reshape(-1) | c.trans)
        graphs.cond(c.dirty.any().reshape(1), lambda: self._peer(c))
        salt = (c.salts + at("ssalt")) & _M32
        traffic = drv._traffic_core(st, salt, at("cap").reshape(()))
        row = drv._row(st, traffic, c.live, at("scrub"))
        meta = torch.stack([st.epoch, c.dirty.to(I32)], dim=-1)
        c.rows.index_copy_(0, c.step, torch.cat([row, meta], dim=-1).unsqueeze(0))
        st.now.copy_(now.expand(c.f_pad))
        st.step.copy_(c.step.expand(c.f_pad))
        st.tape_cursor.copy_(at("cursor").reshape(-1))
        self._record(c, row)

    def _tick(self, c: _FleetCarry, now, now32) -> None:
        drv, st, j = self.fd.driver, c.st, c.step
        decay = c.tab["decay"].index_select(0, j).reshape(-1).index_select(0, c.lt_col)
        new, live, flags = drv._tick(st, now32.reshape(()), decay[:, None])
        a = c.active[:, None]
        for name in _TICK_NAMES:
            lane = _get(st, name)
            lane.copy_(torch.where(a, _get(new, name), lane))
        c.live.copy_(torch.where(a, live, 0))
        c.trans.copy_(flags[:, 0] & c.active)
        st.last_tick.copy_(torch.where(c.active, now, st.last_tick))
        c.lt_col.copy_(torch.where(c.active, j + 1, c.lt_col))

    def _peer(self, c: _FleetCarry) -> None:
        """The dirty lanes: those whose pool key the run peered before
        from the memo, then a WHILE node over the new keys."""
        from ..core import graphs

        st = c.st
        keys = FleetDriver._keys(st)
        valid = c.memo_slots < c.memo_n
        seen = (keys[:, None, :] == c.memo_key[None]).all(-1) & valid
        hit = seen.any(-1) & c.dirty
        slot = seen.to(I32).argmax(-1)
        for f, memo in zip(_PEER_FIELDS, c.memo):
            lane = getattr(st, f)
            lane.copy_(torch.where(_lanes(hit, lane), memo.index_select(0, slot), lane))
        c.n_dirty.add_(c.dirty.sum(dtype=I64))
        c.miss.copy_(c.dirty & ~hit)
        graphs.loop(lambda: c.miss.any().reshape(1), lambda: self._peer_new(c, keys))

    def _peer_new(self, c: _FleetCarry, keys: torch.Tensor) -> None:
        """The first missed lane peered through the dense peering, its
        outputs written into every missed lane of its key and the memo."""
        st = c.st
        lane = c.miss.to(I32).argmax().reshape(1)
        key = keys.index_select(0, lane)
        pool = replace(st.pool, **{f.name: getattr(st.pool, f.name).index_select(0, lane)[0]
                                   for f in fields(st.pool)})
        same = (keys == key).all(-1) & c.miss
        slot = c.memo_n.remainder(c.memo_key.shape[0])
        for f, v, memo in zip(_PEER_FIELDS, self.fd.driver._peer_outs(pool), c.memo):
            out = getattr(st, f)
            out.copy_(torch.where(_lanes(same, out), v.unsqueeze(0), out))
            memo.index_copy_(0, slot, v.unsqueeze(0))
        c.memo_key.index_copy_(0, slot, key)
        c.memo_n.add_(1)
        c.miss.copy_(c.miss & ~same)

    def _flight_row(self, c: _FleetCarry, row: torch.Tensor, wrow=None) -> torch.Tensor:
        """The ring's rows with the lane ladder's probe (one value an
        epoch: the count of dirty lanes and the rung the reference takes
        for it, :meth:`FleetDriver._record` on the device)."""
        from ..core.cluster_state import ladder_rung_device

        c.nd.copy_(c.dirty.sum(dtype=I64))
        c.anyd.copy_(c.dirty.any())
        c.frung.copy_(torch.where(c.anyd, ladder_rung_device(c.nd, self._ladder), -1))
        return super()._flight_row(c, row, wrow)


def _lanes(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``[F]`` lane mask shaped to broadcast over ``like`` ``[F, ...]``."""
    return mask.view((-1,) + (1,) * (like.dim() - 1))


def run_fleet(
    m: OSDMap,
    scenario: str,
    n_clusters: int,
    n_epochs: int,
    *,
    seed: int = 0,
    jitter: float = 0.25,
    **driver_kwargs,
) -> FleetSeries:
    """Convenience one-shot: sample ``n_clusters`` timelines of a named
    scenario and advance them together (``device=`` among the driver
    kwargs; the card by default)."""
    drv = FleetDriver(m, seed=seed, **driver_kwargs)
    tls = drv.sample(n_clusters, scenario, jitter=jitter)
    return drv.run_fleet(n_epochs, tls)
