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
- :class:`FleetDriver` advances every lane one epoch at a time with a
  host loop (the reference's one ``lax.scan`` over a vmapped body).

How one fleet epoch runs
------------------------

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

Every lane equals its own one-cluster run bit for bit
(:meth:`FleetDriver.run_sequential`, and a plain ``EpochDriver``):
held in ``tests/test_torch_fleet.py`` over the chaos zoo.  Outputs land
as a :class:`FleetSeries` (the ``EpochSeries`` fields with a second,
fleet axis), which :mod:`~ceph_tpu_torch.recovery.durability` reduces.
With the template driver's flight recorder on, a per-lane ring
(``[F_pad, R, L]``) records every lane's epoch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

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
    _MAP_KINDS,
    _SERIES_FIELDS,
    EpochDriver,
    EpochRows,
    EpochSeries,
    EventTape,
    _host_bits,
    _packed_layout,
    compile_event_tape,
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
    the device (:func:`~ceph_tpu_torch.recovery.superstep._packed_layout`)."""

    now: np.ndarray      # f64 [n]  (the clock is shared)
    epoch: np.ndarray    # i32 [n, fleet_pad]
    dirty: np.ndarray    # i32 [n, fleet_pad]
    packed: torch.Tensor

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
        return cls.from_rows(rows.now, rows.epoch, rows.dirty, rows.packed.cpu().numpy(),
                             n_clusters)

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

    idx: torch.Tensor | None          # int64 flat lane * n_osds + osd
    edits: list                       # [epoch] -> [(kind, start, stop)]
    tape_dirty: np.ndarray            # bool [n, F]: a map row applied
    bumps: np.ndarray                 # int [n, F]: epoch advances
    sup_any: np.ndarray               # bool [n, F]: any suppressed after
    slow_any: np.ndarray              # bool [n, F]: any slow after
    cursor: np.ndarray                # int [F]: cursors after the run


def _tape_plan(tapes: list[EventTape], nows: np.ndarray, n_osds: int, dev) -> _TapePlan:
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
    idx = (torch.from_numpy(np.concatenate(flat)).to(dev) if flat else None)
    return _TapePlan(idx=idx, edits=edits, tape_dirty=tape_dirty, bumps=bumps,
                     sup_any=sup_any, slow_any=slow_any, cursor=lo.copy())


class FleetDriver:
    """One map geometry, one template driver, N lanes advanced together.

    Owns a template :class:`EpochDriver` built on an empty timeline: it
    contributes the epoch-body pieces and the seeded initial state,
    never a tape.  Every driver kwarg (geometry, knobs, config, mix,
    ``rho_recovery``, ``device``) passes through to the template, so the
    whole fleet shares them; what varies per lane is the timeline and
    the traffic seed.

    - :meth:`run_fleet` advances all ``F_pad`` lanes one epoch at a time
      (pad lanes are cropped);
    - :meth:`run_sequential` runs one lane at a time through the
      template's ``_epoch_step_with``, the one-cluster baseline.

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
        return torch.from_numpy(salts).to(self.device)

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
            tab = self._decay_tab = torch.from_numpy(host).to(self.device)
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

    def _run(self, n_epochs: int, tapes: list[EventTape], salts: torch.Tensor, *,
             start: int = 0, stop: int | None = None, fstate: ClusterState | None = None,
             fs=None):
        """Advance ``len(tapes)`` lanes through epochs ``start .. stop -
        1`` of an ``n_epochs`` run (the whole run by default) from
        ``fstate`` (the initial fleet by default; a state a chunk or a
        restore wrote, whose scalars and down/laggy bits rebuild the
        host's view with one read).  With a flight state ``fs`` the
        per-lane ring records each epoch (:attr:`flight` afterwards).
        Returns ``(state, FleetRows)``, the state's scalars set for the
        chunk's end."""
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
        self.stats = {"reads": 0, "dirty_lane_epochs": 0, "peered": 0, "peer_reused": 0}
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
    ):
        """Advance every timeline ``n_epochs`` epochs together.  Returns a
        cropped :class:`FleetSeries`, or with ``pull=False`` the
        ``(state, rows)`` pair still on the device (:class:`FleetRows`).
        With the template driver's flight recorder on, a per-lane ring
        rides the run (:attr:`flight` afterwards; drained into
        ``journal`` when given) without touching the series lanes."""
        from ..obs.flight import empty_flight, journal_drain

        tls = list(timelines)
        tapes = [compile_event_tape(tl, self.m) for tl in tls]
        ftape = stack_tapes(tapes)
        salts = self._salts(len(tls), ftape.fleet_pad, seeds)
        lanes = tapes + [_empty_tape()] * (ftape.fleet_pad - len(tapes))
        fs = (empty_flight(self.driver.flight_ring_epochs, fleet=ftape.fleet_pad,
                           device=self.device) if self.driver.flight_on else None)
        state, rows = self._run(int(n_epochs), lanes, salts, fs=fs)
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
    ) -> list[EpochSeries]:
        """N one-cluster runs through the template's ``_epoch_step_with``
        (tape and salt as arguments, dense peering), one at a time.  Equal
        to ``EpochDriver(m, timeline_i, seed=seed_i).run_superstep(
        n_epochs)`` per cluster: the same body, and the pad rows sit past
        every epoch's window."""
        tls = list(timelines)
        seeds = self._seeds(len(tls), seeds)
        tapes = [compile_event_tape(tl, self.m) for tl in tls]
        r_pad = _pad_to(max(max((len(tp) for tp in tapes), default=1), 1))
        if rows_pad is not None:
            r_pad = max(r_pad, int(rows_pad))
        drv = self.driver
        out = []
        for tp, sd in zip(tapes, seeds):
            tape = _padded_tape(tp, r_pad)
            state, host = drv._init_state, drv._init_host.copy()
            now, epoch, dirty, packed = [], [], [], []
            for e in range(int(n_epochs)):
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
