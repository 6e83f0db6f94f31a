"""Divergent multi-rank chaos in one process: per-rank views, merged.

The counterpart of the reference package's ``recovery/reconcile.py``,
for one process on one device.  Monitors and OSDs *observe* the same
failure at different times and converge through epoch-ordered map
exchange; this module simulates that:

- **Rank-scoped chaos specs** (parsed by :mod:`.failure`):
  ``rankdelay:<rank>.<ms>`` delays when one simulation rank *sees*
  every event from the spec's schedule time on; ``rankdrop:<rank>``
  suppresses that rank's failure reports at the merge;
  ``rankstall:<rank>.<epochs>`` freezes the rank for a window of
  global epochs.  :func:`rank_schedule`, :func:`rank_view_timeline`,
  :func:`strip_rank_specs` and :class:`RankSchedule` are host code,
  copied.
- **Per-rank views**: each rank advances its own
  :class:`~ceph_tpu_torch.core.cluster_state.ClusterState` through the
  epoch loop's body (``EpochDriver._epoch_step_with``: its own skewed
  tape as an argument, dense peering, K3 on the card), with its own
  host view; on the card through the template's
  :class:`~ceph_tpu_torch.recovery.superstep.TapeProgram` (one load of
  the rank's tape, one graph replay a chunk; the view then stale).  Reconciliation never writes into a rank's view: the
  merged view is a separate consensus output.
- **Reconciliation rounds**: every ``reconcile_every_epochs`` epochs
  the views merge through element-wise lattice joins (torch ops):
  epoch/last-ack/laggy lanes take ``max``; down bits merge under the
  reporter quorum (``mon_osd_min_down_reporters``), then OR;
  ``down_since`` takes the earliest quorum-backed stamp; map-owned
  lanes (pool tables, peering outputs, PG histograms) adopt the
  highest-epoch owner, ties resolved by element-wise ``max``.  The port
  carries the reference's u32 lanes (the survivor mask, checksums) in
  int64, so their lattice bottom is 0, the reference's unsigned bottom.
- **The protocol** (:class:`ReconcileProtocol`, copied): divergence
  retries under seeded exponential backoff in virtual epochs, the
  laggy deadline, the ``rankstalled`` flag, journal and health notes,
  and :class:`~ceph_tpu_torch.analysis.runtime_guard.RankStalledError` for a
  rank that never comes back.  A revived rank replays its own missed
  window through the same body (bit-exact, no state injection).

``run(store=..., crashes=...)`` snapshots every rank's view at each
reconciliation boundary (:mod:`~ceph_tpu_torch.recovery.checkpoint`).

One process a rank: :class:`RankReconciler` advances this rank's view
and joins each round's collectives over a
:class:`~ceph_tpu_torch.parallel.mesh.Mesh` — :class:`ViewMerger`'s
lattice joins as ``pmax``/``pmin`` on owner-masked lanes, and the
progress rows all-gathered, so every rank computes the same verdicts
(and raises :class:`RankStalledError` in the same round).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..analysis.runtime_guard import (
    RankDivergenceError,
    RankStalledError,
    assert_rank_identical,
    rank_checks_enabled,
    rank_fingerprint,
)
from ..common.config import global_config
from ..core.cluster_state import ClusterState, _pad_to, index_state, stack_states, view_delta
from ..osdmap.map import OSDMap
from ..osdmap.mapping import PoolMapState
from .chaos import ChaosEvent, ChaosTimeline
from .failure import FailureSpec, check_rank
from .fleet import _padded_tape
from .liveness import ClusterFlags
from .superstep import EpochDriver, compile_event_tape, pick_path

__all__ = [
    "DivergentDriver",
    "DivergentResult",
    "RankDivergenceError",
    "RankReconciler",
    "RankSchedule",
    "RankStalledError",
    "RoundResult",
    "ViewMerger",
    "merge_stacked",
    "merge_views",
    "normalize_view",
    "rank_schedule",
    "rank_view_timeline",
    "strip_rank_specs",
    "view_fingerprint",
]


# ---------------------------------------------------------------------------
# rank-scoped spec extraction: skewed timelines and rank schedules


@dataclass(frozen=True)
class RankSchedule:
    """One rank's observation-skew directives, decoded from the shared
    timeline (every rank parses the same timeline, so schedules are
    global knowledge)."""

    rank: int
    #: ``(t_sched, delay_s)`` — from ``t_sched`` on, this rank sees
    #: events ``delay_s`` late; multiple directives accumulate
    delays: tuple[tuple[float, float], ...]
    #: ``(t_begin, t_end)`` — report suppression windows (``rankdrop``;
    #: an unmatched ``drop`` runs to +inf)
    drops: tuple[tuple[float, float], ...]
    #: ``(t_sched, epochs)`` — freeze windows (``rankstall``)
    stalls: tuple[tuple[float, int], ...]

    def skew_at(self, t: float) -> float:
        """Total observation delay applied to an event scheduled at
        ``t`` (the sum of every directive already in force)."""
        return sum(d for ts, d in self.delays if ts <= t)

    def reporting(self, t: float) -> bool:
        """False while a ``rankdrop`` window covers ``t``."""
        return not any(b <= t < e for b, e in self.drops)

    def stall_windows(self, t0: float, dt: float) -> tuple[
        tuple[int, int], ...
    ]:
        """Freeze windows in global step space: ``(s0, s0 + epochs)``
        pairs — the rank executes no step ``s`` with ``s0 <= s < s1``
        until the global step counter passes ``s1`` (then it replays
        the whole missed span: the delta-tape catch-up)."""
        out = []
        for t, epochs in self.stalls:
            s0 = max(int(math.ceil((t - t0) / dt)) - 1, 0)
            # epochs == 0 means permanent (the documented rankstall
            # encoding): the window never closes
            s1 = s0 + int(epochs) if epochs else sys.maxsize
            out.append((s0, s1))
        return tuple(out)


def _stall_allowed(
    windows: tuple[tuple[int, int], ...], target: int
) -> int:
    """How far a rank may execute when the global step counter reads
    ``target``: while ``target`` sits inside a freeze window the rank
    parks at the window's start; once the counter passes the window's
    end the whole missed span replays in one go (delta-tape catch-up).
    Iterated to a fixpoint so chained windows compose."""
    allowed = target
    changed = True
    while changed:
        changed = False
        for s0, s1 in windows:
            if s0 < allowed < s1:
                allowed = s0
                changed = True
    return allowed


def _rank_events(timeline: ChaosTimeline, n_ranks: int):
    """``(t, spec)`` pairs for every rank-scoped spec, validated
    against ``n_ranks`` (loud, like every other spec family)."""
    out = []
    for ev in timeline.events():
        for spec in ev.specs:
            if spec.is_rank:
                check_rank(spec, n_ranks)
                out.append((ev.t, spec))
    return out


def strip_rank_specs(timeline: ChaosTimeline) -> ChaosTimeline:
    """The shared cluster timeline with every rank-scoped spec removed
    — the reference a converged run must be bit-equal to."""
    events = []
    for ev in timeline.events():
        specs = tuple(s for s in ev.specs if not s.is_rank)
        if specs:
            events.append(ChaosEvent(ev.t, specs))
    return ChaosTimeline(events)


def rank_schedule(
    timeline: ChaosTimeline, rank: int, n_ranks: int
) -> RankSchedule:
    """Decode one rank's skew/drop/stall directives from the shared
    timeline (validating EVERY rank spec on the way, so a bad spec for
    any rank fails every rank identically)."""
    delays: list[tuple[float, float]] = []
    drops: list[tuple[float, float]] = []
    stalls: list[tuple[float, int]] = []
    open_drop: float | None = None
    for t, spec in _rank_events(timeline, n_ranks):
        if spec.rank() != rank:
            continue
        if spec.scope == "rankdelay":
            delays.append((t, spec.rank_arg() / 1000.0))
        elif spec.scope == "rankdrop":
            if spec.action == "drop":
                if open_drop is None:
                    open_drop = t
            else:
                if open_drop is not None:
                    drops.append((open_drop, t))
                    open_drop = None
        elif spec.scope == "rankstall":
            stalls.append((t, spec.rank_arg()))
    if open_drop is not None:
        drops.append((open_drop, float("inf")))
    return RankSchedule(
        rank=rank, delays=tuple(delays), drops=tuple(drops),
        stalls=tuple(stalls),
    )


def rank_view_timeline(
    timeline: ChaosTimeline, rank: int, n_ranks: int
) -> ChaosTimeline:
    """The cluster timeline as ONE rank observes it: rank specs
    stripped, and every event scheduled at ``t`` shifted to
    ``t + skew_at(t)``.  The shift is non-decreasing in ``t``, so
    replay order is preserved."""
    sched = rank_schedule(timeline, rank, n_ranks)
    events = []
    for ev in timeline.events():
        specs = tuple(s for s in ev.specs if not s.is_rank)
        if specs:
            events.append(ChaosEvent(ev.t + sched.skew_at(ev.t), specs))
    return ChaosTimeline(events)


# ---------------------------------------------------------------------------
# the merge algebra: normalize, then join on the normalized domain


def _obs_bottom(x: torch.Tensor) -> torch.Tensor:
    """The lattice bottom for a max-joined observation lane (what a
    non-reporting contributor is neutralized to).  int64 lanes carry
    the reference's u32 values, so their bottom is 0."""
    if x.dtype == torch.bool or x.dtype == torch.int64:
        return torch.zeros_like(x)
    if x.dtype.is_floating_point:
        return torch.full_like(x, torch.finfo(x.dtype).min)
    return torch.full_like(x, torch.iinfo(x.dtype).min)


def _as_flag(report, device) -> torch.Tensor:
    """A report bit as a 0-d bool tensor on ``device`` (a fill for a
    host bool, no copy)."""
    if isinstance(report, torch.Tensor):
        return report.to(torch.bool)
    return torch.full((), bool(report), dtype=torch.bool, device=device)


def _normalize(view: ClusterState, report, min_reporters) -> ClusterState:
    """Project a view onto the merge domain: down bits gated by the
    reporter quorum (injected downs carry ``ALWAYS_REPORTED`` and always
    pass), ``down_since`` zeroed where not down, and — when ``report``
    is False (a ``rankdrop`` window) — every observation lane collapsed
    to its lattice bottom.  A projection: applying it twice is applying
    it once, which makes the join idempotent on the normalized domain."""
    report = _as_flag(report, view.down.device)
    quorum = view.reporters >= int(min_reporters)
    down = view.down & quorum & report
    return replace(
        view,
        down=down,
        down_since=torch.where(down, view.down_since, 0.0),
        last_ack=torch.where(report, view.last_ack, _obs_bottom(view.last_ack)),
        laggy=torch.where(report, view.laggy, 0.0),
        markdowns=torch.where(report, view.markdowns, 0.0),
        suppressed=view.suppressed & report,
        slow=view.slow & report,
        out=view.out & report,
        reporters=torch.where(report, view.reporters, 0),
    )


def _max(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x | y if x.dtype == torch.bool else torch.maximum(x, y)


def _join(a: ClusterState, b: ClusterState) -> ClusterState:
    """Element-wise lattice join of two NORMALIZED views: commutative
    and associative by construction (every lane is a max, an OR, a
    quorum-masked min, or an owner-select whose tie-break is
    element-wise max), idempotent on the normalized domain."""
    ka, kb = a.epoch, b.epoch

    def own(x, y):
        # map-owned lanes: the highest-epoch owner's value; ties take
        # the element-wise max (symmetric, so the join commutes)
        return torch.where(ka > kb, x, torch.where(kb > ka, y, _max(x, y)))

    if (a.checksums is None) != (b.checksums is None):
        raise ValueError(
            "cannot join a view with a checksum table into one without"
        )
    down = a.down | b.down
    inf = float("inf")
    cand = torch.minimum(
        torch.where(a.down, a.down_since, inf),
        torch.where(b.down, b.down_since, inf),
    )
    pool = PoolMapState(**{f.name: own(getattr(a.pool, f.name), getattr(b.pool, f.name))
                           for f in fields(PoolMapState)})
    return replace(
        a,
        pool=pool,
        last_ack=torch.maximum(a.last_ack, b.last_ack),
        laggy=torch.maximum(a.laggy, b.laggy),
        markdowns=torch.maximum(a.markdowns, b.markdowns),
        down=down,
        down_since=torch.where(down, cand, 0.0),
        suppressed=a.suppressed | b.suppressed,
        slow=a.slow | b.slow,
        out=a.out | b.out,
        reporters=torch.maximum(a.reporters, b.reporters),
        up=own(a.up, b.up),
        up_primary=own(a.up_primary, b.up_primary),
        acting=own(a.acting, b.acting),
        acting_primary=own(a.acting_primary, b.acting_primary),
        flags=own(a.flags, b.flags),
        survivor_mask=own(a.survivor_mask, b.survivor_mask),
        n_alive=own(a.n_alive, b.n_alive),
        pg_hist=own(a.pg_hist, b.pg_hist),
        pg_aux=own(a.pg_aux, b.pg_aux),
        checksums=(
            None if a.checksums is None else own(a.checksums, b.checksums)
        ),
        epoch=torch.maximum(a.epoch, b.epoch),
        now=torch.maximum(a.now, b.now),
        last_tick=torch.maximum(a.last_tick, b.last_tick),
        # rank-local cursors: meaningless in a consensus view (each
        # rank's cursor indexes its OWN skewed tape) — max keeps the
        # algebra total and the output rank-identical
        tape_cursor=torch.maximum(a.tape_cursor, b.tape_cursor),
        step=torch.maximum(a.step, b.step),
    )


def normalize_view(
    view: ClusterState, *, min_reporters: int = 1, report: bool = True
) -> ClusterState:
    """Public projection onto the merge domain (see :func:`_normalize`)."""
    return _normalize(view, report, min_reporters)


def merge_views(
    a: ClusterState,
    b: ClusterState,
    *,
    min_reporters: int = 1,
    report_a: bool = True,
    report_b: bool = True,
) -> ClusterState:
    """Merge two rank views: normalize each (quorum gating + rankdrop
    masking), then join.  Order-free: ``merge(a, b) == merge(b, a)``,
    and any reduction order over N views lands on the same consensus."""
    return _join(
        _normalize(a, report_a, min_reporters),
        _normalize(b, report_b, min_reporters),
    )


def merge_stacked(stacked: ClusterState, report, min_reporters) -> ClusterState:
    """Merge R stacked views (:func:`stack_states` layout: every tensor
    ``[R, ...]``) into one consensus view.  ``report`` is a ``[R]`` bool
    lane (a tensor or host bools; False = the rank is inside a
    ``rankdrop`` window)."""
    n = int(stacked.epoch.shape[0])
    views = [index_state(stacked, i) for i in range(n)]
    merged = _normalize(views[0], report[0], min_reporters)
    for i in range(1, n):
        merged = _join(merged, _normalize(views[i], report[i], min_reporters))
    return merged


#: epoch-versioned lanes a converged rank must agree on bit-exactly —
#: time-stamped observation lanes (last_ack/down_since/laggy/markdowns/
#: last_tick) are deliberately excluded: cross-epoch skew leaves them
#: carrying the observer's stamp, while these lanes are pure functions
#: of the applied event prefix
_FP_LANES = (
    "down", "suppressed", "slow", "out",
    "up", "up_primary", "acting", "acting_primary",
    "flags", "survivor_mask", "n_alive", "pg_hist", "pg_aux",
    "epoch", "step",
)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def view_fingerprint(state) -> int:
    """Convergence fingerprint of one rank's view (on any device; its
    lanes are read back — the between-rounds seam): CRC over the
    epoch-versioned lanes plus the pool mapping tables.  It hashes the
    port's dtypes, so its value differs from the reference's where the
    dtypes differ; equal views give equal fingerprints in either."""
    pool = state.pool
    # torchlint: disable=J003  # the view fingerprint hashes each lane on the host (round seam)
    return rank_fingerprint(*(_host(x) for x in (
        pool.osd_up, pool.osd_exists, pool.osd_weight, pool.primary_affinity,
        *(getattr(state, f) for f in _FP_LANES))))


# ---------------------------------------------------------------------------
# the reconciliation protocol


@dataclass(frozen=True)
class RoundResult:
    """One reconciliation round's verdict (computed from the per-rank
    progress and fingerprint vectors)."""

    round: int
    target_step: int
    steps: tuple[int, ...]         # per-rank executed-step counters
    epochs: tuple[int, ...]        # per-rank map epochs
    fingerprints: tuple[int, ...]  # per-rank view fingerprints
    laggy: tuple[int, ...]         # ranks currently marked laggy
    converged: bool                # live ranks agree on (step,epoch,fp)
    diverged: bool                 # live ranks at same (step, epoch)
    #                                but different fingerprints after
    #                                the bounded retry loop
    retries: int                   # divergence retries spent
    backoff_epochs: int            # extra epochs the retries advanced


@dataclass
class DivergentResult:
    """A full divergent run: per-round audit plus the final consensus."""

    rounds: list[RoundResult]
    merged: ClusterState
    states: list[ClusterState]
    converged: bool
    laggy: tuple[int, ...]
    total_steps: int

    def detection_to_convergence_rounds(self) -> int | None:
        """Rounds from the first skew-visible round (live ranks not in
        agreement) to the next agreeing round — the detection-to-
        convergence latency ``config6 --divergent`` records.  None when
        no round ever diverged."""
        first = next(
            (r.round for r in self.rounds if not r.converged), None
        )
        if first is None:
            return None
        after = next(
            (r.round for r in self.rounds
             if r.round > first and r.converged), None,
        )
        if after is None:
            return len(self.rounds) - first
        return after - first


class ReconcileProtocol:
    """Host-side round bookkeeping: stall counting, laggy marking, the
    ``rankstalled`` flag, journal/health notes, and the seeded backoff
    schedule (a copy of the reference's).  Fed only rank-identical
    inputs (the per-rank progress vectors), so every rank that runs it
    reaches the same verdict at the same round."""

    def __init__(
        self,
        n_ranks: int,
        *,
        config=None,
        seed: int = 0,
        journal=None,
        health=None,
        flags: ClusterFlags | None = None,
    ):
        cfg = config or global_config()
        self.n_ranks = int(n_ranks)
        self.every = int(cfg.get("reconcile_every_epochs"))
        self.deadline = int(cfg.get("reconcile_deadline_epochs"))
        self.retry_max = int(cfg.get("recovery_retry_max"))
        self.backoff_base_s = (
            float(cfg.get("recovery_backoff_base_ms")) / 1000.0
        )
        self.journal = journal
        self.health = health
        self.flags = flags if flags is not None else ClusterFlags()
        self.rng = np.random.default_rng(seed)
        self.stall_rounds = np.zeros(self.n_ranks, np.int64)
        self.laggy: set[int] = set()
        self._prev_steps: np.ndarray | None = None

    def backoff_epochs(self, attempt: int, dt: float) -> int:
        """Seeded exponential backoff, expressed in epochs of virtual
        time (the executor's formula over ``dt``-sized steps)."""
        b = (
            self.backoff_base_s
            * (2.0 ** max(attempt - 1, 0))
            * (1.0 + self.rng.random())
        )
        return max(1, int(math.ceil(b / max(dt, 1e-9))))

    def live(self) -> list[int]:
        return [r for r in range(self.n_ranks) if r not in self.laggy]

    def agreement(self, steps, epochs, fps) -> tuple[bool, bool]:
        """(converged, divergence_candidate) over the live ranks:
        converged = all agree on (step, epoch, fingerprint); a
        divergence candidate agrees on progress but not on content
        (same step AND epoch, different fingerprints) — lattice
        staleness (one rank behind) is neither."""
        live = self.live()
        if len(live) <= 1:
            return True, False
        s0, e0, f0 = steps[live[0]], epochs[live[0]], fps[live[0]]
        same_progress = all(
            steps[r] == s0 and epochs[r] == e0 for r in live[1:]
        )
        same_fp = all(fps[r] == f0 for r in live[1:])
        return (same_progress and same_fp), (same_progress and not same_fp)

    def observe(
        self, round_idx: int, target_step: int,
        steps, epochs, fps, now: float,
        *, retries: int = 0, backoff: int = 0,
    ) -> RoundResult:
        """Fold one round's vectors into the protocol state: stall
        counters, laggy transitions, flag/journal/health surfacing — and
        the verdict.  Raises on a permanently-dead rank."""
        steps = np.asarray(steps, np.int64)
        epochs = np.asarray(epochs, np.int64)
        fps = np.asarray(fps, np.int64)
        if self._prev_steps is not None:
            advanced = steps > self._prev_steps
            self.stall_rounds = np.where(
                advanced, 0, self.stall_rounds + 1
            )
            for r in sorted(self.laggy):
                if advanced[r]:
                    self.laggy.discard(r)
                    if self.journal is not None:
                        self.journal.event(
                            "reconcile.revived", rank=r, t=now,
                            round=round_idx, step=int(steps[r]),
                        )
            if not self.laggy and "rankstalled" in self.flags:
                self.flags.clear("rankstalled")
        self._prev_steps = steps
        for r in range(self.n_ranks):
            if r in self.laggy:
                continue
            if int(self.stall_rounds[r]) >= self.deadline:
                self.laggy.add(r)
                self.flags.set("rankstalled")
                if self.journal is not None:
                    self.journal.event(
                        "reconcile.laggy", rank=r, t=now,
                        round=round_idx,
                        stalled_rounds=int(self.stall_rounds[r]),
                    )
                if self.health is not None:
                    self.health.note_rank_stall(
                        r, int(self.stall_rounds[r])
                    )
        dead = sorted(
            r for r in self.laggy
            if int(self.stall_rounds[r]) >= self.deadline + self.retry_max
        )
        converged, diverged = self.agreement(steps, epochs, fps)
        result = RoundResult(
            round=round_idx, target_step=int(target_step),
            steps=tuple(int(s) for s in steps),
            epochs=tuple(int(e) for e in epochs),
            fingerprints=tuple(int(f) for f in fps),
            laggy=tuple(sorted(self.laggy)),
            converged=converged, diverged=diverged,
            retries=retries, backoff_epochs=backoff,
        )
        if self.health is not None:
            self.health.note_rank_round(
                n_live=len(self.live()),
                laggy=len(self.laggy), diverged=diverged,
            )
        if self.journal is not None:
            self.journal.event(
                "reconcile.round", round=round_idx, t=now,
                target_step=int(target_step),
                steps=[int(s) for s in steps],
                epochs=[int(e) for e in epochs],
                laggy=sorted(self.laggy), converged=converged,
                diverged=diverged, retries=retries,
            )
        if dead:
            if self.journal is not None:
                self.journal.event(
                    "reconcile.stalled", ranks=dead, t=now,
                    round=round_idx,
                    stalled_rounds=[
                        int(self.stall_rounds[r]) for r in dead
                    ],
                )
            raise RankStalledError(
                f"rank(s) {dead} made no progress for "
                f"{int(self.stall_rounds[dead[0]])} reconcile rounds "
                f"(deadline {self.deadline} + {self.retry_max} backoff "
                f"retries exhausted) — every rank raises this at round "
                f"{round_idx}; survivors hold the last merged view"
            )
        return result


# ---------------------------------------------------------------------------
# in-process divergent ranks


def _advance_view(drv: EpochDriver, state: ClusterState, host, tape, start: int,
                  stop: int, *, path: str = "host") -> ClusterState:
    """Epochs ``start .. stop - 1`` of one view through the template
    driver's epoch body with the rank's own tape (rows dropped), with
    the state's scalars set after.

    With ``path="graph"`` (the card's) or ``"eager"`` the template's
    :class:`~ceph_tpu_torch.recovery.superstep.TapeProgram` runs them:
    one ``load`` of the rank's tape and the driver's salt, then one
    replay a chunk (or its body eagerly); ``host`` then keeps only the
    clock and the cursor (``host.stale``).  With ``"host"`` the
    host-decided body (``_epoch_step_with``), the view rebuilt from the
    state with one read when a program left it stale."""
    if path != "host":
        prog = drv.compile_tape_program()
        prog.load(tape, drv.salt_base)
        state, _fs, _rows = prog._advance(state, host, start, stop,
                                          compiled=path == "graph")
        return state
    if host.stale:
        fresh = drv.host_view(state)
        for f in fields(host):
            setattr(host, f.name, getattr(fresh, f.name))
    for e in range(start, stop):
        state, _row = drv._epoch_step_with(state, host, e, tape, drv.salt_base)
    return drv._with_scalars(state, host)


def _rank_tapes(m: OSDMap, timeline: ChaosTimeline, n_ranks: int):
    """Every rank's skewed tape, padded to one shared width (the pad
    lanes are inert): ``(r_pad, [tape per rank])``."""
    tapes = [compile_event_tape(rank_view_timeline(timeline, r, n_ranks), m)
             for r in range(n_ranks)]
    r_pad = _pad_to(max(max(len(tp) for tp in tapes), 1))
    return r_pad, [_padded_tape(tp, r_pad) for tp in tapes]


class DivergentDriver:
    """R simulated ranks in ONE process: each advances its own
    :class:`ClusterState` (and host view) through the template
    driver's ``_epoch_step_with`` with its own skewed tape, and
    reconciliation rounds merge the views with :func:`merge_stacked`.
    All protocol bookkeeping lives in :class:`ReconcileProtocol`.
    Driver kwargs (``device=`` among them; the card by default) pass
    through to the template :class:`EpochDriver`; ``path`` (one of
    ``superstep.PATHS``, :attr:`path` afterwards) picks how each rank's
    epochs run: the tape program's graph (the card's default), its body
    eagerly, or the host-decided body (the CPU's default)."""

    def __init__(
        self,
        m: OSDMap,
        timeline: ChaosTimeline,
        n_ranks: int,
        *,
        config=None,
        journal=None,
        health=None,
        flags: ClusterFlags | None = None,
        seed: int = 0,
        path: str | None = None,
        **driver_kwargs,
    ):
        cfg = config or global_config()
        self.n_ranks = int(n_ranks)
        if self.n_ranks < 1:
            raise ValueError(f"need >= 1 rank, got {n_ranks}")
        self.schedules = [
            rank_schedule(timeline, r, self.n_ranks)
            for r in range(self.n_ranks)
        ]
        base = strip_rank_specs(timeline)
        self.driver = EpochDriver(
            m, base, seed=seed, config=cfg, **driver_kwargs
        )
        #: how each rank's epochs run (``superstep.PATHS``): the tape
        #: program's graph on the card, the host-decided body on the CPU
        self.path = pick_path(self.driver.device, path)
        self._r_pad, self._tapes = _rank_tapes(m, timeline, self.n_ranks)
        self.states = [
            self.driver._init_state for _ in range(self.n_ranks)
        ]
        self.hosts = [self.driver._init_host.copy() for _ in range(self.n_ranks)]
        self.cur = [0] * self.n_ranks
        self.min_reporters = int(cfg.get("mon_osd_min_down_reporters"))
        self.protocol = ReconcileProtocol(
            self.n_ranks, config=cfg, seed=seed, journal=journal,
            health=health, flags=flags,
        )
        self.journal = journal
        self.merged: ClusterState | None = None

    # -- stall-aware advance ------------------------------------------

    def _steps(self, state: ClusterState, host, tape, start: int, stop: int) -> ClusterState:
        return _advance_view(self.driver, state, host, tape, start, stop, path=self.path)

    def _allowed(self, rank: int, target: int) -> int:
        return _stall_allowed(
            self.schedules[rank].stall_windows(
                self.driver.t0, self.driver.dt
            ),
            target,
        )

    def _advance(self, rank: int, target: int) -> None:
        allowed = self._allowed(rank, target)
        if allowed <= self.cur[rank]:
            return
        catch_up = rank in self.protocol.laggy
        old = self.states[rank] if catch_up else None
        state = self._steps(self.states[rank], self.hosts[rank], self._tapes[rank],
                            self.cur[rank], allowed)
        self.states[rank] = state
        self.cur[rank] = allowed
        if catch_up and self.journal is not None:
            self.journal.event(
                "reconcile.catchup", rank=rank,
                **view_delta(old, state).to_json(),
            )

    def _now_at(self, target: int) -> float:
        return self.driver.t0 + target * self.driver.dt

    # -- one round -----------------------------------------------------

    def _merge(self, now: float) -> ClusterState:
        report = [self.schedules[r].reporting(now) for r in range(self.n_ranks)]
        return merge_stacked(stack_states(self.states), report, self.min_reporters)

    def _gather(self):
        """(steps, epochs, fingerprints) per rank (the between-rounds
        seam: each view's lanes read back once)."""
        steps = [self.cur[r] for r in range(self.n_ranks)]
        epochs = [int(s.epoch) for s in self.states]
        # the between-rounds seam: each rank's view read back once a round
        # torchlint: disable=J003
        fps = [view_fingerprint(s) for s in self.states]
        return steps, epochs, fps

    def reconcile_round(
        self, round_idx: int, target: int
    ) -> RoundResult:
        """Advance every rank toward ``target``, merge, and fold the
        round into the protocol — with the bounded divergence-retry
        loop: live ranks at the same progress but different content
        re-advance under seeded backoff until they agree or the retry
        budget drains."""
        proto = self.protocol
        for r in range(self.n_ranks):
            self._advance(r, target)
        now = self._now_at(target)
        self.merged = self._merge(now)
        steps, epochs, fps = self._gather()
        retries = 0
        backoff_total = 0
        converged, diverged = proto.agreement(steps, epochs, fps)
        while diverged and retries < proto.retry_max:
            retries += 1
            extra = proto.backoff_epochs(retries, self.driver.dt)
            backoff_total += extra
            target += extra
            for r in proto.live():
                self._advance(r, target)
            now = self._now_at(target)
            self.merged = self._merge(now)
            # the between-rounds seam: each rank's view read back once a round
            # torchlint: disable=J003
            steps, epochs, fps = self._gather()
            converged, diverged = proto.agreement(steps, epochs, fps)
        result = proto.observe(
            round_idx, target, steps, epochs, fps, now,
            retries=retries, backoff=backoff_total,
        )
        if result.diverged and rank_checks_enabled():
            raise RankDivergenceError(
                f"round {round_idx}: live ranks at step "
                f"{result.steps} / epoch {result.epochs} hold "
                f"different views after {retries} backoff retries "
                f"(fingerprints {result.fingerprints})"
            )
        return result

    # -- the run -------------------------------------------------------

    def run(self, n_epochs: int, *, store=None,
            crashes=()) -> DivergentResult:
        """Drive all ranks ``n_epochs`` epochs with a reconciliation
        round every ``reconcile_every_epochs``.  While a rank is
        laggy, extra backoff rounds continue past the epoch budget
        (bounded by ``recovery_retry_max``) so a permanent stall
        surfaces as :class:`RankStalledError` rather than silence.

        With a :class:`~ceph_tpu_torch.recovery.checkpoint.CheckpointStore`,
        every reconciliation boundary commits a fleet-consistent snapshot
        (all rank views stacked, plus the protocol's verdict state) and a
        fresh call restores from the newest valid one, the revived views
        fingerprint-guarded against the snapshot.  ``crashes`` seeds
        :class:`~ceph_tpu_torch.recovery.checkpoint.CrashPoint` kills at
        those boundaries."""
        proto = self.protocol
        rounds: list[RoundResult] = []
        target = 0
        round_idx = 0
        extra_rounds = 0
        n_epochs = int(n_epochs)
        sched = None
        if store is not None:
            from .checkpoint import _CrashSchedule, restore_divergent, save_divergent

            sched = _CrashSchedule(crashes)
            meta = restore_divergent(store, self)
            if meta is not None:
                target = int(meta["target"])
                round_idx = int(meta["round_idx"])
                extra_rounds = int(meta["extra_rounds"])
                rounds = [
                    RoundResult(
                        round=int(r["round"]),
                        target_step=int(r["target_step"]),
                        steps=tuple(r["steps"]),
                        epochs=tuple(r["epochs"]),
                        fingerprints=tuple(r["fingerprints"]),
                        laggy=tuple(r["laggy"]),
                        converged=bool(r["converged"]),
                        diverged=bool(r["diverged"]),
                        retries=int(r["retries"]),
                        backoff_epochs=int(r["backoff_epochs"]),
                    )
                    for r in meta["rounds"]
                ]
                # the merge is a pure function of the restored views
                self.merged = self._merge(self._now_at(target))

        def _boundary():
            # the reconciliation-boundary checkpoint, with the seeded
            # kill points positioned around its write
            if store is None:
                return
            sched.fire(target, "before")
            during = sched.due(target, "during")
            if during is not None:
                store._crash_hook = lambda phase: during.fire()
            try:
                save_divergent(store, self, round_idx=round_idx, target=target,
                               extra_rounds=extra_rounds, rounds=rounds)
            finally:
                store._crash_hook = None
            sched.fire(target, "after")

        while target < n_epochs:
            target = min(target + proto.every, n_epochs)
            rounds.append(self.reconcile_round(round_idx, target))
            target = max(target, max(self.cur))
            round_idx += 1
            _boundary()
        # drive to resolution: while a rank lags (stalled but not yet
        # past the deadline, laggy awaiting revival, or views not yet
        # in agreement) the survivors keep advancing under seeded
        # backoff — virtual-time sleep — until the rank catches up,
        # the views agree, or the protocol raises RankStalledError.
        # Bounded: stall counters cap the laggy branch, the extra-
        # round counter caps the rest.
        while rounds and (proto.laggy or not rounds[-1].converged):
            if proto.laggy:
                attempt = max(1, max(
                    int(proto.stall_rounds[r]) - proto.deadline + 1
                    for r in sorted(proto.laggy)
                ))
            else:
                extra_rounds += 1
                if extra_rounds > proto.deadline + proto.retry_max:
                    break
                attempt = extra_rounds
            target += proto.backoff_epochs(attempt, self.driver.dt)
            rounds.append(self.reconcile_round(round_idx, target))
            target = max(target, max(self.cur))
            round_idx += 1
            _boundary()
        last = rounds[-1] if rounds else None
        return DivergentResult(
            rounds=rounds,
            merged=self.merged,
            states=list(self.states),
            converged=bool(last.converged) if last else True,
            laggy=tuple(sorted(proto.laggy)),
            total_steps=max(self.cur) if self.cur else 0,
        )

    def reference_state(self, n_epochs: int) -> ClusterState:
        """The single-rank unskewed reference: the stripped timeline
        driven through the same body (so a converged rank's view must be
        bit-equal to it)."""
        drv = self.driver
        return self._steps(drv._init_state, drv._init_host.copy(),
                           _padded_tape(drv.tape, self._r_pad), 0, int(n_epochs))


# ---------------------------------------------------------------------------
# multi-process: one process per rank, merged through collectives


def _bottom(x: torch.Tensor) -> torch.Tensor:
    """The value below every value of ``x``'s dtype (a non-owner's
    contribution to an owner-select max)."""
    if x.dtype.is_floating_point:
        return torch.full_like(x, -math.inf)
    return torch.full_like(x, torch.iinfo(x.dtype).min)


class ViewMerger:
    """The multi-process merge over a mesh: each rank contributes its
    own view, and every rank gets the same consensus.

    :meth:`merge` normalizes the local view, then runs the join as
    collectives: the epoch and the observation lanes take ``pmax`` (bool
    lanes as OR), ``down_since`` the ``pmin`` of the quorum-backed
    stamps, and the map-owned lanes ``pmax`` over the highest-epoch
    owners only (non-owners masked to the dtype's bottom) — the
    reference's ``sel_max``, equal to the in-process join's owner rule
    with its element-wise-max tie break.  :meth:`gather_rows`
    all-gathers the small per-rank progress rows the protocol's verdicts
    come from."""

    def __init__(self, mesh):
        self.mesh = mesh

    def merge(self, state: ClusterState, report, min_reporters: int) -> ClusterState:
        """One merge: ``state`` is this rank's view, ``report`` its bool
        report bit for the round (False inside a ``rankdrop`` window)."""
        mesh = self.mesh
        n = _normalize(state, bool(report), min_reporters)
        kmax = mesh.pmax(n.epoch)
        owner = n.epoch == kmax

        def sel_max(lane):
            if lane.dtype == torch.bool:
                return mesh.pmax(lane & owner)
            return mesh.pmax(torch.where(owner, lane, _bottom(lane)))

        down = mesh.pmax(n.down)
        cand = mesh.pmin(torch.where(n.down, n.down_since, math.inf))
        pool = PoolMapState(**{f.name: sel_max(getattr(n.pool, f.name))
                               for f in fields(PoolMapState)})
        return replace(
            n,
            pool=pool,
            last_ack=mesh.pmax(n.last_ack),
            laggy=mesh.pmax(n.laggy),
            markdowns=mesh.pmax(n.markdowns),
            down=down,
            down_since=torch.where(down, cand, 0.0).to(n.down_since.dtype),
            suppressed=mesh.pmax(n.suppressed),
            slow=mesh.pmax(n.slow),
            out=mesh.pmax(n.out),
            reporters=mesh.pmax(n.reporters),
            up=sel_max(n.up),
            up_primary=sel_max(n.up_primary),
            acting=sel_max(n.acting),
            acting_primary=sel_max(n.acting_primary),
            flags=sel_max(n.flags),
            survivor_mask=sel_max(n.survivor_mask),
            n_alive=sel_max(n.n_alive),
            pg_hist=sel_max(n.pg_hist),
            pg_aux=sel_max(n.pg_aux),
            checksums=None if n.checksums is None else sel_max(n.checksums),
            epoch=kmax,
            now=mesh.pmax(n.now),
            last_tick=mesh.pmax(n.last_tick),
            tape_cursor=mesh.pmax(n.tape_cursor),
            step=mesh.pmax(n.step),
        )

    def gather_rows(self, row) -> np.ndarray:
        """All-gather one small int64 row per rank -> ``[n_ranks, k]``
        on every rank (the protocol's rank-identical input)."""
        t = torch.as_tensor(np.asarray(row, np.int64), device=self.mesh.device)
        return self.mesh.gather_stack(t).cpu().numpy()


class RankReconciler:
    """One process-rank's side of the divergent protocol: advances its
    own skewed view through the epoch body (as :class:`DivergentDriver`
    advances each of its ranks: the template driver of the rank-free
    timeline, this rank's padded tape) and joins every reconciliation
    round's collectives.  All verdicts derive from all-gathered progress
    rows, so laggy marking, backoff schedules and
    :class:`RankStalledError` land on every rank at the same round — the
    stall-tolerant degradation contract.  ``rank`` and ``n_ranks``
    default to the mesh's (one process a rank: they must match it);
    driver kwargs pass to the template :class:`EpochDriver`, on the
    mesh's device."""

    def __init__(
        self,
        m: OSDMap,
        timeline: ChaosTimeline,
        *,
        rank: int | None = None,
        n_ranks: int | None = None,
        mesh=None,
        config=None,
        journal=None,
        health=None,
        flags: ClusterFlags | None = None,
        seed: int = 0,
        path: str | None = None,
        **driver_kwargs,
    ):
        from ..parallel import multihost

        cfg = config or global_config()
        device = driver_kwargs.pop("device", "cuda")
        self.mesh = mesh if mesh is not None else multihost.global_mesh(device=device)
        self.rank = self.mesh.rank if rank is None else int(rank)
        self.n_ranks = self.mesh.size if n_ranks is None else int(n_ranks)
        check_rank(FailureSpec("rankdrop", str(self.rank), "drop"), self.n_ranks)
        if (self.rank, self.n_ranks) != (self.mesh.rank, self.mesh.size):
            raise ValueError(
                f"rank {self.rank} of {self.n_ranks}: one process a rank, but this "
                f"process is rank {self.mesh.rank} of a {self.mesh.size}-rank mesh")
        self.merger = ViewMerger(self.mesh)
        # every rank decodes EVERY schedule (global knowledge: the report
        # mask and stall windows must be rank-identical inputs)
        self.schedules = [
            rank_schedule(timeline, r, self.n_ranks) for r in range(self.n_ranks)
        ]
        self.driver = EpochDriver(m, strip_rank_specs(timeline), seed=seed, config=cfg,
                                  device=self.mesh.device, **driver_kwargs)
        self.path = pick_path(self.driver.device, path)
        _r_pad, tapes = _rank_tapes(m, timeline, self.n_ranks)
        self._tape = tapes[self.rank]
        self.state = self.driver._init_state
        self.host = self.driver._init_host.copy()
        self.cur = 0
        self.min_reporters = int(cfg.get("mon_osd_min_down_reporters"))
        self.protocol = ReconcileProtocol(
            self.n_ranks, config=cfg, seed=seed, journal=journal,
            health=health, flags=flags,
        )
        self.journal = journal
        self.merged: ClusterState | None = None

    def _allowed(self, target: int) -> int:
        return _stall_allowed(
            self.schedules[self.rank].stall_windows(self.driver.t0, self.driver.dt),
            target,
        )

    def _advance(self, target: int) -> None:
        allowed = self._allowed(target)
        if allowed <= self.cur:
            return
        catch_up = self.rank in self.protocol.laggy
        old = self.state if catch_up else None
        self.state = _advance_view(self.driver, self.state, self.host, self._tape,
                                   self.cur, allowed, path=self.path)
        self.cur = allowed
        if catch_up and self.journal is not None:
            self.journal.event(
                "reconcile.catchup", rank=self.rank,
                **view_delta(old, self.state).to_json(),
            )

    def _round_io(self, now: float):
        """One round's collectives: merge + progress gather.  Every rank
        enters BOTH collectives every round (a simulated stall freezes
        the view's content, never the process's participation — that is
        what keeps stalls from deadlocking)."""
        self.merged = self.merger.merge(
            self.state, self.schedules[self.rank].reporting(now), self.min_reporters)
        rows = self.merger.gather_rows(
            [self.cur, int(self.state.epoch), view_fingerprint(self.state)])
        if rank_checks_enabled():
            assert_rank_identical(
                "reconcile.merged", self.merged.epoch, self.merged.down,
                self.merged.acting, self.merged.pg_hist, mesh=self.mesh)
        return rows[:, 0].tolist(), rows[:, 1].tolist(), rows[:, 2].tolist()

    def _now_at(self, target: int) -> float:
        return self.driver.t0 + target * self.driver.dt

    def reconcile_round(self, round_idx: int, target: int) -> RoundResult:
        proto = self.protocol
        self._advance(target)
        now = self._now_at(target)
        steps, epochs, fps = self._round_io(now)
        retries = 0
        backoff_total = 0
        converged, diverged = proto.agreement(steps, epochs, fps)
        while diverged and retries < proto.retry_max:
            retries += 1
            extra = proto.backoff_epochs(retries, self.driver.dt)
            backoff_total += extra
            target += extra
            if self.rank in proto.live():
                self._advance(target)
            now = self._now_at(target)
            # the between-rounds seam: each rank's view read back once a round
            # torchlint: disable=J003
            steps, epochs, fps = self._round_io(now)
            converged, diverged = proto.agreement(steps, epochs, fps)
        result = proto.observe(
            round_idx, target, steps, epochs, fps, now,
            retries=retries, backoff=backoff_total,
        )
        if result.diverged and rank_checks_enabled():
            raise RankDivergenceError(
                f"round {round_idx}: live ranks at step "
                f"{result.steps} / epoch {result.epochs} hold "
                f"different views after {retries} backoff retries "
                f"(fingerprints {result.fingerprints})"
            )
        return result

    def run(self, n_epochs: int) -> DivergentResult:
        """Drive this rank ``n_epochs`` epochs with a reconciliation
        round every ``reconcile_every_epochs`` and, while a rank lags,
        the bounded backoff rounds past the budget (see
        :meth:`DivergentDriver.run`: every rank evaluates the same loop
        condition from the gathered rounds, so all take the same
        rounds)."""
        proto = self.protocol
        rounds: list[RoundResult] = []
        target = 0
        round_idx = 0
        n_epochs = int(n_epochs)
        while target < n_epochs:
            target = min(target + proto.every, n_epochs)
            rounds.append(self.reconcile_round(round_idx, target))
            target = max(target, max(rounds[-1].steps))
            round_idx += 1
        extra_rounds = 0
        while rounds and (proto.laggy or not rounds[-1].converged):
            if proto.laggy:
                attempt = max(1, max(
                    int(proto.stall_rounds[r]) - proto.deadline + 1
                    for r in sorted(proto.laggy)
                ))
            else:
                extra_rounds += 1
                if extra_rounds > proto.deadline + proto.retry_max:
                    break
                attempt = extra_rounds
            target += proto.backoff_epochs(attempt, self.driver.dt)
            rounds.append(self.reconcile_round(round_idx, target))
            target = max(target, max(rounds[-1].steps))
            round_idx += 1
        last = rounds[-1] if rounds else None
        return DivergentResult(
            rounds=rounds,
            merged=self.merged,
            states=[self.state],
            converged=bool(last.converged) if last else True,
            laggy=tuple(sorted(proto.laggy)),
            total_steps=self.cur,
        )
