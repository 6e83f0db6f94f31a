"""Chaos timeline engine: continuous failure schedules on a seeded clock.

The fault injector (:mod:`ceph_tpu_torch.recovery.failure`) delivers one-shot
failures; real clusters — and the reference's ``OSDMonitor`` epoch
stream — deliver them *continuously*: flapping NICs, cascading rack
loss, and fresh faults landing while a repair is still in flight.  This
module drives exactly that: a :class:`ChaosTimeline` is a sorted
``(t, FailureSpec...)`` schedule, a :class:`ChaosEngine` owns the live
map plus a deterministic :class:`VirtualClock`, and the supervised
executor (:class:`ceph_tpu_torch.recovery.executor.SupervisedRecovery`) polls
it between — and across — its peer/plan/decode phases.

Everything is deterministic by construction: the clock is virtual (no
wall time), timelines are explicit, and the only randomness (retry
jitter) comes from a seeded generator — two runs of the same scenario
produce identical retry counts, plan revisions, and final PG states
(asserted in tests/test_torch_supervised.py).

Named scenarios (:func:`build_scenario`, the CLI/bench ``--chaos``
surface):

- ``flap``             — an OSD flaps down/up ``cycles`` times: the
  degraded set appears, shrinks, and vanishes as the device returns;
  exercises plan invalidation by *restored* survivors.
- ``rack-cascade``     — a rack dies host by host, one epoch per host:
  each epoch deepens existing erasure patterns mid-repair.
- ``mid-repair-loss``  — a host fails, its repair starts, then the
  whole surrounding rack fails while the repair is in flight (the
  acceptance scenario).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..osdmap.map import Incremental, OSDMap
from .failure import (
    BitrotEvent,
    FailureSpec,
    inject,
    parse_spec,
    resolve_targets,
)
from .liveness import ClusterFlags, LivenessDetector


class VirtualClock:
    """Deterministic manual clock: ``now``/``sleep`` drop into any
    ``clock=``/``sleep=`` seam (token bucket, backoff, chaos engine).
    Time only moves when something explicitly advances it."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot sleep {seconds}s")
        self._now += seconds

    advance = sleep


@dataclass(frozen=True)
class ChaosEvent:
    """One timeline entry: at virtual time ``t``, inject ``specs`` as
    ONE epoch (multiple specs batch into a single Incremental, the way
    the mon batches simultaneous failure reports)."""

    t: float
    specs: tuple[FailureSpec, ...]


class ChaosTimeline:
    """An ordered, consumable schedule of failure events.

    Construction sorts by time with a stable tiebreak on insertion
    order, so two timelines built from the same pairs replay
    identically.
    """

    def __init__(self, events: list[ChaosEvent] | None = None):
        self._events = sorted(
            events or [], key=lambda e: e.t
        )  # sorted() is stable: equal-t events keep insertion order

    @classmethod
    def from_pairs(cls, pairs) -> "ChaosTimeline":
        """``[(t, spec), ...]`` where spec is a string, a FailureSpec,
        or a list of either (one epoch)."""
        events = []
        for t, spec in pairs:
            if isinstance(spec, (str, FailureSpec)):
                spec = [spec]
            specs = tuple(
                parse_spec(s) if isinstance(s, str) else s for s in spec
            )
            events.append(ChaosEvent(float(t), specs))
        return cls(events)

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> tuple[ChaosEvent, ...]:
        """Non-consuming view of the pending schedule, in replay order
        (the event-tape compiler's input: the superstep pre-stages the
        whole timeline on device without draining it)."""
        return tuple(self._events)

    def peek_next(self) -> float | None:
        """Time of the next pending event, or None when exhausted."""
        return self._events[0].t if self._events else None

    def due(self, now: float) -> list[ChaosEvent]:
        """Pop every event with ``t <= now``, in order."""
        out = []
        while self._events and self._events[0].t <= now:
            out.append(self._events.pop(0))
        return out


SCENARIOS = (
    "flap", "rack-cascade", "mid-repair-loss", "silent-bitrot",
    "scrub-storm", "flapping-osd",
    "ssd-steady", "ssd-burst", "ssd-skew",
)


def _pool_geometry(m: OSDMap) -> tuple[int, int]:
    """(pg_num, size) of the lowest-id pool — the PG space the bitrot
    scenarios corrupt into."""
    if not m.pools:
        raise ValueError("map has no pools")
    pool = m.pools[min(m.pools)]
    return int(pool.pg_num), int(pool.size)


def _rack_and_hosts(m: OSDMap, rack_name: str | None) -> tuple[str, list[str]]:
    """A rack bucket name plus its child host bucket names, in stable
    (CRUSH item) order."""
    racks = sorted(
        b.name for b in m.crush.buckets.values()
        if m.crush.types[b.type_id] == "rack"
    )
    if not racks:
        raise ValueError("map has no rack buckets")
    rack = rack_name or racks[0]
    rb = m.crush.bucket_by_name(rack)
    hosts = [
        m.crush.buckets[i].name for i in rb.items
        if i < 0 and m.crush.types[m.crush.buckets[i].type_id] == "host"
    ]
    if not hosts:
        raise ValueError(f"rack {rack!r} has no host buckets")
    return rack, hosts


def build_scenario(
    name: str,
    m: OSDMap,
    start_s: float = 0.25,
    period_s: float = 1.0,
    cycles: int = 3,
    rack: str | None = None,
) -> ChaosTimeline:
    """Named chaos scenario -> timeline, parameterized by the map's
    own topology (first rack by default)."""
    if name == "flap":
        # one OSD of the target rack flaps down/up `cycles` times
        _, hosts = _rack_and_hosts(m, rack)
        osd = resolve_targets(m, FailureSpec("host", hosts[0], "down"))[0]
        pairs: list[tuple[float, object]] = []
        t = start_s
        for _ in range(cycles):
            pairs.append((t, FailureSpec("osd", str(osd), "down")))
            pairs.append((t + period_s / 2, FailureSpec("osd", str(osd), "up")))
            t += period_s
        return ChaosTimeline.from_pairs(pairs)
    if name == "rack-cascade":
        rname, hosts = _rack_and_hosts(m, rack)
        return ChaosTimeline.from_pairs([
            (start_s + i * period_s, FailureSpec("host", h, "down_out"))
            for i, h in enumerate(hosts)
        ])
    if name == "mid-repair-loss":
        rname, hosts = _rack_and_hosts(m, rack)
        return ChaosTimeline.from_pairs([
            (start_s, FailureSpec("host", hosts[0], "down_out")),
            # the surrounding rack falls while the host repair is in
            # flight (already-down OSDs contribute nothing: xor-safe)
            (start_s + period_s, FailureSpec("rack", rname, "down_out")),
        ])
    if name == "silent-bitrot":
        # no map events at all: `cycles` corruption events trickle in
        # across distinct PGs/shards, invisible to peering — only a
        # scrub pass can find them.  Offsets/masks are index-derived
        # so the scenario is deterministic without an RNG.
        pg_num, size = _pool_geometry(m)
        pairs = []
        for i in range(cycles):
            ev = BitrotEvent(
                pg=(7 * i + 3) % pg_num,
                shard=i % size,
                offset=11 * i,
                mask=1 + (37 * i) % 255,
            )
            pairs.append((
                start_s + i * period_s,
                FailureSpec("bitrot", str(ev), "corrupt"),
            ))
        return ChaosTimeline.from_pairs(pairs)
    if name == "scrub-storm":
        # a burst of corruption lands across many PGs in one event
        # (so one scrub pass floods the "scrub" QoS class with repair
        # demand), then a host dies mid-scrub: scrub-triggered repair
        # and failure-triggered repair contend for bandwidth.
        pg_num, size = _pool_geometry(m)
        _, hosts = _rack_and_hosts(m, rack)
        burst = [
            FailureSpec(
                "bitrot",
                str(BitrotEvent(
                    pg=(5 * i + 1) % pg_num,
                    shard=(3 * i) % size,
                    offset=13 * i,
                    mask=1 + (91 * i) % 255,
                )),
                "corrupt",
            )
            for i in range(max(4 * cycles, 8))
        ]
        return ChaosTimeline.from_pairs([
            (start_s, burst),
            (start_s + period_s, FailureSpec("host", hosts[0], "down_out")),
        ])
    if name == "flapping-osd":
        # the OBSERVED twin of "flap": one OSD's heartbeats cut and
        # restored `cycles` times, with NO map events scheduled at all
        # — every epoch in the run comes from the liveness detector,
        # so the markdown-log damper's epoch-churn savings are
        # directly measurable (damped vs undamped runs of this same
        # timeline).  The drop window is 3/4 of the period: longer
        # than one base grace, shorter than a once-doubled one.
        _, hosts = _rack_and_hosts(m, rack)
        osd = resolve_targets(m, FailureSpec("host", hosts[0], "down"))[0]
        pairs = []
        t = start_s
        for _ in range(cycles):
            pairs.append((t, FailureSpec("netsplit", str(osd), "drop")))
            pairs.append(
                (t + 0.75 * period_s,
                 FailureSpec("netsplit", str(osd), "restore"))
            )
            t += period_s
        return ChaosTimeline.from_pairs(pairs)
    if name == "ssd-steady":
        # the arXiv:1709.05365 steady-state SSD-array profile's failure
        # half (its traffic half is the same-named TrafficMix):
        # independent device churn — a drive dies and is auto-outed,
        # its replacement comes up a few periods later, a second drive
        # on another host dies near the end of the window
        _, hosts = _rack_and_hosts(m, rack)
        a = resolve_targets(m, FailureSpec("host", hosts[0], "down"))[0]
        b_host = hosts[1 % len(hosts)]
        b = resolve_targets(m, FailureSpec("host", b_host, "down"))[0]
        return ChaosTimeline.from_pairs([
            (start_s, FailureSpec("osd", str(a), "down_out")),
            (start_s + 3 * period_s, [
                FailureSpec("osd", str(a), "up"),
                FailureSpec("osd", str(a), "in"),
            ]),
            (start_s + 5 * period_s, FailureSpec("osd", str(b), "down_out")),
        ])
    if name == "ssd-burst":
        # the ingest-burst profile: a correlated host loss lands inside
        # a write burst, a second host's drive browns out (down, then
        # back) while the first repair is still in flight
        _, hosts = _rack_and_hosts(m, rack)
        h0 = hosts[0]
        b_host = hosts[1 % len(hosts)]
        b = resolve_targets(m, FailureSpec("host", b_host, "down"))[0]
        return ChaosTimeline.from_pairs([
            (start_s + period_s, FailureSpec("host", h0, "down_out")),
            (start_s + 2 * period_s, FailureSpec("osd", str(b), "down")),
            (start_s + 3 * period_s, FailureSpec("osd", str(b), "up")),
        ])
    if name == "ssd-skew":
        # the hot-spot profile: the drive under the skewed read set
        # goes slow (late acks) for `cycles` windows, then dies for
        # good — tail latency degrades before availability does
        _, hosts = _rack_and_hosts(m, rack)
        osd = resolve_targets(m, FailureSpec("host", hosts[0], "down"))[0]
        pairs: list[tuple[float, object]] = []
        t = start_s
        for _ in range(cycles):
            pairs.append((t, FailureSpec("slow", str(osd), "drop")))
            pairs.append(
                (t + 0.5 * period_s,
                 FailureSpec("slow", str(osd), "restore"))
            )
            t += period_s
        pairs.append((t, FailureSpec("osd", str(osd), "down_out")))
        return ChaosTimeline.from_pairs(pairs)
    raise ValueError(f"unknown chaos scenario {name!r}; one of {SCENARIOS}")


@dataclass
class AppliedEvent:
    """Audit-trail entry: what :meth:`ChaosEngine.poll` injected."""

    t: float
    epoch: int
    specs: tuple[FailureSpec, ...]
    incremental: Incremental


@dataclass
class AppliedCorruption:
    """Audit-trail entry for one applied bitrot event, stamped with the
    map epoch it landed under (the epoch does NOT advance — silent
    corruption is invisible to the mon)."""

    t: float
    epoch: int
    event: BitrotEvent


@dataclass
class AppliedCrashSpec:
    """Audit-trail entry for one crash-scoped spec the engine saw.

    Crash specs never touch the map, the detector, or even the
    simulated cluster — they kill the *driving process*, and only the
    checkpointed runners (:mod:`~ceph_tpu_torch.recovery.checkpoint`)
    enact them.  The engine journals and records them so a non-checkpointed
    replay of a kill scenario still leaves an audit trail."""

    t: float
    epoch: int
    spec: FailureSpec


@dataclass
class AppliedChipSpec:
    """Audit-trail entry for one chip-scoped spec the engine saw.

    Chip specs never touch the map, the detector, or the simulated
    cluster — they fault a *device-mesh chip*, and only the
    work-stealing dispatcher (:mod:`~ceph_tpu_torch.recovery.dispatch`)
    enacts them.  The engine journals and records them so a replay of
    a chip-fault scenario without the dispatcher still leaves an
    audit trail."""

    t: float
    epoch: int
    spec: FailureSpec


@dataclass
class AppliedRankSpec:
    """Audit-trail entry for one rank-scoped spec the engine saw.

    Rank specs never mutate the map or the detector — they direct how
    *one simulation rank observes* the shared timeline, and the actual
    skew/stall/drop is enacted by the reconcile layer
    (:mod:`~ceph_tpu_torch.recovery.reconcile`).  The engine only journals and records them so
    a single-process replay of a divergent scenario still leaves an
    audit trail."""

    t: float
    epoch: int
    spec: FailureSpec


class ChaosEngine:
    """Owns the live map, the timeline, and the virtual clock.

    The supervised executor calls :meth:`poll` between phases; every
    due map event becomes an ordinary epoch through the normal
    ``Incremental`` machinery, so nothing downstream can tell a chaos
    event from an organic mon update.  ``bitrot`` specs take the other
    channel: they never touch the map — :meth:`poll` hands each decoded
    :class:`BitrotEvent` to the ``corrupt(pg, shard, offset, mask)``
    callback (the shard store's mutator; offsets wrap modulo the
    shard's chunk length there) and records it, epoch-stamped, in
    :attr:`corruptions`.  ``device`` is where the default liveness
    detector keeps its heartbeat lanes.
    """

    def __init__(
        self,
        m: OSDMap,
        timeline: ChaosTimeline | None = None,
        clock: VirtualClock | None = None,
        journal=None,
        corrupt=None,
        liveness: LivenessDetector | None = None,
        flags: ClusterFlags | None = None,
        config=None,
        device="cuda",
    ):
        self.osdmap = m
        self.timeline = timeline or ChaosTimeline()
        self.clock = clock or VirtualClock()
        self.journal = journal
        self.corrupt = corrupt
        self.flags = flags if flags is not None else ClusterFlags()
        self.liveness = liveness or LivenessDetector(
            m.max_osd, self.clock, config=config, journal=journal,
            flags=self.flags, osdmap=m, device=device,
        )
        self.applied: list[AppliedEvent] = []
        self.corruptions: list[AppliedCorruption] = []
        self.rank_applied: list[AppliedRankSpec] = []
        self.crash_applied: list[AppliedCrashSpec] = []
        self.chip_applied: list[AppliedChipSpec] = []

    @property
    def epoch(self) -> int:
        return self.osdmap.epoch

    def exhausted(self) -> bool:
        return (
            len(self.timeline) == 0
            and self.liveness.next_deadline() is None
        )

    def poll(self) -> list[Incremental]:
        """Inject every event due at the current virtual time; returns
        the applied incrementals (empty list = no epoch advance).
        Bitrot specs in due events are applied through the ``corrupt``
        callback and appended to :attr:`corruptions` — callers that
        care about silent damage compare ``len(engine.corruptions)``
        across the poll, since no incremental marks it."""
        incs = []
        for ev in self.timeline.due(self.clock.now()):
            rot = [s for s in ev.specs if s.is_bitrot]
            net = [s for s in ev.specs if s.is_net]
            rank = [s for s in ev.specs if s.is_rank]
            crash = [s for s in ev.specs if s.is_crash]
            chip = [s for s in ev.specs if s.is_chip]
            fail = tuple(
                s for s in ev.specs
                if not s.is_bitrot and not s.is_net
                and not s.is_rank and not s.is_crash and not s.is_chip
            )
            if fail:
                inc = inject(self.osdmap, list(fail))
                incs.append(inc)
                self.applied.append(AppliedEvent(ev.t, inc.epoch, fail, inc))
                self._sync_liveness(fail)
                if self.journal is not None:
                    self.journal.event(
                        "chaos.inject",
                        epoch=inc.epoch,
                        sched_t=ev.t,
                        specs=[str(s) for s in fail],
                    )
            for spec in net:
                self.liveness.apply(spec)
                if self.journal is not None:
                    self.journal.event(
                        "chaos.net",
                        epoch=self.osdmap.epoch,
                        sched_t=ev.t,
                        spec=str(spec),
                    )
            for spec in crash:
                # no map/detector effect: the audit trail for replay
                # tooling (the checkpointed runners enact the kill)
                self.crash_applied.append(
                    AppliedCrashSpec(ev.t, self.osdmap.epoch, spec)
                )
                if self.journal is not None:
                    self.journal.event(
                        "chaos.crash",
                        epoch=self.osdmap.epoch,
                        sched_t=ev.t,
                        spec=str(spec),
                    )
            for spec in chip:
                # no map/detector effect: the audit trail for replay
                # tooling (a work-stealing dispatcher enacts the fault)
                self.chip_applied.append(
                    AppliedChipSpec(ev.t, self.osdmap.epoch, spec)
                )
                if self.journal is not None:
                    self.journal.event(
                        "chaos.chip",
                        epoch=self.osdmap.epoch,
                        sched_t=ev.t,
                        spec=str(spec),
                    )
            for spec in rank:
                # no map/detector effect: the audit trail for replay
                # tooling (a reconcile layer enacts the skew)
                self.rank_applied.append(
                    AppliedRankSpec(ev.t, self.osdmap.epoch, spec)
                )
                if self.journal is not None:
                    self.journal.event(
                        "chaos.rank",
                        epoch=self.osdmap.epoch,
                        sched_t=ev.t,
                        spec=str(spec),
                    )
            for spec in rot:
                rot_ev = spec.bitrot()
                if self.corrupt is not None:
                    self.corrupt(
                        rot_ev.pg, rot_ev.shard, rot_ev.offset, rot_ev.mask
                    )
                self.corruptions.append(
                    AppliedCorruption(ev.t, self.osdmap.epoch, rot_ev)
                )
                if self.journal is not None:
                    self.journal.event(
                        "chaos.bitrot",
                        epoch=self.osdmap.epoch,
                        sched_t=ev.t,
                        pg=rot_ev.pg,
                        shard=rot_ev.shard,
                        offset=rot_ev.offset,
                        mask=rot_ev.mask,
                    )
        incs.extend(self._poll_liveness())
        return incs

    def _sync_liveness(self, specs) -> None:
        """Authoritative up/in events reset detector bookkeeping for
        the affected OSDs (a stale last-ack must never re-mark an OSD
        an admin just brought back)."""
        ups = [
            o
            for s in specs
            if s.action in ("up", "in")
            for o in resolve_targets(self.osdmap, s)
        ]
        if ups:
            self.liveness.observe_map(ups)

    def _effective_transitions(self, specs):
        """Drop detector transitions the map already reflects, so a
        detection that races a direct map event never burns an empty
        epoch."""
        out = []
        for s in specs:
            osd = int(s.target)
            if s.action == "down" and self.osdmap.is_up(osd):
                out.append(s)
            elif s.action == "up" and self.osdmap.exists(osd) \
                    and not self.osdmap.is_up(osd):
                out.append(s)
            elif s.action == "out" and not self.osdmap.is_out(osd):
                out.append(s)
        return out

    def _poll_liveness(self) -> list[Incremental]:
        """Tick the failure detector at the current virtual time; any
        down/up/out transitions it reports become ONE ordinary epoch
        (the mon batching simultaneous failure reports)."""
        specs = self._effective_transitions(self.liveness.tick())
        if not specs:
            return []
        inc = inject(self.osdmap, specs)
        self.applied.append(
            AppliedEvent(self.clock.now(), inc.epoch, tuple(specs), inc)
        )
        if self.journal is not None:
            self.journal.event(
                "chaos.detected",
                epoch=inc.epoch,
                t=self.clock.now(),
                specs=[str(s) for s in specs],
            )
        return [inc]

    def advance_to_next(self) -> bool:
        """Jump the clock to the next scheduled event OR the next
        liveness deadline (grace expiry / down->out), whichever comes
        first — the idle path: no repair work pending but state still
        due to change.  Returns False when both are exhausted."""
        cands = [
            t
            for t in (self.timeline.peek_next(),
                      self.liveness.next_deadline())
            if t is not None
        ]
        if not cands:
            return False
        t = min(cands)
        if t > self.clock.now():
            self.clock.advance(t - self.clock.now())
        return True
