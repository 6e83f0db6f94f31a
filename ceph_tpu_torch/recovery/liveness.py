"""Mon-style failure detection on the virtual clock.

Every chaos event used to land as an instantly-authoritative map
incremental; real clusters *observe* failures.  This module closes
that gap (the reference's ``OSDMonitor`` heartbeat path: grace,
``mon_osd_down_out_interval``, the markdown log, ``noout``):

- :class:`LivenessDetector` keeps per-OSD heartbeat state — last-ack
  time, laggy score, markdown count, down/out — as fixed-shape
  ``[n_osds]`` tensors on the detector's device, advanced by one
  :func:`heartbeat_step` of torch ops per tick.  The lanes are float32,
  as in the reference package, and every policy scalar is rounded to
  float32 before it meets them (XLA's weak-type rule), so the port
  takes the same decisions.
- ``netsplit:N`` chaos specs suppress an OSD's heartbeats *without* a
  map event; the OSD is marked **down** only once
  ``osd_heartbeat_grace`` expires with enough peer failure reports
  (``mon_osd_min_down_reporters``) — detection latency becomes real
  and measurable.
- A detector-down OSD is auto-marked **out** after
  ``mon_osd_down_out_interval``, host-gated by the ``noout`` cluster
  flag and ``mon_osd_min_in_ratio`` (never push the in-fraction below
  the floor).  Auto-out applies only to *detector* downs; direct map
  events keep their authoritative semantics.
- The markdown log: every down-mark increments a decaying per-OSD
  markdown count, and when ``mon_osd_adjust_heartbeat_grace`` is on
  the effective grace doubles per markdown (capped) — a flapping OSD
  has to stay bad exponentially longer each round before it can
  thrash peering again.
- ``slow:N`` specs model stragglers: the OSD still acks, but its
  laggy score (EWMA, ``mon_osd_laggy_weight`` /
  ``mon_osd_laggy_halflife``) rises; laggy OSDs are surfaced, never
  marked down.

:class:`ClusterFlags` is the tiny authoritative flag set
(``noout``/``norecover``/``nobackfill``/``norebalance``/``pause``,
plus ``rankstalled`` raised by the reconcile layer when a simulation
rank stops contributing) that the executor and the traffic engine
consult for graceful degradation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..common.config import global_config
from .failure import FailureSpec

F32 = torch.float32

KNOWN_FLAGS = ("noout", "norecover", "nobackfill", "norebalance", "pause",
               "rankstalled")

#: laggy score above this counts the OSD in ``osds_laggy``
LAGGY_THRESHOLD = 0.5

#: nudge added to host-computed deadlines so jumping the clock there
#: makes the strict ``elapsed > grace`` comparison true on the device
_DEADLINE_EPS = 1e-3


class ClusterFlags:
    """The cluster-wide flag set (``ceph osd set noout`` analog).

    Validated against :data:`KNOWN_FLAGS`; shared by reference between
    the chaos engine, the executor, and the traffic engine so one
    ``flags.set("pause")`` gates every consumer.
    """

    def __init__(self, *names: str):
        self._flags: set[str] = set()
        for n in names:
            self.set(n)

    @staticmethod
    def _check(name: str) -> str:
        if name not in KNOWN_FLAGS:
            raise ValueError(
                f"unknown cluster flag {name!r}; one of {KNOWN_FLAGS}"
            )
        return name

    def set(self, name: str) -> None:
        self._flags.add(self._check(name))

    def clear(self, name: str) -> None:
        self._flags.discard(self._check(name))

    def __contains__(self, name: str) -> bool:
        return name in self._flags

    def __iter__(self):
        return iter(sorted(self._flags))

    def __len__(self) -> int:
        return len(self._flags)

    def __bool__(self) -> bool:
        return bool(self._flags)

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._flags))

    def __repr__(self) -> str:
        return f"ClusterFlags({', '.join(self.names())})"


@dataclass(frozen=True)
class Detection:
    """One completed failure detection: heartbeats stopped at
    ``t_fail`` (the netsplit), the detector marked the OSD down at
    ``t_down`` — ``latency`` is the gap the mon's grace imposes."""

    osd: int
    t_fail: float
    t_down: float

    @property
    def latency(self) -> float:
        return self.t_down - self.t_fail


def heartbeat_step(
    last_ack, laggy, markdowns, down, down_since,
    suppressed, slow, reporters,
    now, grace, grace_cap, adjust, min_reporters,
    down_out_interval, laggy_weight, decay,
):
    """Advance every OSD's heartbeat state to ``now``.

    The eight lanes are ``[n_osds]`` tensors on one device (float32
    ``last_ack``/``laggy``/``markdowns``/``down_since``, bool
    ``down``/``suppressed``/``slow``, int32 ``reporters``), or
    ``[lanes, n_osds]`` for a fleet; the eight policy scalars are Python
    numbers, each rounded to float32 (the reporter threshold stays an
    integer) before it meets a lane.  A fleet's ``decay`` may be a
    float32 ``[lanes, 1]`` tensor, one factor a lane.  Returns
    ``(last_ack, laggy, markdowns, down, down_since, propose_out)``."""
    dev = last_ack.device

    def f32(v):
        if isinstance(v, torch.Tensor):
            return v
        # a fill, not a copy from the host (which would sync the card)
        return torch.full((), float(v), dtype=F32, device=dev)

    now = f32(now)
    ack = ~suppressed
    last_ack = torch.where(ack, now, last_ack)
    elapsed = now - last_ack
    md = markdowns * f32(decay)
    # markdown log: each prior down-mark doubles the grace (capped)
    doublings = torch.pow(f32(2.0), torch.minimum(md, f32(grace_cap)))
    eff_grace = f32(grace) * (doublings if float(adjust) > 0.5 else torch.ones_like(md))
    newly_down = ~down & suppressed & (elapsed > eff_grace) & (reporters >= int(min_reporters))
    down = (down | newly_down) & suppressed
    down_since = torch.where(newly_down, now, down_since)
    md = md + newly_down.to(F32)
    laggy = laggy * f32(decay)
    laggy = torch.where(slow & ack, laggy + f32(laggy_weight) * (1.0 - laggy), laggy)
    propose_out = down & ((now - down_since) >= f32(down_out_interval))
    return last_ack, laggy, md, down, down_since, propose_out


class LivenessDetector:
    """Per-OSD heartbeat bookkeeping plus the mon's down/out policy.

    Owned (and ticked) by :class:`~ceph_tpu_torch.recovery.chaos.ChaosEngine`;
    netsplit/slow chaos specs route here via :meth:`apply`, and each
    :meth:`tick` returns the map transitions (down / up / out specs)
    the engine injects as ordinary incrementals.  The heartbeat lanes
    live on ``device`` (the card by default); each tick copies them back
    once.
    """

    def __init__(
        self,
        n_osds: int,
        clock,
        *,
        config=None,
        journal=None,
        flags: ClusterFlags | None = None,
        osdmap=None,
        device="cuda",
    ):
        self.n = int(n_osds)
        self.device = resolve_device(device)
        self.clock = clock
        self.config = config or global_config()
        self.journal = journal
        self.flags = flags if flags is not None else ClusterFlags()
        self.osdmap = osdmap

        n, dev = self.n, self.device
        self._last_ack = torch.full((n,), float(clock.now()), dtype=F32, device=dev)
        self._laggy = torch.zeros(n, dtype=F32, device=dev)
        self._markdowns = torch.zeros(n, dtype=F32, device=dev)
        self._down = torch.zeros(n, dtype=torch.bool, device=dev)
        self._down_since = torch.zeros(n, dtype=F32, device=dev)

        # host-authoritative inputs/policy state
        self._suppressed = np.zeros(n, bool)
        self._slow = np.zeros(n, bool)
        self._reporters = np.full(n, 1 << 16, np.int32)
        self._out = np.zeros(n, bool)
        self._fail_time = np.zeros(n, np.float64)

        # host mirrors, refreshed each tick (for deadlines/surfacing)
        self._down_h = np.zeros(n, bool)
        self._down_since_h = np.zeros(n, np.float64)
        self._markdowns_h = np.zeros(n, np.float64)
        self._laggy_h = np.zeros(n, np.float64)
        self._last_ack_h = np.full(n, float(clock.now()), np.float64)
        self._last_tick = float(clock.now())

        self.detections: list[Detection] = []
        self._fresh: list[Detection] = []
        self.ticks = 0
        self.downs = 0
        self.ups = 0
        self.auto_out_events = 0
        self.flap_damped_events = 0

    # -- config accessors (read live so runtime `set` takes effect) ----

    def _opt(self, name: str) -> float:
        return self.config.get(name)

    # -- chaos-spec surface -------------------------------------------

    def apply(self, spec: FailureSpec) -> None:
        """Route one ``netsplit:``/``slow:`` spec into detector state.
        ``drop`` begins suppression/slowness, ``restore`` ends it.  No
        map event happens here — only detection can produce one."""
        osd = int(spec.target)
        if not (0 <= osd < self.n):
            raise ValueError(f"{spec}: osd {osd} outside [0, {self.n})")
        begin = spec.action == "drop"
        now = self.clock.now()
        if spec.scope == "netsplit":
            if begin and not self._suppressed[osd]:
                self._fail_time[osd] = now
            self._suppressed[osd] = begin
            # the OSD acked right up to the split (drop) / resumes
            # immediately (restore): stamp last_ack either way, so a
            # stale ack from the idle fast-path era can't turn a fresh
            # split into an instant (zero-grace) detection
            self._last_ack[osd] = float(now)
            self._last_ack_h[osd] = now
        elif spec.scope == "slow":
            self._slow[osd] = begin
        else:
            raise ValueError(f"not a net spec: {spec}")

    def observe_map(self, osds_up) -> None:
        """Sync direct map events into detector state: an OSD brought
        up by an authoritative incremental acks from now on, so a
        stale ``last_ack`` can never re-mark it."""
        now = float(self.clock.now())
        for osd in osds_up:
            if 0 <= osd < self.n:
                self._last_ack[int(osd)] = now
                self._last_ack_h[osd] = now
                self._suppressed[osd] = False
                self._out[osd] = False

    def set_reporters(self, counts) -> None:
        """Per-OSD failure-reporter pool (distinct co-serving peers
        from the peering adjacency); an OSD nobody peers with can
        never collect ``mon_osd_min_down_reporters`` reports."""
        counts = np.asarray(counts, np.int32)
        if counts.shape != (self.n,):
            raise ValueError(
                f"reporter counts shape {counts.shape} != ({self.n},)"
            )
        self._reporters = counts

    # -- the tick ------------------------------------------------------

    def tick(self, now: float | None = None):
        """Advance heartbeat state to ``now``; returns the list of map
        transition specs (``osd:N:down`` / ``osd:N:up`` / ``osd:N:out``)
        the caller should inject as one epoch."""
        now = float(self.clock.now() if now is None else now)
        if (
            not self._suppressed.any()
            and not self._slow.any()
            and not self._down_h.any()
            and not self._laggy_h.any()
        ):
            # idle fast path: nothing can transition, skip the device
            # step (legacy runs with no net specs stay zero-cost).
            # _last_tick is deliberately NOT advanced — exponential
            # decay composes, so the next real tick decays over the
            # full elapsed window.
            return []
        cfg = self.config
        decay = 0.5 ** (
            max(now - self._last_tick, 0.0)
            / max(cfg.get("mon_osd_laggy_halflife"), 1e-9)
        )
        adjust = 1.0 if cfg.get("mon_osd_adjust_heartbeat_grace") else 0.0
        dev = self.device
        out = heartbeat_step(
            self._last_ack, self._laggy, self._markdowns, self._down,
            self._down_since,
            torch.from_numpy(self._suppressed).to(dev),
            torch.from_numpy(self._slow).to(dev),
            torch.from_numpy(self._reporters).to(dev),
            now,
            float(cfg.get("osd_heartbeat_grace")),
            float(cfg.get("mon_osd_grace_doublings_max")),
            adjust,
            int(cfg.get("mon_osd_min_down_reporters")),
            float(cfg.get("mon_osd_down_out_interval")),
            float(cfg.get("mon_osd_laggy_weight")),
            decay,
        )
        (self._last_ack, self._laggy, self._markdowns, self._down,
         self._down_since, propose_out) = out
        (last_ack_h, laggy_h, md_h, down_h, down_since_h, propose_h) = (
            # torchlint: disable=J003  # the tick's six lanes feed the host's markdown bookkeeping
            t.cpu().numpy() for t in out
        )
        self.ticks += 1
        prev_down = self._down_h
        prev_md = self._markdowns_h
        self._last_ack_h = np.asarray(last_ack_h, np.float64)
        self._laggy_h = np.asarray(laggy_h, np.float64)
        self._markdowns_h = np.asarray(md_h, np.float64)
        self._down_h = np.asarray(down_h, bool)
        self._down_since_h = np.asarray(down_since_h, np.float64)
        self._last_tick = now

        specs: list[FailureSpec] = []
        newly_down = np.flatnonzero(self._down_h & ~prev_down)
        newly_up = np.flatnonzero(prev_down & ~self._down_h)
        damped = adjust > 0.5
        for osd in newly_down:
            osd = int(osd)
            det = Detection(osd, float(self._fail_time[osd]), now)
            self.detections.append(det)
            self._fresh.append(det)
            self.downs += 1
            specs.append(FailureSpec("osd", str(osd), "down"))
            if self.journal is not None:
                self.journal.event(
                    "osd.down", osd=osd, t=now,
                    latency_s=det.latency,
                    markdowns=float(prev_md[osd]),
                )
            if damped and prev_md[osd] >= 1.0:
                self.flap_damped_events += 1
                if self.journal is not None:
                    self.journal.event(
                        "osd.flap_damped", osd=osd, t=now,
                        markdowns=float(prev_md[osd]),
                    )
        for osd in newly_up:
            osd = int(osd)
            self.ups += 1
            specs.append(FailureSpec("osd", str(osd), "up"))
        specs.extend(self._approve_outs(np.asarray(propose_h, bool), now))
        return specs

    def _approve_outs(self, propose: np.ndarray, now: float):
        """The host half of down->out: the device proposes, policy
        disposes (``noout`` flag, ``mon_osd_min_in_ratio`` floor)."""
        specs: list[FailureSpec] = []
        if "noout" in self.flags:
            return specs
        if self._opt("mon_osd_down_out_interval") <= 0:
            return specs
        candidates = np.flatnonzero(propose & ~self._out)
        if candidates.size == 0:
            return specs
        min_ratio = self._opt("mon_osd_min_in_ratio")
        n_exist, n_in = self._in_counts()
        for osd in candidates:
            osd = int(osd)
            if n_exist > 0 and (n_in - 1) / n_exist < min_ratio:
                break  # floor reached: keep remaining downs in
            self._out[osd] = True
            n_in -= 1
            self.auto_out_events += 1
            specs.append(FailureSpec("osd", str(osd), "out"))
            if self.journal is not None:
                self.journal.event(
                    "osd.out", osd=osd, t=now,
                    down_for_s=now - float(self._down_since_h[osd]),
                )
        return specs

    def _in_counts(self) -> tuple[int, int]:
        """(existing, in) OSD counts from the live map when we have
        one, else from detector-local out bookkeeping."""
        m = self.osdmap
        if m is not None:
            exist = [o for o in range(m.max_osd) if m.exists(o)]
            n_in = sum(1 for o in exist if not m.is_out(o))
            return len(exist), n_in
        return self.n, self.n - int(self._out.sum())

    # -- scheduling / draining ----------------------------------------

    def next_deadline(self) -> float | None:
        """The earliest future time at which a tick can change state:
        a pending grace expiry or a pending down->out.  None when
        nothing is in flight (the legacy idle path)."""
        cfg = self.config
        grace = cfg.get("osd_heartbeat_grace")
        cap = cfg.get("mon_osd_grace_doublings_max")
        adjust = cfg.get("mon_osd_adjust_heartbeat_grace")
        min_rep = cfg.get("mon_osd_min_down_reporters")
        interval = cfg.get("mon_osd_down_out_interval")
        cands: list[float] = []
        pending = np.flatnonzero(
            self._suppressed & ~self._down_h & (self._reporters >= min_rep)
        )
        for osd in pending:
            eff = grace
            if adjust:
                eff = grace * 2.0 ** min(self._markdowns_h[osd], cap)
            cands.append(float(self._last_ack_h[osd]) + eff + _DEADLINE_EPS)
        if interval > 0 and "noout" not in self.flags:
            for osd in np.flatnonzero(self._down_h & ~self._out):
                cands.append(
                    float(self._down_since_h[osd]) + interval + _DEADLINE_EPS
                )
        return min(cands) if cands else None

    def pop_detections(self) -> list[Detection]:
        """Drain detections completed since the last call (the obs
        layer's feed for detection-latency SLOs)."""
        fresh, self._fresh = self._fresh, []
        return fresh

    # -- surfacing -----------------------------------------------------

    @property
    def osds_down(self) -> int:
        return int(self._down_h.sum())

    @property
    def osds_laggy(self) -> int:
        return int((self._laggy_h > LAGGY_THRESHOLD).sum())

    @property
    def osds_suppressed(self) -> int:
        return int(self._suppressed.sum())

    def laggy_probability(self, osd: int) -> float:
        return float(self._laggy_h[osd])

    def summary(self) -> dict:
        return {
            "n_osds": self.n,
            "ticks": self.ticks,
            "downs": self.downs,
            "ups": self.ups,
            "auto_out_events": self.auto_out_events,
            "flap_damped_events": self.flap_damped_events,
            "osds_down": self.osds_down,
            "osds_laggy": self.osds_laggy,
            "osds_suppressed": self.osds_suppressed,
            "detections": len(self.detections),
            "flags": list(self.flags),
        }
