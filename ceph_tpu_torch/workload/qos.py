"""mclock-style QoS arbiter: client traffic and recovery share bandwidth.

The reference schedules OSD work with dmClock (``osd_op_queue =
mclock_scheduler``): every class gets a *reservation* (bytes/s it is
guaranteed), a *weight* (its share of whatever is left), and a *limit*
(a hard cap).  Here the arbiter replaces the executor's lone
:class:`~ceph_tpu_torch.recovery.executor.TokenBucket` as the admission
gate: each request is tagged

- ``r_tag`` — the time the reservation schedule would serve it
  (``prev_r + nbytes / reservation``),
- ``p_tag`` — the proportional-share schedule
  (``prev_p + nbytes / (weight_share * capacity)``),
- ``l_tag`` — the limit schedule (``prev_l + nbytes / limit``),

and admitted at ``max(l_tag_prev, min(r_tag, p_tag))`` — served
immediately while inside its reservation, by weight once reservations
are met, never past its limit.  The serial simulator sleeps the
admission delay on the injectable clock, so chaos runs stay
deterministic and virtual-clocked.  (Full dmClock compares tags
*across* classes at a central queue; with one serial caller per class
the per-class tag schedule gives the same rate guarantees, which is
what the starvation tests assert.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from ..common.config import Config, global_config


@dataclass(frozen=True)
class QoSClass:
    """One traffic class's policy (the ``osd_mclock_scheduler_*_res/
    wgt/lim`` analog).  Rates are bytes/s; 0 disables that term
    (no reservation / no cap)."""

    name: str
    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0


@dataclass
class _ClassState:
    spec: QoSClass
    r_tag: float = 0.0
    p_tag: float = 0.0
    l_tag: float = 0.0
    granted_bytes: int = 0
    requests: int = 0
    waited_s: float = 0.0


class MClockArbiter:
    """Serial mclock admission over an injectable clock.

    ``capacity_bps`` anchors the proportional term: a class of weight
    ``w`` receives ``w / sum(weights)`` of it when every class is
    backlogged.  ``request(name, nbytes)`` blocks (via ``sleep``) until
    the class's schedule admits the bytes and returns the seconds
    waited.
    """

    def __init__(
        self,
        classes: list[QoSClass],
        capacity_bps: float,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if not classes:
            raise ValueError("MClockArbiter needs at least one QoSClass")
        self.capacity_bps = float(capacity_bps)
        self._clock = clock
        self._sleep = sleep
        self._classes: dict[str, _ClassState] = {
            c.name: _ClassState(c) for c in classes
        }
        total_w = sum(max(c.weight, 0.0) for c in classes) or 1.0
        self._share: dict[str, float] = {
            c.name: max(c.weight, 0.0) / total_w for c in classes
        }

    @classmethod
    def from_config(
        cls,
        capacity_bps: float,
        config: Config | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> "MClockArbiter":
        """The standard client/recovery/scrub trio from the
        ``osd_mclock_*`` options (scrub is the background integrity
        class: it shares the same tag algebra, so a scrub storm admits
        by weight and can never starve the other two)."""
        cfg = config or global_config()
        return cls(
            [
                QoSClass(
                    "client",
                    reservation=float(cfg.get("osd_mclock_client_res_bps")),
                    weight=float(cfg.get("osd_mclock_client_wgt")),
                    limit=float(cfg.get("osd_mclock_client_lim_bps")),
                ),
                QoSClass(
                    "recovery",
                    reservation=float(cfg.get("osd_mclock_recovery_res_bps")),
                    weight=float(cfg.get("osd_mclock_recovery_wgt")),
                    limit=float(cfg.get("osd_mclock_recovery_lim_bps")),
                ),
                QoSClass(
                    "scrub",
                    reservation=float(cfg.get("osd_mclock_scrub_res_bps")),
                    weight=float(cfg.get("osd_mclock_scrub_wgt")),
                    limit=float(cfg.get("osd_mclock_scrub_lim_bps")),
                ),
            ],
            capacity_bps,
            clock=clock,
            sleep=sleep,
        )

    def request(self, name: str, nbytes: int) -> float:
        """Admit ``nbytes`` for class ``name``; returns seconds slept."""
        st = self._classes[name]
        spec = st.spec
        now = self._clock()
        # candidate start times under each schedule (an idle class's
        # stale tags snap forward to now — no banked credit)
        r_start = max(st.r_tag, now) if spec.reservation > 0 else None
        p_rate = self._share[name] * self.capacity_bps
        p_start = max(st.p_tag, now) if p_rate > 0 else now
        start = min(r_start, p_start) if r_start is not None else p_start
        if spec.limit > 0:
            start = max(start, max(st.l_tag, now))
        waited = 0.0
        if start > now:
            waited = start - now
            self._sleep(waited)
            st.waited_s += waited
            now = self._clock()
        # advance every tag by this grant
        if spec.reservation > 0:
            st.r_tag = max(st.r_tag, now) + nbytes / spec.reservation
        if p_rate > 0:
            st.p_tag = max(st.p_tag, now) + nbytes / p_rate
        if spec.limit > 0:
            st.l_tag = max(st.l_tag, now) + nbytes / spec.limit
        st.granted_bytes += int(nbytes)
        st.requests += 1
        return waited

    def granted(self, name: str) -> int:
        return self._classes[name].granted_bytes

    def waited(self, name: str) -> float:
        return self._classes[name].waited_s

    def summary(self) -> dict:
        """Per-class grant/wait telemetry (rides the bench JSON line)."""
        return {
            name: {
                "reservation_bps": st.spec.reservation,
                "weight": st.spec.weight,
                "limit_bps": st.spec.limit,
                "granted_bytes": st.granted_bytes,
                "requests": st.requests,
                "waited_s": round(st.waited_s, 6),
            }
            for name, st in sorted(self._classes.items())
        }
