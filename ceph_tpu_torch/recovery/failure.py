"""Fault injector: OSD/host/rack failures as epoch-stamped map edits.

The reference has no single "fault injector" — failures arrive as mon
epochs flipping ``CEPH_OSD_UP`` bits and zeroing reweights (upstream
``OSDMonitor::prepare_failure`` -> ``OSDMap::Incremental``).  This
module reproduces exactly that surface: every injected event is an
:class:`~ceph_tpu.osdmap.map.Incremental` applied through the normal
epoch machinery, so the peering pass (:mod:`ceph_tpu.recovery.peering`)
sees failures the same way the real cluster would — as a diff between
two epochs — and nothing downstream can tell an injected failure from a
organic one.

Specs are strings (the CLI surface, ``ceph_tpu.cli.recovery``)::

    osd:5            # one device
    host:host0_1     # every OSD under the named bucket
    rack:0           # every OSD under the bucket named "rack0"
    rack:0:out       # action suffix: down (default) | out | down_out | up | in

Bucket scopes accept either a full bucket name or a bare index that is
prefixed with the scope (``rack:0`` -> bucket ``rack0``), matching the
``build_simple``/``build_hierarchy`` naming convention.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crush.map import CrushMap
from ..osdmap.map import Incremental, OSDMap, UP

ACTIONS = ("down", "out", "down_out", "up", "in")

# The one action the ``bitrot`` scope supports: flip bits in a shard
# buffer (no map edit, no epoch — the whole point is that the failure
# is *silent* until a scrub pass finds it).
BITROT_ACTION = "corrupt"

# The *observed*-failure scopes: ``netsplit:N`` stops OSD N's
# heartbeats, ``slow:N`` makes it a straggler (acks late; laggy score
# rises).  Neither is a map edit — the map only changes if and when
# the liveness detector (:mod:`ceph_tpu.recovery.liveness`) notices.
NET_SCOPES = ("netsplit", "slow")

# Actions for NET_SCOPES: ``drop`` begins the condition (default),
# ``restore`` ends it.
NET_ACTIONS = ("drop", "restore")

# Rank-scoped chaos: not a map edit and not even a *cluster* condition
# — these shape how one simulation rank OBSERVES the shared timeline
# (:mod:`ceph_tpu_torch.recovery.reconcile`).  ``rankdelay:R.MS`` delays when
# rank R sees every subsequent event by MS milliseconds;
# ``rankdrop:R`` suppresses rank R's heartbeat reports entirely (its
# down-evidence stops counting toward reporter quorums at merge);
# ``rankstall:R.E`` freezes rank R's superstep for E epochs (E=0 =
# permanently — the RankStalledError acceptance path).
RANK_SCOPES = ("rankdelay", "rankdrop", "rankstall")

# Allowed actions per rank scope (first entry is the default): skew /
# drop|restore / stall.
RANK_ACTIONS = {
    "rankdelay": ("skew",),
    "rankdrop": ("drop", "restore"),
    "rankstall": ("stall",),
}

# How many dot-separated non-negative integers each rank scope's
# target carries (rank[, milliseconds | epochs]).
_RANK_TARGET_ARITY = {"rankdelay": 2, "rankdrop": 1, "rankstall": 2}

# Chip-scoped chaos: not a map edit, not a cluster condition, not
# even an observation skew — these shape the *device mesh* the
# work-stealing dispatcher (:mod:`ceph_tpu_torch.recovery.dispatch`) drives.
# ``chipstall:D.LAUNCHES`` makes chip D's next LAUNCHES launches hang
# forever (LAUNCHES=0 = every launch — the conviction acceptance
# path); ``chipslow:D.FACTOR`` multiplies chip D's completion time by
# FACTOR (a straggler, the hedge path); ``chipdrop:D`` makes chip D's
# launches fail fast (the retry/backoff path; ``restore`` ends it).
# Only the dispatcher consumes chip specs; every other consumer
# rejects them loudly.
CHIP_SCOPES = ("chipstall", "chipslow", "chipdrop")

# Allowed actions per chip scope (first entry is the default).
CHIP_ACTIONS = {
    "chipstall": ("stall",),
    "chipslow": ("slow",),
    "chipdrop": ("drop", "restore"),
}

# How many dot-separated non-negative integers each chip scope's
# target carries (chip[, launches | factor]).
_CHIP_TARGET_ARITY = {"chipstall": 2, "chipslow": 2, "chipdrop": 1}

# Process-lifetime chaos: ``crash:EPOCH[:PHASE]`` kills the *driving
# process* at a simulated-epoch boundary.  Not a map edit, not a
# cluster condition, not an observation skew — the simulated cluster
# never sees it; what it tests is the checkpoint/restore subsystem
# (:mod:`ceph_tpu.recovery.checkpoint`).  PHASE positions the crash
# relative to the checkpoint write at the first snapshot boundary at
# or past EPOCH: ``before`` the write starts (default), ``during`` it
# (a torn write), or ``after`` it commits.  Only the checkpointed
# runners consume crash specs; every other consumer rejects them
# loudly.
CRASH_SCOPE = "crash"
CRASH_ACTIONS = ("before", "during", "after")

# The scopes a spec may name: ``osd`` plus the reference's stock CRUSH
# bucket types (``src/crush/CrushWrapper.cc`` default type set), plus
# ``bitrot`` — silent shard corruption, which is not a map edit at all
# (see :class:`BitrotEvent`) — plus the :data:`NET_SCOPES` heartbeat
# conditions and the :data:`RANK_SCOPES` observation-skew conditions.
# Maps with exotic custom type names can pass ``scopes=`` to
# parse_spec.
KNOWN_SCOPES = (
    "osd", "host", "chassis", "rack", "row", "pdu", "pod", "room",
    "datacenter", "dc", "zone", "region", "root", "bitrot",
) + NET_SCOPES + RANK_SCOPES + CHIP_SCOPES + (CRASH_SCOPE,)

# The keys a dict-form spec may carry (the JSON timeline surface).
SPEC_KEYS = ("scope", "target", "action")


class UnknownSpecKeyError(ValueError):
    """A dict-form failure spec carried a key outside
    :data:`SPEC_KEYS` — rejected loudly (a typo like ``"scop"`` must
    not silently produce a default event).  Rank-scoped specs raise it
    for malformed targets too (negative/zero delay, non-integer or
    out-of-range rank): the same loud surface, the same reason."""


@dataclass(frozen=True)
class BitrotEvent:
    """One silent-corruption event: XOR ``mask`` into byte ``offset``
    of shard ``shard`` of PG ``pg``.

    Encoded in a :class:`FailureSpec` as ``bitrot:PG.SHARD.OFF.MASK``
    (four dot-separated non-negative integers; mask 1..255 so the
    corruption is never a no-op), action ``corrupt`` — e.g.
    ``bitrot:12.3.77.255:corrupt``.  Unlike every other scope this is
    NOT an :class:`~ceph_tpu.osdmap.map.Incremental`: nothing in the
    map changes, no epoch advances, and peering cannot see it — only a
    scrub pass (:mod:`ceph_tpu.recovery.scrub`) can.
    """

    pg: int
    shard: int
    offset: int
    mask: int

    def __str__(self) -> str:
        return f"{self.pg}.{self.shard}.{self.offset}.{self.mask}"

    @classmethod
    def from_target(cls, target: str) -> "BitrotEvent":
        parts = target.split(".")
        if len(parts) != 4 or not all(p.isdigit() for p in parts):
            raise ValueError(
                f"bad bitrot target {target!r} "
                "(want PG.SHARD.BYTE_OFFSET.XOR_MASK, four non-negative "
                "integers)"
            )
        pg, shard, offset, mask = (int(p) for p in parts)
        if not 1 <= mask <= 255:
            raise ValueError(
                f"bitrot xor mask must be 1..255, got {mask} in {target!r}"
            )
        return cls(pg, shard, offset, mask)


@dataclass(frozen=True)
class FailureSpec:
    """One failure event: a scope (osd or any bucket type), a target
    (device id or bucket name/index), and an action."""

    scope: str
    target: str
    action: str = "down"

    def __str__(self) -> str:
        return f"{self.scope}:{self.target}:{self.action}"

    @property
    def is_bitrot(self) -> bool:
        return self.scope == "bitrot"

    @property
    def is_net(self) -> bool:
        """Heartbeat-layer spec (netsplit/slow): no map edit; routed
        to the liveness detector, never to build_incremental."""
        return self.scope in NET_SCOPES

    @property
    def is_rank(self) -> bool:
        """Rank-observation spec (rankdelay/rankdrop/rankstall): no
        map edit and no cluster condition at all — routed to
        :mod:`ceph_tpu_torch.recovery.reconcile`, never to
        build_incremental or the event tape."""
        return self.scope in RANK_SCOPES

    @property
    def is_chip(self) -> bool:
        """Chip-fault spec (chipstall/chipslow/chipdrop): shapes the
        device mesh the work-stealing dispatcher drives — routed to
        :mod:`ceph_tpu_torch.recovery.dispatch`, never to build_incremental
        or the event tape."""
        return self.scope in CHIP_SCOPES

    @property
    def is_crash(self) -> bool:
        """Process-kill spec (``crash:EPOCH[:PHASE]``): kills the
        driving process itself — routed to
        :mod:`ceph_tpu.recovery.checkpoint`, never to
        build_incremental or the event tape."""
        return self.scope == CRASH_SCOPE

    def bitrot(self) -> BitrotEvent:
        """Decode a ``bitrot`` spec's target (raises for map scopes)."""
        if not self.is_bitrot:
            raise ValueError(f"{self} is not a bitrot spec")
        return BitrotEvent.from_target(self.target)

    def rank(self) -> int:
        """The simulation rank a rank-scoped spec targets (raises for
        every other scope)."""
        if not self.is_rank:
            raise ValueError(f"{self} is not a rank-scoped spec")
        return int(self.target.split(".")[0])

    def rank_arg(self) -> int:
        """The second target component of a rank-scoped spec: the
        delay in milliseconds (``rankdelay``) or the stall length in
        epochs (``rankstall``, 0 = permanent)."""
        parts = self.target.split(".")
        if not self.is_rank or len(parts) != 2:
            raise ValueError(f"{self} carries no rank argument")
        return int(parts[1])

    def chip(self) -> int:
        """The local chip index a chip-scoped spec targets (raises for
        every other scope)."""
        if not self.is_chip:
            raise ValueError(f"{self} is not a chip-scoped spec")
        return int(self.target.split(".")[0])

    def chip_arg(self) -> int:
        """The second target component of a chip-scoped spec: the
        stalled-launch count (``chipstall``, 0 = every launch) or the
        slowdown factor (``chipslow``)."""
        parts = self.target.split(".")
        if not self.is_chip or len(parts) != 2:
            raise ValueError(f"{self} carries no chip argument")
        return int(parts[1])

    def crash_epoch(self) -> int:
        """The simulated epoch a crash spec fires at (raises for every
        other scope)."""
        if not self.is_crash:
            raise ValueError(f"{self} is not a crash spec")
        return int(self.target)


def _parse_rank_target(scope: str, target: str) -> str:
    """Validate + canonicalize a rank-scoped target (loudly: the same
    surface as dict-key typos).  Returns the canonical dotted form
    with no leading zeros."""
    want = _RANK_TARGET_ARITY[scope]
    shape = {
        "rankdelay": "RANK.DELAY_MS", "rankdrop": "RANK",
        "rankstall": "RANK.EPOCHS",
    }[scope]
    parts = target.split(".")
    if len(parts) != want or not all(p.isdigit() for p in parts):
        raise UnknownSpecKeyError(
            f"bad {scope} target {target!r} (want {shape}, "
            f"{want} non-negative integer(s) — a negative rank, delay, "
            "or epoch count is invalid)"
        )
    vals = [int(p) for p in parts]
    if scope == "rankdelay" and vals[1] == 0:
        raise UnknownSpecKeyError(
            f"rankdelay of 0 ms in {target!r} is a no-op; schedule a "
            "positive delay or drop the spec"
        )
    return ".".join(str(v) for v in vals)


def _parse_chip_target(scope: str, target: str) -> str:
    """Validate + canonicalize a chip-scoped target (loudly: the same
    surface as rank targets).  Returns the canonical dotted form with
    no leading zeros."""
    want = _CHIP_TARGET_ARITY[scope]
    shape = {
        "chipstall": "CHIP.LAUNCHES", "chipslow": "CHIP.FACTOR",
        "chipdrop": "CHIP",
    }[scope]
    parts = target.split(".")
    if len(parts) != want or not all(p.isdigit() for p in parts):
        raise UnknownSpecKeyError(
            f"bad {scope} target {target!r} (want {shape}, "
            f"{want} non-negative integer(s) — a negative chip index, "
            "launch count, or slowdown factor is invalid)"
        )
    vals = [int(p) for p in parts]
    if scope == "chipslow" and vals[1] < 2:
        raise UnknownSpecKeyError(
            f"chipslow factor {vals[1]} in {target!r} is a no-op; "
            "schedule a factor >= 2 or drop the spec"
        )
    return ".".join(str(v) for v in vals)


def check_chip(spec: FailureSpec, n_chips: int) -> int:
    """Range-check a chip-scoped spec against the mesh it will run
    under (the consumer-side twin of :func:`check_rank`).  Returns the
    chip index."""
    c = spec.chip()
    if not 0 <= c < n_chips:
        raise UnknownSpecKeyError(
            f"{spec}: chip {c} outside [0, {n_chips})"
        )
    return c


def check_rank(spec: FailureSpec, n_ranks: int) -> int:
    """Range-check a rank-scoped spec against the process count it
    will run under (the consumer-side twin of
    :meth:`LivenessDetector.apply`'s OSD range check).  Returns the
    rank."""
    r = spec.rank()
    if not 0 <= r < n_ranks:
        raise UnknownSpecKeyError(
            f"{spec}: rank {r} outside [0, {n_ranks})"
        )
    return r


def parse_spec(text, scopes: tuple[str, ...] = KNOWN_SCOPES) -> FailureSpec:
    """``scope:target[:action]`` string OR ``{"scope": ..., "target":
    ..., "action": ...}`` dict -> :class:`FailureSpec`.

    Validates eagerly — a bad spec must die at the CLI/timeline surface
    with a clear message, not deep inside map application: the scope
    must be ``osd``, ``bitrot``, or a known bucket type, the target
    non-empty (a non-negative integer for ``osd``, normalized so
    ``osd:007`` and ``osd:7`` are the same event;
    ``PG.SHARD.OFFSET.MASK`` for ``bitrot``), and the action one of
    :data:`ACTIONS` (``corrupt``, and only ``corrupt``, for
    ``bitrot``).  Dict-form specs reject unknown keys with
    :class:`UnknownSpecKeyError` — silently ignoring a typoed key would
    inject a default event the author never scheduled.
    """
    if isinstance(text, dict):
        extra = sorted(set(text) - set(SPEC_KEYS))
        if extra:
            raise UnknownSpecKeyError(
                f"unknown key(s) {extra} in failure spec dict {text!r}; "
                f"allowed keys {SPEC_KEYS}, scopes one of {KNOWN_SCOPES}"
            )
        if "scope" not in text or "target" not in text:
            raise ValueError(
                f"failure spec dict {text!r} needs 'scope' and 'target'"
            )
        scope = str(text["scope"])
        parts = [scope, str(text["target"])]
        if "action" in text:
            parts.append(str(text["action"]))
        return parse_spec(":".join(parts), scopes)
    parts = text.split(":")
    if len(parts) == 2:
        scope, target = parts
        if scope == "bitrot":
            action = BITROT_ACTION
        elif scope in NET_SCOPES:
            action = "drop"
        elif scope in RANK_SCOPES:
            action = RANK_ACTIONS[scope][0]
        elif scope in CHIP_SCOPES:
            action = CHIP_ACTIONS[scope][0]
        else:
            action = "down"
    elif len(parts) == 3:
        scope, target, action = parts
    else:
        raise ValueError(f"bad failure spec {text!r} (scope:target[:action])")
    if scope not in scopes:
        raise ValueError(
            f"unknown scope {scope!r} in {text!r}; one of {scopes}"
        )
    if not target:
        raise ValueError(f"empty target in failure spec {text!r}")
    if scope == "osd":
        if not target.isdigit():
            raise ValueError(
                f"osd target must be a non-negative integer, got {target!r}"
            )
        target = str(int(target))  # canonical: no leading zeros
    if scope == "bitrot":
        if action != BITROT_ACTION:
            raise ValueError(
                f"bitrot specs only support action {BITROT_ACTION!r}, "
                f"got {action!r}"
            )
        # canonical: no leading zeros in any component
        target = str(BitrotEvent.from_target(target))
        return FailureSpec(scope, target, action)
    if scope in NET_SCOPES:
        if not target.isdigit():
            raise ValueError(
                f"{scope} target must be an OSD id (non-negative "
                f"integer), got {target!r}"
            )
        if action not in NET_ACTIONS:
            raise ValueError(
                f"{scope} specs only support actions {NET_ACTIONS}, "
                f"got {action!r}"
            )
        return FailureSpec(scope, str(int(target)), action)
    if scope in RANK_SCOPES:
        if action not in RANK_ACTIONS[scope]:
            raise ValueError(
                f"{scope} specs only support actions "
                f"{RANK_ACTIONS[scope]}, got {action!r}"
            )
        return FailureSpec(scope, _parse_rank_target(scope, target), action)
    if scope in CHIP_SCOPES:
        if action not in CHIP_ACTIONS[scope]:
            raise ValueError(
                f"{scope} specs only support actions "
                f"{CHIP_ACTIONS[scope]}, got {action!r}"
            )
        return FailureSpec(scope, _parse_chip_target(scope, target), action)
    if scope == CRASH_SCOPE:
        if len(parts) == 2:
            action = CRASH_ACTIONS[0]
        if action not in CRASH_ACTIONS:
            raise ValueError(
                f"{CRASH_SCOPE} specs only support actions "
                f"{CRASH_ACTIONS}, got {action!r}"
            )
        if not target.isdigit():
            raise UnknownSpecKeyError(
                f"bad {CRASH_SCOPE} target {target!r} (want a "
                "non-negative simulated-epoch index)"
            )
        return FailureSpec(scope, str(int(target)), action)
    if action not in ACTIONS:
        raise ValueError(f"bad action {action!r}; one of {ACTIONS}")
    return FailureSpec(scope, target, action)


def normalize(text: str, scopes: tuple[str, ...] = KNOWN_SCOPES) -> str:
    """Canonical ``scope:target:action`` string for a spec; the fixed
    point of parsing (``str(parse_spec(s)) == normalize(s)``)."""
    return str(parse_spec(text, scopes))


def osds_in_subtree(crush: CrushMap, bucket_id: int) -> list[int]:
    """All device ids under a bucket, depth-first (stable order)."""
    out: list[int] = []
    stack = [bucket_id]
    seen = set()
    while stack:
        bid = stack.pop()
        if bid in seen:
            raise ValueError(f"cycle at bucket {bid}")
        seen.add(bid)
        b = crush.buckets[bid]
        subs = []
        for item in b.items:
            if item >= 0:
                out.append(item)
            else:
                subs.append(item)
        stack.extend(reversed(subs))
    return out


def resolve_targets(m: OSDMap, spec: FailureSpec) -> list[int]:
    """OSD ids a spec touches.  ``osd`` scope is the id itself; bucket
    scopes resolve the bucket by name (bare indices get the scope
    prefixed: ``rack:0`` -> ``rack0``) and collect its subtree."""
    if spec.is_bitrot:
        raise ValueError(f"{spec} targets shard bytes, not OSDs")
    if spec.is_rank:
        raise ValueError(
            f"{spec} targets a simulation rank's observations, not OSDs"
        )
    if spec.is_chip:
        raise ValueError(
            f"{spec} targets a device-mesh chip, not OSDs"
        )
    if spec.is_crash:
        raise ValueError(
            f"{spec} kills the driving process, it touches no OSDs"
        )
    if spec.is_net:
        return [int(spec.target)]
    if spec.scope == "osd":
        osd = int(spec.target)
        if not m.exists(osd):
            raise ValueError(f"osd.{osd} does not exist")
        return [osd]
    name = spec.target
    try:
        bucket = m.crush.bucket_by_name(name)
    except KeyError:
        try:
            bucket = m.crush.bucket_by_name(f"{spec.scope}{name}")
        except KeyError:
            raise ValueError(
                f"no bucket {name!r} or {spec.scope}{name!r} in crush map"
            ) from None
    tname = m.crush.types[bucket.type_id]
    if tname != spec.scope:
        raise ValueError(
            f"bucket {bucket.name!r} has type {tname!r}, not {spec.scope!r}"
        )
    return [o for o in osds_in_subtree(m.crush, bucket.id) if m.exists(o)]


def build_incremental(m: OSDMap, specs) -> Incremental:
    """Compile failure specs into one epoch delta (NOT applied).

    State edits use the reference's xor-mask convention: an OSD that is
    already in the target state contributes nothing, so re-injecting an
    event is a no-op rather than a state flip back.
    """
    if isinstance(specs, (str, FailureSpec)):
        specs = [specs]
    inc = Incremental(epoch=m.epoch + 1)
    for spec in specs:
        if isinstance(spec, str):
            spec = parse_spec(spec)
        if spec.is_bitrot:
            raise ValueError(
                f"{spec} is silent corruption, not a map edit; route it "
                "through ChaosEngine (corrupt= callback), not "
                "build_incremental/inject"
            )
        if spec.is_net:
            raise ValueError(
                f"{spec} suppresses heartbeats, it is not a map edit; "
                "route it through ChaosEngine's LivenessDetector — the "
                "map changes only when detection fires"
            )
        if spec.is_rank:
            raise ValueError(
                f"{spec} skews one rank's observations, it is not a "
                "map edit; route it through "
                "ceph_tpu_torch.recovery.reconcile (rank_view_timeline / "
                "DivergentDriver)"
            )
        if spec.is_chip:
            raise ValueError(
                f"{spec} faults a device-mesh chip, it is not a map "
                "edit; route it through the work-stealing dispatcher "
                "(ceph_tpu_torch.recovery.dispatch)"
            )
        if spec.is_crash:
            raise ValueError(
                f"{spec} kills the driving process, it is not a map "
                "edit; route it through a checkpointed runner "
                "(ceph_tpu.recovery.checkpoint)"
            )
        for osd in resolve_targets(m, spec):
            if spec.action in ("down", "down_out") and m.is_up(osd):
                inc.new_state[osd] = inc.new_state.get(osd, 0) | UP
            if spec.action == "up" and m.exists(osd) and not m.is_up(osd):
                inc.new_state[osd] = inc.new_state.get(osd, 0) | UP
            if spec.action in ("out", "down_out") and not m.is_out(osd):
                inc.new_weight[osd] = 0
            if spec.action == "in" and m.is_out(osd):
                inc.new_weight[osd] = 0x10000
    return inc


def inject(m: OSDMap, specs) -> Incremental:
    """Apply failure specs to the map as one new epoch; returns the
    applied :class:`Incremental` so callers can log/replay it."""
    inc = build_incremental(m, specs)
    m.apply_incremental(inc)
    return inc


@dataclass
class FlapRecord:
    """One flapping run's epoch trail."""

    osds: list[int]
    incrementals: list[Incremental] = field(default_factory=list)


def flap(m: OSDMap, spec: FailureSpec | str, cycles: int = 3) -> FlapRecord:
    """Flapping sequence: ``cycles`` down/up pairs, each its own epoch
    (the mon would see exactly this trail from a flapping NIC).  The
    map ends back up; every intermediate epoch is returned so a peering
    pass can replay the churn epoch by epoch."""
    if isinstance(spec, str):
        spec = parse_spec(spec)
    if spec.action != "down":
        raise ValueError("flap() only makes sense for 'down' specs")
    rec = FlapRecord(osds=resolve_targets(m, spec))
    for _ in range(cycles):
        rec.incrementals.append(inject(m, spec))
        rec.incrementals.append(
            inject(m, FailureSpec(spec.scope, spec.target, "up"))
        )
    return rec
