"""Device-resident flight recorder for the epoch loop.

The counterpart of the reference package's ``obs/flight.py``.  A fixed
ring of per-epoch telemetry rows rides the epoch loop on the device:

- :class:`FlightState` is a frozen dataclass of an int64 ring ``[R,
  L]`` (``[F, R, L]`` for a fleet; ``R`` a power of two, ``L`` the
  static :data:`FLIGHT_LANES` schema) and a 0-d int64 ``head`` counting
  every epoch ever recorded; the row a record lands in is ``head & (R -
  1)``, worked out on the device.
- :func:`flight_record` writes one row with an indexed copy and reads
  nothing back (:func:`flight_record_` in place, as a graph replay
  does).  Per-stage cost is carried as **cycle proxies**:
  deterministic op counts (the peering bucket width, the routed ops,
  the scrub window), never the wall clock, so two runs compare exactly.
- :func:`drain_flight` un-rotates the ring on one copy back;
  :func:`journal_drain` lands its summary as a ``flight.drain`` journal
  record; :func:`write_flight_dump` commits a crash-consistent
  ``flightdump-*.json`` (tmp, fsync, replace, directory fsync) and
  :func:`crash_dump_guard` arms it around typed failures, so ``cli.status
  crash`` can render a post-mortem panel.

``flight_recorder`` is ``on``/``off``/``auto``; the port has no
bench-decided defaults file, so ``auto`` resolves to off.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device

I64 = torch.int64

#: static per-epoch lane schema (ring columns, int64 each): epoch
#: identity, dirty-set/ladder telemetry, traffic outcomes, liveness
#: transitions, scrub, stripe cache (zero when no write path rides the
#: loop), and the per-stage cycle proxies
FLIGHT_LANES = (
    "epoch",               # epoch-loop step index (absolute epoch)
    "dirty",               # 1 = peering re-ran this epoch
    "rung",                # ladder rung chosen (-1 quiet, n_rungs dense)
    "dirty_pgs",           # dirty-set size entering the ladder
    "compact",             # 1 = compacted branch taken (vs dense)
    "heavy",               # heavy-epoch flag (weight edit / OSD up)
    "served",              # traffic outcome counts
    "degraded",
    "blocked",
    "writes",              # committed client writes
    "deg_reads",           # degraded reads served
    "eff_down",            # liveness transitions become map edits
    "eff_up",
    "eff_out",
    "down_total",          # detector-down OSDs after the tick
    "scrub_due",           # PGs whose scrub window ticked
    "stripe_hits",         # stripe-cache traffic (write-path runs)
    "stripe_misses",
    "stripe_evictions",
    "stripe_delta_words",  # parity-delta payload (u32 words)
    "cycles_peer",         # per-stage cycle proxies
    "cycles_traffic",      # (op counts, never the wall clock)
    "cycles_scrub",
)

N_FLIGHT_LANES = len(FLIGHT_LANES)

#: journal/dump envelope version for drained flight payloads
FLIGHT_SCHEMA_VERSION = 1


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclass(frozen=True)
class FlightState:
    """The recorder's state: the lane ring and the epoch head.  ``head``
    counts every epoch ever recorded (occupancy is ``min(head, R)``,
    drops ``max(head - R, 0)``)."""

    ring: torch.Tensor  # i64 [..., R, N_FLIGHT_LANES]
    head: torch.Tensor  # i64 []: epochs recorded since empty

    @property
    def ring_epochs(self) -> int:
        return int(self.ring.shape[-2])


def empty_flight(ring_epochs: int, *, fleet: int | None = None,
                 device="cuda") -> FlightState:
    """A zeroed recorder on ``device`` (the card by default).
    ``ring_epochs`` must be a power of two; ``fleet`` adds a leading
    per-lane axis."""
    r = int(ring_epochs)
    if not _is_pow2(r):
        raise ValueError(
            f"flight_ring_epochs must be a power of two, got {r}"
        )
    dev = resolve_device(device)
    shape = (r, N_FLIGHT_LANES) if fleet is None else (
        int(fleet), r, N_FLIGHT_LANES
    )
    return FlightState(ring=torch.zeros(shape, dtype=I64, device=dev),
                       head=torch.zeros((), dtype=I64, device=dev))


def flight_row(*, device=None, **lanes) -> torch.Tensor:
    """One int64 lane row (or a ``[fleet, L]`` block when the values
    carry a leading fleet axis) in :data:`FLIGHT_LANES` order.  Values
    are host numbers or tensors; missing lanes are zero; unknown lane
    names raise."""
    unknown = set(lanes) - set(FLIGHT_LANES)
    if unknown:
        raise ValueError(f"unknown flight lanes: {sorted(unknown)}")
    if device is None:
        device = next((v.device for v in lanes.values() if isinstance(v, torch.Tensor)),
                      torch.device("cpu"))

    def value(v):
        if isinstance(v, torch.Tensor):
            return v.to(I64)
        if isinstance(v, np.ndarray) and v.ndim:
            return torch.from_numpy(v.astype(np.int64)).to(device)
        # a host number becomes a fill on the device: no copy, no sync
        return torch.full((), int(v), dtype=I64, device=device)

    vals = [value(lanes.get(name, 0)) for name in FLIGHT_LANES]
    return torch.stack(torch.broadcast_tensors(*vals), dim=-1)


def flight_record(fs: FlightState, row: torch.Tensor) -> FlightState:
    """Record one epoch's lane row into the ring: an indexed copy at
    ``head & (R - 1)``, computed on the device (nothing is read back).
    Returns a new state; ``fs`` is left as it was."""
    r = fs.ring.shape[-2]
    idx = (fs.head & (r - 1)).reshape(1)
    ring = fs.ring.index_copy(fs.ring.dim() - 2, idx, row.unsqueeze(-2).to(I64))
    return FlightState(ring=ring, head=fs.head + 1)


def flight_record_(fs: FlightState, row: torch.Tensor) -> FlightState:
    """:func:`flight_record` in place: the row copied into ``fs.ring`` at
    ``head & (R - 1)`` and ``fs.head`` advanced, both on the device (the
    compiled superstep's ring, which a graph replay writes)."""
    r = fs.ring.shape[-2]
    idx = (fs.head & (r - 1)).reshape(1)
    fs.ring.index_copy_(fs.ring.dim() - 2, idx, row.unsqueeze(-2).to(I64))
    fs.head.add_(1)
    return fs


# ---------------------------------------------------------------------------
# host-side drain


def drain_flight(fs: FlightState) -> dict:
    """Bring the ring to the host and un-rotate it: a pure read.  Returns
    occupancy bookkeeping plus the valid rows oldest-to-newest
    (``[occupancy, L]``, or ``[fleet, occupancy, L]`` for per-lane
    rings)."""
    ring = fs.ring.cpu().numpy()
    head = int(fs.head)
    r = ring.shape[-2]
    occ = min(head, r)
    if head <= r:
        rows = ring[..., :head, :]
    else:
        cut = head & (r - 1)
        rows = np.concatenate(
            [ring[..., cut:, :], ring[..., :cut, :]], axis=-2
        )
    return {
        "v": FLIGHT_SCHEMA_VERSION,
        "lanes": list(FLIGHT_LANES),
        "ring_epochs": r,
        "head": head,
        "occupancy": occ,
        "drops": max(head - r, 0),
        "rows": rows,
    }


def _lane_col(drain: dict, name: str) -> np.ndarray:
    return drain["rows"][..., FLIGHT_LANES.index(name)]


def journal_drain(journal, fs: FlightState, **extra) -> dict | None:
    """Land a drained ring summary as a typed ``flight.drain`` journal
    record (aggregates only; the trace exporter re-joins rows by epoch).
    Returns the drain dict, or None when the ring is empty."""
    drain = drain_flight(fs)
    if drain["occupancy"] == 0:
        return None
    epochs = _lane_col(drain, "epoch")
    dirty = _lane_col(drain, "dirty")
    attrs = {
        "v": drain["v"],
        "ring_epochs": drain["ring_epochs"],
        "head": drain["head"],
        "occupancy": drain["occupancy"],
        "drops": drain["drops"],
        "epoch_first": int(epochs.min()),
        "epoch_last": int(epochs.max()),
        "dirty_epochs": int(dirty.sum()),
        "stripe_hits": int(_lane_col(drain, "stripe_hits").sum()),
        "stripe_misses": int(_lane_col(drain, "stripe_misses").sum()),
        **extra,
    }
    journal.event("flight.drain", **attrs)
    return drain


# ---------------------------------------------------------------------------
# knob resolution


def resolve_flight_recorder(mode: str) -> bool:
    """Map the ``flight_recorder`` knob onto on/off.  The reference's
    'auto' consults a bench-decided defaults file; the port has none,
    so 'auto' is off."""
    mode = str(mode)
    if mode == "on":
        return True
    if mode in ("off", "auto"):
        return False
    raise ValueError(f"flight_recorder must be on/off/auto, "
                     f"got {mode!r}")


# ---------------------------------------------------------------------------
# crash-dump forensics


def _fsync_dir(path: str) -> None:
    """fsync a directory so renames within it survive a crash."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _next_dump_path(root: str, reason: str) -> str:
    """A fresh ``flightdump-<reason>-<k>.json`` name: numbered, not
    timestamped (this module stays off the wall clock)."""
    k = 0
    while True:
        path = os.path.join(root, f"flightdump-{reason}-{k:04d}.json")
        if not os.path.exists(path) and not os.path.exists(
            path + ".tmp"
        ):
            return path
        k += 1


def write_flight_dump(
    root: str,
    fs: FlightState | None,
    *,
    reason: str,
    error: str = "",
    state: dict | None = None,
    journal=None,
) -> str:
    """Commit a crash-consistent flight dump and return its path.

    The payload is the drained ring (last-N-epoch rows, lane schema,
    occupancy bookkeeping) plus free-form ``state``.  The commit chain:
    write ``.tmp``, flush + fsync the file, ``os.replace`` onto the final
    name, fsync the directory, so a crash leaves either no dump or a
    complete one.  With a journal, a ``flight.dump`` event names the
    path, so the status CLI can find the dump from the journal alone."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    drain = drain_flight(fs) if fs is not None else None
    payload = {
        "v": FLIGHT_SCHEMA_VERSION,
        "kind": "flight.dump",
        "reason": str(reason),
        "error": str(error),
        "state": state or {},
    }
    if drain is not None:
        payload["flight"] = {
            **{k: drain[k] for k in (
                "v", "lanes", "ring_epochs", "head", "occupancy",
                "drops",
            )},
            "rows": np.asarray(drain["rows"]).tolist(),
        }
    final = _next_dump_path(root, str(reason))
    tmp = final + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, sort_keys=True)
        fh.write("\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)
    _fsync_dir(root)
    if journal is not None:
        journal.event(
            "flight.dump", path=final, reason=str(reason),
            error=str(error),
        )
    return final


def read_flight_dump(path: str) -> dict:
    """Parse a dump back; raises ValueError on a structurally invalid
    file."""
    with open(path) as fh:
        doc = json.load(fh)
    problems = validate_flight_dump(doc)
    if problems:
        raise ValueError(f"{path}: invalid flight dump: {problems}")
    return doc


def validate_flight_dump(doc) -> list[str]:
    """Minimal schema check for a dump payload; [] = valid."""
    out = []
    if not isinstance(doc, dict):
        return ["dump is not an object"]
    for key in ("v", "kind", "reason", "state"):
        if key not in doc:
            out.append(f"missing key {key!r}")
    if doc.get("kind") != "flight.dump":
        out.append(f"kind is {doc.get('kind')!r}")
    fl = doc.get("flight")
    if fl is not None:
        if not isinstance(fl, dict):
            return out + ["flight is not an object"]
        if fl.get("lanes") != list(FLIGHT_LANES):
            out.append("flight.lanes does not match FLIGHT_LANES")
        rows = fl.get("rows")
        if not isinstance(rows, list):
            out.append("flight.rows is not a list")
        elif rows and not _is_pow2(int(fl.get("ring_epochs", 0))):
            out.append("flight.ring_epochs is not a power of two")
    return out


class crash_dump_guard:
    """Context manager arming crash-dump forensics around a run: any
    escaping typed failure (``ChipLostError``, ``RankStalledError``,
    ``CheckpointError``, or anything matching ``types``) dumps the
    recorder's last-N-epoch ring plus the supplied state snapshot, then
    re-raises.  ``flight`` may be a :class:`FlightState` or a zero-arg
    callable resolved at failure time (the driver's live state)."""

    def __init__(self, root: str, flight=None, *, journal=None,
                 state: dict | None = None, types=None):
        self.root = str(root)
        self.flight = flight
        self.journal = journal
        self.state = state or {}
        if types is None:
            from ..analysis.runtime_guard import RankStalledError
            from ..recovery.checkpoint import CheckpointError
            from ..recovery.dispatch import ChipLostError

            types = (ChipLostError, RankStalledError, CheckpointError)
        self.types = tuple(types)
        self.dump_path: str | None = None

    def __enter__(self) -> "crash_dump_guard":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None or not issubclass(exc_type, self.types):
            return False
        fs = self.flight() if callable(self.flight) else self.flight
        self.dump_path = write_flight_dump(
            self.root, fs,
            reason=exc_type.__name__,
            error=str(exc),
            state=self.state,
            journal=self.journal,
        )
        return False
