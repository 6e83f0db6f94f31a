"""Crash-consistent checkpoint and restore of device-resident state.

The counterpart of the reference package's ``recovery/checkpoint.py``,
with its file format, so a snapshot either package writes restores in
the other:

- :class:`CheckpointStore`: one file a snapshot, ``ckpt-<seq>.bin``: a
  JSON header line (magic ``ceph-tpu-ckpt``, version 1, seq, meta, and
  the lane table: name, dtype, shape, nbytes, CRC32C a lane) followed by
  the lanes' raw bytes.  The lanes are the reference's flatten order and
  dtypes (:func:`~ceph_tpu_torch.convert.state_lanes`: ``state.000``,
  ``state.001``, ... then ``series.<column>``).  The commit order is tmp
  file, fsync, atomic rename, directory fsync, fsync'd manifest append;
  a torn write at any point falls back to the previous valid snapshot
  (a ``checkpoint.torn`` journal event).
- The lanes' CRCs run through K8 on the state's device: every lane's
  bytes, zero-padded at the front to whole :data:`CRC_ROW`-byte rows
  (leading zero bytes leave the CRC register at 0), in one
  :func:`~ceph_tpu_torch.recovery.scrub.crc_rows` launch, the rows of a
  lane combined on the host (:func:`lane_crcs`).  A restore copies the
  payload to the device once and checks every lane the same way.
- :class:`WriteAheadLog`: an fsync-per-append JSONL of applied
  Incrementals and tape cursors between snapshots.
- :func:`checkpointed_superstep`, :func:`checkpointed_fleet`: the epoch
  loops with a durable snapshot (state and the series so far) at every
  ``snapshot_every`` boundary; a killed run resumes from the last valid
  snapshot and lands bit-equal to an uninterrupted run.  The epoch
  loop's host view is written into the state's scalars at a snapshot
  and rebuilt from them on restore (``EpochDriver.host_view``).
- ``crash:EPOCH[:PHASE]`` specs lower to :class:`CrashPoint`\\ s that raise
  :class:`SimulatedCrash` or SIGKILL the process before, during (a torn
  tmp file) or after a checkpoint write (``python -m
  ceph_tpu_torch.recovery._crashbox``).
- :func:`save_divergent`, :func:`restore_divergent`: every rank's view
  and the reconcile protocol's state at a reconciliation boundary,
  guarded on restore by recomputed view fingerprints.
"""

from __future__ import annotations

import functools
import json
import os
import signal
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..analysis import runtime_guard
from ..convert import lane_bytes, lane_specs, state_from_lanes
from ..core.cluster_state import apply_incremental, index_state, stack_states
from ..osdmap.map import Incremental
from .chaos import ChaosEvent, ChaosTimeline
from .failure import CRASH_ACTIONS
from .scrub import crc32c_shift, crc32c_x8n, crc_rows, gf2_multmodp
from .superstep import _SERIES_FIELDS, EpochSeries

MAGIC = "ceph-tpu-ckpt"
VERSION = 1
MANIFEST = "MANIFEST"
#: bytes a CRC row: every lane is cut into rows of this many bytes
CRC_ROW = 4096


class CheckpointError(ValueError):
    """A snapshot failed validation (bad magic/version, lane CRC
    mismatch, truncated payload, or a shape/dtype that does not match
    the restore template).  The loader treats it as a torn write and
    falls back to the previous manifest entry; it only escapes to a
    caller through :func:`restore_divergent`'s fingerprint guard."""


class SimulatedCrash(RuntimeError):
    """An in-process ``crash:`` spec fired: the run must stop HERE, as
    if the process had been killed.  Carries the seeded epoch and the
    checkpoint-relative phase."""

    def __init__(self, epoch: int, phase: str):
        super().__init__(
            f"simulated crash at epoch {epoch} ({phase} checkpoint "
            "write)"
        )
        self.epoch = int(epoch)
        self.phase = str(phase)


@dataclass(frozen=True)
class CrashPoint:
    """One seeded kill: fire at the first snapshot boundary at or past
    ``epoch``, positioned ``before``/``during``/``after`` that
    boundary's checkpoint write.  ``action`` picks the mechanism:
    ``raise`` (default) throws :class:`SimulatedCrash`, ``sigkill``
    SIGKILLs the process outright (the ``_crashbox`` child uses it)."""

    epoch: int
    phase: str = "before"
    action: str = "raise"

    def __post_init__(self):
        if self.phase not in CRASH_ACTIONS:
            raise ValueError(
                f"crash phase must be one of {CRASH_ACTIONS}, "
                f"got {self.phase!r}"
            )
        if self.action not in ("raise", "sigkill"):
            raise ValueError(f"bad crash action {self.action!r}")

    def fire(self) -> None:
        if self.action == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise SimulatedCrash(self.epoch, self.phase)


def crash_points(
    timeline: ChaosTimeline, action: str = "raise"
) -> tuple[CrashPoint, ...]:
    """The :class:`CrashPoint`\\ s a timeline's ``crash:`` specs lower
    to, in epoch order."""
    pts = [
        CrashPoint(spec.crash_epoch(), spec.action, action)
        for ev in timeline.events()
        for spec in ev.specs
        if spec.is_crash
    ]
    return tuple(sorted(pts, key=lambda p: p.epoch))


def strip_crash_specs(timeline: ChaosTimeline) -> ChaosTimeline:
    """The timeline with every ``crash:`` spec removed: what the tape
    compiler (which rejects them) may consume."""
    events = []
    for ev in timeline.events():
        specs = tuple(s for s in ev.specs if not s.is_crash)
        if specs:
            events.append(ChaosEvent(ev.t, specs))
    return ChaosTimeline(events)


class _CrashSchedule:
    """Fire-once bookkeeping for a run's crash points: each point fires
    at the FIRST boundary whose end epoch reaches it, in its declared
    phase, then never again."""

    def __init__(self, crashes):
        self.points = [
            c if isinstance(c, CrashPoint) else CrashPoint(*c)
            for c in crashes
        ]
        self._fired: set[int] = set()

    def due(self, end_epoch: int, phase: str) -> CrashPoint | None:
        for i, cp in enumerate(self.points):
            if i in self._fired or cp.phase != phase:
                continue
            if cp.epoch <= end_epoch:
                self._fired.add(i)
                return cp
        return None

    def fire(self, end_epoch: int, phase: str) -> None:
        cp = self.due(end_epoch, phase)
        if cp is not None:
            cp.fire()


# ---------------------------------------------------------------------------
# lane CRCs through K8


def lane_crcs(lanes: list[torch.Tensor], device) -> list[int]:
    """CRC32C of each flat uint8 lane, through one K8 launch on
    ``device`` (the plain version on the CPU).  Each lane is padded at
    the front with zero bytes to whole :data:`CRC_ROW`-byte rows; since
    leading zeros leave the CRC register at 0, the padded lane's CRC
    turns into the lane's by ``S_Lp(~0) ^ S_L(~0)`` (``S_n`` the
    register after ``n`` zero bytes), and a lane's rows combine as
    :func:`~ceph_tpu_torch.recovery.scrub.crc32c_combine` does, by one
    multiplier computed once."""
    device = resolve_device(device)
    rows, counts = [], []
    for b in lanes:
        n = int(b.numel())
        k = -(-n // CRC_ROW)
        counts.append(k)
        if k:
            b = b.to(device)
            pad = k * CRC_ROW - n
            if pad:
                b = torch.cat([torch.zeros(pad, dtype=torch.uint8, device=device), b])
            rows.append(b.view(k, CRC_ROW))
    crcs = crc_rows(torch.cat(rows)).tolist() if rows else []
    row_shift = crc32c_x8n(CRC_ROW)  # S_CRC_ROW's multiplier, once
    out, i = [], 0
    for b, k in zip(lanes, counts):
        n = int(b.numel())
        if not k:
            out.append(0)
            continue
        c = crcs[i]
        for r in crcs[i + 1:i + k]:
            c = gf2_multmodp(row_shift, c) ^ r  # crc32c_combine(c, r, CRC_ROW)
        i += k
        out.append(c ^ _ones_after(k * CRC_ROW) ^ _ones_after(n))
    return out


@functools.lru_cache(maxsize=None)
def _ones_after(n: int) -> int:
    """S_n(0xFFFFFFFF): the conditioning term of an ``n``-byte CRC."""
    return crc32c_shift(0xFFFFFFFF, n)


# ---------------------------------------------------------------------------
# the durable snapshot store


def _read_jsonl_tolerant(path: str) -> list[dict]:
    """JSONL records, tolerating a torn FINAL line (the only damage an
    fsync-per-line writer can take from a crash).  A malformed line
    followed by valid records is real corruption and raises."""
    out: list[dict] = []
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return out
    torn_at: int | None = None
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            torn_at = i
            continue
        if torn_at is not None:
            raise ValueError(
                f"{path}:{torn_at + 1}: corrupt line followed by "
                "valid records (not a torn tail)"
            )
        out.append(rec)
    return out


def _repair_torn_tail(path: str) -> None:
    """Truncate a partial final line (no trailing newline: the only
    shape a torn single-write append can leave)."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return
    if not data or data.endswith(b"\n"):
        return
    keep = data.rfind(b"\n") + 1
    with open(path, "rb+") as fh:
        fh.truncate(keep)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointStore:
    """Durable, crash-consistent snapshots of device-resident state.

    One directory a run.  Each snapshot is ``ckpt-<seq>.bin``: a
    one-line JSON header (magic, version, seq, caller meta and the lane
    table) followed by the lanes' raw bytes.  The commit order is the
    crash-consistency argument:

    1. the payload goes to ``.tmp-ckpt-<seq>`` (a crash here leaves a
       tmp file the next save sweeps away: the manifest never saw it);
    2. flush, fsync, atomic :func:`os.replace` to the final name,
       directory fsync (a crash before the manifest append leaves a
       valid orphan the loader never consults);
    3. one fsync'd JSONL manifest append chaining to the previous
       snapshot (a crash mid-append leaves a torn final line the reader
       tolerates).

    :meth:`load_latest` walks the manifest newest-first, checking each
    candidate's lane CRCs (K8 on ``device``, the card by default) and
    its lane table against the restore template; any damage emits a
    ``checkpoint.torn`` journal event and falls back to the previous
    entry.  ``journal``/``health`` are optional observability rides."""

    def __init__(self, root: str, *, journal=None, health=None, device="cuda"):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.journal = journal
        self.health = health
        self.device = resolve_device(device)
        #: test/chaos seam: ``callable(phase: str)`` invoked mid-write
        #: (after a partial payload flush, before the rename)
        self._crash_hook = None
        #: snapshots the loader rejected, for post-mortems
        self.torn: list[str] = []
        self.bytes_written = 0

    # -- manifest -----------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST)

    def entries(self) -> list[dict]:
        """Committed manifest entries, oldest first (torn final line
        tolerated)."""
        return _read_jsonl_tolerant(self.manifest_path)

    def next_seq(self) -> int:
        ents = self.entries()
        return int(ents[-1]["seq"]) + 1 if ents else 0

    # -- write --------------------------------------------------------

    def save(self, state, *, meta: dict | None = None,
             series: dict | None = None, host=None) -> str:
        """Commit one snapshot; returns the committed path.

        ``state`` is a ``ClusterState`` (stacked or not), a
        ``StripeBufferState``, a ``FlightState`` or a tuple of them;
        ``host`` an epoch loop's host view, whose scalars the state's
        lanes take; ``series`` an optional ``{column: ndarray}`` payload
        (the run's series so far); ``meta`` small JSON-able bookkeeping
        (the resume cursor)."""
        for fn in os.listdir(self.root):
            if fn.startswith(".tmp-"):
                os.remove(os.path.join(self.root, fn))
        seq = self.next_seq()
        specs = lane_specs(state)
        dev_lanes = lane_bytes(state, host)
        device = next((b.device for b in dev_lanes), self.device)
        names = [f"state.{i:03d}" for i in range(len(specs))]
        host_series = [np.ascontiguousarray(series[k]) for k in sorted(series or {})]
        names += [f"series.{k}" for k in sorted(series or {})]
        specs += [(a.dtype, a.shape) for a in host_series]
        series_bytes = [torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
                        for a in host_series]
        crcs = lane_crcs(dev_lanes + series_bytes, device)
        payload = (torch.cat(dev_lanes).cpu().numpy().tobytes() if dev_lanes else b"")
        lens = [int(b.numel()) for b in dev_lanes + series_bytes]
        table = [
            {"name": name, "dtype": str(np.dtype(dt)), "shape": [int(v) for v in shape],
             "nbytes": n, "crc": int(c)}
            for name, (dt, shape), n, c in zip(names, specs, lens, crcs)
        ]
        header = {
            "magic": MAGIC, "version": VERSION, "seq": seq,
            "meta": meta or {}, "lanes": table,
        }
        fname = f"ckpt-{seq:08d}.bin"
        final = os.path.join(self.root, fname)
        tmp = os.path.join(self.root, f".tmp-{fname}")
        total = sum(lens)
        span = (
            self.journal.span(
                "checkpoint.write", seq=seq, bytes=total,
                lanes=len(table),
            )
            if self.journal is not None else nullcontext()
        )
        first = lens[0] if lens else 0
        audit = (runtime_guard.FsyncAudit(f"checkpoint save seq={seq}")
                 if runtime_guard.fsync_audit_enabled() else None)
        with span, (audit if audit is not None else nullcontext()):
            with open(tmp, "wb") as fh:
                fh.write(
                    (json.dumps(header, sort_keys=True) + "\n").encode()
                )
                fh.write(payload[:first])
                if self._crash_hook is not None:
                    # the mid-write seam: header + a partial payload
                    # are durable, the commit rename is not
                    fh.flush()
                    os.fsync(fh.fileno())
                    self._crash_hook("during")
                fh.write(payload[first:])
                for a in host_series:
                    fh.write(a.tobytes())
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, final)
            _fsync_dir(self.root)
            ents = self.entries()
            prev = ents[-1]["file"] if ents else None
            # a crash mid-append can leave a torn final line; appending
            # after it would glue the new entry onto the fragment
            _repair_torn_tail(self.manifest_path)
            with open(self.manifest_path, "a") as fh:
                fh.write(json.dumps(
                    {"seq": seq, "file": fname, "prev": prev},
                    sort_keys=True,
                ) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
        if audit is not None:
            # the commit chain just performed: fsync before the replace,
            # directory fsync after
            audit.verify()
        self.bytes_written += total
        if self.health is not None:
            self.health.note_checkpoint()
        return final

    # -- read ---------------------------------------------------------

    def load_latest(self, template, *, with_series: bool = False):
        """Newest fully-valid snapshot, or ``None`` when no committed
        snapshot survives validation (the caller starts fresh).

        ``template`` supplies the structure and each lane's dtype and
        shape (a driver's initial state, or a tuple).  Returns ``(meta,
        state)`` or, ``with_series=True``, ``(meta, state, series)``,
        the state in the port's carriers on the store's device."""
        for ent in reversed(self.entries()):
            fname = str(ent.get("file", ""))
            path = os.path.join(self.root, fname)
            try:
                # each candidate snapshot's lane CRCs are checked on the host
                # torchlint: disable=J003
                meta, state, series = self._load_file(path, template)
            except (OSError, ValueError, KeyError) as e:
                self.torn.append(f"{fname}: {e}")
                if self.journal is not None:
                    self.journal.event(
                        "checkpoint.torn", file=fname,
                        seq=ent.get("seq"), error=str(e)[:200],
                    )
                continue
            if self.journal is not None:
                self.journal.event(
                    "checkpoint.restore", file=fname,
                    seq=ent.get("seq"),
                )
            if with_series:
                return meta, state, series
            return meta, state
        return None

    def _load_file(self, path: str, template):
        with open(path, "rb") as fh:
            blob = fh.read()
        nl = blob.find(b"\n")
        if nl < 0:
            raise CheckpointError("no header line")
        header = json.loads(blob[:nl].decode())
        if header.get("magic") != MAGIC:
            raise CheckpointError(f"bad magic {header.get('magic')!r}")
        if int(header.get("version", -1)) != VERSION:
            raise CheckpointError(
                f"unsupported version {header.get('version')!r}"
            )
        payload = blob[nl + 1:]
        lanes = header["lanes"]
        total = sum(int(lane["nbytes"]) for lane in lanes)
        if len(payload) < total:
            # name the first lane the short payload cuts
            off = 0
            for lane in lanes:
                n = int(lane["nbytes"])
                if off + n > len(payload):
                    raise CheckpointError(
                        f"lane {lane['name']} truncated "
                        f"({max(len(payload) - off, 0)}/{n} bytes)"
                    )
                off += n
        flat = torch.frombuffer(bytearray(payload[:total]), dtype=torch.uint8) if total else \
            torch.zeros(0, dtype=torch.uint8)
        flat = flat.to(self.device)  # the one copy to the device
        views, off = [], 0
        for lane in lanes:
            n = int(lane["nbytes"])
            views.append(flat[off:off + n])
            off += n
        for lane, crc in zip(lanes, lane_crcs(views, self.device)):
            if crc != int(lane["crc"]):
                raise CheckpointError(f"lane {lane['name']} CRC mismatch")
        try:
            specs = lane_specs(template)
        except TypeError as e:
            raise CheckpointError(f"template: {e}") from None
        state_lanes = sorted(
            (lane["name"], i) for i, lane in enumerate(lanes)
            if lane["name"].startswith("state.")
        )
        if len(state_lanes) != len(specs):
            raise CheckpointError(
                f"{len(state_lanes)} state lanes for a "
                f"{len(specs)}-leaf template"
            )
        bits = []
        for (name, i), (want_dtype, want_shape) in zip(state_lanes, specs):
            lane = lanes[i]
            dt, shape = np.dtype(lane["dtype"]), tuple(lane["shape"])
            if shape != want_shape or dt != want_dtype:
                raise CheckpointError(
                    f"lane {name}: {dt}{list(shape)} does not "
                    f"match template {want_dtype}{list(want_shape)}"
                )
            from ..convert import _BITS

            v = views[i]
            if v.storage_offset() % dt.itemsize:
                v = v.clone()  # a lane's bytes start where the last ended
            bits.append(v.view(_BITS[dt]).reshape(shape))
        state = state_from_lanes(bits, template)
        series = {}
        for lane, v in zip(lanes, views):
            if lane["name"].startswith("series."):
                series[lane["name"][len("series."):]] = np.frombuffer(
                    # a loaded series lane is the result, returned as numpy
                    # torchlint: disable=J003
                    v.cpu().numpy().tobytes(), np.dtype(lane["dtype"])
                ).reshape(tuple(lane["shape"]))
        return header.get("meta", {}), state, series


# ---------------------------------------------------------------------------
# the write-ahead log


class WriteAheadLog:
    """Fsync-per-append JSONL of what happened since the last snapshot:
    applied :class:`Incremental`\\ s (host-driven flows) and event-tape
    cursors (epoch-loop flows, where the tape itself is the log and the
    cursor names the replay point).  Reads tolerate a torn final line;
    :meth:`replay` drives the incremental tail through
    :func:`~ceph_tpu_torch.core.cluster_state.apply_incremental`."""

    def __init__(self, path: str):
        self.path = str(path)
        # restart seam: appending after a torn final line would glue
        # the new record onto the fragment and corrupt both
        _repair_torn_tail(self.path)
        self._fh = open(self.path, "a")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _write(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def append_incremental(self, inc: Incremental, *, t: float = 0.0):
        """Log one applied epoch delta."""
        self._write({
            "kind": "inc", "t": float(t), "epoch": int(inc.epoch),
            "new_state": {str(k): int(v)
                          for k, v in sorted(inc.new_state.items())},
            "new_weight": {str(k): int(v)
                           for k, v in sorted(inc.new_weight.items())},
            "new_primary_affinity": {
                str(k): int(v)
                for k, v in sorted(inc.new_primary_affinity.items())
            },
        })

    def append_cursor(self, *, step: int, tape_cursor: int,
                      now: float) -> None:
        """Log the epoch loop's replay point: the next step index and
        the tape cursor / virtual clock that go with it."""
        self._write({
            "kind": "cursor", "step": int(step),
            "tape_cursor": int(tape_cursor), "now": float(now),
        })

    def reset(self) -> None:
        """Truncate after a snapshot commits: everything in the log is
        now covered by the checkpoint."""
        self.close()
        with open(self.path, "w") as fh:
            fh.flush()
            os.fsync(fh.fileno())
        self._fh = open(self.path, "a")

    @staticmethod
    def read(path: str) -> list[dict]:
        """All committed records (torn final line tolerated)."""
        return _read_jsonl_tolerant(path)

    @staticmethod
    def _to_incremental(rec: dict) -> Incremental:
        return Incremental(
            epoch=int(rec["epoch"]),
            new_state={int(k): int(v)
                       for k, v in rec.get("new_state", {}).items()},
            new_weight={int(k): int(v)
                        for k, v in rec.get("new_weight", {}).items()},
            new_primary_affinity={
                int(k): int(v)
                for k, v in rec.get("new_primary_affinity", {}).items()
            },
        )

    def replay(self, state, *, records: list[dict] | None = None):
        """Apply the log's incremental tail to ``state`` (records past
        the state's epoch only: replay is idempotent across a checkpoint
        that already absorbed a prefix)."""
        recs = self.read(self.path) if records is None else records
        epoch = int(state.epoch)
        for rec in recs:
            if rec.get("kind") != "inc":
                continue
            if int(rec["epoch"]) <= epoch:
                continue
            state = apply_incremental(
                state, self._to_incremental(rec)
            )
        return state

    def cursor(self) -> dict | None:
        """The newest cursor record, or None."""
        recs = [r for r in self.read(self.path)
                if r.get("kind") == "cursor"]
        return recs[-1] if recs else None


# ---------------------------------------------------------------------------
# checkpointed runners


def _aligned_end(start: int, n_epochs: int, every: int) -> int:
    """The next snapshot boundary: absolute multiples of ``every`` (so a
    resumed run re-aligns with the uninterrupted run's boundaries),
    clamped to the run length."""
    return min(int(n_epochs), ((int(start) // every) + 1) * every)


def _series_cols(series: dict, like: EpochSeries) -> dict:
    """Restored series columns in the port's dtypes (the reference
    writes ``hist`` as int64, R10)."""
    return {f: np.asarray(series[f]).astype(getattr(like, f).dtype) for f in _SERIES_FIELDS}


def _commit(store: CheckpointStore, sched: _CrashSchedule, end: int, obj, *, meta: dict,
            series: dict, host=None) -> None:
    """One boundary's snapshot with the seeded kill points around it."""
    sched.fire(end, "before")
    during = sched.due(end, "during")
    if during is not None:
        store._crash_hook = lambda phase: during.fire()
    try:
        store.save(obj, meta=meta, series=series, host=host)
    finally:
        store._crash_hook = None
    sched.fire(end, "after")


def _append(cols, part, fields) -> dict:
    return {f: (np.concatenate([cols[f], getattr(part, f)]) if cols is not None
                else getattr(part, f)) for f in fields}


def checkpointed_superstep(
    driver,
    n_epochs: int,
    *,
    store: CheckpointStore,
    snapshot_every: int = 0,
    crashes=(),
    wal: WriteAheadLog | None = None,
) -> EpochSeries:
    """:meth:`EpochDriver.run_superstep` with a durable snapshot at every
    boundary and resume-from-store on entry.

    Each boundary commits the state (its scalars from the host view) and
    the full series so far, so a restore reproduces the whole run's
    :class:`EpochSeries` bit-equal to an uninterrupted one.  ``crashes``
    are :class:`CrashPoint`\\ s (or ``(epoch, phase[, action])`` tuples).
    With the driver's flight recorder on, the snapshot is the
    ``(ClusterState, FlightState)`` pair: the ring resumes with the state
    it observed."""
    n_epochs = int(n_epochs)
    every = int(snapshot_every) or max(n_epochs, 1)
    sched = _CrashSchedule(crashes)
    flight_on = bool(driver.flight_on)
    template = ((driver._init_state, driver._init_flight) if flight_on
                else driver._init_state)
    empty = EpochSeries.from_device(driver._empty_rows())
    resume = store.load_latest(template, with_series=True)
    fs = driver._init_flight
    if resume is None:
        state, start, cols = driver._init_state, 0, None
        host = driver._init_host.copy()
    else:
        meta, carry, series = resume
        state, fs = carry if flight_on else (carry, None)
        start = int(meta.get("next_epoch", 0))
        cols = _series_cols(series, empty) if series else None
        host = driver.host_view(state)
    if start == 0:
        cols = None
        state, host, fs = driver._init_state, driver._init_host.copy(), driver._init_flight
    while start < n_epochs:
        end = _aligned_end(start, n_epochs, every)
        state, fs, rows = driver.advance(state, host, start, end, fs)
        driver.flight = fs
        cols = _append(cols, EpochSeries.from_device(rows), _SERIES_FIELDS)
        # a compiled chunk set the state's scalars on the device; its host view is stale
        _commit(store, sched, end, (state, fs) if flight_on else state,
                meta={"next_epoch": end, "n_epochs": n_epochs}, series=cols,
                host=None if host.stale else host)
        if wal is not None:
            wal.reset()
            wal.append_cursor(step=end, tape_cursor=host.cursor, now=host.now)
        start = end
    driver.final_state = state
    if cols is None:
        return empty
    return EpochSeries(**cols)


def checkpointed_fleet(
    fdriver,
    n_epochs: int,
    timelines,
    *,
    store: CheckpointStore,
    snapshot_every: int = 0,
    seeds=None,
    crashes=(),
    path: str | None = None,
):
    """:meth:`FleetDriver.run_fleet` chunked over snapshot boundaries with
    a durable stacked-fleet snapshot at each; resume-from-store on
    entry.  Returns the cropped ``FleetSeries``, every lane bit-equal to
    the uninterrupted fleet run's.  ``path`` is :meth:`FleetDriver._run`'s."""
    from .fleet import FleetSeries, _empty_tape, compile_event_tape, stack_tapes

    n_epochs = int(n_epochs)
    every = int(snapshot_every) or max(n_epochs, 1)
    sched = _CrashSchedule(crashes)
    tls = list(timelines)
    tapes = [compile_event_tape(tl, fdriver.m) for tl in tls]
    ftape = stack_tapes(tapes)
    salts = fdriver._salts(len(tls), ftape.fleet_pad, seeds)
    lanes = tapes + [_empty_tape()] * (ftape.fleet_pad - len(tapes))
    template = fdriver._fleet_state(ftape.fleet_pad)
    resume = store.load_latest(template, with_series=True)
    if resume is None:
        fstate, start, cols = None, 0, None
    else:
        meta, fstate, series = resume
        start = int(meta.get("next_epoch", 0))
        cols = ({f: np.asarray(series[f]) for f in _SERIES_FIELDS} if series else None)
    if start == 0:
        fstate, cols = None, None
    empty = FleetSeries.from_device(fdriver._run(0, lanes, salts, path=path)[1], len(tls))
    while start < n_epochs:
        end = _aligned_end(start, n_epochs, every)
        fstate, rows = fdriver._run(n_epochs, lanes, salts, start=start, stop=end,
                                    fstate=fstate, path=path)
        part = FleetSeries.from_device(rows, len(tls))
        cols = _append(cols, part, _SERIES_FIELDS)
        _commit(store, sched, end, fstate,
                meta={"next_epoch": end, "n_epochs": n_epochs,
                      "fleet_pad": int(ftape.fleet_pad), "n_clusters": len(tls)},
                series=cols)
        start = end
    fdriver.final_state = fstate
    if cols is None:
        return empty
    return FleetSeries(**{f: np.asarray(cols[f]).astype(getattr(empty, f).dtype)
                          for f in _SERIES_FIELDS})


# ---------------------------------------------------------------------------
# multi-rank coordination (DivergentDriver hooks)


def save_divergent(store: CheckpointStore, driver, *, round_idx: int,
                   target: int, extra_rounds: int, rounds) -> str:
    """Snapshot every rank's view (one stacked state) plus the reconcile
    protocol's verdict state at a reconciliation boundary: the
    fleet-consistent snapshot a revived rank restores from."""
    from .reconcile import view_fingerprint

    proto = driver.protocol
    meta = {
        "round_idx": int(round_idx),
        "target": int(target),
        "extra_rounds": int(extra_rounds),
        "cur": [int(c) for c in driver.cur],
        "n_ranks": int(driver.n_ranks),
        "fingerprints": [view_fingerprint(s) for s in driver.states],
        "stall_rounds": [int(v) for v in proto.stall_rounds],
        "laggy": sorted(int(r) for r in proto.laggy),
        "prev_steps": (
            [int(v) for v in proto._prev_steps]
            if proto._prev_steps is not None else None
        ),
        "rng_state": proto.rng.bit_generator.state,
        "rounds": [
            {
                "round": r.round, "target_step": r.target_step,
                "steps": list(r.steps), "epochs": list(r.epochs),
                "fingerprints": list(r.fingerprints),
                "laggy": list(r.laggy), "converged": r.converged,
                "diverged": r.diverged, "retries": r.retries,
                "backoff_epochs": r.backoff_epochs,
            }
            for r in rounds
        ],
    }
    return store.save(stack_states(driver.states), meta=meta)


def restore_divergent(store: CheckpointStore, driver) -> dict | None:
    """Restore a :class:`DivergentDriver`'s rank views (and their host
    views) and protocol state from the newest valid snapshot; returns
    the snapshot meta or ``None``.  The restored views are
    re-fingerprinted against the snapshot's: a drifted view raises
    :class:`CheckpointError` instead of silently reconverging."""
    from .reconcile import view_fingerprint

    template = stack_states(
        [driver.driver._init_state] * driver.n_ranks
    )
    out = store.load_latest(template)
    if out is None:
        return None
    meta, fleet = out
    if int(meta.get("n_ranks", -1)) != driver.n_ranks:
        raise CheckpointError(
            f"snapshot holds {meta.get('n_ranks')} rank views, "
            f"driver has {driver.n_ranks}"
        )
    states = [index_state(fleet, r) for r in range(driver.n_ranks)]
    fps = [view_fingerprint(s) for s in states]
    want = [int(f) for f in meta.get("fingerprints", [])]
    if fps != want:
        raise CheckpointError(
            f"restored rank views fingerprint {fps}, snapshot "
            f"recorded {want}: refusing a divergent revival"
        )
    driver.states = states
    driver.hosts = [driver.driver.host_view(s) for s in states]
    driver.cur = [int(c) for c in meta["cur"]]
    proto = driver.protocol
    proto.stall_rounds = np.asarray(meta["stall_rounds"], np.int64)
    proto.laggy = set(int(r) for r in meta["laggy"])
    proto._prev_steps = (
        np.asarray(meta["prev_steps"], np.int64)
        if meta.get("prev_steps") is not None else None
    )
    proto.rng.bit_generator.state = meta["rng_state"]
    return meta


def _flat_leaves(obj) -> list[torch.Tensor]:
    from ..convert import _leaves

    return [v for v, _dt in _leaves(obj)]


def diff_states(a, b) -> list[str]:
    """Leaf indices (as strings) where two states differ bit for bit,
    in the port's carriers (floats compared exactly)."""
    la, lb = _flat_leaves(a), _flat_leaves(b)
    if len(la) != len(lb):
        return ["<treedef>"]
    out = []
    for i, (x, y) in enumerate(zip(la, lb)):
        # torchlint: disable=J003  # a diff of two states (a check): each leaf compared on the host
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
            out.append(f"leaf{i}")
    return out
