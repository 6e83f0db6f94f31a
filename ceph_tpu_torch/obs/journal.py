"""Correlated event journal: JSONL spans on virtual + wall clocks.

Recovery already emits device-side profiler annotations
(:func:`ceph_tpu_torch.common.tracing.trace_annotation`) and host-side perf
counters, but neither answers "what happened, in order, and why" after
a chaos run: counters are aggregates and Perfetto traces have no
injection/phase context.  The journal is the correlation layer — every
record carries a shared ``trace_id``, its own ``span_id`` (and
``parent_id`` inside an open span), the *virtual* clock (deterministic,
replayable) and the wall clock (lines up with profiler traces), plus
free-form attrs.  :meth:`EventJournal.span` additionally opens a
matching :func:`torch.profiler` annotation so device traces and host
spans share names.

Records are kept in memory and, when ``path`` is given, appended as
JSON lines — readable back with :meth:`EventJournal.read` for
round-trip tests and the ``cli.status`` timeline view.  Long soaks
(fleet sweeps, divergent-rank chaos) can cap the on-disk footprint
with ``max_bytes``: when the live file would exceed it, the journal
rotates — ``path`` is renamed to ``path.1`` (older segments shifting
to ``path.2``, ...), the newest ``max_segments - 1`` rotated segments
are kept, and writing continues on a fresh ``path``.  Each segment is
independently crash-tolerant (same torn-tail rule), and
:meth:`EventJournal.read_rotated` stitches oldest-to-newest.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Callable

from ..common.tracing import trace_annotation

#: journal envelope version (the ``v`` field on every record).
#: v2 added ``v`` + the monotonic ``seq`` emission counter.
SCHEMA_VERSION = 2


def _fsync_dir(path: str) -> None:
    """fsync a directory so renames within it survive a crash."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class EventJournal:
    """Append-only span/event log.

    ``clock`` is the virtual clock read (``() -> float``); ``trace_id``
    is injectable so seeded runs journal deterministically (default
    derives from the wall clock).  ``wall`` is injectable for tests.
    ``max_bytes`` (0 = unbounded) caps the live file: crossing it
    rotates keep-last-``max_segments`` style.  In-memory ``records``
    are never rotated — the cap bounds disk, not correlation.
    """

    def __init__(
        self,
        path: str | None = None,
        clock: Callable[[], float] | None = None,
        trace_id: str | None = None,
        wall: Callable[[], float] = time.time,
        max_bytes: int = 0,
        max_segments: int = 4,
    ):
        self.path = str(path) if path is not None else None
        self.clock = clock or (lambda: 0.0)
        self.wall = wall
        self.trace_id = trace_id or f"{int(wall() * 1e6):x}"
        self.max_bytes = int(max_bytes)
        self.max_segments = int(max_segments)
        if self.max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        if self.max_segments < 1:
            raise ValueError(
                f"max_segments must be >= 1, got {max_segments}"
            )
        self.records: list[dict] = []
        self._next_span = 0
        self._next_seq = 0  # emission order, assigned at _emit time
        self._open: list[int] = []  # span-id stack for parent linkage
        self._fh = None
        self._size = 0
        if self.path:
            self._resume()

    def _resume(self) -> None:
        """Open the path for append — the process-restart seam.

        Three resume guarantees: a torn final line left by a crash is
        truncated away (appending after it would turn a tolerable
        torn tail into mid-file corruption and poison every later
        :meth:`read`), rotated segments past the current
        ``max_segments`` budget are trimmed (the disk cap must count
        segments a PREVIOUS process rotated, not only ones this one
        will), and size accounting reseeds from the repaired live
        file."""
        if os.path.exists(self.path):
            self._repair_torn_tail(self.path)
            self._reseed_seq(self.path)
        if self._next_seq == 0 and os.path.exists(self.path + ".1"):
            # crash between rotation and the first fresh append: the
            # stream's tail is the newest rotated segment
            self._reseed_seq(self.path + ".1")
        base = os.path.basename(self.path)
        d = os.path.dirname(self.path) or "."
        for fn in sorted(os.listdir(d)):
            if not fn.startswith(base + "."):
                continue
            suffix = fn[len(base) + 1:]
            if suffix.isdigit() and int(suffix) >= self.max_segments:
                os.remove(os.path.join(d, fn))
        self._fh = open(self.path, "a")
        self._size = os.path.getsize(self.path)

    def _reseed_seq(self, path: str) -> None:
        """Continue the emission counter past a restart: seq must stay
        monotonic across the FILE, not per process, or every resume
        would manufacture a phantom gap (or mask a real one)."""
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError:
            return
        for raw in reversed(data.splitlines()):
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and isinstance(
                rec.get("seq"), int
            ):
                self._next_seq = max(self._next_seq, rec["seq"] + 1)
                return

    @staticmethod
    def _repair_torn_tail(path: str) -> None:
        """Truncate a partial final line (no trailing newline — the
        only shape a torn single-write append can leave)."""
        with open(path, "rb") as fh:
            data = fh.read()
        if not data or data.endswith(b"\n"):
            return
        keep = data.rfind(b"\n") + 1
        with open(path, "rb+") as fh:
            fh.truncate(keep)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "EventJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- emission ---------------------------------------------------

    def _emit(self, record: dict) -> dict:
        # seq is assigned HERE, not in _record: span ids are allocated
        # at open but spans land at close, so only emission order is
        # monotonic in the file — the property the gap reader checks
        record["seq"] = self._next_seq
        self._next_seq += 1
        self.records.append(record)
        if self._fh is not None:
            line = json.dumps(record, sort_keys=True) + "\n"
            if (
                self.max_bytes
                and self._size
                and self._size + len(line) > self.max_bytes
            ):
                self._rotate()
            self._fh.write(line)
            self._fh.flush()
            self._size += len(line)
        return record

    def _rotate(self) -> None:
        """Shift ``path`` -> ``path.1`` -> ``path.2`` ... keeping the
        newest ``max_segments - 1`` rotated segments, then reopen a
        fresh live file.  Rename-based, so a crash mid-rotation never
        tears a record — only whole segments move."""
        self._fh.close()
        oldest = self.path + f".{self.max_segments - 1}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.max_segments - 2, 0, -1):
            src = self.path + f".{i}"
            if os.path.exists(src):
                os.replace(src, self.path + f".{i + 1}")
        if self.max_segments > 1:
            os.replace(self.path, self.path + ".1")
        else:
            os.remove(self.path)
        # the shift is only durable once the directory entries are:
        # without this a crash can resurrect pre-rotation names and
        # double-count segments against the disk cap on resume
        _fsync_dir(os.path.dirname(self.path) or ".")
        # fresh live file: the previous one (and any torn tail it
        # carried) was renamed away above, so there is nothing to
        # repair before appending
        self._fh = open(self.path, "a")
        self._size = 0

    def _record(self, kind: str, name: str, **attrs) -> dict:
        span_id = self._next_span
        self._next_span += 1
        record = {
            "v": SCHEMA_VERSION,
            "trace_id": self.trace_id,
            "span_id": span_id,
            "parent_id": self._open[-1] if self._open else None,
            "kind": kind,
            "name": name,
            "t": round(float(self.clock()), 9),
            "wall": self.wall(),
        }
        if attrs:
            record["attrs"] = attrs
        return record

    def event(self, name: str, **attrs) -> dict:
        """Point-in-time record (an injection, a retry, a salvage)."""
        return self._emit(self._record("event", name, **attrs))

    @contextmanager
    def span(self, name: str, **attrs):
        """Timed record bracketing a phase; nests (children link via
        ``parent_id``) and opens a matching profiler annotation so the
        device trace carries the same name."""
        record = self._record("span", name, **attrs)
        self._open.append(record["span_id"])
        try:
            with trace_annotation(name):
                yield record
        finally:
            self._open.pop()
            record["t_end"] = round(float(self.clock()), 9)
            record["wall_end"] = self.wall()
            self._emit(record)

    # ---- read-back --------------------------------------------------

    def by_name(self, name: str) -> list[dict]:
        return [r for r in self.records if r["name"] == name]

    @staticmethod
    def _with_gap_records(records: list[dict]) -> list[dict]:
        """Surface missing emission counters as synthetic
        ``journal.gap`` records, in place in the stream.

        Torn-tail repair (and surgical segment truncation) removes
        whole records from the middle of a rotated stream; the seq
        counter makes the loss *visible*: any jump between
        consecutive seq-carrying records becomes a synthetic event
        naming the window, so post-mortem replay knows what it is
        missing instead of silently reading a shorter history.
        Records without ``seq`` (pre-v2 files) are passed through and
        never flagged."""
        out: list[dict] = []
        prev: int | None = None
        for rec in records:
            seq = rec.get("seq") if isinstance(rec, dict) else None
            if isinstance(seq, int) and prev is not None and (
                seq > prev + 1
            ):
                out.append({
                    "v": SCHEMA_VERSION,
                    "kind": "journal.gap",
                    "name": "journal.gap",
                    "synthetic": True,
                    "seq_before": prev,
                    "seq_after": seq,
                    "n_missing": seq - prev - 1,
                })
            if isinstance(seq, int):
                prev = seq
            out.append(rec)
        return out

    @staticmethod
    def read(path: str, *, tolerate_torn: bool = True,
             detect_gaps: bool = True) -> list[dict]:
        """Parse a journal file back into records — crash-tolerant.

        Every record is flushed as it is emitted, so the only damage a
        crash (or a full disk) can leave is a torn FINAL line.  That
        tail is skipped, not raised: post-mortem replay of everything
        that made it to disk is exactly the journal's job.  A
        malformed line with valid records AFTER it is real corruption
        and still raises, with the line number.  ``tolerate_torn=False``
        raises on the torn tail too — :meth:`read_rotated` uses it for
        segments that are NOT the stream's final one, where a torn
        line can only mean corruption (rotation moves whole files)."""
        out = []
        with open(path) as fh:
            lines = fh.readlines()
        torn_at: int | None = None
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                torn_at = i
                continue
            if torn_at is not None:
                raise ValueError(
                    f"{path}:{torn_at + 1}: corrupt journal line "
                    "followed by valid records (not a torn tail)"
                )
            out.append(record)
        if torn_at is not None and not tolerate_torn:
            raise ValueError(
                f"{path}:{torn_at + 1}: torn line in a non-final "
                "journal segment (rotation moves whole files, so "
                "only the stream's last segment may end torn)"
            )
        if detect_gaps:
            out = EventJournal._with_gap_records(out)
        return out

    @staticmethod
    def read_rotated(path: str) -> list[dict]:
        """Records across every surviving segment, oldest first:
        ``path.<N>`` ... ``path.1`` then the live ``path``.

        Torn-tail tolerance is STREAM-level, not per-segment: only
        the stream's final segment may legitimately end torn.  That
        is the live ``path`` when it has content — but when a crash
        lands exactly between rotation and the first fresh append,
        the live file is empty (or missing) and the stream's true
        tail is the newest ROTATED segment ``path.1``, so tolerance
        extends there.  A torn line in any older segment is real
        corruption and raises."""
        segs = []
        i = 1
        while os.path.exists(f"{path}.{i}"):
            segs.append(f"{path}.{i}")
            i += 1
        live = os.path.exists(path)
        stream = list(reversed(segs)) + ([path] if live else [])
        if live and os.path.getsize(path) > 0:
            tail = path
        elif segs:
            tail = segs[0]  # newest rotated segment
        else:
            tail = path
        out: list[dict] = []
        for seg in stream:
            # per-segment gap detection is deferred: a gap spanning a
            # rotation boundary is only visible on the stitched stream
            out.extend(
                EventJournal.read(
                    seg, tolerate_torn=(seg == tail),
                    detect_gaps=False,
                )
            )
        return EventJournal._with_gap_records(out)
