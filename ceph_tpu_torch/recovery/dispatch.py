"""Fault-tolerant work-stealing dispatch for pattern-group decodes.

The counterpart of the reference package's ``recovery/dispatch.py``:
host code, copied, with each launch the group's K4 encoder
(:class:`~ceph_tpu_torch.ec.backend.TableEncoder`) on the chip's torch
device.  The chips are a list of torch devices and may repeat one
device: that is how one card (or the CPU) carries several virtual
chips, whose decisions come from the virtual clock all the same.

The static mesh path (:mod:`ceph_tpu_torch.recovery.sharded`) splits every
launch evenly over the chips, so the whole window gates on the slowest
one, and a stalled or lost chip hangs recovery outright.  This module
is the rateless alternative (arXiv:1804.10331): over-decompose each
pattern group into ``recovery_subshards_per_chip x n_chips`` byte-range
sub-shards and assign them greedily as chips drain, so stragglers and
skewed group mixes stop gating the mesh.

Robustness is the headline:

- **per-chip health**: an EWMA of observed/expected completion time per
  chip; a launch is *overdue* when it runs past
  ``recovery_dispatch_hedge_factor x`` that estimate;
- **hedging**: an overdue sub-shard is re-dispatched to an idle chip —
  first completion wins, the loser is cancelled/discarded, and a
  per-sub-shard sequence number guards against duplicate commits;
- **retry**: a failed launch (``chipdrop``) re-queues its sub-shard
  with bounded seeded exponential backoff (the PR-3 knobs:
  ``recovery_retry_max`` / ``recovery_backoff_base_ms``);
- **conviction**: ``recovery_chip_fail_threshold`` consecutive misses
  convict a chip; its queue drains to the survivors, and a typed
  :class:`ChipLostError` is raised only when EVERY chip is convicted —
  never a hang.

Chip faults are a first-class chaos dimension (the way PR 14 made rank
divergence one): ``chipstall:<d>.<launches>`` / ``chipslow:<d>.<factor>``
/ ``chipdrop:<d>`` specs parse through the normal grammar
(:mod:`ceph_tpu_torch.recovery.failure`), are stripped off a timeline with
:func:`strip_chip_specs` (the tape compiler rejects them loudly, like
rank and crash specs), and are enacted *only here*, through
:class:`ChipFaultSchedule` — an injectable seam, so tests and
``config6 --chaos`` exercise conviction/hedge/steal deterministically.

Determinism and bit-equality: the scheduler runs on a private
batch-relative virtual clock (completion times come from a seeded cost
model, never the wall clock), so two runs of one scenario take
identical steal/hedge decisions — and the *recovered bytes* are
identical to the static sharded path under ANY interleaving, because
per-PG byte columns are independent in GF(2^8) and every sub-shard
commits exactly once into its own byte range (order-free by
construction; the differential tests prove it).

Sub-shard widths are power-of-two bucketed (``piece =
next_pow2(ceil(W / target))``), so the per-chip launch shape ``[k,
piece]`` stays in a few buckets as group widths or sub-shard counts
vary — the same bucketing contract the fleet axis uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..common.config import Config, global_config
from ..ec.backend import TableEncoder
from .chaos import ChaosEvent, ChaosTimeline
from .failure import FailureSpec, check_chip, parse_spec


class ChipLostError(RuntimeError):
    """Every chip in the dispatcher's mesh has been convicted — the
    graceful-degradation floor.  Carries the convicted chip ids so the
    caller's report can name them.  Raised synchronously from
    :meth:`WorkStealingDispatcher.result`, never from inside a
    collective: the multihost analog of
    :class:`~ceph_tpu_torch.analysis.runtime_guard.RankStalledError`."""

    def __init__(self, chips):
        self.chips = sorted(int(c) for c in chips)
        super().__init__(
            f"all {len(self.chips)} dispatch chips convicted "
            f"({self.chips}); recovery cannot make progress"
        )


def strip_chip_specs(
    timeline: ChaosTimeline,
) -> tuple[ChaosTimeline, tuple[FailureSpec, ...]]:
    """Split a timeline into (chip-free timeline, chip specs) — the
    dispatcher's twin of ``checkpoint.strip_crash_specs``: the tape
    compiler and the map engine reject chip specs loudly, so a chaos
    scenario that carries them must be stripped first, and only the
    work-stealing dispatcher consumes what comes off."""
    events = []
    chip_specs: list[FailureSpec] = []
    for ev in timeline.events():
        chip_specs.extend(s for s in ev.specs if s.is_chip)
        keep = tuple(s for s in ev.specs if not s.is_chip)
        if keep:
            events.append(ChaosEvent(ev.t, keep))
    return ChaosTimeline(events), tuple(chip_specs)


@dataclass
class ChipFaultSchedule:
    """Validated chip-fault state for one mesh, built from chip specs.

    ``stall`` maps chip id -> stalled-launch budget (0 = every launch
    hangs); ``slow`` maps chip id -> completion-time factor;
    ``dropped`` chips fail every launch fast.  Chip ids index the
    *global* mesh flat order (each process's dispatcher applies only
    the ids of its local devices).  Specs are applied in order, so a
    later ``chipdrop:<d>:restore`` cancels an earlier drop.
    """

    n_chips: int
    stall: dict = field(default_factory=dict)
    slow: dict = field(default_factory=dict)
    dropped: set = field(default_factory=set)

    @classmethod
    def from_specs(cls, specs, n_chips: int) -> "ChipFaultSchedule":
        """Build from an iterable of chip specs (strings or
        :class:`FailureSpec`), range-checking each against the mesh
        size via :func:`check_chip` — a spec for a chip the mesh does
        not have dies loudly here, not as a silent no-op."""
        sched = cls(n_chips=int(n_chips))
        for spec in specs:
            if isinstance(spec, str):
                spec = parse_spec(spec)
            if not spec.is_chip:
                raise ValueError(
                    f"{spec} is not a chip-scoped spec; only "
                    "chipstall/chipslow/chipdrop reach the dispatcher"
                )
            c = check_chip(spec, n_chips)
            if spec.scope == "chipstall":
                sched.stall[c] = spec.chip_arg()
            elif spec.scope == "chipslow":
                sched.slow[c] = spec.chip_arg()
            elif spec.action == "restore":
                sched.dropped.discard(c)
            else:
                sched.dropped.add(c)
        return sched

    @property
    def empty(self) -> bool:
        return not (self.stall or self.slow or self.dropped)

    def faulty(self, chip_id: int) -> bool:
        """Would this chip gate a *static* collective forever?  A
        stalled or dropped chip never finishes its even share, so the
        static path's makespan is unbounded (the counterfactual the
        idle-fraction metric is measured against)."""
        return chip_id in self.stall or chip_id in self.dropped


@dataclass
class DispatchStats:
    """Cumulative dispatcher telemetry; snapshot with :meth:`copy` and
    difference with :meth:`delta` to scope counters to one run."""

    n_chips: int
    subshards: int = 0
    launches: int = 0
    stolen_subshards: int = 0
    hedged_launches: int = 0
    hedge_wasted_bytes: int = 0
    chip_convictions: int = 0
    drop_retries: int = 0
    busy_s: list = field(default_factory=list)
    makespan_s: float = 0.0
    static_busy_s: list = field(default_factory=list)
    static_makespan_s: float = 0.0
    # True when a stall/drop fault means the static collective would
    # never complete: the counterfactual idle fraction saturates at 1.0
    static_gated: bool = False

    def __post_init__(self):
        if not self.busy_s:
            self.busy_s = [0.0] * self.n_chips
        if not self.static_busy_s:
            self.static_busy_s = [0.0] * self.n_chips

    def copy(self) -> "DispatchStats":
        return DispatchStats(
            n_chips=self.n_chips,
            subshards=self.subshards,
            launches=self.launches,
            stolen_subshards=self.stolen_subshards,
            hedged_launches=self.hedged_launches,
            hedge_wasted_bytes=self.hedge_wasted_bytes,
            chip_convictions=self.chip_convictions,
            drop_retries=self.drop_retries,
            busy_s=list(self.busy_s),
            makespan_s=self.makespan_s,
            static_busy_s=list(self.static_busy_s),
            static_makespan_s=self.static_makespan_s,
            static_gated=self.static_gated,
        )

    def delta(self, before: "DispatchStats") -> "DispatchStats":
        """Per-run counters: self minus an earlier snapshot."""
        return DispatchStats(
            n_chips=self.n_chips,
            subshards=self.subshards - before.subshards,
            launches=self.launches - before.launches,
            stolen_subshards=(
                self.stolen_subshards - before.stolen_subshards
            ),
            hedged_launches=self.hedged_launches - before.hedged_launches,
            hedge_wasted_bytes=(
                self.hedge_wasted_bytes - before.hedge_wasted_bytes
            ),
            chip_convictions=(
                self.chip_convictions - before.chip_convictions
            ),
            drop_retries=self.drop_retries - before.drop_retries,
            busy_s=[
                a - b for a, b in zip(self.busy_s, before.busy_s)
            ],
            makespan_s=self.makespan_s - before.makespan_s,
            static_busy_s=[
                a - b
                for a, b in zip(self.static_busy_s, before.static_busy_s)
            ],
            static_makespan_s=(
                self.static_makespan_s - before.static_makespan_s
            ),
            static_gated=self.static_gated,
        )

    def idle_fraction_per_chip(self) -> list:
        """1 - busy/makespan per chip (0.0 when nothing ran)."""
        if self.makespan_s <= 0.0:
            return [0.0] * self.n_chips
        return [
            max(0.0, 1.0 - b / self.makespan_s) for b in self.busy_s
        ]

    def static_idle_fraction_per_chip(self) -> list:
        """The static-sharding counterfactual for the same work: every
        chip gets an even byte split, the makespan is the slowest
        chip's time, and a stall/drop fault pins every fraction at 1.0
        (the collective never returns, so the mesh is idle forever)."""
        if self.static_gated:
            return [1.0] * self.n_chips
        if self.static_makespan_s <= 0.0:
            return [0.0] * self.n_chips
        return [
            max(0.0, 1.0 - b / self.static_makespan_s)
            for b in self.static_busy_s
        ]


@dataclass
class _Chip:
    """Per-chip health + fault state (one dispatcher = local chips)."""

    index: int  # position in the dispatcher's device list
    chip_id: int  # global mesh flat index (fault-spec target space)
    device: object  # torch device, or None (the encoder's own device)
    ewma: float = 1.0  # observed/expected completion-time ratio
    misses: int = 0  # consecutive deadline misses
    convicted: bool = False
    busy_s: float = 0.0
    # fault state (from ChipFaultSchedule): stall budget is None (no
    # stall), -1 (every launch hangs) or a remaining-launch count
    stall_budget: int | None = None
    slow_factor: float = 1.0
    dropped: bool = False

    def take_stall(self) -> bool:
        """Consume one stalled launch from the budget, if any."""
        if self.stall_budget is None or self.stall_budget == 0:
            return False
        if self.stall_budget > 0:
            self.stall_budget -= 1
        return True


@dataclass
class _SubShard:
    """One byte-range slice of a job's operand, committed exactly once
    (the sequence number is the duplicate-commit guard)."""

    seq: int  # global, monotonic: the commit key
    job: "_Job"
    start: int  # first byte column in the job operand
    width: int  # true width (<= piece; the commit trims to this)
    piece: int  # power-of-two padded launch width
    retries: int = 0  # failed-launch (drop) retries so far


@dataclass
class _QEntry:
    """A queued launch candidate for one sub-shard copy."""

    sub: _SubShard
    hedge: bool = False  # may run alongside a live copy
    not_before: float = 0.0  # backoff gate (batch-relative time)


@dataclass
class _Launch:
    """One in-flight (simulated) launch of a sub-shard on a chip."""

    sub: _SubShard
    chip: _Chip
    t_start: float
    t_done: float  # inf = stalled forever
    t_deadline: float
    out: object = None  # device tensor; None for stall/drop launches
    failing: bool = False  # chipdrop fast-fail


@dataclass
class _Job:
    """One submitted pattern-group decode: the sub-shard set plus the
    winning launch per sequence number."""

    jid: int
    enc: object  # TableEncoder for the group's repair matrix
    src: np.ndarray  # [k, W] u8 survivor operand
    subs: list = field(default_factory=list)
    committed: dict = field(default_factory=dict)  # seq -> _Launch
    done: bool = False


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


class WorkStealingDispatcher:
    """Greedy work-stealing scheduler over a local device list.

    Batch API mirroring the executor's dispatch/finalize split:
    :meth:`submit` enqueues one pattern group (a co-schedule window
    accumulates several), :meth:`drain` runs the scheduling loop (all
    real device launches happen here, overlapped via async dispatch),
    and :meth:`result` assembles one job's recovered bytes on the host
    — the single deliberate host-transfer seam.

    Scheduling runs on a *batch-relative* virtual clock fed by a
    deterministic cost model (``launch_overhead_s`` +
    ``per_byte_s x piece``, scaled by a chip's fault factor), so the
    chaos engine's shared clock is untouched and every steal/hedge/
    convict decision replays bit-identically.  Chip faults arrive only
    through the injected :class:`ChipFaultSchedule` — the seam the
    chaos grammar's ``chip*`` specs plug into.
    """

    def __init__(
        self,
        devices,
        config: Config | None = None,
        *,
        chip_ids=None,
        faults: ChipFaultSchedule | None = None,
        seed: int = 0,
        journal=None,
        launch_overhead_s: float = 5e-4,
        per_byte_s: float = 1e-9,
    ):
        cfg = config or global_config()
        self.subshards_per_chip = int(
            cfg.get("recovery_subshards_per_chip")
        )
        self.hedge_factor = float(
            cfg.get("recovery_dispatch_hedge_factor")
        )
        self.fail_threshold = int(cfg.get("recovery_chip_fail_threshold"))
        self.retry_max = int(cfg.get("recovery_retry_max"))
        self.backoff_base_s = (
            float(cfg.get("recovery_backoff_base_ms")) / 1000.0
        )
        self._rng = np.random.default_rng(seed)
        self.journal = journal
        self.overhead_s = float(launch_overhead_s)
        self.per_byte_s = float(per_byte_s)
        devices = list(devices) or [None]
        if chip_ids is None:
            chip_ids = list(range(len(devices)))
        if len(chip_ids) != len(devices):
            raise ValueError(
                f"{len(chip_ids)} chip ids for {len(devices)} devices"
            )
        self.chips = [
            _Chip(i, int(cid), dev)
            for i, (cid, dev) in enumerate(zip(chip_ids, devices))
        ]
        self.faults = faults
        if faults is not None:
            for ch in self.chips:
                if ch.chip_id in faults.stall:
                    n = int(faults.stall[ch.chip_id])
                    ch.stall_budget = -1 if n == 0 else n
                ch.slow_factor = float(faults.slow.get(ch.chip_id, 1.0))
                ch.dropped = ch.chip_id in faults.dropped
        self.stats = DispatchStats(n_chips=len(self.chips))
        self._seq = 0
        self._jid = 0
        self._batch: list[_Job] = []
        # per-(job encoder, device) K4 operands for chips on a device
        # other than the encoder's
        self._encoders: dict = {}

    # -- batch API ---------------------------------------------------

    @property
    def n_chips(self) -> int:
        return len(self.chips)

    def submit(self, enc, src: np.ndarray) -> _Job:
        """Enqueue one pattern-group decode; no device work happens
        until :meth:`drain`/:meth:`result`.  Never raises
        :class:`ChipLostError` itself (a dead mesh surfaces at the
        finalize seam, where the supervised retry loop cannot mistake
        it for a retryable launch failure)."""
        src = np.ascontiguousarray(src, np.uint8)
        job = _Job(jid=self._jid, enc=enc, src=src)
        self._jid += 1
        w = src.shape[1]
        target = max(1, self.subshards_per_chip * len(self.chips))
        piece = _next_pow2(-(-w // target))
        for start in range(0, w, piece):
            job.subs.append(
                _SubShard(
                    seq=self._seq,
                    job=job,
                    start=start,
                    width=min(piece, w - start),
                    piece=piece,
                )
            )
            self._seq += 1
        self.stats.subshards += len(job.subs)
        self._batch.append(job)
        return job

    def result(self, job: _Job) -> np.ndarray:
        """Drain (if needed) and assemble one job's ``[n_missing, W]``
        recovered bytes — the one place device outputs are
        materialized on the host."""
        if not job.done:
            self.drain()
        wins = [job.committed[s.seq] for s in job.subs]
        rows = int(wins[0].out.shape[0]) if wins else 0
        out = np.zeros((rows, job.src.shape[1]), np.uint8)
        for launch in wins:
            sub = launch.sub
            # deliberate host seam: the winner's padded slice, trimmed
            # the deliberate host seam: the winning launch's slice, trimmed
            # torchlint: disable=J003
            host = launch.out.cpu().numpy()
            out[:, sub.start:sub.start + sub.width] = host[:, :sub.width]
        return out

    # -- scheduling loop ---------------------------------------------

    def _jevent(self, name: str, **attrs) -> None:
        if self.journal is not None:
            self.journal.event(name, **attrs)

    def _expected_s(self, piece: int) -> float:
        """Nominal (healthy-chip) completion time for one launch."""
        return self.overhead_s + float(piece) * self.per_byte_s

    def _deadline(self, chip: _Chip, piece: int, now: float) -> float:
        return now + self.hedge_factor * max(chip.ewma, 1e-6) * (
            self._expected_s(piece)
        )

    def _launch(self, entry: _QEntry, chip: _Chip, now: float) -> _Launch:
        sub = entry.sub
        self.stats.launches += 1
        if chip.take_stall():
            # a hung device launch: never completes, cannot be
            # cancelled — the chip is occupied until conviction
            return _Launch(
                sub, chip, now, float("inf"),
                self._deadline(chip, sub.piece, now),
            )
        if chip.dropped:
            # fast failure: the launch errors out after the dispatch
            # overhead, and the sub-shard re-queues with backoff
            return _Launch(
                sub, chip, now, now + self.overhead_s,
                self._deadline(chip, sub.piece, now), failing=True,
            )
        src = sub.job.src
        padded = np.zeros((src.shape[0], sub.piece), np.uint8)
        padded[:, : sub.width] = src[:, sub.start:sub.start + sub.width]
        out = self._encoder(sub.job.enc, chip.device).encode_async(padded)
        dur = self._expected_s(sub.piece) * max(chip.slow_factor, 1.0)
        return _Launch(
            sub, chip, now, now + dur,
            self._deadline(chip, sub.piece, now), out=out,
        )

    def _encoder(self, enc, device):
        """The job's encoder on the chip's device (the launch runs where
        its operand lives)."""
        if device is None or getattr(enc, "device", None) == device:
            return enc
        key = (id(enc), device)
        if key not in self._encoders:
            self._encoders[key] = (enc, TableEncoder(enc.matrix, device))
        return self._encoders[key][1]

    @staticmethod
    def _live_copies(sub: _SubShard, queue, running, but=None) -> int:
        """Copies of ``sub`` currently queued or running, excluding
        ``but`` — the hedge-spawn guard (at most one hedge twin)."""
        n = sum(1 for e in queue if e.sub.seq == sub.seq)
        n += sum(
            1
            for launch in running.values()
            if launch.sub.seq == sub.seq and launch is not but
        )
        return n

    def _convict(self, chip: _Chip, now: float, queue, running) -> None:
        chip.convicted = True
        self.stats.chip_convictions += 1
        launch = running.pop(chip.index, None)
        if launch is not None:
            chip.busy_s += now - launch.t_start
            sub = launch.sub
            if sub.seq not in sub.job.committed and not self._live_copies(
                sub, queue, running
            ):
                # the abandoned sub-shard drains to the survivors
                queue.insert(0, _QEntry(sub, not_before=now))
        self._jevent(
            "dispatch.convict",
            chip=chip.chip_id,
            misses=chip.misses,
            t=round(now, 9),
        )

    def drain(self) -> None:
        """Run the scheduling loop until every batched sub-shard is
        committed (or :class:`ChipLostError`).  All real device
        launches happen here; nothing is materialized on the host —
        :meth:`result` owns that seam."""
        batch = [j for j in self._batch if not j.done]
        self._batch = []
        if not batch:
            return
        self._record_static(batch)
        pending: dict[int, _SubShard] = {
            s.seq: s for j in batch for s in j.subs
        }
        queue: list[_QEntry] = [
            _QEntry(s) for j in batch for s in j.subs
        ]
        running: dict[int, _Launch] = {}
        now = 0.0
        busy0 = [c.busy_s for c in self.chips]
        # defensive livelock bound, far above any legitimate schedule
        # (every sub-shard retried on every chip plus hedges)
        budget = (self.retry_max + 3) * max(1, len(pending)) * max(
            1, len(self.chips)
        ) + 16
        launches = 0
        while pending:
            live = [c for c in self.chips if not c.convicted]
            if not live:
                raise ChipLostError(c.chip_id for c in self.chips)
            # greedy assignment: idle chips take the first eligible
            # queued copy, in chip-index order (deterministic)
            for chip in live:
                if chip.index in running:
                    continue
                picked = None
                for i, entry in enumerate(queue):
                    if entry.sub.seq not in pending:
                        continue  # committed while queued; drop below
                    if entry.not_before > now:
                        continue
                    if not entry.hedge and any(
                        launch.sub.seq == entry.sub.seq
                        for launch in running.values()
                    ):
                        continue  # one live copy unless hedging
                    picked = i
                    break
                if picked is None:
                    continue
                entry = queue.pop(picked)
                launches += 1
                if launches > budget:
                    raise RuntimeError(
                        f"dispatch livelock: {launches} launches for "
                        f"{len(pending)} pending sub-shards"
                    )
                running[chip.index] = self._launch(entry, chip, now)
            queue = [e for e in queue if e.sub.seq in pending]
            if not running:
                gates = [e.not_before for e in queue if e.sub.seq in pending]
                if not gates:
                    raise RuntimeError(
                        "dispatch stuck: pending sub-shards with no "
                        "queued or running copy"
                    )
                now = min(gates)  # idle until the earliest backoff gate
                continue
            # next event over in-flight launches: completions win ties
            # against deadlines, then lowest chip index (deterministic)
            chip_i, launch = min(
                running.items(),
                key=lambda kv: (
                    min(kv[1].t_done, kv[1].t_deadline),
                    kv[1].t_done > kv[1].t_deadline,
                    kv[0],
                ),
            )
            if launch.t_done <= launch.t_deadline:
                now = launch.t_done
                self._complete(launch, now, pending, queue, running)
            else:
                now = launch.t_deadline
                self._overdue(launch, now, pending, queue, running)
        # every byte is committed; account the straggler tail — losers
        # of the final hedge races run out, and a chip still hung on a
        # launch that will NEVER return is convicted now (it could
        # never serve another batch; deferring the conviction past the
        # barrier would leak a dead chip into the next window)
        makespan = now
        for ci in sorted(running):
            launch = running.get(ci)
            if launch is None:
                continue
            chip = launch.chip
            if launch.t_done != float("inf"):
                del running[ci]
                chip.busy_s += launch.t_done - launch.t_start
                if launch.out is not None:
                    self.stats.hedge_wasted_bytes += launch.sub.width
                makespan = max(makespan, launch.t_done)
            else:
                t = launch.t_deadline
                chip.misses += 1
                interval = self.hedge_factor * max(chip.ewma, 1e-6) * (
                    self._expected_s(launch.sub.piece)
                )
                while chip.misses < self.fail_threshold:
                    chip.misses += 1
                    t += interval
                self._convict(chip, t, queue, running)
                makespan = max(makespan, t)
        self.stats.makespan_s += makespan
        for i, chip in enumerate(self.chips):
            self.stats.busy_s[i] += chip.busy_s - busy0[i]
        for job in batch:
            job.done = True

    def _complete(self, launch, now, pending, queue, running) -> None:
        chip = launch.chip
        del running[chip.index]
        chip.busy_s += now - launch.t_start
        sub = launch.sub
        if launch.failing:
            # chipdrop: the launch errored; consecutive failures count
            # toward conviction, the sub-shard backs off and re-queues
            chip.misses += 1
            self.stats.drop_retries += 1
            sub.retries += 1
            self._jevent(
                "dispatch.drop", chip=chip.chip_id, seq=sub.seq,
                retries=sub.retries,
            )
            if sub.seq in pending and not self._live_copies(
                sub, queue, running
            ):
                backoff = (
                    self.backoff_base_s
                    * (2 ** min(sub.retries - 1, 16))
                    * (1.0 + self._rng.random())
                )
                queue.append(_QEntry(sub, not_before=now + backoff))
            if chip.misses >= self.fail_threshold:
                self._convict(chip, now, queue, running)
            return
        expected = self._expected_s(sub.piece)
        ratio = max(now - launch.t_start, 1e-9) / expected
        chip.ewma = 0.5 * ratio + 0.5 * chip.ewma
        chip.misses = 0
        if sub.seq not in pending:
            # a hedge twin already committed this range: late loser
            self.stats.hedge_wasted_bytes += sub.width
            return
        del pending[sub.seq]
        sub.job.committed[sub.seq] = launch
        if chip.index != sub.seq % len(self.chips):
            # committed off the static round-robin owner: stolen
            self.stats.stolen_subshards += 1
        # first completion wins.  Queued twins are dropped here; a
        # RUNNING twin cannot be cancelled (a hung device launch never
        # returns) — it runs to completion (its bytes discarded, the
        # duplicate commit blocked by the sequence guard) or keeps
        # missing deadlines until its chip is convicted
        queue[:] = [e for e in queue if e.sub.seq != sub.seq]

    def _overdue(self, launch, now, pending, queue, running) -> None:
        chip = launch.chip
        chip.misses += 1
        sub = launch.sub
        if sub.seq in pending and not self._live_copies(
            sub, queue, running, but=launch
        ):
            # hedge: one twin at the queue head for the next idle chip
            queue.insert(0, _QEntry(sub, hedge=True, not_before=now))
            self.stats.hedged_launches += 1
            self._jevent(
                "dispatch.hedge", chip=chip.chip_id, seq=sub.seq,
                misses=chip.misses,
            )
        # re-arm: a permanently stalled launch keeps missing repeated
        # deadlines, so its chip always reaches conviction — never a
        # hang
        launch.t_deadline = self._deadline(chip, sub.piece, now)
        if chip.misses >= self.fail_threshold:
            self._convict(chip, now, queue, running)

    def _record_static(self, batch) -> None:
        """Accumulate the static-sharding counterfactual for this
        batch: each job's width split evenly over every chip, each
        chip's share scaled by its slowdown, the batch makespan the
        max — and a stall/drop fault gates the collective forever."""
        n = len(self.chips)
        times = [0.0] * n
        gated = False
        for job in batch:
            share = -(-job.src.shape[1] // n)
            for i, chip in enumerate(self.chips):
                if chip.stall_budget is not None or chip.dropped:
                    gated = True
                times[i] += self._expected_s(share) * max(
                    chip.slow_factor, 1.0
                )
        if gated:
            self.stats.static_gated = True
        for i in range(n):
            self.stats.static_busy_s[i] += times[i]
        self.stats.static_makespan_s += max(times) if times else 0.0
