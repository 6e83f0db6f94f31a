"""The online write path as a per-epoch encode stage of the epoch loop.

The counterpart of the reference package's ``workload/writepath.py``.
:class:`WritepathDriver` wraps an
:class:`~ceph_tpu_torch.recovery.superstep.EpochDriver` and adds the data
plane the traffic model only counts: each epoch's committed client
writes (the SAME routed, classified ops the traffic step counts: the
same ids, salt and ``_route`` predicates on the post-peering survivor
masks) are compacted into a fixed-shape write batch and absorbed by the
stripe buffer (:mod:`ceph_tpu_torch.ec.online`: K9, then K6 over the
touched slots and K9's commit).  Full-stripe writes encode whole stripes; small overwrites become
read-modify-write parity deltas.  The write stage reads the cluster
state and never writes it, so the 18 epoch lanes stay bit-equal to the
same driver's run without it; the buffer rides the loop, so checkpoints
of ``(ClusterState, StripeBufferState)`` resume with a warm cache.  Each
epoch's step consumes the buffer in place, so every run starts from its
own clone of the driver's cold buffer, which stays as it was.

The batch holds the power-of-two bucket of ``max_writes`` lanes; the
per-epoch cap is a value (a host number, or a 0-d buffer on the device),
so any cap inside the bucket runs the same shapes.

On the card a chunk of epochs is one replay of one CUDA graph
(:class:`WritepathProgram`, :meth:`WritepathDriver.compile_writepath`):
the compiled epoch superstep's body
(:class:`~ceph_tpu_torch.recovery.superstep.SuperstepProgram`) with the
write batch, the stripe step (K9, K6, K9's commit) and the write row
after each epoch's row, the ring row last.  On the CPU the epochs are
decided on the host (:meth:`WritepathDriver._advance_host`); the same
compiled body runs eagerly through ``program.run_eager``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..analysis import runtime_guard
from ..core.hashes import crush_hash32_2
from ..ec.online import (
    WP_LANES,
    ParityDeltaEngine,
    StripeBufferState,
    _i32_bits,
    empty_stripe_buffer,
    register_stripe_cache,
    stripe_buffer_step,
    summarize_buffer,
    writepath_counters,
)
from ..recovery.superstep import (
    _SALT_STEP,
    _SERIES_FIELDS,
    EpochRows,
    EpochSeries,
    SuperstepProgram,
    _Carry,
)

I32 = torch.int32
I64 = torch.int64
_M32 = 0xFFFFFFFF

#: decorrelate the stripe-index, chunk-index, full-stripe and payload
#: coins from each other and from the routing/skew hashes
_STRIPE_SALT = 0x7FEB352D
_CHUNK_SALT = 0x846CA68B
_FULL_SALT = 0x9E485565
_SEED_SALT = 0xE2D0D4CB


def _pow2_bucket(n: int) -> int:
    """The power-of-two batch bucket holding ``n`` write slots."""
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def default_bitmatrix(k: int, m: int, w: int | None = None):
    """The write-path codec for a ``k+m`` pool: a minimal-density RAID-6
    code when ``m == 2`` (liberation: the cheapest XOR programs), else
    the cauchy-good w=8 expansion.  Returns ``(bitmatrix, w)``."""
    from ..ec import gf, gfw

    if int(m) == 2:
        if w is None:
            w = next(p for p in (7, 11, 13, 17, 19, 23)
                     if p >= int(k))
        return gfw.liberation_bitmatrix(int(k), int(w)), int(w)
    return gf.matrix_to_bitmatrix(
        gf.cauchy_good_matrix(int(k), int(m))
    ), 8


@dataclass(frozen=True)
class WritepathSeries:
    """Per-epoch write-path lanes (``WP_LANES`` order), host numpy: the
    stripe buffer's journal payload and the differential tests'
    comparison surface."""

    lanes: np.ndarray  # i64 [n, len(WP_LANES)]

    def __len__(self) -> int:
        return int(self.lanes.shape[0])

    @classmethod
    def from_device(cls, wrows: torch.Tensor) -> "WritepathSeries":
        return cls(lanes=wrows.cpu().numpy().reshape(-1, len(WP_LANES)))

    @classmethod
    def concat(cls, parts: list["WritepathSeries"]) -> "WritepathSeries":
        if len(parts) == 1:
            return parts[0]
        return cls(lanes=np.concatenate([p.lanes for p in parts]))

    def lane(self, name: str) -> np.ndarray:
        return self.lanes[:, WP_LANES.index(name)]

    def totals(self) -> dict:
        tot = self.lanes.sum(axis=0) if len(self) else np.zeros(
            len(WP_LANES), np.int64
        )
        return {n: int(v) for n, v in zip(WP_LANES, tot)}

    def diff(self, other: "WritepathSeries") -> list[str]:
        """Lane names where the two series differ bit for bit."""
        if self.lanes.shape != other.lanes.shape:
            return ["<shape>"]
        return [
            n for i, n in enumerate(WP_LANES)
            if not np.array_equal(self.lanes[:, i], other.lanes[:, i])
        ]


class WritepathDriver:
    """The online EC write path over a built epoch driver, on its device.

    ``n_sets`` x ``ways`` is the stripe-buffer geometry (``n_sets`` a
    power of two); ``stripes_per_pg`` shapes the stripe key space (``key
    = pg * stripes_per_pg + stripe``); ``full_permille`` is the
    full-stripe share of committed writes (the rest are single-chunk
    small overwrites); ``groups`` scales the chunk size (``chunk_bytes =
    groups * w * packetsize``).  ``max_writes`` caps the per-epoch write
    batch, whose width is its power-of-two bucket."""

    def __init__(
        self,
        driver,
        *,
        bitmatrix: np.ndarray | None = None,
        w: int | None = None,
        packetsize: int = 8,
        groups: int = 1,
        n_sets: int = 16,
        ways: int = 4,
        stripes_per_pg: int = 4,
        full_permille: int = 125,
        max_writes: int | None = None,
        cache=None,
        name: str = "writepath",
    ):
        self.driver = driver
        self.device = driver.device
        if packetsize % 4:
            raise ValueError(
                f"packetsize must be u32-aligned on the device path, "
                f"got {packetsize}"
            )
        if bitmatrix is None:
            k = int(driver.k)
            m = max(int(driver.size) - k, 1)
            bitmatrix, w = default_bitmatrix(k, m, w)
        self.engine = ParityDeltaEngine(
            np.asarray(bitmatrix), w=int(w or 8),
            packetsize=int(packetsize), cache=cache, name=name, device=self.device,
        )
        self.k = self.engine.k
        self.m = self.engine.m
        self.w = self.engine.w
        self.packetsize = self.engine.packetsize
        self.groups = int(groups)
        self.chunk_bytes = self.groups * self.w * self.packetsize
        #: u32 words per packed row (packetsize is u32-aligned, so the
        #: packet layout is a pure reshape: no tail pad)
        self.words = self.groups * (self.packetsize // 4)
        enc = self.engine.full_encoder()
        self.schedule = enc.schedule
        self.table = enc.table
        self.n_sets = int(n_sets)
        self.ways = int(ways)
        self.stripes_per_pg = int(stripes_per_pg)
        self.full_permille = int(full_permille)
        self.max_writes = int(
            max_writes if max_writes is not None else driver.n_ops
        )
        self.batch_size = _pow2_bucket(self.max_writes)
        if runtime_guard.bucket_checks_enabled():
            runtime_guard.assert_bucketed("writepath batch bucket", self.batch_size)
        self._init_buf = empty_stripe_buffer(
            self.n_sets, self.ways, self.k * self.w, self.m * self.w,
            self.words, device=self.device,
        )
        self.name = str(name)
        self.pc = writepath_counters()
        self.final_state = None
        self.final_buf: StripeBufferState | None = None
        #: the recorder's ring after the most recent flight-on run
        self.flight = None
        # the compiled write paths (recorder off, on)
        self._programs: dict[bool, WritepathProgram] = {}
        register_stripe_cache(self)

    # -- the per-epoch write batch (drawn from the traffic step) -------

    def _write_batch(self, state, step, cap, *, salt=None):
        """Compact this epoch's committed writes into the fixed-shape
        batch: the SAME ids, salt and ``_route`` predicates the traffic
        step counted, so ``sum(valid)`` (uncapped) equals the epoch row's
        ``writes`` lane.  ``step`` gives the salt, unless ``salt`` (the
        step table's, a 0-d int64 tensor) is given; ``cap`` is a host
        number or a 0-d tensor.  Returns the batch lanes ``(keys,
        chunks, fulls, seeds, valid)``, ``[B]`` each (keys and chunks
        int32, seeds int32 u32 bits)."""
        from .traffic import _route, _salt_xor, _skew_ids, _u32_scalar

        drv = self.driver
        B = self.batch_size
        if salt is None:
            salt = (drv.salt_base + step * _SALT_STEP) & _M32
        ids = drv._ids
        mix = drv._mix
        if mix is not None and mix.hot_permille > 0:
            ids = _skew_ids(ids, salt, mix.hot_permille, mix.hot_objects)
        pg_bmask = (1 << max(drv.pg_num - 1, 1).bit_length()) - 1
        pg, _prim, is_write, blocked, _deg, _cost = _route(
            state.survivor_mask, state.n_alive, state.acting_primary, ids, salt,
            drv.pg_num, pg_bmask, drv.k, drv.size, drv.min_size, drv.write_permille)
        okw = ~blocked & is_write
        pos = torch.cumsum(okw.to(I32), 0) - 1
        limit = cap.clamp(max=B) if isinstance(cap, torch.Tensor) else min(int(cap), B)
        take = okw & (pos < limit)
        # rejected lanes all write the fill to the spare slot B, which
        # is then cut off, so the scatter is order-free
        slot = torch.where(take, pos, B).to(I64)

        def coin(mask):
            return crush_hash32_2(ids, _u32_scalar(_salt_xor(salt, mask), ids.device))

        stripe = coin(_STRIPE_SALT) % self.stripes_per_pg
        key = (pg.to(I64) * self.stripes_per_pg + stripe).to(I32)
        chunk = (coin(_CHUNK_SALT) % self.k).to(I32)
        full = (coin(_FULL_SALT) % 1000) < self.full_permille
        seed = _i32_bits(coin(_SEED_SALT))

        def compact(vals, fill):
            out = torch.full((B + 1,), fill, dtype=vals.dtype, device=vals.device)
            return out.scatter_(0, slot, torch.where(take, vals, fill))[:B]

        bkeys = compact(key, -1)
        bvalid = compact(torch.ones_like(take), False) & (bkeys >= 0)
        return bkeys, compact(chunk, 0), compact(full, False), compact(seed, 0), bvalid

    # -- the extended epoch body ---------------------------------------

    def _wp_epoch(self, state, host, buf, step: int, cap: int, fs=None):
        """One epoch: the wrapped driver's body, the write batch, the
        stripe step, and with a flight state the ring row (its stripe
        lanes from the write row).  Returns ``(state, buf, fs, (dirty,
        row), wrow)``."""
        drv = self.driver
        if fs is None:
            state, (d, row) = drv._epoch_step(state, host, step)
        else:
            state, (d, row), extras = drv._epoch_step(state, host, step, traced=True)
        buf, wrow = stripe_buffer_step(buf, self.table, self.schedule.n_out, self.k, self.w,
                                       *self._write_batch(state, step, cap))
        if fs is not None:
            fs = drv._record(fs, row, extras, wrow)
        return state, buf, fs, (d, row), wrow

    def advance(self, state, host, buf, start: int, stop: int, cap: int, fs=None):
        """Epochs ``start .. stop - 1``: ``(state, buf, fs, rows,
        wrows)``, the rows kept on the device (:class:`EpochRows` and an
        int64 ``[n, len(WP_LANES)]`` tensor).  ``buf`` is consumed; the
        buffer returned is the caller's.  On the card the compiled write
        path runs them (:meth:`compile_writepath`, or its flight twin
        with ``fs``): the host view keeps only the clock and cursors
        then (``host.stale``)."""
        if self.device.type == "cuda":
            prog = self.compile_writepath() if fs is None else self.compile_writepath_flight()
            return prog.advance(state, host, buf, start, stop, cap, fs)
        return self._advance_host(state, host, buf, start, stop, cap, fs)

    def _advance_host(self, state, host, buf, start: int, stop: int, cap: int, fs=None):
        """:meth:`advance` decided on the host, one epoch at a time (the
        CPU's driver): the wrapped driver's reads of a busy epoch's tick
        and the ladder's rung, the write stage after each epoch."""
        now, epoch, dirty, packed, wpacked = [], [], [], [], []
        for e in range(start, stop):
            state, buf, fs, (d, row), wrow = self._wp_epoch(state, host, buf, e, cap, fs)
            now.append(host.now)
            epoch.append(host.epoch)
            dirty.append(int(d))
            packed.append(row)
            wpacked.append(wrow)
        drv = self.driver
        state = drv._with_scalars(state, host)
        if not packed:
            return state, buf, fs, drv._empty_rows(), self._empty_wrows()
        rows = EpochRows(np.asarray(now, np.float64), np.asarray(epoch, np.int32),
                         np.asarray(dirty, np.int32), torch.stack(packed))
        return state, buf, fs, rows, torch.stack(wpacked)

    def _empty_wrows(self) -> torch.Tensor:
        return torch.zeros((0, len(WP_LANES)), dtype=I64, device=self.device)

    def compile_writepath(self) -> "WritepathProgram":
        """The ONE program of a chunk of write-path epochs
        (:class:`WritepathProgram`, built once a driver): on the card one
        CUDA graph, captured on its first chunk and replayed for every
        later one.  The write cap is a buffer of the graph, so every cap
        inside the batch bucket replays the same capture."""
        if self._programs.get(False) is None:
            self._programs[False] = WritepathProgram(self, flight=False)
        return self._programs[False]

    def compile_writepath_flight(self) -> "WritepathProgram":
        """The recorder-carrying twin of :meth:`compile_writepath`: each
        epoch's ring row written in place after the stripe step, its
        stripe lanes from the write row."""
        if not self.driver.flight_on:
            raise RuntimeError("flight recorder is off for this driver (flight_recorder=on "
                               "enables it)")
        if self._programs.get(True) is None:
            self._programs[True] = WritepathProgram(self, flight=True)
        return self._programs[True]

    # -- drivers -------------------------------------------------------

    def _note_totals(self, wseries: WritepathSeries) -> None:
        self.engine.pc_inc(self.pc, wseries.lanes.sum(axis=0))

    def run_superstep(
        self, n_epochs: int, *, cap: int | None = None,
        snapshot_every: int = 0, pull: bool = True,
        buf: StripeBufferState | None = None, start_epoch: int = 0,
        journal=None,
    ):
        """Drive the write path in chunks of ``snapshot_every`` epochs,
        mirroring :meth:`EpochDriver.run_superstep` (``pull=False``
        returns ``(state, buf, rows, wrows)`` still on the device).  A
        ``buf`` given is consumed (stepped in place); without one the run
        starts from a clone of the cold buffer.  On the card a chunk is
        one replay of the compiled write path's graph (:meth:`advance`).
        With the wrapped driver's flight recorder on, the ring rides the
        loop and drains into ``journal`` at each chunk's end
        (:attr:`flight` afterwards)."""
        return self._run_chunks(self.advance, self.driver._init_flight, n_epochs, cap=cap,
                                snapshot_every=snapshot_every, pull=pull, buf=buf,
                                start_epoch=start_epoch, journal=journal)

    def _run_chunks(self, advance, fs, n_epochs: int, *, cap: int | None = None,
                    snapshot_every: int = 0, pull: bool = True,
                    buf: StripeBufferState | None = None, start_epoch: int = 0, journal=None):
        """:meth:`run_superstep` over ``advance`` from the initial state
        and the ring ``fs``."""
        from ..obs.flight import journal_drain

        drv = self.driver
        state = drv._init_state
        host = drv._init_host.copy()
        buf = self._init_buf.clone() if buf is None else buf
        drv.rungs_taken = []
        cap = self.max_writes if cap is None else int(cap)
        n_epochs = int(n_epochs)
        chunk = int(snapshot_every) or max(n_epochs, 1)
        parts: list[EpochSeries] = []
        wparts: list[WritepathSeries] = []
        rows = wrows = None
        start = int(start_epoch)
        end_at = start + n_epochs
        if n_epochs <= 0:
            state, buf, fs, rows, wrows = advance(state, host, buf, start, start, cap, fs)
            parts, wparts = [EpochSeries.from_device(rows)], [WritepathSeries.from_device(wrows)]
        while start < end_at:
            size = min(chunk, end_at - start)
            state, buf, fs, rows, wrows = advance(state, host, buf, start, start + size, cap, fs)
            self.flight = drv.flight = fs
            if rows.lanes is not None:
                drv._rung_rows.append(rows)
            if fs is not None and journal is not None:
                journal_drain(journal, fs, chunk_start=start, source="writepath")
            if pull:
                parts.append(EpochSeries.from_device(rows))
                wparts.append(WritepathSeries.from_device(wrows))
            start += size
        self.final_state, self.final_buf = state, buf
        drv.final_state = state
        if not pull:
            return state, buf, rows, wrows
        wseries = WritepathSeries.concat(wparts)
        self._note_totals(wseries)
        return EpochSeries.concat(parts), wseries

    def run_staged(self, n_epochs: int, *, cap: int | None = None):
        """The differential reference: the same epoch body, one epoch at
        a time, both rows copied back after each epoch."""
        drv = self.driver
        state, host, buf = drv._init_state, drv._init_host.copy(), self._init_buf.clone()
        cap = self.max_writes if cap is None else int(cap)
        rows, wrows = [], []
        for e in range(int(n_epochs)):
            state, buf, _fs, (d, row), wrow = self._wp_epoch(state, host, buf, e, cap)
            # torchlint: disable=J003  # the staged reference path reads each epoch's rows
            rows.append((host.now, host.epoch, int(d), row.cpu().numpy()))
            # torchlint: disable=J003  # the staged reference path reads each epoch's rows
            wrows.append(wrow.cpu().numpy())
        self.final_state, self.final_buf = drv._with_scalars(state, host), buf
        drv.final_state = self.final_state
        if not rows:
            return (EpochSeries.from_device(drv._empty_rows()),
                    WritepathSeries(lanes=np.zeros((0, len(WP_LANES)), np.int64)))
        now, epoch, dirty, packed = zip(*rows)
        return (EpochSeries.from_rows(now, epoch, dirty, np.stack(packed)),
                WritepathSeries(lanes=np.stack(wrows)))

    # -- observability -------------------------------------------------

    def dump_stripe_cache(self) -> dict:
        """This driver's panel for the ``dump_stripe_cache`` admin hook:
        buffer occupancy, counters and the footprint-program cache."""
        buf = self.final_buf if self.final_buf is not None else (
            self._init_buf
        )
        return {
            "name": self.name,
            **summarize_buffer(buf),
            "schedule_cache": self.engine.cache.dump(),
        }


# ---------------------------------------------------------------------------
# checkpoint integration: durable snapshots of (cluster, stripe buffer)


def checkpointed_writepath(
    wdrv: WritepathDriver,
    n_epochs: int,
    *,
    store,
    snapshot_every: int = 0,
    cap: int | None = None,
    crashes=(),
):
    """:meth:`WritepathDriver.run_superstep` with a durable snapshot at
    every boundary and resume-from-store on entry: each boundary commits
    the ``(ClusterState, StripeBufferState)`` pair (with the ring when
    the recorder is on) plus both series so far, so a killed run resumes
    with a WARM stripe buffer and lands bit-equal to an uninterrupted
    run."""
    from ..recovery.checkpoint import _aligned_end, _append, _commit, _CrashSchedule

    drv = wdrv.driver
    n_epochs = int(n_epochs)
    every = int(snapshot_every) or max(n_epochs, 1)
    sched = _CrashSchedule(crashes)
    cap = wdrv.max_writes if cap is None else int(cap)
    flight_on = drv.flight_on
    template = (drv._init_state, wdrv._init_buf) + ((drv._init_flight,) if flight_on else ())
    empty = EpochSeries.from_device(drv._empty_rows())
    resume = store.load_latest(template, with_series=True)
    state, buf, fs = drv._init_state, wdrv._init_buf.clone(), drv._init_flight
    host = drv._init_host.copy()
    start, cols, wlanes = 0, None, None
    if resume is not None:
        meta, carry, series = resume
        start = int(meta.get("next_epoch", 0))
        if start:
            state, buf = carry[0], carry[1]
            fs = carry[2] if flight_on else None
            host = drv.host_view(state)
            if series:
                cols = {f: np.asarray(series[f]).astype(getattr(empty, f).dtype)
                        for f in _SERIES_FIELDS}
                wlanes = np.asarray(series["wp_lanes"], np.int64)
    while start < n_epochs:
        end = _aligned_end(start, n_epochs, every)
        state, buf, fs, rows, wrows = wdrv.advance(state, host, buf, start, end, cap, fs)
        wdrv.flight = drv.flight = fs
        cols = _append(cols, EpochSeries.from_device(rows), _SERIES_FIELDS)
        wpart = WritepathSeries.from_device(wrows).lanes
        wlanes = np.concatenate([wlanes, wpart]) if wlanes is not None else wpart
        # the snapshot's copy of the buffer is queued on the stream before
        # the next step's kernels, which update the buffer in place, so
        # it reads the committed bytes
        # a compiled chunk set the state's scalars on the device; its host view is stale
        _commit(store, sched, end, (state, buf) + ((fs,) if flight_on else ()),
                meta={"next_epoch": end, "n_epochs": n_epochs},
                series={**cols, "wp_lanes": wlanes}, host=None if host.stale else host)
        start = end
    wdrv.final_state, wdrv.final_buf = state, buf
    drv.final_state = state
    if cols is None:
        return empty, WritepathSeries(lanes=np.zeros((0, len(WP_LANES)), np.int64))
    wseries = WritepathSeries(lanes=wlanes)
    wdrv._note_totals(wseries)
    return EpochSeries(**cols), wseries


# ---------------------------------------------------------------------------
# the compiled write path


class _WriteCarry(_Carry):
    """:class:`~ceph_tpu_torch.recovery.superstep._Carry` with the write
    path's buffers: the stripe buffer's lanes (updated in place by the
    stripe step), the write rows ``[capacity, len(WP_LANES)]`` (int64)
    and the write cap (0-d int32)."""

    def __init__(self, wdrv: WritepathDriver, state, fs, capacity: int):
        super().__init__(wdrv.driver, state, fs, capacity)
        self.buf = wdrv._init_buf.clone()
        self.wrows = torch.zeros((self.capacity, len(WP_LANES)), dtype=I64, device=wdrv.device)
        self.cap = torch.zeros((), dtype=I32, device=wdrv.device)

    def load_writes(self, buf: StripeBufferState, cap: int) -> None:
        """Copy a chunk's starting buffer in and set the cap."""
        self._load_buf(buf)
        self.cap.fill_(int(cap))

    def _load_buf(self, buf: StripeBufferState) -> None:
        for dst, src in zip(_lanes(self.buf), _lanes(buf)):
            dst.copy_(src)

    def follow(self, other: "_WriteCarry") -> None:
        super().follow(other)
        self._load_buf(other.buf)
        self.cap.copy_(other.cap)

    def take(self, n: int) -> tuple:
        return self.rows[:n].clone(), self.wrows[:n].clone()

    def buffer(self) -> StripeBufferState:
        """A copy of the buffer, the caller's own: the next chunk steps
        the carry's in place."""
        return self.buf.clone()


def _lanes(buf: StripeBufferState) -> tuple:
    return (buf.keys, buf.data, buf.parity, buf.dirty, buf.lru, buf.tick, buf.totals)


class WritepathProgram(SuperstepProgram):
    """The compiled write path of one :class:`WritepathDriver`
    (:meth:`WritepathDriver.compile_writepath`, and
    :meth:`WritepathDriver.compile_writepath_flight` with the recorder's
    ring riding it): a chunk of epochs as one program.

    Its epoch is the compiled superstep's (the tape window, the tick, the
    dirty branch with K3, the traffic core, the epoch row), then the write
    batch (:meth:`WritepathDriver._write_batch` on the step table's salt
    and the cap buffer), the stripe step (K9, one K6 launch over the
    compact Δdata, K9's commit, all updating the carry's buffer in place),
    the write row written in place, and with the recorder on the ring row,
    its stripe lanes from the write row.  On the card the chunk is one
    CUDA graph, captured on the first chunk (after every branch and the
    write stage ran once eagerly on scratch copies of the buffers) and
    replayed for every later one, whatever its cap; on the CPU the same
    body runs eagerly, each decision one host read of its predicate.

    ``program(n_epochs, **kw)`` runs as :meth:`WritepathDriver.run_superstep`;
    :meth:`advance` is :meth:`WritepathDriver.advance`'s compiled form."""

    def __init__(self, wdrv: WritepathDriver, *, flight: bool):
        super().__init__(wdrv.driver, flight=flight)
        self.wdrv = wdrv

    def __call__(self, n_epochs: int, **kw):
        w = self.wdrv
        return w._run_chunks(self.advance, w.driver._init_flight if self.flight else None,
                             n_epochs, **kw)

    def run_eager(self, n_epochs: int, **kw):
        """The same body run eagerly on the driver's device, each decision
        read to the host: what the graph is held against on the card."""
        w = self.wdrv
        return w._run_chunks(functools.partial(self._advance_writes, compiled=False),
                             w.driver._init_flight if self.flight else None, n_epochs, **kw)

    def advance(self, state, host, buf, start: int, stop: int, cap: int, fs=None):
        """Epochs ``start .. stop - 1``: ``(state, buf, fs, rows, wrows)``
        as :meth:`WritepathDriver.advance` returns them, the rows' host
        lanes on the device."""
        return self._advance_writes(state, host, buf, start, stop, cap, fs,
                                    compiled=self.compiled)

    def _advance_writes(self, state, host, buf, start, stop, cap, fs=None, *, compiled: bool):
        start, stop = int(start), int(stop)
        fs = fs if self.flight else None
        if stop <= start:
            return state, buf, fs, self.driver._empty_rows(), self.wdrv._empty_wrows()
        c = self._carry_for(state, fs, stop - start)
        c.load_writes(buf, cap)
        lanes, wrows = self._run(c, host, start, stop, compiled)
        return c.state(), c.buffer(), c.flight(), self._rows(c, lanes), wrows

    def _new_carry(self, state, fs, capacity: int) -> _WriteCarry:
        return _WriteCarry(self.wdrv, state, fs, capacity)

    def _epoch_end(self, c: _WriteCarry, row: torch.Tensor) -> None:
        """The write stage after the epoch's row, then the ring row."""
        w = self.wdrv
        j = (c.step - c.start).reshape(1)
        salt = c.tab["salt"].index_select(0, j).reshape(())
        _buf, wrow = stripe_buffer_step(c.buf, w.table, w.schedule.n_out, w.k, w.w,
                                        *w._write_batch(c.st, None, c.cap, salt=salt))
        c.wrows.index_copy_(0, j, wrow.unsqueeze(0))
        self._record(c, row, wrow)
