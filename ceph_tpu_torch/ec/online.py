"""Online EC write path: the stripe buffer on one device, parity deltas.

The counterpart of the reference package's ``ec/online.py``.

- :class:`StripeBufferState`: the stripe cache as a frozen dataclass of
  tensors: power-of-two ``n_sets`` x ``ways`` slots keyed by a packed
  ``(pg, stripe)`` id, each holding the stripe's data and parity as
  packed u32 word rows (the XOR-schedule packet layout) carried in
  int32 (the same bits; XOR is the same), with per-slot dirty chunk
  masks and an LRU tick lane.
- :func:`stripe_buffer_step`: one epoch's write batch absorbed in two
  phases, in place (the step consumes its buffer).  Phase 1 (lookup, LRU
  victim, install from the backing store, the chunk or full-stripe
  write, Δdata, the counter row) is K9, :func:`stripe_absorb`:
  ``csrc/online.cu`` on a CUDA tensor, :func:`stripe_absorb_plain` on a
  CPU one.  Δdata exists only for the slots the batch touches: compacted
  to ``[kw, B * words]`` (entry ``j`` the slot whose first write is
  batch lane ``j``, ``slot_of[j]`` that slot or -1).  Phase 2 is one K6
  launch over that compact operand through the codec's XOR schedule,
  then K9's commit (:func:`stripe_commit`) XORs each owned entry into
  its slot's parity, adds the row into the totals and sets the tick,
  all in place.  Nothing in the
  step is proportional to the buffer's size; untouched slots are not
  read.
- :class:`ParityDeltaEngine`: read-modify-write parity deltas for one
  codec bitmatrix through footprint programs cached in a
  :class:`~ceph_tpu_torch.ec.schedule.ScheduleCache` (K6).
- ``dump_stripe_cache``: the admin-socket hook body.

K9 walks the batch in order, but writes to different sets never
interact: the set is ``crush_hash32_2(key, _SET_SALT) & (n_sets - 1)``,
and the only thing the sets share is the LRU clock, whose value at a
write is the starting tick plus the count of valid writes before it.
So the kernel runs one block a set, and :func:`stripe_absorb_by_set_plain`
models that order on the CPU (sets one by one, ticks from the prefix
count) to show it is exact.

Scrub coverage of delta-updated parity lives in
:mod:`ceph_tpu_torch.recovery.scrub` (``Scrubber.note_stripe_writes``,
``scrub_stripe_buffer``), built on :func:`dense_parity_words`, a numpy
GF(2) product that shares no code with the schedule compiler.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..analysis.runtime_guard import plain_stand_in
from ..common.perf_counters import PerfCounters, PerfCountersBuilder, registry
from ..core.hashes import crush_hash32_2
from .kernels import schedule_apply
from .schedule import ScheduleCache, XorScheduleEncoder

I32 = torch.int32
I64 = torch.int64

#: decorrelate the set-index hash from the routing/payload hashes
_SET_SALT = 0xB5297A4D
#: per-op payload content seed salt
_PAYLOAD_SALT = 0x68E31DA4
#: backing-store stripe content salt (miss installs regenerate from it)
_BASE_SALT = 0x1B56C4E9

#: the per-epoch stripe-buffer output lanes, in row order
WP_LANES = (
    "hits", "misses", "evictions", "delta_writes", "full_writes",
    "delta_words", "full_words", "touched_slots",
)
#: K9's launch counts, its absorb and its commit (each wrapper adds one
#: where it launches, outside a graph capture), its wrappers' calls (on
#: entry, on any device), and the launches graph replays ran (counted by
#: the runtime guard: the compiled write path's body)
LAUNCHES = {"stripe_absorb": 0, "stripe_commit": 0}
CALLS = dict.fromkeys(LAUNCHES, 0)
REPLAYS = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = CALLS[k] = REPLAYS[k] = 0


def _launched(name: str) -> None:
    """Count a launch that ran: one captured into a graph runs when the
    graph replays, and is counted then."""
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """u32 values carried in int64 -> the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


def _signed32(v: int) -> int:
    """A u32 value as the int32 with its bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def _u32_of(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their u32 values in int64."""
    return x.to(I64) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the stripe buffer


@dataclass(frozen=True)
class StripeBufferState:
    """The stripe cache as tensors on one device.

    ``n_sets`` (a power of two: the set index is a hash masked by
    ``n_sets - 1``) x ``ways`` slots; each slot caches one stripe's data
    and parity as packed u32 word rows carried in int32 (``k*w`` data
    rows, ``m*w`` parity rows, ``words`` each).

    Ownership: :func:`stripe_buffer_step` consumes the buffer it is
    given, as a donated argument would be: it updates every tensor of
    the instance in place and returns that same instance.  A caller that
    needs the old buffer again steps a :meth:`clone`."""

    keys: torch.Tensor    # i32 [n_sets, ways]  packed stripe key, -1 empty
    data: torch.Tensor    # i32 [n_sets, ways, k*w, words]  (u32 bits)
    parity: torch.Tensor  # i32 [n_sets, ways, m*w, words]  (u32 bits)
    dirty: torch.Tensor   # i32 [n_sets, ways]  bitmask over k data chunks
    lru: torch.Tensor     # i32 [n_sets, ways]  last-access tick, -1 empty
    tick: torch.Tensor    # i32 []  access counter (the LRU clock)
    totals: torch.Tensor  # i64 [len(WP_LANES)]  cumulative counters

    @property
    def n_sets(self) -> int:
        return int(self.keys.shape[0])

    @property
    def ways(self) -> int:
        return int(self.keys.shape[1])

    @property
    def words(self) -> int:
        return int(self.data.shape[3])

    def clone(self) -> "StripeBufferState":
        """A copy holding tensors of its own."""
        return StripeBufferState(*(t.clone() for t in (
            self.keys, self.data, self.parity, self.dirty, self.lru, self.tick, self.totals)))


def empty_stripe_buffer(n_sets: int, ways: int, kw: int, mw: int, words: int,
                        device="cuda") -> StripeBufferState:
    """A cold buffer on ``device`` (the card by default): all slots empty
    (``keys == -1``, LRU ``-1`` so victim choice fills empties before
    evicting)."""
    n_sets, ways = int(n_sets), int(ways)
    if n_sets <= 0 or n_sets & (n_sets - 1):
        raise ValueError(f"n_sets must be a power of two, got {n_sets}")
    dev = resolve_device(device)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=dev)

    return StripeBufferState(
        keys=full((n_sets, ways), -1, I32),
        data=full((n_sets, ways, int(kw), int(words)), 0, I32),
        parity=full((n_sets, ways, int(mw), int(words)), 0, I32),
        dirty=full((n_sets, ways), 0, I32),
        lru=full((n_sets, ways), -1, I32),
        tick=full((), 0, I32),
        totals=full((len(WP_LANES),), 0, I64),
    )


def _hash_rows(seed, salt: int, n_rows: int, words: int, device) -> torch.Tensor:
    """Deterministic u32 content rows for one stripe or payload, as int32
    bits ``[n_rows, words]`` (the backing store too: a re-install after
    eviction regenerates the identical stripe)."""
    grid = torch.arange(n_rows * words, dtype=I64, device=device).reshape(n_rows, words)
    return _i32_bits(crush_hash32_2(grid, _scalar((int(seed) & 0xFFFFFFFF) ^ salt, device)))


def stripe_base_rows(key, kw: int, words: int, device="cuda") -> torch.Tensor:
    """The backing store's data rows for stripe ``key`` ([kw, words])."""
    return _hash_rows(key, _BASE_SALT, kw, words, resolve_device(device))


def payload_rows(seed, kw: int, words: int, device="cuda") -> torch.Tensor:
    """One write op's content rows ([kw, words]; small writes mask to
    their chunk's ``w`` rows)."""
    return _hash_rows(seed, _PAYLOAD_SALT, kw, words, resolve_device(device))


def _scalar(v: int, device) -> torch.Tensor:
    """A u32 value as a 0-d int64 tensor on ``device`` (a fill, no copy)."""
    return torch.full((), int(v) & 0xFFFFFFFF, dtype=I64, device=device)


def set_index(keys: torch.Tensor, n_sets: int) -> torch.Tensor:
    """Each batch key's set (int64)."""
    return crush_hash32_2(keys.to(I64), _scalar(_SET_SALT, keys.device)) & (int(n_sets) - 1)


# ---------------------------------------------------------------------------
# phase 1: K9 and its plain versions


def _absorb_one(keys, data, parity, dirty, lru, ddata, slot_of, entry_of: dict, s: int,
                lane: int, key: int, chunk: int, full: bool, seed: int, tick: int, k: int,
                w: int, counts: list) -> None:
    """One valid write (batch lane ``lane``) into set ``s``, in place, as
    the reference's loop body does it: the first equal key hits, else the
    first minimum of ``lru`` is the victim and the stripe installs from
    the backing store as a delta from zero; then the full-stripe or chunk
    write.  The slot's Δdata is the compact entry of its first write in
    the batch (``entry_of``; a new entry starts at zero, as the
    reference's full-width Δdata does)."""
    _n_sets, ways, kw, words = data.shape
    dev = data.device
    row_keys = keys[s].tolist()
    hit = key in row_keys
    if hit:
        way = row_keys.index(key)
    else:
        row_lru = lru[s].tolist()
        way = row_lru.index(min(row_lru))
    install = not hit
    evict = install and row_keys[way] >= 0
    slot = s * ways + way
    if slot not in entry_of:
        entry_of[slot] = lane
        slot_of[lane] = slot
    entry = entry_of[slot]
    dd = ddata[:, entry * words:(entry + 1) * words]  # [kw, words] view
    if install:
        base = stripe_base_rows(key, kw, words, dev)
        data[s, way] = base
        parity[s, way] = 0
        dd.copy_(base)
        dirty[s, way] = 0
    content = payload_rows(seed, kw, words, dev)
    if full:
        data[s, way] = content
        dd.copy_(content)
        parity[s, way] = 0
        dirty[s, way] = (1 << k) - 1
    else:
        rows = slice(chunk * w, (chunk + 1) * w)
        data[s, way, rows] ^= content[rows]
        dd[rows] ^= content[rows]
        bit = (1 << chunk) if 0 <= chunk < 32 else 0
        dirty[s, way] = _signed32((int(dirty[s, way]) & 0xFFFFFFFF) | bit)
    keys[s, way] = key
    lru[s, way] = tick
    counts[0] += int(hit)
    counts[1] += int(install)
    counts[2] += int(evict)
    counts[3] += int(not full)
    counts[4] += int(full)
    counts[5] += w * words if (not full and hit) else 0
    counts[6] += kw * words if (full or not hit) else 0


def _absorb_args(data, n: int):
    """Zeroed compact Δdata ``[kw, n * words]`` and ``slot_of`` (-1)."""
    kw, words = int(data.shape[2]), int(data.shape[3])
    return (torch.zeros((kw, n * words), dtype=I32, device=data.device),
            torch.full((n,), -1, dtype=I32, device=data.device))


def _batch_host(bkeys, bchunks, bfulls, bseeds, bvalid):
    return (bkeys.tolist(), bchunks.tolist(), bfulls.tolist(),
            (_u32_of(bseeds)).tolist(), bvalid.tolist())


def _absorb_out(keys, data, parity, dirty, lru, tick: int, ddata, slot_of, counts, device):
    """The outputs, the touched count (entries with a nonzero word) last."""
    kw, words, n = int(data.shape[2]), int(data.shape[3]), int(slot_of.shape[0])
    touched = int((ddata.view(kw, n, words) != 0).any(2).any(0).sum())
    return (keys, data, parity, dirty, lru, torch.full((), tick, dtype=I32, device=device),
            ddata, slot_of, torch.tensor(counts + [touched], dtype=I64, device=device))


def stripe_absorb_plain(keys, data, parity, dirty, lru, tick, bkeys, bchunks, bfulls,
                        bseeds, bvalid, k: int, w: int):
    """Plain K9: the reference's phase-1 loop body, one write at a time
    in batch order, on the buffer lanes in place.  Returns ``(keys, data,
    parity, dirty, lru, tick, ddata, slot_of, row)``: the buffer lanes
    (the tensors given), the new tick, the compact Δdata ``[kw, B *
    words]`` int32 (entry ``j`` the Δdata of the slot whose first write
    in the batch is lane ``j``: phase 2's K6 operand), ``slot_of [B]``
    int32 (that slot, ``set * ways + way``, or -1 where lane ``j`` owns
    no entry, whose Δdata is zero) and the counter row ``[8]`` int64
    (``WP_LANES``)."""
    dev = data.device
    tick = int(tick)
    ddata, slot_of = _absorb_args(data, int(bkeys.shape[0]))
    n_sets = int(keys.shape[0])
    sets = set_index(bkeys, n_sets).tolist()
    counts = [0] * (len(WP_LANES) - 1)
    entry_of: dict = {}
    for lane, (s, key, chunk, full, seed, val) in enumerate(zip(
            sets, *_batch_host(bkeys, bchunks, bfulls, bseeds, bvalid))):
        if not val:
            continue
        # K9's plain version: CPU tensors only, its lanes walked on the host
        # torchlint: disable=J003
        _absorb_one(keys, data, parity, dirty, lru, ddata, slot_of, entry_of, s, lane, key,
                    chunk, full, seed, tick, k, w, counts)
        tick += 1
    return _absorb_out(keys, data, parity, dirty, lru, tick, ddata, slot_of, counts, dev)


def stripe_absorb_by_set_plain(keys, data, parity, dirty, lru, tick, bkeys, bchunks, bfulls,
                               bseeds, bvalid, k: int, w: int):
    """Plain K9 in the kernel's order: the sets one by one, each walking
    the batch for its own writes, each write's tick the starting tick
    plus the count of valid writes before it in the batch.  Equal to
    :func:`stripe_absorb_plain` because writes to different sets never
    interact (and an entry's number is its lane's, whatever the order)."""
    dev = data.device
    tick0 = int(tick)
    ddata, slot_of = _absorb_args(data, int(bkeys.shape[0]))
    n_sets = int(keys.shape[0])
    sets = set_index(bkeys, n_sets).tolist()
    lanes = list(zip(sets, *_batch_host(bkeys, bchunks, bfulls, bseeds, bvalid)))
    ticks, n_valid = [], 0
    for lane in lanes:
        ticks.append(tick0 + n_valid)
        n_valid += int(bool(lane[5]))
    counts = [0] * (len(WP_LANES) - 1)
    entry_of: dict = {}
    for s in range(n_sets):
        for i, ((ls, key, chunk, full, seed, val), t) in enumerate(zip(lanes, ticks)):
            if val and ls == s:
                # K9's plain version: CPU tensors only, its lanes walked on the host
                # torchlint: disable=J003
                _absorb_one(keys, data, parity, dirty, lru, ddata, slot_of, entry_of, s, i,
                            key, chunk, full, seed, t, k, w, counts)
    return _absorb_out(keys, data, parity, dirty, lru, tick0 + n_valid, ddata, slot_of,
                       counts, dev)


def expand_ddata(ddata: torch.Tensor, slot_of: torch.Tensor, n_slots: int,
                 words: int) -> torch.Tensor:
    """Compact Δdata back to the full width ``[kw, n_slots * words]`` (the
    slots stacked along the word axis, zero where the batch did not
    touch a slot): the reference's layout, for tests and checks."""
    kw, n = int(ddata.shape[0]), int(slot_of.shape[0])
    full = torch.zeros((kw, int(n_slots), int(words)), dtype=ddata.dtype, device=ddata.device)
    own = slot_of >= 0
    full[:, slot_of[own].long()] = ddata.view(kw, n, int(words))[:, own]
    return full.view(kw, int(n_slots) * int(words))


def _check_absorb(keys, data, parity, dirty, lru, tick, batch) -> None:
    for name, t in (("keys", keys), ("data", data), ("parity", parity), ("dirty", dirty),
                    ("lru", lru), ("tick", tick)):
        if t.dtype != I32:
            raise TypeError(f"stripe_absorb: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise TypeError(f"stripe_absorb: {name} must be contiguous (it is updated in place)")
    bkeys, bchunks, bfulls, bseeds, bvalid = batch
    n = int(bkeys.shape[0])
    for name, t, dt in (("bkeys", bkeys, I32), ("bchunks", bchunks, I32),
                        ("bfulls", bfulls, torch.bool), ("bseeds", bseeds, I32),
                        ("bvalid", bvalid, torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (n,):
            raise TypeError(f"stripe_absorb: {name} must be [{n}] {dt}, got "
                            f"{tuple(t.shape)} {t.dtype}")
        if t.device != data.device:
            raise ValueError(f"stripe_absorb: {name} on {t.device}, buffer on {data.device}")


#: K9 (csrc/online.cu): threads a block, most ways a set
ABSORB_THREADS = 256
MAX_WAYS = 64


def stripe_absorb(keys, data, parity, dirty, lru, tick, bkeys, bchunks, bfulls, bseeds,
                  bvalid, k: int, w: int):
    """K9: phase 1 of :func:`stripe_buffer_step` over one epoch's batch
    lanes (``[B]`` each: keys int32, chunks int32, fulls bool, seeds
    int32 u32 bits, valid bool), on the buffer lanes in place.  On a CUDA
    tensor it launches ``csrc/online.cu`` (one block a set; it writes
    every compact Δdata entry and ``slot_of`` itself) or raises; on a CPU
    tensor it runs :func:`stripe_absorb_plain`.  Returns what the plain
    version returns."""
    batch = (bkeys, bchunks, bfulls, bseeds, bvalid)
    _check_absorb(keys, data, parity, dirty, lru, tick, batch)
    CALLS["stripe_absorb"] += 1
    if data.device.type == "cpu":
        with plain_stand_in():
            return stripe_absorb_plain(keys, data, parity, dirty, lru, tick, *batch, k, w)
    from .. import _cuda

    n_sets, ways, kw, words = (int(v) for v in data.shape)
    mw = int(parity.shape[2])
    if ways > MAX_WAYS:
        raise ValueError(f"stripe_absorb: at most {MAX_WAYS} ways, got {ways}")
    if kw != k * w:
        raise ValueError(f"stripe_absorb: {kw} data rows for k={k}, w={w}")
    batch = tuple(t.contiguous() for t in batch)
    n = int(bkeys.shape[0])
    dev = data.device
    ddata = torch.empty((kw, n * words), dtype=I32, device=dev)
    slot_of = torch.empty((n,), dtype=I32, device=dev)
    tick_out = torch.empty((), dtype=I32, device=dev)
    row = torch.zeros(len(WP_LANES), dtype=I64, device=dev)
    _cuda.launch("online", "online_stripe_absorb", dev, *(_cuda.ptr(t) for t in batch), n,
                 _cuda.ptr(keys), _cuda.ptr(data), _cuda.ptr(parity), _cuda.ptr(dirty),
                 _cuda.ptr(lru), _cuda.ptr(tick), _cuda.ptr(tick_out), _cuda.ptr(ddata),
                 _cuda.ptr(slot_of), _cuda.ptr(row), n_sets, ways, kw, mw, words, int(k), int(w))
    _launched("stripe_absorb")
    return keys, data, parity, dirty, lru, tick_out, ddata, slot_of, row


def stripe_commit_plain(parity, dpar, slot_of, row, totals, tick, tick_new) -> None:
    """Plain K9 commit, in place: each owned entry's Δparity (``dpar
    [mw, B * words]``, K6 over the compact Δdata) XORed into its slot's
    parity, ``row`` added into ``totals``, ``tick`` set to ``tick_new``
    (K9's new tick)."""
    n_sets, ways, mw, words = (int(v) for v in parity.shape)
    n = int(slot_of.shape[0])
    own = slot_of >= 0
    flat = parity.view(n_sets * ways, mw, words)
    flat[slot_of[own].long()] ^= dpar.view(mw, n, words).permute(1, 0, 2)[own]
    totals += row
    tick.copy_(tick_new)


def stripe_commit(parity, dpar, slot_of, row, totals, tick, tick_new) -> None:
    """K9's commit: phase 2's tail over the owned entries only, updating
    ``parity``, ``totals`` and ``tick`` in place as
    :func:`stripe_commit_plain` does.  On a CUDA tensor it launches
    ``csrc/online.cu``'s ``stripe_commit_kernel`` (one block an entry) or
    raises; on a CPU tensor it runs :func:`stripe_commit_plain`."""
    n = int(slot_of.shape[0])
    mw, words = int(parity.shape[2]), int(parity.shape[3])
    for name, t, dt, shape in (("parity", parity, I32, tuple(parity.shape)),
                               ("dpar", dpar, I32, (mw, n * words)),
                               ("slot_of", slot_of, I32, (n,)),
                               ("row", row, I64, (len(WP_LANES),)),
                               ("totals", totals, I64, (len(WP_LANES),)),
                               ("tick", tick, I32, ()), ("tick_new", tick_new, I32, ())):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise TypeError(f"stripe_commit: {name} must be contiguous {list(shape)} {dt}, "
                            f"got {list(t.shape)} {t.dtype}")
        if t.device != parity.device:
            raise ValueError(f"stripe_commit: {name} on {t.device}, parity on {parity.device}")
    CALLS["stripe_commit"] += 1
    if parity.device.type == "cpu":
        with plain_stand_in():
            return stripe_commit_plain(parity, dpar, slot_of, row, totals, tick, tick_new)
    from .. import _cuda

    _cuda.launch("online", "online_stripe_commit", parity.device, _cuda.ptr(dpar),
                 _cuda.ptr(slot_of), _cuda.ptr(parity), _cuda.ptr(row), _cuda.ptr(tick_new),
                 _cuda.ptr(tick), _cuda.ptr(totals), n, mw, words)
    _launched("stripe_commit")


# ---------------------------------------------------------------------------
# the epoch step


def stripe_buffer_step(buf: StripeBufferState, table, n_out: int, k: int, w: int, keys,
                       chunks, fulls, seeds, valid):
    """Absorb one epoch's fixed-shape write batch into ``buf`` in place
    (the step consumes it, ``consumes=buf``: see :class:`StripeBufferState`); returns
    ``buf`` itself and the epoch's counter row (``WP_LANES`` order,
    int64).

    ``table`` is the codec's :class:`~ceph_tpu_torch.ec.kernels.StepTable`
    (the full-stripe XOR schedule); ``keys/chunks/fulls/seeds/valid`` are
    the batch lanes (invalid lanes change nothing).  Phase 1 is K9
    (:func:`stripe_absorb`); phase 2 is one K6 launch over the compact
    Δdata of the touched slots, then :func:`stripe_commit`."""
    *_lanes, tick, ddata, slot_of, row = stripe_absorb(
        buf.keys, buf.data, buf.parity, buf.dirty, buf.lru, buf.tick, keys, chunks, fulls,
        seeds, valid, k, w)
    dpar = schedule_apply(table, ddata, int(n_out))  # [mw, B * words]
    stripe_commit(buf.parity, dpar, slot_of, row, buf.totals, buf.tick, tick)
    return buf, row


# ---------------------------------------------------------------------------
# host-facing parity-delta engine (footprint-compiled XOR programs)


def dense_parity_words(bitmatrix: np.ndarray, data_words: np.ndarray):
    """Independent dense GF(2) product over packed u32 word rows:
    ``[mw, kw] x [kw, NW] -> [mw, NW]`` (numpy).  The scrub re-encode
    reference: no shared code with the schedule compiler, so a wrong
    delta program cannot verify itself."""
    bm = (np.asarray(bitmatrix) & 1).astype(bool)
    words = np.ascontiguousarray(data_words)
    words = words.view(np.uint32) if words.dtype.itemsize == 4 else words.astype(np.uint32)
    sel = np.where(bm[:, :, None], words[None, :, :], np.uint32(0))
    return np.bitwise_xor.reduce(sel, axis=1)


class ParityDeltaEngine:
    """Read-modify-write parity deltas for one codec bitmatrix.

    Encoding is linear over GF(2), so overwriting chunks ``F`` turns the
    parity update into ``Δparity = encode_F(old_F ^ new_F)`` where
    ``encode_F`` is the generator bitmatrix restricted to ``F``'s chunk
    columns.  Each footprint's program lowers through the Paar CSE
    compiler once and is cached per ``(codec, footprint)`` in a
    :class:`~ceph_tpu_torch.ec.schedule.ScheduleCache`; the programs run
    through K6 on ``device`` (the card by default)."""

    def __init__(
        self,
        bitmatrix: np.ndarray,
        w: int = 8,
        packetsize: int = 8,
        cache: ScheduleCache | None = None,
        name: str = "writepath",
        device="cuda",
    ):
        self.bitmatrix = np.asarray(bitmatrix, np.uint8) & 1
        self.w = int(w)
        self.packetsize = int(packetsize)
        self.device = resolve_device(device)
        self.mw, self.kw = self.bitmatrix.shape
        if self.kw % self.w or self.mw % self.w:
            raise ValueError(
                f"bitmatrix {self.bitmatrix.shape} not a multiple of "
                f"w={self.w}"
            )
        self.k = self.kw // self.w
        self.m = self.mw // self.w
        # stable cache key half: the generator's content fingerprint
        from ..recovery.scrub import crc32c

        self.codec_id = (
            self.k, self.m, self.w,
            crc32c(np.ascontiguousarray(self.bitmatrix).reshape(-1)),
        )
        self.cache = cache if cache is not None else ScheduleCache(name=name)

    def _footprint(self, footprint) -> tuple[int, ...]:
        fp = tuple(sorted({int(c) for c in footprint}))
        if not fp or fp[0] < 0 or fp[-1] >= self.k:
            raise ValueError(
                f"footprint {fp} out of range for k={self.k}"
            )
        return fp

    def delta_bitmatrix(self, footprint) -> np.ndarray:
        """The generator sub-bitmatrix for an update footprint: the
        column blocks of the touched data chunks."""
        fp = self._footprint(footprint)
        cols = np.concatenate(
            [np.arange(c * self.w, (c + 1) * self.w) for c in fp]
        )
        return np.ascontiguousarray(self.bitmatrix[:, cols])

    def encoder_for(self, footprint) -> XorScheduleEncoder:
        """The compiled delta program for one footprint (cached)."""
        fp = self._footprint(footprint)
        return self.cache.get(
            ("delta", self.codec_id, fp),
            lambda: XorScheduleEncoder(
                self.delta_bitmatrix(fp), layout="packet",
                w=self.w, packetsize=self.packetsize, device=self.device,
            ),
        )

    def full_encoder(self) -> XorScheduleEncoder:
        """The full-stripe encode program (cached once per codec)."""
        return self.cache.get(
            ("full", self.codec_id),
            lambda: XorScheduleEncoder(
                self.bitmatrix, layout="packet",
                w=self.w, packetsize=self.packetsize, device=self.device,
            ),
        )

    def encode(self, data: np.ndarray) -> np.ndarray:
        """Full-stripe parity ``[k, S] u8 -> [m, S] u8`` through the
        schedule path."""
        return self.full_encoder().encode(np.asarray(data, np.uint8))

    def dense_parity(self, data: np.ndarray) -> np.ndarray:
        """Dense reference parity (K5's path: the bit-equality gate's and
        scrub's comparison side)."""
        from .backend import BitmatrixEncoder

        return BitmatrixEncoder(self.bitmatrix, self.packetsize, self.w,
                                self.device).encode(np.asarray(data, np.uint8))

    def apply_delta(
        self, parity: np.ndarray, footprint, old_chunks: np.ndarray,
        new_chunks: np.ndarray,
    ) -> np.ndarray:
        """One read-modify-write: ``parity ^ encode_F(old ^ new)``.

        ``old_chunks``/``new_chunks`` are ``[len(F), S] u8`` in
        footprint order; returns the ``[m, S]`` updated parity."""
        fp = self._footprint(footprint)
        old = np.asarray(old_chunks, np.uint8)
        new = np.asarray(new_chunks, np.uint8)
        if old.shape != new.shape or old.shape[0] != len(fp):
            raise ValueError(
                f"delta chunks {old.shape}/{new.shape} do not match "
                f"footprint {fp}"
            )
        dparity = self.encoder_for(fp).encode(old ^ new)
        return np.asarray(parity, np.uint8) ^ dparity

    def pc_inc(self, counters: "PerfCounters", row) -> None:
        """Fold one epoch row (``WP_LANES`` order) into the
        ``ec_writepath`` perf component."""
        vals = [int(v) for v in np.asarray(row).reshape(-1)]
        for lane, v in zip(WP_LANES, vals):
            name = _COUNTER_OF.get(lane)
            if name is not None and v:
                counters.inc(name, v)


# ---------------------------------------------------------------------------
# observability: counters + the dump_stripe_cache admin hook


_COUNTER_OF = {
    "hits": "stripe_hits",
    "misses": "stripe_misses",
    "evictions": "stripe_evictions",
    "delta_writes": "delta_writes",
    "full_writes": "full_writes",
    "delta_words": "delta_words",
    "full_words": "full_words",
}


def _build_counters() -> PerfCounters:
    return (
        PerfCountersBuilder("ec_writepath")
        .add_u64_counter(
            "stripe_hits", "write ops served from a resident stripe"
        )
        .add_u64_counter(
            "stripe_misses",
            "write ops that installed their stripe from the backing "
            "store",
        )
        .add_u64_counter(
            "stripe_evictions",
            "resident stripes displaced by an LRU victim choice",
        )
        .add_u64_counter(
            "delta_writes", "small overwrites absorbed as parity deltas"
        )
        .add_u64_counter(
            "full_writes", "full-stripe writes batched through encode"
        )
        .add_u64_counter(
            "delta_words",
            "u32 words encoded through footprint delta programs",
        )
        .add_u64_counter(
            "full_words",
            "u32 words encoded as whole-stripe parity (installs + "
            "full-stripe writes)",
        )
        .create_perf_counters()
    )


def writepath_counters() -> PerfCounters:
    """The process-wide ``ec_writepath`` perf-counter component."""
    return registry().get("ec_writepath") or _build_counters()


# every live stripe buffer owner, for the dump_stripe_cache admin hook
_LIVE_STRIPE_CACHES: weakref.WeakSet = weakref.WeakSet()


def register_stripe_cache(owner) -> None:
    """Self-register an object exposing ``dump_stripe_cache() -> dict``
    (the :class:`~ceph_tpu_torch.workload.writepath.WritepathDriver` does
    this on construction)."""
    _LIVE_STRIPE_CACHES.add(owner)


def summarize_buffer(buf: StripeBufferState) -> dict:
    """Host summary of one buffer's occupancy and counters (the admin
    hook payload; a cold-path read)."""
    keys = buf.keys.cpu().numpy()
    dirty = buf.dirty.cpu().numpy()
    totals = buf.totals.cpu().numpy()
    totals = {
        lane: int(v) for lane, v in zip(WP_LANES, totals.reshape(-1))
    }
    lookups = totals["hits"] + totals["misses"]
    return {
        "n_sets": int(keys.shape[0]),
        "ways": int(keys.shape[1]),
        "occupied": int((keys >= 0).sum()),
        "dirty_slots": int((dirty != 0).sum()),
        "hit_rate": (
            round(totals["hits"] / lookups, 4) if lookups else 0.0
        ),
        "delta_bytes": 4 * totals["delta_words"],
        "full_bytes": 4 * totals["full_words"],
        **totals,
    }


def dump_stripe_cache() -> dict:
    """Admin-socket hook body: every live stripe buffer plus the
    aggregate ``ec_writepath`` counters."""
    return {
        "buffers": sorted(
            (o.dump_stripe_cache() for o in _LIVE_STRIPE_CACHES),
            key=lambda d: str(d.get("name", "")),
        ),
        "counters": writepath_counters().dump(),
    }
