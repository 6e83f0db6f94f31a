"""Pure-XOR schedule compiler for GF(2) erasure coding.

Every codec in this tree ultimately multiplies a GF(2) bit-matrix by
bit-rows of the data: RS/Cauchy matrices expand through
:func:`gf.matrix_to_bitmatrix` (w=8) / :func:`gfw.matrix_to_bitmatrix`
(w in {16,32}), and the minimal-density RAID-6 codes (liberation,
blaum_roth, liber8tion) are *defined* by their bitmatrix.  The dense
product XORs every selected row per output row — but parity rows share
sub-sums, and "Accelerating XOR-based Erasure Coding using Program
Optimization Techniques" (arXiv:2108.02692) shows greedy common-
subexpression elimination (Paar's algorithm) cuts 30%+ of those XORs.

This module lowers a bitmatrix to an ordered **XOR schedule**: a flat
``[n_steps, 2]`` step table where step ``(dst, src)`` means
``buf[dst] ^= buf[src]`` over u32 words.  Buffers are laid out
``[inputs | outputs | derived]``; non-input buffers start zeroed, so
the first XOR into a buffer is the move and each derived
subexpression is materialized exactly once.  The compiler
(:func:`compile_schedule`, a copy of the reference package's) runs
Paar's greedy CSE with an incremental pair-count heap;
:class:`XorScheduleEncoder` packs chunk bytes into word rows on the
device and runs the table through K6
(:func:`ceph_tpu_torch.ec.kernels.schedule_apply`), and
:class:`ScheduleCache` memoizes compiled schedules per erasure pattern.

Two data layouts cover every codec family:

- ``packet`` — jerasure's packet-interleaved regions (w packets of
  ``packetsize`` bytes per group): the native layout of
  :class:`~ceph_tpu_torch.ec.backend.BitmatrixEncoder` chunks, i.e.
  every bitmatrix-technique codec (cauchy, w>8 RS, minimal-density
  codes).
- ``bitplane`` — byte-element GF(2^8) chunks (the TableEncoder/RS
  layout): plane ``(j, l)`` holds bit ``l`` of every byte of chunk
  ``j``, so applying ``gf.matrix_to_bitmatrix(R)`` to the planes is
  exactly the byte-wise GF(2^8) product ``R @ chunks``.

Words ride as int32 tensors (XOR is bit-identical; CPU PyTorch has no
u32 arithmetic).  The numpy pack/unpack functions are the host
reference of the device packing.
"""

from __future__ import annotations

import heapq
import weakref
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..common.perf_counters import PerfCounters, PerfCountersBuilder, registry
from . import gf, kernels
from .backend import BitmatrixEncoder, to_device


@dataclass(frozen=True)
class XorSchedule:
    """An ordered XOR program computing ``bitmatrix @ rows`` over GF(2).

    ``steps[i] = (dst, src)`` means ``buf[dst] ^= buf[src]``; buffers
    ``[0, n_in)`` are the input rows, ``[n_in, n_in + n_out)`` the
    output rows, and the rest derived subexpressions.  Non-input
    buffers start zeroed (first XOR = move).  ``xor_count`` uses the
    literature's metric (an r-term sum costs r-1 XORs; the move is
    free), so it is directly comparable to ``naive_xor_count`` — the
    dense product's cost on the same matrix.
    """

    steps: np.ndarray  # [n_steps, 2] int32
    n_in: int
    n_out: int
    n_bufs: int
    xor_count: int
    naive_xor_count: int

    @property
    def n_steps(self) -> int:
        return int(self.steps.shape[0])

    @property
    def reduction_fraction(self) -> float:
        """Fraction of the dense product's XORs the CSE removed."""
        if not self.naive_xor_count:
            return 0.0
        return 1.0 - self.xor_count / self.naive_xor_count

    def execute_host(self, words: np.ndarray) -> np.ndarray:
        """Reference interpreter: ``words [n_in, N] u32 -> [n_out, N]``."""
        bufs = np.zeros((self.n_bufs, words.shape[1]), np.uint32)
        bufs[: self.n_in] = words
        for dst, src in self.steps:
            bufs[dst] ^= bufs[src]
        return bufs[self.n_in : self.n_in + self.n_out].copy()


def compile_schedule(
    bitmatrix: np.ndarray, max_derived: int = 1024
) -> XorSchedule:
    """Shrink a GF(2) bit-matrix product into an XOR schedule via
    greedy CSE (Paar's algorithm, arXiv:2108.02692 §3).

    Repeatedly extracts the symbol pair shared by the most rows
    (ties broken deterministically on the pair itself), materializes it
    as a derived symbol for 1 XOR, and substitutes — a pair in c rows
    saves c-1 XORs net, so the schedule's XOR count only ever drops.
    Pair counts are maintained incrementally in a lazy-deletion
    max-heap, so each extraction costs O(affected rows x row width)
    instead of a full matrix rescan.  ``max_derived`` bounds the
    scratch-buffer count (stopping early is always correct).
    """
    bm = (np.asarray(bitmatrix) & 1).astype(bool)
    n_out, n_in = bm.shape
    rows = [set(np.flatnonzero(r).tolist()) for r in bm]
    naive = sum(max(len(r) - 1, 0) for r in rows)
    pair_rows: dict[tuple[int, int], set[int]] = {}
    for ri, r in enumerate(rows):
        syms = sorted(r)
        for i in range(len(syms)):
            for j in range(i + 1, len(syms)):
                pair_rows.setdefault((syms[i], syms[j]), set()).add(ri)
    heap = [(-len(v), p) for p, v in pair_rows.items()]
    heapq.heapify(heap)
    derived: list[tuple[int, int]] = []  # creation-ordered (a, b) defs
    next_sym = n_in

    def _dec(pair: tuple[int, int], ri: int) -> None:
        s = pair_rows.get(pair)
        if s is not None:
            s.discard(ri)
            if not s:
                del pair_rows[pair]

    def _inc(pair: tuple[int, int], ri: int) -> None:
        s = pair_rows.setdefault(pair, set())
        s.add(ri)
        heapq.heappush(heap, (-len(s), pair))

    while len(derived) < max_derived and heap:
        negc, pair = heapq.heappop(heap)
        cur = pair_rows.get(pair)
        if cur is None or len(cur) != -negc:
            continue  # stale heap entry (lazy deletion)
        if -negc < 2:
            break  # no pair shared by >= 2 rows: CSE is done
        a, b = pair
        s = next_sym
        next_sym += 1
        derived.append((a, b))
        del pair_rows[pair]
        for ri in sorted(cur):
            r = rows[ri]
            r.discard(a)
            r.discard(b)
            for x in r:
                _dec((a, x) if a < x else (x, a), ri)
                _dec((b, x) if b < x else (x, b), ri)
            for x in r:
                _inc((s, x) if s < x else (x, s), ri)
            r.add(s)

    # emit: derived defs in creation order (each references only inputs
    # and earlier derived symbols), then the surviving output sums
    def buf(sym: int) -> int:
        return sym if sym < n_in else sym + n_out

    steps: list[tuple[int, int]] = []
    for i, (a, b) in enumerate(derived):
        d = n_in + n_out + i
        steps.append((d, buf(a)))
        steps.append((d, buf(b)))
    for ri, r in enumerate(rows):
        dst = n_in + ri
        for sym in sorted(r):
            steps.append((dst, buf(sym)))
    xor = len(derived) + sum(max(len(r) - 1, 0) for r in rows)
    return XorSchedule(
        steps=np.asarray(steps, np.int32).reshape(-1, 2),
        n_in=n_in,
        n_out=n_out,
        n_bufs=n_in + n_out + len(derived),
        xor_count=xor,
        naive_xor_count=naive,
    )


# ---------------------------------------------------------------------------
# data layouts: chunk bytes <-> u32 word rows the schedule operates on
# (numpy: the host reference; the *_dev functions: the device packing)


def packet_words(size: int, w: int, packetsize: int) -> int:
    """Words per row for the packet layout of a ``size``-byte chunk."""
    pb = (packetsize + 3) // 4 * 4
    return size // (w * packetsize) * (pb // 4)


def pack_packet_rows(
    data: np.ndarray, w: int, packetsize: int
) -> np.ndarray:
    """Packet-interleave ``[k, S] u8 -> [k*w, NW] u32`` (row ``j*w+l``
    = chunk j's packets l across groups, each packet tail-padded to a
    whole word — XOR of zero-padded packets is the zero-padded XOR, so
    the pad trims off exactly on unpack)."""
    k, size = data.shape
    p = packetsize
    group = w * p
    if size % group:
        raise ValueError(f"chunk size {size} % w*packetsize={group} != 0")
    g = size // group
    pb = (p + 3) // 4 * 4
    d = np.ascontiguousarray(data).reshape(k, g, w, p)
    d = d.transpose(0, 2, 1, 3).reshape(k * w, g, p)
    if pb != p:
        d = np.pad(d, ((0, 0), (0, 0), (0, pb - p)))
    return np.ascontiguousarray(d).view(np.uint32).reshape(k * w, g * (pb // 4))


def unpack_packet_rows(
    words: np.ndarray, n_chunks: int, w: int, packetsize: int, size: int
) -> np.ndarray:
    """Inverse of :func:`pack_packet_rows`: ``[n*w, NW] u32 -> [n, S]``."""
    p = packetsize
    g = size // (w * p)
    pb = (p + 3) // 4 * 4
    b = np.ascontiguousarray(words).view(np.uint8)
    b = b.reshape(n_chunks * w, g, pb)[:, :, :p]
    b = b.reshape(n_chunks, w, g, p).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(b.reshape(n_chunks, size))


def bitplane_words(size: int) -> int:
    """Words per plane for the bit-plane layout of a ``size``-byte chunk."""
    return ((size + 31) // 32 * 32) // 32


def pack_bitplanes(data: np.ndarray) -> np.ndarray:
    """Byte-element layout ``[k, S] u8 -> [k*8, NW] u32``: plane
    ``j*8+l`` packs bit ``l`` of every byte of chunk j (little-endian
    within the plane bytes), so ``gf.matrix_to_bitmatrix(R)`` applied
    to the planes is exactly the byte-wise GF(2^8) product."""
    k, size = data.shape
    pad = (-size) % 32
    if pad:
        data = np.pad(data, ((0, 0), (0, pad)))
    shifts = np.arange(8, dtype=np.uint8)[None, :, None]
    bits = (data[:, None, :] >> shifts) & 1
    planes = np.packbits(
        bits.reshape(k * 8, -1), axis=-1, bitorder="little"
    )
    return np.ascontiguousarray(planes).view(np.uint32)


def unpack_bitplanes(
    words: np.ndarray, n_chunks: int, size: int
) -> np.ndarray:
    """Inverse of :func:`pack_bitplanes`: ``[n*8, NW] u32 -> [n, S]``."""
    planes = np.ascontiguousarray(words).view(np.uint8)
    bits = np.unpackbits(planes, axis=-1, bitorder="little")
    bits = bits.reshape(n_chunks, 8, -1)[:, :, :size]
    shifts = np.arange(8, dtype=np.uint8)[None, :, None]
    return np.ascontiguousarray(
        (bits << shifts).sum(axis=1, dtype=np.uint8)
    )


def _shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def _as_words(b: torch.Tensor) -> torch.Tensor:
    """``[r, 4n]`` u8 -> ``[r, n]`` int32, the same bytes."""
    if b.shape[1] == 0:
        return torch.empty((b.shape[0], 0), dtype=torch.int32, device=b.device)
    return b.contiguous().view(torch.int32)


def _as_bytes(w: torch.Tensor) -> torch.Tensor:
    """``[r, n]`` int32 -> ``[r, 4n]`` u8, the same bytes."""
    if w.shape[1] == 0:
        return torch.empty((w.shape[0], 0), dtype=torch.uint8, device=w.device)
    return w.contiguous().view(torch.uint8)


def pack_packet_rows_dev(data: torch.Tensor, w: int, packetsize: int) -> torch.Tensor:
    """:func:`pack_packet_rows` on the device: ``[k, S]`` u8 tensor ->
    ``[k*w, NW]`` int32 tensor (each packet tail-padded to a word)."""
    k, size = data.shape
    p = packetsize
    if size % (w * p):
        raise ValueError(f"chunk size {size} % w*packetsize={w * p} != 0")
    g = size // (w * p)
    pb = (p + 3) // 4 * 4
    d = data.reshape(k, g, w, p).permute(0, 2, 1, 3).reshape(k * w, g, p)
    if pb != p:
        d = torch.nn.functional.pad(d, (0, pb - p))
    return _as_words(d.reshape(k * w, g * pb))


def unpack_packet_rows_dev(words: torch.Tensor, n_chunks: int, w: int, packetsize: int,
                           size: int) -> torch.Tensor:
    """Inverse of :func:`pack_packet_rows_dev`: ``[n*w, NW]`` int32 ->
    ``[n, S]`` u8, the packet padding trimmed."""
    p = packetsize
    g = size // (w * p)
    pb = (p + 3) // 4 * 4
    b = _as_bytes(words).reshape(n_chunks * w, g, pb)[:, :, :p]
    return b.reshape(n_chunks, w, g, p).permute(0, 2, 1, 3).reshape(n_chunks, size)


def pack_bitplanes_dev(data: torch.Tensor) -> torch.Tensor:
    """:func:`pack_bitplanes` on the device: ``[k, S]`` u8 -> ``[k*8,
    NW]`` int32, S padded to 32 bytes; bit ``i`` of plane byte ``b`` is
    bit ``l`` of data byte ``8*b + i`` (numpy's little bit order)."""
    k, size = data.shape
    data = torch.nn.functional.pad(data, (0, (-size) % 32))
    sh = _shifts(data.device)
    bits = (data[:, None, :] >> sh[None, :, None]) & 1  # [k, 8, S']
    bits = bits.reshape(k * 8, -1, 8)
    planes = (bits << sh).sum(dim=-1, dtype=torch.uint8)  # [k*8, S'/8]
    return _as_words(planes)


def unpack_bitplanes_dev(words: torch.Tensor, n_chunks: int, size: int) -> torch.Tensor:
    """Inverse of :func:`pack_bitplanes_dev`: ``[n*8, NW]`` int32 ->
    ``[n, S]`` u8."""
    sh = _shifts(words.device)
    planes = _as_bytes(words)  # [n*8, NW*4]
    bits = (planes[..., None] >> sh) & 1  # [n*8, NW*4, 8]
    bits = bits.reshape(n_chunks, 8, -1)[:, :, :size]
    return (bits << sh[None, :, None]).sum(dim=1, dtype=torch.uint8)


# ---------------------------------------------------------------------------
# device execution


class XorScheduleEncoder:
    """Execute a compiled XOR schedule for one repair bitmatrix on one
    device.

    ``encode_async`` packs chunk bytes into word rows on the device,
    runs the schedule (K6, :func:`~ceph_tpu_torch.ec.kernels.
    schedule_apply`) and returns the in-flight ``[n_out_bits, NW]``
    int32 tensor; ``finalize`` unpacks it, trims the padding and brings
    ``[n_chunks, S]`` bytes to the host.  ``layout`` picks the
    byte<->row mapping: ``"packet"`` (bitmatrix codecs, w + packetsize)
    or ``"bitplane"`` (byte-element GF(2^8) chunks, w fixed at 8).
    """

    def __init__(
        self,
        bitmatrix: np.ndarray,
        layout: str = "packet",
        w: int = 8,
        packetsize: int = 64,
        max_derived: int = 1024,
        device="cuda",
    ):
        if layout not in ("packet", "bitplane"):
            raise ValueError(f"unknown schedule layout {layout!r}")
        self.bitmatrix = np.asarray(bitmatrix, np.uint8) & 1
        self.layout = layout
        self.w = w if layout == "packet" else 8
        self.packetsize = packetsize
        self.device = resolve_device(device)
        self.schedule = compile_schedule(self.bitmatrix, max_derived)
        self.n_chunks_out = self.schedule.n_out // self.w
        self.table = kernels.StepTable(self.schedule.steps, self.schedule.n_bufs, self.device,
                                       self.schedule.n_in, self.schedule.n_out)

    def _pack(self, data: torch.Tensor) -> torch.Tensor:
        if self.layout == "packet":
            return pack_packet_rows_dev(data, self.w, self.packetsize)
        return pack_bitplanes_dev(data)

    def encode_async(self, data) -> torch.Tensor:
        """``data [k, S]`` u8 (numpy or tensor) -> in-flight
        ``[n_out_bits, NW]`` int32 on the device."""
        words = self._pack(to_device(data, self.device))
        return kernels.schedule_apply(self.table, words, self.schedule.n_out)

    def finalize(self, out: torch.Tensor, size: int) -> np.ndarray:
        """Materialize an in-flight output for ``size``-byte chunks."""
        if self.layout == "packet":
            nw = packet_words(size, self.w, self.packetsize)
            got = unpack_packet_rows_dev(out[:, :nw], self.n_chunks_out, self.w,
                                         self.packetsize, size)
        else:
            got = unpack_bitplanes_dev(out[:, :bitplane_words(size)], self.n_chunks_out, size)
        return got.cpu().numpy()

    def encode(self, data) -> np.ndarray:
        """``data [k, S] u8 -> [n_chunks_out, S] u8`` (synchronous)."""
        return self.finalize(self.encode_async(data), data.shape[1])


class DenseBitmatrixAdapter:
    """``encode_async``/``finalize`` shim over the dense
    :class:`~ceph_tpu_torch.ec.backend.BitmatrixEncoder` product (K5),
    so the executor's bit-level dispatch is engine-agnostic (the
    ``recovery_xor_schedule = off`` reference path)."""

    schedule = None  # no XOR schedule: the cache skips its counters

    def __init__(self, bitmatrix: np.ndarray, w: int, packetsize: int, device="cuda"):
        self._enc = BitmatrixEncoder(np.asarray(bitmatrix, np.uint8), packetsize, w, device)

    def encode_async(self, data) -> torch.Tensor:
        group = self._enc.w * self._enc.packetsize
        if data.shape[1] % group:
            raise ValueError(
                f"chunk size {data.shape[1]} not a multiple of "
                f"w*packetsize={group}"
            )
        return self._enc.encode_async(data)

    def finalize(self, out: torch.Tensor, size: int) -> np.ndarray:
        return out.cpu().numpy()


# ---------------------------------------------------------------------------
# caching + observability


def _build_counters() -> PerfCounters:
    return (
        PerfCountersBuilder("ec_schedule")
        .add_u64_counter(
            "schedules_compiled", "XOR schedules compiled (CSE passes run)"
        )
        .add_u64_counter(
            "schedule_xor_count",
            "total XORs across compiled schedules (post-CSE)",
        )
        .add_u64_counter(
            "schedule_xor_naive",
            "total XORs the dense bit-matrix products would have cost",
        )
        .add_u64_counter(
            "schedule_cache_hits",
            "schedule-cache lookups served without recompiling",
        )
        .add_u64_counter(
            "schedule_cache_evictions",
            "cached engines evicted by the LRU bound "
            "(recovery_schedule_cache_max)",
        )
        .add_u64_counter(
            "schedules_quarantined",
            "compiled engines evicted + blacklisted after their output "
            "failed decode-verify (miscompiled XOR schedules)",
        )
        .create_perf_counters()
    )


def schedule_counters() -> PerfCounters:
    """The process-wide ``ec_schedule`` perf-counter component."""
    return registry().get("ec_schedule") or _build_counters()


# every live cache, for the admin socket's dump_ec_schedules hook
_LIVE_CACHES: weakref.WeakSet = weakref.WeakSet()


class ScheduleCache:
    """Compiled-schedule cache, one entry per (engine, erasure pattern).
    Hits and compile-time XOR counters land in the ``ec_schedule`` perf
    component (Prometheus scrapes it through the shared registry); live
    caches self-register for the ``dump_ec_schedules`` hook.

    ``max_entries`` bounds the cache LRU (``recovery_schedule_cache_max``
    at the executor surface; 0 = unbounded): a long chaos timeline
    visits many erasure patterns and must not grow device state without
    limit.  :meth:`quarantine` is the decode-verify eviction path — an
    engine whose output failed CRC verification is dropped AND
    blacklisted, so :func:`encoder_for_group` reroutes that pattern to
    the dense reference engine instead of recompiling the same bad
    schedule.
    """

    def __init__(self, name: str = "recovery", max_entries: int = 0):
        self.name = name
        self.max_entries = int(max_entries)
        self._entries: OrderedDict = OrderedDict()
        self._quarantined: set = set()
        self.pc = schedule_counters()
        _LIVE_CACHES.add(self)

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key, build):
        """Fetch the engine for ``key``, building (and counting) once;
        refreshes the key's LRU position and evicts past the bound."""
        enc = self._entries.get(key)
        if enc is not None:
            self._entries.move_to_end(key)
            self.pc.inc("schedule_cache_hits")
            return enc
        enc = self._entries[key] = build()
        sched = getattr(enc, "schedule", None)
        if sched is not None:
            self.pc.inc("schedules_compiled")
            self.pc.inc("schedule_xor_count", sched.xor_count)
            self.pc.inc("schedule_xor_naive", sched.naive_xor_count)
        if self.max_entries > 0:
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.pc.inc("schedule_cache_evictions")
        return enc

    def quarantine(self, key) -> bool:
        """Evict AND blacklist ``key`` (decode-verify caught its engine
        shipping wrong bytes).  Returns True the first time — callers
        journal ``scrub.schedule_quarantined`` exactly once per key."""
        self._entries.pop(key, None)
        if key in self._quarantined:
            return False
        self._quarantined.add(key)
        self.pc.inc("schedules_quarantined")
        return True

    def is_quarantined(self, key) -> bool:
        return key in self._quarantined

    def dump(self) -> dict:
        entries = []
        for key, enc in sorted(
            self._entries.items(), key=lambda kv: str(kv[0])
        ):
            e: dict = {"key": str(key)}
            sched = getattr(enc, "schedule", None)
            if sched is None:
                e["engine"] = "dense"
            else:
                e.update(
                    engine="schedule",
                    n_steps=sched.n_steps,
                    n_in=sched.n_in,
                    n_out=sched.n_out,
                    xor_count=sched.xor_count,
                    naive_xor_count=sched.naive_xor_count,
                    reduction_fraction=round(sched.reduction_fraction, 4),
                )
            entries.append(e)
        return {
            "name": self.name,
            "entries": entries,
            "max_entries": self.max_entries,
            "quarantined": sorted(str(k) for k in self._quarantined),
        }


def dump_ec_schedules() -> dict:
    """Admin hook body: every live schedule cache plus the aggregate
    ``ec_schedule`` counters."""
    return {
        "caches": sorted(
            (c.dump() for c in _LIVE_CACHES), key=lambda d: d["name"]
        ),
        "counters": schedule_counters().dump(),
    }


def encoder_for_group(cache: ScheduleCache, group, mode: str, device="cuda"):
    """Build-or-fetch the batched-decode engine for one pattern group
    on ``device``.

    Bit-level groups (``repair_bitmatrix`` set — bitmatrix-native and
    cauchy-technique codecs) run the XOR schedule in packet layout, or
    the dense bitmatrix product (K5) when ``mode == "off"``.  GF(2^8)
    table groups reach here only when ``mode == "on"`` forces them onto
    the schedule path: their repair matrix expands through
    :func:`gf.matrix_to_bitmatrix` and executes in bit-plane layout,
    byte-identical to the LUT product.

    A pattern whose schedule was quarantined (decode-verify caught it
    shipping wrong bytes) permanently reroutes to the dense reference
    engine — same repair bitmatrix, independent execution path.
    """
    if group.repair_bitmatrix is not None:
        if mode == "off" or cache.is_quarantined(("packet", group.mask)):
            return cache.get(
                ("dense", group.mask),
                lambda: DenseBitmatrixAdapter(
                    group.repair_bitmatrix, group.w, group.packetsize, device
                ),
            )
        return cache.get(
            ("packet", group.mask),
            lambda: XorScheduleEncoder(
                group.repair_bitmatrix,
                layout="packet",
                w=group.w,
                packetsize=group.packetsize,
                device=device,
            ),
        )
    return cache.get(
        ("bitplane", group.mask),
        lambda: XorScheduleEncoder(
            gf.matrix_to_bitmatrix(group.repair_matrix), layout="bitplane",
            device=device,
        ),
    )
