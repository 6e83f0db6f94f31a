"""Device-side scrub: batched CRC32C verification of shard buffers.

Upstream detects silent corruption with per-chunk checksums:
``osd_scrub`` / ``osd_deep_scrub`` walk every object, recompute its
CRC32C (``ceph_crc32c``, the Castagnoli polynomial), compare against
the stored digest, and mark mismatching PGs ``inconsistent`` so
``PG::repair_object`` can rebuild them through the EC decode path.
Here the whole pool scrubs in one pass on one device: every (pg, shard)
chunk is stacked into a ``[n_pgs, n_shards, chunk]`` operand, kernel K8
(:func:`crc_rows`, ``csrc/scrub.cu``) computes the CRC32C of every row,
and the comparison against the stored checksum table reduces — with a
few torch ops on the device — to a per-PG *inconsistent bitmask* in
exactly the survivor-bitmask format the repair planner groups by
(:mod:`ceph_tpu_torch.recovery.planner`): bit ``s`` set means shard
``s``'s bytes are damaged and must not be used as a decode source.

Scrub bandwidth admits through the ``"scrub"`` mclock class
(:mod:`ceph_tpu_torch.workload.qos`) when an arbiter is attached, so a
scrub storm can never starve client or recovery traffic.

:class:`DecodeVerifier` closes the loop on the *repair* side: before
the executor commits a decode launch's output it recomputes the
rebuilt chunks' CRCs (K8 again) and optionally re-encodes parity
against the write-time checksum table — a miscompiled XOR schedule
(:mod:`ceph_tpu_torch.ec.schedule`) is caught here, quarantined, and
retried through the dense bit-matrix path instead of shipping bad
bytes.

CRCs ride in int64 tensors (u32 values; CPU PyTorch has no u32
arithmetic) and come back to the host as u32.

The online write path's stripe buffer (:mod:`ceph_tpu_torch.ec.online`)
scrubs through two independent lanes (:meth:`Scrubber.note_stripe_writes`,
:meth:`Scrubber.scrub_stripe_buffer`, :meth:`DecodeVerifier.
verify_stripe_buffer`): each resident slot's parity digest (K8 over the
slots' parity rows on the buffer's device) against the write-time
table, and a dense numpy GF(2) re-encode of its data.

Under a mesh (:func:`sharded_scrub_step`, ``Scrubber(mesh=)``) the PG
axis splits over the ranks: each rank runs K8 over its slice of PGs,
the damage histogram and total are summed over the ranks, and the
per-PG bitmask is all-gathered so every rank can plan the repair.
"""

from __future__ import annotations

import functools
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..analysis.runtime_guard import (
    assert_rank_identical,
    plain_stand_in,
    rank_checks_enabled,
)
from ..common.perf_counters import PerfCounters, PerfCountersBuilder, registry
from ..common.tracing import trace_annotation
from ..parallel.padding import pad_to_multiple

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8

#: CRC32C (Castagnoli) reflected polynomial — upstream's
#: ``ceph_crc32c`` and iSCSI/ext4's checksum.
CRC32C_POLY = 0x82F63B78

#: K8's launches (``chip_smoke.py`` reads and resets these) and its
#: wrapper's calls (on entry, on any device)
LAUNCHES = {"crc32c_rows": 0}
CALLS = dict.fromkeys(LAUNCHES, 0)

_TABLE: np.ndarray | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = CALLS[k] = 0


def crc32c_table() -> np.ndarray:
    """The 256-entry CRC32C lookup table (u32), built once."""
    global _TABLE
    if _TABLE is None:
        table = np.empty(256, np.uint32)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (CRC32C_POLY if crc & 1 else 0)
            table[i] = crc
        _TABLE = table
    return _TABLE


def crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """Host CRC32C of every row of a ``[n, chunk]`` u8 array -> [n]
    u32.  Byte-serial over the chunk axis, vectorized over rows."""
    rows = np.ascontiguousarray(rows, np.uint8)
    lut = crc32c_table()
    crc = np.full(rows.shape[0], 0xFFFFFFFF, np.uint32)
    for i in range(rows.shape[1]):
        crc = (crc >> np.uint32(8)) ^ lut[(crc ^ rows[:, i]) & 0xFF]
    return crc ^ np.uint32(0xFFFFFFFF)


def crc32c(data) -> int:
    """Host CRC32C of one byte buffer (tests + write-time digests)."""
    buf = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)
    ) else np.asarray(data, np.uint8)
    return int(crc32c_rows(buf[None, :])[0])


def apply_bitrot(buf: np.ndarray, offset: int, mask: int) -> None:
    """XOR ``mask`` into ``buf[offset % len(buf)]`` in place — the
    standard ``corrupt`` callback body for a host shard store (offsets
    wrap so scenario-generated events always land inside the chunk)."""
    buf[offset % len(buf)] ^= np.uint8(mask)


def scrub_phases(n_pgs: int, period_s: float) -> np.ndarray:
    """Per-PG deep-scrub phase offsets in ``[0, period_s)`` ([n_pgs]
    f64): a Knuth multiplicative hash of the PG seed, so the pool's
    scrub load spreads evenly across the period instead of every PG
    scrubbing at once (upstream's ``osd_deep_scrub_randomize_ratio``
    spread, but deterministic — the virtual clock has no randomness)."""
    pgs = np.arange(n_pgs, dtype=np.uint64)
    h = (pgs * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    return h.astype(np.float64) / float(2**32) * float(period_s)


# ---------------------------------------------------------------------------
# CRC32C algebra (zlib's crc32_combine, for the Castagnoli polynomial)
#
# A CRC register in the reflected form is a polynomial of degree < 32
# with bit 31 the coefficient of x^0.  Let R(c, M) be the register after
# the bytes M from state c (no final XOR) and S_n(c) = c * x^(8n) mod P,
# the register after n zero bytes.  CRC is linear, so R(c, M) =
# S_|M|(c) ^ R(0, M), R(0, A||B) = S_|B|(R(0, A)) ^ R(0, B) and
# crc32c(M) = R(0, M) ^ S_|M|(0xFFFFFFFF) ^ 0xFFFFFFFF.  K8 folds segments
# of a row at once and combines them by these identities.

_X2N: list[int] = []


def gf2_multmodp(a: int, b: int) -> int:
    """``a * b mod P`` for two registers in the reflected form (zlib's
    ``multmodp``)."""
    p = 0
    for j in range(32):
        if a & (0x80000000 >> j):
            p ^= b
        b = (b >> 1) ^ (CRC32C_POLY if b & 1 else 0)
    return p


def crc32c_x8n(n: int) -> int:
    """``x^(8n) mod P``, the multiplier of S_n (zlib's ``x2nmodp(n, 3)``)."""
    if not _X2N:
        p = 1 << 30  # x^1
        for _ in range(64):
            _X2N.append(p)  # x^(2^k)
            p = gf2_multmodp(p, p)
    p, k = 1 << 31, 3  # x^0; 8n = n << 3
    while n:
        if n & 1:
            p = gf2_multmodp(_X2N[k], p)
        n >>= 1
        k += 1
    return p


def crc32c_shift(c: int, n: int) -> int:
    """S_n(c): the register ``c`` after ``n`` zero bytes."""
    return gf2_multmodp(crc32c_x8n(n), c)


def crc32c_combine(a: int, b: int, len_b: int) -> int:
    """crc32c(A||B) from ``a = crc32c(A)``, ``b = crc32c(B)`` and
    ``len_b = |B|`` (the conditioning terms cancel); the same holds for
    raw registers R(0, .)."""
    return crc32c_shift(a, len_b) ^ b


def crc32c_shift_tables(n: int) -> np.ndarray:
    """S_n as byte tables, ``[4, 256]`` u32: ``t[k, i] = S_n(i << 8k)``,
    so ``S_n(c) = t[0, c & 255] ^ t[1, c >> 8 & 255] ^ t[2, c >> 16 & 255]
    ^ t[3, c >> 24]``."""
    a = (np.arange(256, dtype=np.uint64)[None, :] << (8 * np.arange(4, dtype=np.uint64))[:, None])
    a = a.astype(np.uint32)
    p, b = np.zeros_like(a), crc32c_x8n(n)
    for j in range(32):
        p ^= np.where(a & np.uint32(0x80000000 >> j), np.uint32(b), np.uint32(0))
        b = (b >> 1) ^ (CRC32C_POLY if b & 1 else 0)
    return p


def crc32c_slice_tables() -> np.ndarray:
    """Slicing-by-4 tables, ``[4, 256]`` u32: ``t[0]`` the byte table,
    ``t[k][i]`` the register of byte ``i`` followed by ``k`` zero bytes,
    so a little-endian word ``w`` folds as ``c = crc ^ w; crc = t[3][c &
    255] ^ t[2][c >> 8 & 255] ^ t[1][c >> 16 & 255] ^ t[0][c >> 24]``."""
    t = np.empty((4, 256), np.uint32)
    t[0] = crc32c_table()
    for k in range(1, 4):
        t[k] = (t[k - 1] >> np.uint32(8)) ^ t[0][t[k - 1] & 0xFF]
    return t


# ---------------------------------------------------------------------------
# K8: CRC32C of rows

#: lanes K8 aims to keep busy: 132 SMs x 512 threads (one H100)
K8_FILL_LANES = 132 * 512
#: a lane's share of a long row, in bytes
K8_LANE_BYTES = 1024
#: at most one block (512 lanes, 2^9) a row
K8_MAX_LOG_LANES = 9


def _log2_ceil(x: int) -> int:
    return (max(int(x), 1) - 1).bit_length()


def crc_segments(n: int, L: int) -> tuple[int, int]:
    """K8's cut of ``[n, L]`` rows, from the shape alone: ``(log_w,
    seg)``, ``2^log_w`` lanes a row, each folding a segment of ``seg``
    bytes (a multiple of 16; ``seg << log_w >= L``).  Lanes go up until
    ``n`` rows fill :data:`K8_FILL_LANES` or a lane has about
    :data:`K8_LANE_BYTES` of a long row, but never past one block a row
    or below 16 bytes a lane: ``[90112, 32768]`` (a scrub pass) gives a
    warp a row, 1 KiB a lane; ``[32, 32768]`` (a decode-verify call) a
    block a row, 64 bytes a lane."""
    log_w = max(_log2_ceil(-(-L // K8_LANE_BYTES)), _log2_ceil(-(-K8_FILL_LANES // max(n, 1))))
    log_w = min(log_w, _log2_ceil(-(-L // 16)), K8_MAX_LOG_LANES)
    seg = -(-L // (1 << log_w))
    return log_w, max(16, -(-seg // 16) * 16)


def crc_operand(L: int, log_w: int, seg: int) -> tuple[np.ndarray, int]:
    """K8's operand for rows of ``L`` bytes cut as ``(log_w, seg)``:
    ``(words, init)``, ``words`` u32 the slicing tables then the byte
    tables of S_{seg 2^d} for each tree level ``d < log_w`` (``[1 +
    log_w, 4, 256]`` flattened), ``init = S_L(0xFFFFFFFF) ^
    0xFFFFFFFF``."""
    tables = [crc32c_slice_tables()] + [crc32c_shift_tables(seg << d) for d in range(log_w)]
    return np.concatenate(tables).reshape(-1), crc32c_shift(0xFFFFFFFF, L) ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=64)
def _device_operand(L: int, log_w: int, seg: int, device: torch.device):
    words, init = crc_operand(L, log_w, seg)
    return torch.from_numpy(words.view(np.int32)).to(device), init


def crc_rows_plain(data: torch.Tensor) -> torch.Tensor:
    """Plain K8: ``[n, L]`` u8 -> ``[n]`` int64 CRC32C (u32 values), the
    byte chain of the reference's ``_crc_rows`` as int64 torch ops, one
    step per byte for every row at once."""
    table = torch.from_numpy(crc32c_table().astype(np.int64)).to(data.device)
    crc = torch.full((data.shape[0],), 0xFFFFFFFF, dtype=I64, device=data.device)
    for i in range(data.shape[1]):
        crc = (crc >> 8) ^ table[(crc ^ data[:, i].to(I64)) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc_rows_segmented_plain(data: torch.Tensor, seg: int, log_w: int | None = None
                             ) -> torch.Tensor:
    """K8's decomposition as int64 torch ops (a CPU model of the kernel,
    for tests): each row cut into ``2^log_w`` segments of ``seg`` bytes
    aligned to its end (zero bytes in front of a short first segment, or
    as empty lanes, change no R(0, .)), each segment's R(0, .) folded by
    the slicing tables a word at a time (bytes past the last whole word
    by the byte table), then the kernel's tree: level ``d`` takes ``a <-
    S_{seg 2^d}(a) ^ right`` by the operand's byte tables, and the root
    XORs in ``init``.  ``log_w`` defaults to the fewest levels that hold
    every segment."""
    n, L = data.shape
    if log_w is None:
        log_w = _log2_ceil(-(-L // seg))
    W = 1 << log_w
    if seg * W < L:
        raise ValueError(f"{W} segments of {seg} bytes do not hold {L}")
    words, init = crc_operand(L, log_w, seg)
    ops = torch.from_numpy(words.astype(np.int64)).view(1 + log_w, 4, 256)
    rows = torch.zeros((n, W * seg), dtype=U8, device=data.device)
    rows[:, W * seg - L:] = data
    segs = rows.view(n * W, seg).to(I64)
    t = ops[0].to(data.device)
    a = torch.zeros(n * W, dtype=I64, device=data.device)
    whole = seg - seg % 4
    for i in range(0, whole, 4):
        c = a ^ segs[:, i] ^ (segs[:, i + 1] << 8) ^ (segs[:, i + 2] << 16) ^ (segs[:, i + 3] << 24)
        a = t[3][c & 0xFF] ^ t[2][(c >> 8) & 0xFF] ^ t[1][(c >> 16) & 0xFF] ^ t[0][c >> 24]
    for i in range(whole, seg):
        a = t[0][(a ^ segs[:, i]) & 0xFF] ^ (a >> 8)
    a = a.view(n, W)
    for d in range(log_w):
        m = ops[1 + d].to(data.device)
        left, right = a[:, 0::2], a[:, 1::2]
        a = (m[0][left & 0xFF] ^ m[1][(left >> 8) & 0xFF] ^ m[2][(left >> 16) & 0xFF]
             ^ m[3][left >> 24] ^ right)
    return a[:, 0] ^ init


def crc_rows(data: torch.Tensor) -> torch.Tensor:
    """K8: the CRC32C of every row of a ``[n, L]`` u8 tensor, as ``[n]``
    int64 (u32 values).  On a CUDA tensor it launches
    ``csrc/scrub.cu``'s kernel (or raises) cut as :func:`crc_segments`
    says, with the operand of :func:`crc_operand` (built once a shape and
    device); on a CPU tensor it runs :func:`crc_rows_plain`.  Rows may
    start at any byte address."""
    if data.dim() != 2 or data.dtype != U8:
        raise ValueError(f"crc_rows takes a [n, L] uint8 tensor, got "
                         f"{tuple(data.shape)} {data.dtype}")
    CALLS["crc32c_rows"] += 1
    if data.device.type == "cpu":
        with plain_stand_in():
            return crc_rows_plain(data)
    from .. import _cuda

    if not data.is_contiguous():
        raise ValueError("crc_rows: kernel input must be contiguous")
    n, L = data.shape
    out = torch.empty(n, dtype=I64, device=data.device)
    if n == 0:
        return out
    log_w, seg = crc_segments(n, L)
    consts, init = _device_operand(L, log_w, seg, data.device)
    _cuda.launch("scrub", "scrub_crc32c_rows", data.device, _cuda.ptr(data), n, L, log_w, seg,
                 _cuda.ptr(consts), init, _cuda.ptr(out))
    LAUNCHES["crc32c_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# device scrub step


def scrub_step(data: torch.Tensor, expected: torch.Tensor, in_range=None):
    """One scrub reduction on ``data``'s device.

    ``data [n_pgs, n_shards, chunk]`` u8, ``expected [n_pgs,
    n_shards]`` int64 stored checksums (u32 values), ``in_range``
    ``[n_pgs]`` bool (None: every row; a padded tail never votes).
    Returns ``(bad_mask [n_pgs] int64, hist [n_shards] int32, n_bad
    int32)`` — ``bad_mask`` bit ``s`` set iff shard ``s``'s recomputed
    CRC disagrees with the stored one, ``hist[s]`` the count of PGs
    damaged at slot ``s``."""
    n_pgs, n_shards, chunk = data.shape
    crcs = crc_rows(data.reshape(n_pgs * n_shards, chunk))
    bad = crcs.reshape(n_pgs, n_shards) != expected
    if in_range is not None:
        bad = bad & in_range[:, None]
    weights = torch.ones(n_shards, dtype=I64, device=data.device) << torch.arange(
        n_shards, dtype=I64, device=data.device)
    bad_mask = (bad.to(I64) * weights).sum(dim=1)
    hist = bad.sum(dim=0, dtype=I32)
    return bad_mask, hist, hist.sum(dtype=I32)


def sharded_scrub_step(mesh, gather: bool = True):
    """Mesh scrub step: ``f(data, expected, valid) -> (bad_mask, hist,
    n_bad)``.  ``data [n_pgs, n_shards, chunk]`` and ``expected`` are the
    whole pool, padded on the PG axis to a rank multiple (every rank
    passes the same); each rank runs K8 over its slice of PGs, and the
    histogram and total are summed over the ranks so every rank agrees
    on the damage counts.  ``bad_mask`` is this rank's slice — the whole
    padded pool's with ``gather`` — and the rows past ``valid`` never
    vote."""
    size, rank = mesh.size, mesh.rank

    def step(data: torch.Tensor, expected: torch.Tensor, valid: int):
        w = data.shape[0] // size
        lo = rank * w
        in_range = (torch.arange(w, device=data.device) + lo) < int(valid)
        bad_mask, hist, n_bad = scrub_step(data[lo:lo + w].contiguous(),
                                           expected[lo:lo + w], in_range)
        if gather:
            bad_mask = mesh.all_gather(bad_mask)
        return bad_mask, mesh.psum(hist), mesh.psum(n_bad)

    return step


# ---------------------------------------------------------------------------
# observability


def _build_counters() -> PerfCounters:
    return (
        PerfCountersBuilder("scrub")
        .add_u64_counter("scrub_passes", "whole-pool scrub launches")
        .add_u64_counter("scrubbed_bytes", "shard bytes CRC-verified")
        .add_u64_counter(
            "inconsistencies_found",
            "shard chunks whose recomputed CRC32C disagreed with the "
            "stored checksum",
        )
        .add_time_avg("l_scrub", "device scrub pass time")
        .create_perf_counters()
    )


def scrub_counters() -> PerfCounters:
    """The process-wide ``scrub`` perf-counter component."""
    return registry().get("scrub") or _build_counters()


@dataclass
class ScrubResult:
    """One scrub pass's verdict."""

    inconsistent_mask: np.ndarray  # [n_pgs] u32: bit s = shard s damaged
    hist: np.ndarray  # [n_shards] i32: PGs damaged at each slot
    n_inconsistent: int  # total damaged shard chunks
    scrubbed_bytes: int
    waited_s: float = 0.0  # QoS admission delay
    # staggered pass: [n_pgs] bool of the PGs this pass actually
    # verified (None = full-pool pass).  Non-due PGs never vote in
    # ``inconsistent_mask``; the caller must keep their old damage bits.
    due: np.ndarray | None = None

    @property
    def pgs(self) -> np.ndarray:
        """PG ids with at least one damaged shard."""
        return np.flatnonzero(self.inconsistent_mask).astype(np.int64)


class Scrubber:
    """Whole-pool scrub driver: stack, admit, launch, classify.

    The stored-checksum table is built at "write time"
    (:meth:`build_checksums` — call it while the store is clean, it runs
    K8 on ``device``); every :meth:`scrub` pass restacks the live shard
    bytes, admits them through the arbiter's ``"scrub"`` class (so scrub
    bandwidth obeys mclock policy), runs K8 and the reduction on
    ``device``, and returns the per-PG inconsistent bitmask.  With a
    ``mesh`` (every rank scrubbing the same store), each rank runs K8
    over its slice of PGs on its device (:func:`sharded_scrub_step`) and
    every rank gets the whole bitmask.
    """

    def __init__(
        self,
        n_pgs: int,
        n_shards: int,
        mesh=None,
        arbiter=None,
        journal=None,
        clock=None,
        device="cuda",
    ):
        self.mesh = mesh
        self._step = sharded_scrub_step(mesh) if mesh is not None else None
        self.n_pgs = int(n_pgs)
        self.n_shards = int(n_shards)
        self.arbiter = arbiter
        self.journal = journal
        self.clock = clock
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.pc = scrub_counters()
        self.checksums: np.ndarray | None = None  # [n_pgs, n_shards] u32
        # staggered deep scrub: virtual time the phase window last
        # closed at (None until the first staggered pass)
        self._stagger_anchor: float | None = None

    def _stack(self, read_shard) -> np.ndarray:
        """Every (pg, shard) chunk in one ``[n_pgs, n_shards, chunk]``
        array, each copied once."""
        out = None
        for pg in range(self.n_pgs):
            for s in range(self.n_shards):
                a = np.asarray(read_shard(pg, s), np.uint8)
                if out is None:
                    out = np.empty((self.n_pgs, self.n_shards) + a.shape, np.uint8)
                elif a.shape != out.shape[2:]:
                    raise ValueError(f"shard ({pg}, {s}) has shape {a.shape}, "
                                     f"not {out.shape[2:]}")
                out[pg, s] = a
        if out is None:
            raise ValueError("need at least one shard to stack")
        return out

    def _crcs(self, rows: np.ndarray) -> np.ndarray:
        """K8 over host rows ``[n, chunk]`` on this scrubber's device."""
        data = torch.from_numpy(np.ascontiguousarray(rows, np.uint8)).to(self.device)
        return crc_rows(data).cpu().numpy().astype(np.uint32)

    def build_checksums(self, read_shard) -> np.ndarray:
        """Digest every (pg, shard) chunk of the CLEAN store — the
        write-time checksum table every later scrub compares against."""
        data = self._stack(read_shard)
        self.checksums = self._crcs(
            data.reshape(self.n_pgs * self.n_shards, -1)
        ).reshape(self.n_pgs, self.n_shards)
        return self.checksums

    def note_write(self, pg: int, read_shard) -> None:
        """Checksum-at-write: refresh one PG's row of the table from the
        bytes the write just landed, so the table tracks the live store
        instead of only the construction-time snapshot.  Rot that lands
        AFTER the write still mismatches on the next scrub or
        :meth:`verify_read`."""
        if self.checksums is None:
            raise RuntimeError("build_checksums() before note_write()")
        pg = int(pg)
        rows = np.stack([
            np.asarray(read_shard(pg, s), np.uint8)
            for s in range(self.n_shards)
        ])
        self.checksums[pg] = self._crcs(rows)

    def verify_read(self, pg: int, read_shard, mask=None) -> list[int]:
        """Verify one PG's shards against the write-time table on the
        read path (the degraded-read integrity check).  ``mask``
        restricts the check to surviving shards (survivor-bitmask
        format, bit ``s`` = shard ``s`` holds data); returns the shard
        ids whose bytes fail."""
        if self.checksums is None:
            raise RuntimeError("build_checksums() before verify_read()")
        pg = int(pg)
        shards = [
            s for s in range(self.n_shards)
            if mask is None or (int(mask) >> s) & 1
        ]
        if not shards:
            return []
        rows = np.stack([
            np.asarray(read_shard(pg, s), np.uint8)
            for s in shards
        ])
        crcs = self._crcs(rows)
        return [
            s for s, c in zip(shards, crcs)
            if int(c) != int(self.checksums[pg, s])
        ]

    def _due_mask(self, now: float, period_s: float) -> np.ndarray:
        """PGs whose hashed phase falls inside the window since the
        last staggered pass ([n_pgs] bool).  Over one full period every
        PG comes due exactly once, so scrub bandwidth per pass is
        proportional to elapsed virtual time instead of the whole pool.
        The first staggered pass covers a full period (everything due)."""
        phases = scrub_phases(self.n_pgs, period_s)
        anchor = self._stagger_anchor
        self._stagger_anchor = float(now)
        if anchor is None or now - anchor >= period_s:
            return np.ones(self.n_pgs, bool)
        lo = anchor % period_s
        hi = now % period_s
        if lo <= hi:
            return (phases > lo) & (phases <= hi)
        return (phases > lo) | (phases <= hi)  # window wraps the period

    def scrub(
        self, read_shard, now: float | None = None,
        period_s: float | None = None,
    ) -> ScrubResult:
        """One scrub pass against the live store.

        With ``now``/``period_s`` (knob ``osd_scrub_stagger_period``)
        the pass is *staggered*: only PGs whose hashed phase came due
        since the previous pass are verified — the pass stays
        full-width, but non-due PGs contribute zero bytes to QoS
        admission and never vote in the inconsistent mask
        (``ScrubResult.due`` tells the caller which damage bits are
        fresh).  Default is the whole pool every pass.
        """
        if self.checksums is None:
            raise RuntimeError("build_checksums() before scrub()")
        due: np.ndarray | None = None
        if period_s is not None and period_s > 0 and now is not None:
            due = self._due_mask(float(now), float(period_s))
        data = self._stack(read_shard)
        if due is not None and not due.all():
            # partial pass: non-due PG rows become zero chunks whose
            # expected CRC is the zero-chunk digest, so they can never
            # mismatch (and cost no admitted bytes)
            zero_crc = crc32c_rows(np.zeros((1, data.shape[2]), np.uint8))
            data[~due] = 0
            nbytes = int(due.sum()) * self.n_shards * data.shape[2]
        else:
            zero_crc = None
            nbytes = int(data.nbytes)
        waited = 0.0
        if self.arbiter is not None:
            waited = self.arbiter.request("scrub", nbytes)
        span = (
            self.journal.span("scrub.pass", n_pgs=self.n_pgs, bytes=nbytes)
            if self.journal is not None
            else nullcontext()
        )
        with span, trace_annotation("scrub:pass"), self.pc.time("l_scrub"):
            expected = np.ascontiguousarray(self.checksums, np.uint32)
            if zero_crc is not None:
                expected = expected.copy()
                expected[~due] = zero_crc[0]
            dev = self.device
            if self.mesh is None:
                bad_mask, hist, n_bad = scrub_step(
                    torch.from_numpy(data).to(dev),
                    torch.from_numpy(expected.astype(np.int64)).to(dev),
                )
            else:
                size = self.mesh.size
                data, _ = pad_to_multiple(data, size, axis=0)
                expected, _ = pad_to_multiple(expected, size, axis=0)
                if rank_checks_enabled():
                    assert_rank_identical("scrub_pass", data, expected,
                                          np.int64(self.n_pgs), mesh=self.mesh)
                bad_mask, hist, n_bad = self._step(
                    torch.from_numpy(data).to(dev),
                    torch.from_numpy(expected.astype(np.int64)).to(dev),
                    self.n_pgs,
                )
            bad_mask = bad_mask.cpu().numpy()[: self.n_pgs]
            hist = hist.cpu().numpy()
            n_bad = int(n_bad)
        self.pc.inc("scrub_passes")
        self.pc.inc("scrubbed_bytes", nbytes)
        self.pc.inc("inconsistencies_found", n_bad)
        res = ScrubResult(
            inconsistent_mask=bad_mask.astype(np.uint32),
            hist=hist,
            n_inconsistent=n_bad,
            scrubbed_bytes=nbytes,
            waited_s=waited,
            due=due,
        )
        if self.journal is not None and n_bad:
            self.journal.event(
                "scrub.inconsistent",
                n_chunks=n_bad,
                pgs=[int(p) for p in res.pgs],
            )
        return res


# ---------------------------------------------------------------------------
# decode-verify


@dataclass
class VerifyReport:
    """Per-group decode-verify verdict."""

    bad_pgs: set[int] = field(default_factory=set)
    checked_pgs: int = 0

    @property
    def ok(self) -> bool:
        return not self.bad_pgs


class DecodeVerifier:
    """CRC-check (and optionally parity-re-encode-check) a decode
    launch's rebuilt chunks against the write-time checksum table
    before the executor commits them.

    The checksum table covers *every* shard — data and parity alike —
    so a rebuilt parity chunk is verified exactly like a data chunk.
    ``verify_parity`` adds an independent algebraic check for EC
    groups: when a group rebuilt data shards, the full data matrix
    (survivor reads + rebuilt rows) re-encodes through the codec and
    the freshly rebuilt parity must match — catching the (pathological)
    case of a corrupted checksum table.  The CRCs run through K8 on
    ``device``.
    """

    def __init__(self, checksums: np.ndarray, codec=None,
                 verify_parity: bool = True, device="cuda"):
        self.checksums = np.asarray(checksums, np.uint32)
        self.device = resolve_device(device)
        if codec is not None:
            # accept plugin wrappers the same way the planner does: the
            # parity check needs the raw systematic codec's [k, S] ->
            # [m, S] encode, not the interface-style encode(want, data)
            from .planner import _planning_codec

            try:
                codec, _ = _planning_codec(codec)
            except TypeError:
                codec = None  # locality plugins: CRC check only
        self.codec = codec
        self.verify_parity = bool(verify_parity)

    def bad_pgs(self, group, out: np.ndarray, chunk: int,
                read_shard=None) -> set[int]:
        """PG ids in ``group`` whose rebuilt chunks fail verification.
        ``out`` is the decode output ``[n_missing, n_pgs * chunk]``."""
        pgs = np.asarray(group.pgs, np.int64)
        n_missing = len(group.missing)
        rows = np.ascontiguousarray(out[:n_missing], np.uint8).reshape(
            n_missing * len(pgs), chunk)
        crcs = crc_rows(torch.from_numpy(rows).to(self.device)).cpu().numpy()
        crcs = crcs.astype(np.uint32).reshape(n_missing, len(pgs))
        bad: set[int] = set()
        for j, s in enumerate(group.missing):
            expected = self.checksums[pgs, s]
            for pg in pgs[crcs[j] != expected]:
                bad.add(int(pg))
        if (
            self.verify_parity
            and self.codec is not None
            and read_shard is not None
            and not bad
        ):
            bad |= self._parity_mismatch(group, out, chunk, read_shard)
        return bad

    def _parity_mismatch(self, group, out, chunk, read_shard) -> set[int]:
        # only meaningful when the launch rebuilt parity shards AND the
        # full data matrix is assemblable (it always is post-repair)
        k = getattr(self.codec, "k", None)
        if k is None:
            return set()
        missing = list(group.missing)
        par_rows = [(j, s) for j, s in enumerate(missing) if s >= k]
        if not par_rows or not any(s < k for s in missing):
            return set()  # no rebuilt data to re-encode, CRC was enough
        data = np.empty((k, out.shape[1]), np.uint8)
        for s in range(k):
            if s in missing:
                data[s] = np.asarray(out[missing.index(s)], np.uint8)
            else:
                data[s] = np.concatenate([
                    np.asarray(read_shard(int(pg), s), np.uint8)
                    for pg in group.pgs
                ])
        parity = np.asarray(self.codec.encode(data), np.uint8)
        bad: set[int] = set()
        for j, s in par_rows:
            got = np.asarray(out[j], np.uint8)
            want = parity[s - k]
            for i, pg in enumerate(group.pgs):
                sl = slice(i * chunk, (i + 1) * chunk)
                if not np.array_equal(got[sl], want[sl]):
                    bad.add(int(pg))
        return bad

    def verify_stripe_buffer(self, buf, bitmatrix) -> set[int]:
        """Stripe keys in a resident stripe buffer whose parity fails the
        independent dense re-encode: the decode-side twin of
        :meth:`Scrubber.scrub_stripe_buffer`, run before a repair plan
        trusts cached parity as a decode source."""
        from ..ec.online import dense_parity_words

        keys, data, parity = _buffer_host(buf)
        bad: set[int] = set()
        for si, wi in zip(*np.nonzero(keys >= 0)):
            want = dense_parity_words(bitmatrix, data[si, wi])
            if not np.array_equal(parity[si, wi], want):
                bad.add(int(keys[si, wi]))
        return bad


# ---------------------------------------------------------------------------
# stripe-buffer scrub: delta-updated parity coverage


def _buffer_host(buf):
    """A stripe buffer's keys, data and parity on the host (words as
    u32)."""
    return (buf.keys.cpu().numpy(), buf.data.cpu().numpy().view(np.uint32),
            buf.parity.cpu().numpy().view(np.uint32))


@dataclass
class StripeScrubResult:
    """One stripe-buffer scrub pass's verdict.

    Two independent lanes vote: the CRC lane compares each resident
    slot's parity digest against the write-time stripe checksum table
    (:meth:`Scrubber.note_stripe_writes`), and the re-encode lane
    recomputes every slot's parity through
    :func:`~ceph_tpu_torch.ec.online.dense_parity_words`, a dense GF(2)
    product sharing no code with the XOR-schedule compiler, so a wrong
    parity delta is caught even when the checksum table was refreshed
    over the wrong bytes."""

    crc_bad: list  # (set, way, key) whose parity CRC mismatches
    reencode_bad: list  # (set, way, key) failing the dense re-encode
    checked_slots: int
    scrubbed_bytes: int

    @property
    def inconsistent(self) -> list:
        """Damaged slots, both lanes merged."""
        return sorted(set(self.crc_bad) | set(self.reencode_bad))

    @property
    def status(self) -> str:
        """``"inconsistent"`` when any resident slot failed a lane."""
        return "inconsistent" if self.inconsistent else "ok"


def stripe_parity_crcs(buf) -> np.ndarray:
    """CRC32C of every slot's parity rows, ``[n_sets, ways]`` u32: K8 on
    the buffer's device over the slots' parity bytes."""
    n_sets, ways = buf.keys.shape
    rows = buf.parity.reshape(n_sets * ways, -1).contiguous().view(U8)
    return crc_rows(rows).cpu().numpy().astype(np.uint32).reshape(n_sets, ways)


def _scrubber_note_stripe_writes(self, buf) -> np.ndarray:
    """Checksum-at-write for the online write path: digest every resident
    slot's (delta-updated) parity, so later passes compare against the
    bytes the writes actually committed."""
    self.stripe_checksums = stripe_parity_crcs(buf)
    self._stripe_keys = buf.keys.cpu().numpy().copy()
    return self.stripe_checksums


def _scrubber_scrub_stripe_buffer(self, buf, bitmatrix) -> StripeScrubResult:
    """Scrub every resident stripe slot: the CRC lane against the
    write-time table, plus the independent dense re-encode lane
    (``parity == bitmatrix · data`` over GF(2)).  A wrong delta must be
    caught here, never silently committed."""
    from ..ec.online import dense_parity_words

    keys, data, parity = _buffer_host(buf)
    bm = np.asarray(bitmatrix)
    crcs = stripe_parity_crcs(buf)
    crc_bad, re_bad = [], []
    checked = 0
    for si, wi in zip(*np.nonzero(keys >= 0)):
        key = int(keys[si, wi])
        slot = (int(si), int(wi), key)
        checked += 1
        if (
            self.stripe_checksums is not None
            and self._stripe_keys is not None
            and int(self._stripe_keys[si, wi]) == key
            and int(crcs[si, wi]) != int(self.stripe_checksums[si, wi])
        ):
            crc_bad.append(slot)
        want = dense_parity_words(bm, data[si, wi])
        if not np.array_equal(parity[si, wi], want):
            re_bad.append(slot)
    nbytes = checked * int(parity.shape[2]) * int(parity.shape[3]) * 4
    res = StripeScrubResult(
        crc_bad=crc_bad,
        reencode_bad=re_bad,
        checked_slots=checked,
        scrubbed_bytes=nbytes,
    )
    self.pc.inc("scrub_passes")
    self.pc.inc("scrubbed_bytes", nbytes)
    self.pc.inc("inconsistencies_found", len(res.inconsistent))
    if self.journal is not None and res.inconsistent:
        self.journal.event(
            "scrub.stripe_inconsistent",
            n_slots=len(res.inconsistent),
            keys=[key for _, _, key in res.inconsistent],
        )
    return res


# the stripe lanes sit beside StripeScrubResult so the delta-parity
# scrub reads as one block, as in the reference
Scrubber.stripe_checksums = None
Scrubber._stripe_keys = None
Scrubber.note_stripe_writes = _scrubber_note_stripe_writes
Scrubber.scrub_stripe_buffer = _scrubber_scrub_stripe_buffer
