"""GF(2) kernels K5 and K6: wrappers, launch counters, plain versions.

The counterpart of ``ceph_tpu/ec/pallas_kernels.py``.  Each wrapper
takes tensors on one device: on a CUDA tensor it launches the kernel
from ``csrc/ec.cu`` (or raises), on a CPU tensor it runs the plain
PyTorch version.  Launches are counted in ``LAUNCHES``.

- K5 :func:`bitmatrix_encode`: the GF(2) bitmatrix product over packet
  rows, ``out[r] = XOR_s (d[s] & bitmatrix[r, s])``, for any word size
  ``w`` — every bitmatrix codec's encode and decode
  (``backend.BitmatrixEncoder``).

Packet layout (``gfref_bitmatrix_encode``'s, generalised to any w):
each chunk is groups of ``w`` packets of ``packetsize`` bytes; packet
row ``s = j*w + l`` of group ``g`` is bytes ``[g*w*p + l*p, +p)`` of
chunk ``j``, and output row ``r = i*w + t`` lands at the same place in
output chunk ``i``.  The kernel indexes that layout in place, so there
is no packing step.

- K6 :func:`schedule_apply`: the XOR-schedule interpreter over u32 word
  rows (carried as int32: XOR is bit-identical).  Buffers are
  ``[inputs | outputs | derived]``, non-input buffers start zeroed, each
  step ``(dst, src)`` does ``buf[dst] ^= buf[src]``, and the result is
  rows ``n_in : n_in + n_out`` — every compiled schedule of
  ``ec.schedule.XorScheduleEncoder`` (the recovery executor's bit-level
  pattern groups), whose steps are checked once on the host
  (:class:`StepTable`).  The kernel keeps a block's columns of every buffer
  in shared memory when ``n_bufs`` allows (:func:`schedule_smem_cols`),
  else works on a ``[n_bufs, NW]`` scratch the wrapper allocates.
"""

from __future__ import annotations

import numpy as np
import torch

from .gf_kernels import SMEM_BYTES

U8 = torch.uint8
ROW_TILES = (8, 16, 32)  # output rows per K5 thread (csrc/ec.cu launch_bitmatrix)
MAX_KW = 12288  # input packet rows whose masks fit 48 KB of shared memory

SCHEDULE_COLS = (128, 64)  # word columns per K6 block on its shared-memory path

LAUNCHES = {"bitmatrix_encode": 0, "schedule_apply": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Bitmatrix:
    """A GF(2) bitmatrix ``[MW, KW]`` of a code with word size ``w``,
    packed for K5 on one device.

    ``masks`` is int32 ``[n_tiles, KW]``: bit ``r`` of ``masks[t, s]``
    is entry ``(t*rt + r, s)``, for the row tile ``rt`` (the smallest
    of 8, 16, 32 that covers MW, else 32)."""

    def __init__(self, bitmatrix: np.ndarray, w: int, device):
        bits = np.asarray(bitmatrix, np.uint8) & 1
        self.mw, self.kw = bits.shape
        if self.mw % w or self.kw % w:
            raise ValueError(f"bitmatrix {bits.shape} is not in whole {w}-row blocks")
        if self.kw > MAX_KW:
            raise ValueError(f"{self.kw} input packet rows; K5 takes at most {MAX_KW}")
        self.w = w
        self.bits = bits
        self.rt = next((t for t in ROW_TILES if t >= self.mw), ROW_TILES[-1])
        n_tiles = -(-self.mw // self.rt)
        padded = np.zeros((n_tiles * self.rt, self.kw), np.uint64)
        padded[: self.mw] = bits
        weights = np.uint64(1) << np.arange(self.rt, dtype=np.uint64)
        words = (padded.reshape(n_tiles, self.rt, self.kw) * weights[None, :, None]).sum(axis=1)
        self.masks = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(device)


def _groups(bm: Bitmatrix, data: torch.Tensor, packetsize: int) -> int:
    k = bm.kw // bm.w
    if data.dim() != 2 or data.shape[0] != k:
        raise ValueError(f"bitmatrix_encode takes [{k}, S] data, got {tuple(data.shape)}")
    size = data.shape[1]
    group = bm.w * packetsize
    if size % group:
        raise ValueError(f"chunk size {size} not a multiple of w*packetsize={group}")
    return size // group


def bitmatrix_encode_plain(bm: Bitmatrix, data: torch.Tensor, packetsize: int) -> torch.Tensor:
    """Plain K5: one in-place XOR of a strided packet-row view per set
    bitmatrix entry."""
    g = _groups(bm, data, packetsize)
    w, p = bm.w, packetsize
    d = data.view(bm.kw // w, g, w, p)
    out = torch.zeros((bm.mw // w, g, w, p), dtype=U8, device=data.device)
    for r in range(bm.mw):
        acc = out[r // w, :, r % w, :]
        for s in np.nonzero(bm.bits[r])[0].tolist():
            acc ^= d[s // w, :, s % w, :]
    return out.view(bm.mw // w, data.shape[1])


def bitmatrix_encode(bm: Bitmatrix, data: torch.Tensor, packetsize: int) -> torch.Tensor:
    """K5: ``[k, S]`` u8 chunks -> ``[MW / w, S]`` u8 through the GF(2)
    bitmatrix, ``S`` a multiple of ``w * packetsize``."""
    _groups(bm, data, packetsize)
    if data.device.type == "cpu":
        return bitmatrix_encode_plain(bm, data, packetsize)
    from .. import _cuda

    if data.dtype != U8 or not data.is_contiguous():
        raise TypeError("bitmatrix_encode takes a contiguous uint8 tensor")
    if bm.masks.device != data.device:
        raise ValueError(f"bitmatrix on {bm.masks.device}, data on {data.device}")
    S = data.shape[1]
    out = torch.empty((bm.mw // bm.w, S), dtype=U8, device=data.device)
    if S == 0:
        return out
    _cuda.launch("ec", "ec_bitmatrix_encode", data.device, _cuda.ptr(bm.masks), _cuda.ptr(data),
                 _cuda.ptr(out), bm.kw, bm.mw, bm.w, packetsize, bm.rt, S)
    LAUNCHES["bitmatrix_encode"] += 1
    return out


def schedule_smem_cols(n_bufs: int) -> int:
    """Word columns per block of K6's shared-memory path for a schedule
    of ``n_bufs`` buffers, or 0: the schedule takes the global-memory
    path."""
    return next((c for c in SCHEDULE_COLS if n_bufs * c * 4 <= SMEM_BYTES), 0)


class StepTable:
    """A compiled XOR schedule's step table, on one device, for K6.

    ``steps`` are ``[n_steps, 2]`` ``(dst, src)`` buffer indices.  The
    kernel indexes its buffers with them unchecked, so they are checked
    against ``[0, n_bufs)`` here, once, on the host: a launch checks only
    types, shapes and devices and never reads the table back."""

    def __init__(self, steps, n_bufs: int, device):
        host = np.asarray(steps)
        if host.ndim != 2 or host.shape[1] != 2 or not np.issubdtype(host.dtype, np.integer):
            raise TypeError(f"steps are [n_steps, 2] integers, got {host.shape} {host.dtype}")
        if host.size and (host.min() < 0 or host.max() >= n_bufs):
            raise ValueError(f"step buffer indices span [{host.min()}, {host.max()}], "
                             f"outside [0, {n_bufs})")
        self.host = host.astype(np.int32)
        self.n_bufs = int(n_bufs)
        self.steps = torch.from_numpy(self.host.copy()).to(device)

    @property
    def n_steps(self) -> int:
        return len(self.host)


def _check_schedule(table: StepTable, words: torch.Tensor, n_out: int) -> None:
    if words.dim() != 2 or words.dtype != torch.int32:
        raise TypeError(f"words are [n_in, NW] int32, got {tuple(words.shape)} {words.dtype}")
    if n_out < 0 or table.n_bufs < words.shape[0] + n_out:
        raise ValueError(f"n_bufs={table.n_bufs} < n_in={words.shape[0]} + n_out={n_out}")
    if table.steps.device != words.device:
        raise ValueError(f"steps on {table.steps.device}, words on {words.device}")


def schedule_apply_plain(table: StepTable, words: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain K6: one in-place row XOR per step (``_xla_apply``'s
    semantics)."""
    _check_schedule(table, words, n_out)
    n_in = words.shape[0]
    bufs = torch.zeros((table.n_bufs, words.shape[1]), dtype=torch.int32, device=words.device)
    bufs[:n_in] = words
    for dst, src in table.host.tolist():
        bufs[dst] ^= bufs[src]
    return bufs[n_in:n_in + n_out].clone()


def schedule_apply(table: StepTable, words: torch.Tensor, n_out: int) -> torch.Tensor:
    """K6: run an XOR schedule over ``words [n_in, NW]`` int32 ->
    ``[n_out, NW]`` int32, the output buffers ``n_in : n_in + n_out`` of
    ``table``."""
    _check_schedule(table, words, n_out)
    if words.device.type == "cpu":
        return schedule_apply_plain(table, words, n_out)
    from .. import _cuda

    if not words.is_contiguous():
        raise TypeError("schedule_apply takes contiguous words")
    n_in, nw = words.shape
    n_bufs = table.n_bufs
    out = torch.empty((n_out, nw), dtype=torch.int32, device=words.device)
    if nw == 0 or n_out == 0:
        return out
    cols = schedule_smem_cols(n_bufs)
    scratch = None if cols else torch.empty((n_bufs, nw), dtype=torch.int32, device=words.device)
    _cuda.launch("ec", "ec_xor_schedule", words.device, _cuda.ptr(table.steps), table.n_steps,
                 _cuda.ptr(words), _cuda.ptr(out), None if scratch is None else _cuda.ptr(scratch),
                 n_in, n_out, n_bufs, cols, nw)
    LAUNCHES["schedule_apply"] += 1
    return out
