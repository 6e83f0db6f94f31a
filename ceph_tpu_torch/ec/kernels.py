"""GF(2) bitmatrix kernel K5: wrapper, launch counter, plain version.

The counterpart of ``ceph_tpu/ec/pallas_kernels.py``.  The wrapper
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

K6 (``schedule_apply``, the XOR-schedule interpreter) belongs here too;
it is not ported yet (``ROADMAP.md`` §1 item 7, §2 K6).
"""

from __future__ import annotations

import numpy as np
import torch

U8 = torch.uint8
ROW_TILES = (8, 16, 32)  # output rows per K5 thread (csrc/ec.cu launch_bitmatrix)
MAX_KW = 12288  # input packet rows whose masks fit 48 KB of shared memory

LAUNCHES = {"bitmatrix_encode": 0}


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
