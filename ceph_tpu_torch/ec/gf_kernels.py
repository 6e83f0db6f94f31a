"""GF(2^8) byte-table kernels K4 and K7: wrappers, launch counters, plain versions.

The counterpart of ``ceph_tpu/ec/pallas_gf.py``.  Each wrapper takes
tensors on one device.  On a CUDA tensor it launches its kernel from
``csrc/ec.cu`` (or raises); on a CPU tensor it runs its plain PyTorch
version, which the CPU tests hold against the reference package and
``chip_smoke.py`` holds the kernel against on the card.  Each wrapper
counts its calls in ``CALLS`` (on entry, on any device) and its kernel
launches in ``LAUNCHES``.

- K4 :func:`matrix_encode`: ``coding[j] = XOR_i mul[M[j, i]][data[i]]``,
  the GF(2^8) matrix product of every table codec's encode and decode
  (``backend.TableEncoder``).  Its plain version reads the 256-byte
  product tables (:func:`mul_tables`); the kernel reads split nibble
  tables (:func:`nibble_tables`), 32 bytes a coefficient, four bytes at
  a time with ``prmt``.
- K7 :func:`byte_lut`: ``table[x]`` for a u8 tensor of any shape
  (CLAY's pair transforms).
"""

from __future__ import annotations

import numpy as np
import torch

from ..analysis.runtime_guard import plain_stand_in
from . import gf

U8 = torch.uint8
SMEM_BYTES = 232448  # csrc/ec.cu kMaxSmem: a block's shared memory
NIBBLE_SMEM_BYTES = 16384  # csrc/ec.cu kNibbleSmem: K4 stages nibble tables up to this

LAUNCHES = {"matrix_encode": 0, "byte_lut": 0}
CALLS = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = CALLS[k] = 0


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if t.dtype != U8:
            raise TypeError(f"the EC kernels take uint8 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


# ---------------------------------------------------------------- K4


def mul_tables(matrix: np.ndarray, device) -> torch.Tensor:
    """K4's operand: ``[m, k, 256]`` u8, row ``(j, i)`` the GF(2^8)
    product table of the coefficient ``matrix[j, i]``."""
    rows = gf.mul_table()[np.asarray(matrix, np.uint8)]
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device)


def nibble_tables(matrix: np.ndarray, device) -> torch.Tensor:
    """K4's kernel operand: ``[m, k, 32]`` u8, row ``(j, i)`` the split
    nibble tables of ``c = matrix[j, i]``: ``lo[x] = c*x`` (bytes 0-15)
    then ``hi[x] = c*(x << 4)`` (bytes 16-31), so that ``c*d = lo[d & 15]
    ^ hi[d >> 4]``."""
    mul = gf.mul_table()[np.asarray(matrix, np.uint8)]  # [m, k, 256]
    nib = np.concatenate([mul[..., :16], mul[..., ::16]], axis=-1)
    return torch.from_numpy(np.ascontiguousarray(nib)).to(device)


def tables_staged(m: int, k: int) -> bool:
    """Whether K4 holds these nibble tables in shared memory (else it
    reads them from global memory through L1)."""
    return m * k * 32 <= NIBBLE_SMEM_BYTES


def nibble_product_plain(nibbles: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The GF(2^8) product through the nibble tables, in plain PyTorch:
    ``out[j] = XOR_i lo[j, i][d & 15] ^ hi[j, i][d >> 4]`` — what the
    kernel computes, on any device."""
    m, k, _ = nibbles.shape
    out = torch.zeros((m, data.shape[1]), dtype=U8, device=data.device)
    for i in range(k):
        lo, hi = (data[i] & 15).long(), (data[i] >> 4).long()
        for j in range(m):
            out[j] ^= nibbles[j, i, :16][lo] ^ nibbles[j, i, 16:][hi]
    return out


def matrix_encode_plain(tables: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain K4: one gather per coefficient, XOR-accumulated."""
    m, k, _ = tables.shape
    out = torch.zeros((m, data.shape[1]), dtype=U8, device=data.device)
    for i in range(k):
        idx = data[i].long()
        for j in range(m):
            out[j] ^= tables[j, i][idx]
    return out


def matrix_encode(tables: torch.Tensor, data: torch.Tensor,
                  nibbles: torch.Tensor | None = None) -> torch.Tensor:
    """K4: GF(2^8) ``[m, k] x [k, S] -> [m, S]``.

    tables: u8 ``[m, k, 256]`` (:func:`mul_tables`); data: u8 ``[k, S]``;
    nibbles: u8 ``[m, k, 32]`` of the same matrix (:func:`nibble_tables`),
    the kernel's operand, needed on a CUDA device."""
    m, k, _ = tables.shape
    if data.dim() != 2 or data.shape[0] != k or tables.shape[2] != 256:
        raise ValueError(f"matrix_encode: tables {tuple(tables.shape)}, data {tuple(data.shape)}")
    CALLS["matrix_encode"] += 1
    if data.device.type == "cpu":
        with plain_stand_in():
            return matrix_encode_plain(tables, data)
    from .. import _cuda

    if nibbles is None or nibbles.shape != (m, k, 32):
        raise ValueError(f"matrix_encode on {data.device} takes [{m}, {k}, 32] nibble tables")
    _check_cuda(data, nibbles)
    if nibbles.data_ptr() % 16:
        raise ValueError("matrix_encode: nibble tables must be 16-byte aligned")
    S = data.shape[1]
    out = torch.empty((m, S), dtype=U8, device=data.device)
    if S == 0:
        return out
    _cuda.launch("ec", "ec_matrix_encode", data.device, _cuda.ptr(nibbles), _cuda.ptr(data),
                 _cuda.ptr(out), m, k, S)
    LAUNCHES["matrix_encode"] += 1
    return out


# ---------------------------------------------------------------- K7


def byte_lut_plain(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain K7: an index gather."""
    return table[x.long()]


def byte_lut(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K7: ``table[x]`` for a u8 tensor of any shape; table: u8 ``[256]``
    on x's device."""
    if table.shape != (256,):
        raise ValueError(f"byte_lut takes a [256] table, got {tuple(table.shape)}")
    CALLS["byte_lut"] += 1
    if x.device.type == "cpu":
        with plain_stand_in():
            return byte_lut_plain(x, table)
    from .. import _cuda

    _check_cuda(x, table)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    _cuda.launch("ec", "ec_byte_lut", x.device, _cuda.ptr(table), _cuda.ptr(x), _cuda.ptr(out),
                 x.numel())
    LAUNCHES["byte_lut"] += 1
    return out
