"""CRUSH core primitives as PyTorch tensor ops (the plain versions).

Bit-exact counterparts of :mod:`ceph_tpu_torch.core.ref`, elementwise
over integer tensors of any shape.  PyTorch on the CPU has no unsigned
32-bit arithmetic, so every u32 quantity rides in int64 and is masked
with ``& 0xFFFFFFFF`` after each add, subtract and left shift.  Inputs
may be any integer dtype; negative i32 values (bucket ids) are hashed
as their u32 bit pattern.  Results are int64.

These functions are what the CUDA straw2 kernels are held against
(:mod:`ceph_tpu_torch.core.straw2`).  The straw2 draw uses the unsigned
form ``negdraw = (2^48 - crush_ln(u)) // w`` (smaller wins, first index
on ties), with a zero weight mapped to int64 max: real draws are at most
2^48, so the sentinel keeps the order that u64 max gives in the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ._crush_ln_tables import LL_TBL, RH_LH_TBL

M32 = 0xFFFFFFFF
CRUSH_HASH_SEED = 1315423911
NEGDRAW_NONE = (1 << 63) - 1  # zero-weight sentinel (u64 max in the kernels)

# only the first 258 RH/LH entries are reachable (index1 - 255 <= 257)
_RH_LH_NP = np.array(RH_LH_TBL[:258], dtype=np.int64)
_LL_NP = np.array(LL_TBL, dtype=np.int64)
_TABLE_CACHE: dict = {}


def ln_tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(RH/LH [258], LL [256]) int64 tables on ``device`` (cached)."""
    dev = torch.device(device)
    hit = _TABLE_CACHE.get(dev)
    if hit is None:
        hit = (torch.from_numpy(_RH_LH_NP).to(dev),
               torch.from_numpy(_LL_NP).to(dev))
        _TABLE_CACHE[dev] = hit
    return hit


def u32(v) -> torch.Tensor:
    """Any integer tensor -> int64 holding its u32 bit pattern."""
    return torch.as_tensor(v).to(torch.int64) & M32


def hashmix(a, b, c):
    """One rjenkins mix round over u32 values carried in int64."""
    a = (a - b - c) & M32
    a = a ^ (c >> 13)
    b = (b - c - a) & M32
    b = b ^ ((a << 8) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 13)
    a = (a - b - c) & M32
    a = a ^ (c >> 12)
    b = (b - c - a) & M32
    b = b ^ ((a << 16) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 5)
    a = (a - b - c) & M32
    a = a ^ (c >> 3)
    b = (b - c - a) & M32
    b = b ^ ((a << 10) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 15)
    return a, b, c


def crush_hash32_2(a, b) -> torch.Tensor:
    a, b = torch.broadcast_tensors(u32(a), u32(b))
    h = CRUSH_HASH_SEED ^ a ^ b
    x = torch.full_like(a, 231232)
    y = torch.full_like(a, 1232)
    a, b, h = hashmix(a, b, h)
    x, a, h = hashmix(x, a, h)
    b, y, h = hashmix(b, y, h)
    return h


def crush_hash32_3(a, b, c) -> torch.Tensor:
    a, b, c = torch.broadcast_tensors(u32(a), u32(b), u32(c))
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x = torch.full_like(a, 231232)
    y = torch.full_like(a, 1232)
    a, b, h = hashmix(a, b, h)
    c, x, h = hashmix(c, x, h)
    y, a, h = hashmix(y, a, h)
    b, x, h = hashmix(b, x, h)
    y, c, h = hashmix(y, c, h)
    return h


def ceph_stable_mod(x, b: int, bmask: int) -> torch.Tensor:
    """Split-friendly bucketing for non-power-of-two moduli."""
    x = u32(x)
    return torch.where((x & bmask) < b, x & bmask, x & (bmask >> 1))


def crush_ln(u) -> torch.Tensor:
    """~2^44 * log2(u+1) for u in [0, 0xffff] (48-bit fixed point)."""
    u = u32(u)
    rh_lh, ll_tbl = ln_tables(u.device)
    x = u + 1  # [1, 0x10000]
    p = torch.zeros_like(x)
    for k in range(1, 17):  # p = floor(log2(x))
        p = p + (x >= (1 << k)).to(torch.int64)
    need = p < 15
    xs = torch.where(need, x << (15 - p).clamp(min=0), x)  # [0x8000, 0x10000]
    iexpon = torch.where(need, p, torch.full_like(p, 15))
    index1 = (xs >> 8) << 1
    rh = rh_lh[index1 - 256]
    lh = rh_lh[index1 - 255]
    # (xs * rh) >> 48 reaches 64 bits: split rh into 32-bit halves
    # (xs < 2^17, rh < 2^49), so neither partial product overflows int64
    hi = xs * (rh >> 32) + ((xs * (rh & M32)) >> 32)
    index2 = (hi >> 16) & 0xFF
    ll = ll_tbl[index2]
    return (iexpon << 44) + ((lh + ll) >> 4)


def straw2_negdraw(x, item_id, r, weight) -> torch.Tensor:
    """Negated straw2 draw, smaller wins (first index on ties).

    ``weight`` is the 16.16 fixed-point u32 item weight; zero weight
    gives :data:`NEGDRAW_NONE`.  Equal to the reference's
    ``straw2_negdraw_magic``: its magic-reciprocal divide is an exact
    floor division, which is what ``//`` computes here."""
    u = crush_hash32_3(x, item_id, r) & 0xFFFF
    ln_neg = (1 << 48) - crush_ln(u)
    w = u32(weight)
    nd = ln_neg // w.clamp(min=1)
    return torch.where(w == 0, torch.full_like(nd, NEGDRAW_NONE), nd)


def magic_reciprocal(weight: np.ndarray) -> np.ndarray:
    """Host-precomputed M = floor((2^64-1)/w) per 16.16 weight (u64),
    the kernels' divide-free reciprocal.  Zero weights use w = 1 (their
    lanes are masked to the sentinel anyway)."""
    w = np.maximum(np.asarray(weight, np.uint64), 1)
    return (np.uint64(0xFFFFFFFFFFFFFFFF) // w).astype(np.uint64)


def is_out(weight_osd, item, x) -> torch.Tensor:
    """Reweight rejection (True = rejected)."""
    w = u32(weight_osd)
    h = crush_hash32_2(x, item) & 0xFFFF
    return torch.where(w >= 0x10000, torch.zeros_like(w, dtype=torch.bool),
                       torch.where(w == 0, torch.ones_like(w, dtype=torch.bool),
                                   h >= w))
