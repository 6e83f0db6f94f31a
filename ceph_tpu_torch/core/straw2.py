"""straw2 kernels K1-K3: wrappers, launch counters, plain versions, packers.

The counterpart of ``ceph_tpu/core/pallas_straw2.py``.  Each wrapper
takes tensors on one device.  On a CUDA tensor it launches its kernel
from ``csrc/straw2.cu`` (or raises); on a CPU tensor it runs its plain
PyTorch version, which the CPU tests hold against the reference package
and ``chip_smoke.py`` holds the kernel against on the card.  Each
wrapper counts its calls in ``CALLS`` (on entry, on any device) and its
kernel launches that ran in ``LAUNCHES``.  A call captured into a CUDA
graph (:mod:`ceph_tpu_torch.core.graphs`) ticks ``CALLS`` only: it runs
nothing then.  The launches graph replays run are added to ``LAUNCHES``
and to ``REPLAYS`` (by the runtime guard).  The
wrappers are safe to capture once warmed up: they read nothing back,
allocate through PyTorch, and their one upload (the crush_ln table block,
:func:`_ln_stacked`) happens on first use, which a capture refuses.

- K1 :func:`negdraw`: the straw2 draw of every slot of gathered bucket
  rows (the ``draw`` mode's hot op).
- K2 :func:`level_choose`: one straw2 level per lane: row fetch, draws,
  first-index argmin, winner's fields (the ``level`` mode).
- K3 :func:`descend_fused`: every level of one descent per lane, with
  the per-level status block (the ``descend`` mode).

Tables: a descent's BFS levels are stacked into flat slot arrays (id,
weight, magic reciprocal, ``child_type << 16 | next_local_index``) and a
size array, with one ``(nb, fanout, slot_off, size_off)`` row per level
(:class:`DescendTables`).  Ids, weights and packed fields are int32
holding u32 bit patterns, the magic int64 holding u64 bits.  K2 and K3
read a slot as one 16-byte record (magic low word, magic high word, id,
weight: ``DescendTables.slots``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..analysis.runtime_guard import plain_stand_in
from . import hashes

ITEM_NONE = 0x7FFFFFFF
CTYPE_DANGLING = 255
MAX_LEVELS = 32  # the descend kernel's level bound (csrc/straw2.cu kMaxLevels)

LAUNCHES = {"negdraw": 0, "level_choose": 0, "descend": 0}
CALLS = dict.fromkeys(LAUNCHES, 0)
REPLAYS = dict.fromkeys(LAUNCHES, 0)

I32 = torch.int32
I64 = torch.int64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = CALLS[k] = REPLAYS[k] = 0


def _launched(name: str) -> None:
    """Count a launch that ran: one captured into a graph runs when the
    graph replays, and is counted then."""
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1


class DescendTables:
    """Stacked straw2 tables of one descent, on one device."""

    #: the tables' tensors, by attribute (a CUDA graph copies them into its own)
    TENSORS = ("ids", "weights", "magic", "ctnl", "size", "slots")

    def __init__(self, ids, weights, magic, ctnl, size, meta):
        self.ids = ids            # int32 [S]
        self.weights = weights    # int32 [S]
        self.magic = magic        # int64 [S]
        self.ctnl = ctnl          # int32 [S]
        self.size = size          # int32 [NB_total]
        self.meta = tuple(meta)   # ((nb, fanout, slot_off, size_off), ...)
        # int32 [S, 4]: the kernels' slot records (magic lo, magic hi, id, weight)
        self.slots = torch.cat([magic.view(I32).view(-1, 2), ids.view(-1, 1),
                                weights.view(-1, 1)], 1).contiguous()

    @property
    def n_levels(self) -> int:
        return len(self.meta)

    @property
    def device(self) -> torch.device:
        return self.ids.device

    def level(self, lv: int):
        """(ids, weights, magic, ctnl) as [nb, fanout] views and size [nb]."""
        nb, fanout, so, zo = self.meta[lv]
        sl = slice(so, so + nb * fanout)
        return (self.ids[sl].view(nb, fanout), self.weights[sl].view(nb, fanout),
                self.magic[sl].view(nb, fanout), self.ctnl[sl].view(nb, fanout),
                self.size[zo:zo + nb])

    @property
    def signature(self) -> tuple:
        return tuple((nb, f) for nb, f, _, _ in self.meta)


def _i32(a: np.ndarray) -> np.ndarray:
    """u32 (or wider) values -> their int32 bit pattern."""
    return np.asarray(a).astype(np.uint64).astype(np.uint32).view(np.int32)


def pack_descend_tables(levels, device) -> DescendTables:
    """Host-side pack of a descent's levels into :class:`DescendTables`.

    ``levels`` is a list of ``(ids, weights, ctype, nlidx, sizes)`` numpy
    arrays per BFS level (``[nb, F]`` each, sizes ``[nb]``), rows padded
    with zero weights.  Raises when a field outgrows its packed width
    (``supports()`` in the engine keeps real maps inside)."""
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{len(levels)} levels; the kernels take 1..{MAX_LEVELS}")
    ids_l, w_l, mg_l, ct_l, sz_l, meta = [], [], [], [], [], []
    so = zo = 0
    for ids, ws, ctype, nlidx, sizes in levels:
        nb, fanout = ids.shape
        if nlidx.max(initial=0) > 0xFFFF or ctype.max(initial=0) > 0xFF:
            raise ValueError("child type or next-level index outgrows its field")
        ids_l.append(_i32(ids).reshape(-1))
        w_l.append(_i32(ws).reshape(-1))
        mg_l.append(hashes.magic_reciprocal(ws).view(np.int64).reshape(-1))
        ct_l.append(_i32((ctype.astype(np.uint64) << np.uint64(16))
                         | nlidx.astype(np.uint64)).reshape(-1))
        sz_l.append(np.asarray(sizes, np.int32))
        meta.append((nb, fanout, so, zo))
        so += nb * fanout
        zo += nb
    t = lambda parts: torch.from_numpy(np.ascontiguousarray(np.concatenate(parts))).to(device)
    return DescendTables(t(ids_l), t(w_l), t(mg_l), t(ct_l), t(sz_l), meta)


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if ts[0].numel() >= 1 << 31:
        raise ValueError("batch too large for 32-bit lane indices")


def _tables_args(tb: DescendTables):
    from .. import _cuda

    return (_cuda.ptr(tb.slots), _cuda.ptr(tb.ctnl), _cuda.ptr(tb.size), tb.ids.numel(),
            tb.size.numel())


# ---------------------------------------------------------------- K1


def negdraw_plain(x, r, ids, weights, magic=None) -> torch.Tensor:
    """Plain K1: ``straw2_negdraw(x[:, None], ids, r[:, None], w)``.
    ``magic`` is the kernel's reciprocal; the plain divide needs none."""
    return hashes.straw2_negdraw(x[:, None], ids, r[:, None], weights)


def negdraw(x, r, ids, weights, magic) -> torch.Tensor:
    """K1: negated straw2 draws of gathered rows.

    x, r: int32 [B]; ids, weights: int32 [B, F]; magic: int64 [B, F].
    Returns int64 [B, F], zero weights as ``hashes.NEGDRAW_NONE``."""
    CALLS["negdraw"] += 1
    if x.device.type == "cpu":
        with plain_stand_in():
            return negdraw_plain(x, r, ids, weights, magic)
    from .. import _cuda

    _check_cuda(ids, weights, magic, x, r)
    if not (x.dtype == r.dtype == ids.dtype == weights.dtype == I32 and magic.dtype == I64):
        raise TypeError("negdraw takes int32 x, r, ids, weights and int64 magic")
    B, F = ids.shape
    if x.shape != (B,) or r.shape != (B,) or weights.shape != (B, F) or magic.shape != (B, F):
        raise ValueError("negdraw shape mismatch")
    out = torch.empty((B, F), dtype=I64, device=x.device)
    _cuda.launch("straw2", "straw2_negdraw", x.device, _cuda.ptr(x), _cuda.ptr(r), _cuda.ptr(ids),
                 _cuda.ptr(weights), _cuda.ptr(magic), _cuda.ptr(out), B * F, F,
                 _cuda.ptr(_ln_stacked(x.device)))
    _launched("negdraw")
    return out


# ---------------------------------------------------------------- the kernels' draw, modelled
#
# Plain numpy models of the arithmetic csrc/straw2.cu does for one draw,
# in the forms the kernels use (the CPU tests hold each against the
# reference package): the hash with the subtractions of the lines in
# MIX_MASK as multiply-adds by 0xFFFFFFFF, the crush_ln walk with its
# 64-bit product taken in 32-bit halves, and the divide by the magic
# reciprocal with one correction.

MIX_MASK = 0x1FE  # csrc/straw2.cu kMixMask: bit i, line i of each mix on the FMA pipe
_U32 = np.uint32
_NEG1 = np.uint32(0xFFFFFFFF)
_MIX = ((0, 1, 2, ">>", 13), (1, 2, 0, "<<", 8), (2, 0, 1, ">>", 13), (0, 1, 2, ">>", 12),
        (1, 2, 0, "<<", 16), (2, 0, 1, ">>", 5), (0, 1, 2, ">>", 3), (1, 2, 0, "<<", 10),
        (2, 0, 1, ">>", 15))


def _mix_model(a, b, c, mask: int):
    v = [a, b, c]
    for i, (xi, yi, zi, op, k) in enumerate(_MIX):
        x, y, z = v[xi], v[yi], v[zi]
        d = (x + y * _NEG1) + z * _NEG1 if mask >> i & 1 else x - y - z
        v[xi] = d ^ (z >> _U32(k) if op == ">>" else z << _U32(k))
    return tuple(v)


def hash32_3_model(a, b, c, mask: int = MIX_MASK) -> np.ndarray:
    """``crush_hash32_3`` in the kernels' instruction forms, over uint32
    arrays (numpy wraps mod 2^32, as the card does)."""
    with np.errstate(over="ignore"):
        a, b, c = (np.asarray(t).astype(_U32) for t in np.broadcast_arrays(a, b, c))
        h = _U32(hashes.CRUSH_HASH_SEED) ^ a ^ b ^ c
        x = np.full_like(a, 231232)
        y = np.full_like(a, 1232)
        a, b, h = _mix_model(a, b, h, mask)
        c, x, h = _mix_model(c, x, h, mask)
        y, a, h = _mix_model(y, a, h, mask)
        b, x, h = _mix_model(b, x, h, mask)
        y, c, h = _mix_model(y, c, h, mask)
        return h


def ln_neg_model(u) -> np.ndarray:
    """``2^48 - crush_ln(u)`` as the kernels compute it (uint64): the
    RH/LH pair at ``(xs >> 8) - 128``, and bits 48..55 of ``xs * rh``
    from 32-bit halves, ``xs * rh_hi + umulhi(xs, rh_lo)`` mod 2^32."""
    u = np.asarray(u).astype(np.uint64)
    xv = u + np.uint64(1)
    p = (np.frexp(xv.astype(np.float64))[1] - 1).astype(np.uint64)  # floor(log2(xv))
    iexpon = np.minimum(p, np.uint64(15))
    xs = xv << (np.uint64(15) - iexpon)
    pair = (xs >> np.uint64(8)) - np.uint64(128)
    rh = hashes._RH_LH_NP[2 * pair].astype(np.uint64)
    lh = hashes._RH_LH_NP[2 * pair + 1].astype(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    t = (xs * (rh >> np.uint64(32)) + ((xs * (rh & m32)) >> np.uint64(32))) & m32
    ll = hashes._LL_NP[((t >> np.uint64(16)) & np.uint64(0xFF)).astype(np.int64)].astype(np.uint64)
    lnv = (iexpon << np.uint64(44)) + ((lh + ll) >> np.uint64(4))
    return (np.uint64(1) << np.uint64(48)) - lnv


def umul64hi_model(a, b) -> np.ndarray:
    """High 64 bits of the 128-bit product of uint64 arrays, from 32-bit
    halves (``__umul64hi``)."""
    a, b = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    m32, s32 = np.uint64(0xFFFFFFFF), np.uint64(32)
    with np.errstate(over="ignore"):
        a0, a1, b0, b1 = a & m32, a >> s32, b & m32, b >> s32
        p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
        mid = p01 + (p00 >> s32)             # < 2^64: no carry
        mid2 = mid + (p10 & m32)             # may carry
        carry = (mid2 < mid).astype(np.uint64)
        return p11 + (p10 >> s32) + (mid2 >> s32) + (carry << s32)


def div_magic_model(a, magic, w) -> np.ndarray:
    """The kernels' divide: ``floor(a / w)`` for ``a <= 2^48`` and
    ``w >= 1`` from ``magic = floor((2^64-1)/w)``: the high product is
    the quotient or one less (it exceeds ``a/w - 2^-16``), so one
    correction suffices."""
    a, w = np.asarray(a, np.uint64), np.asarray(w).astype(np.uint64)
    q = umul64hi_model(a, magic)
    with np.errstate(over="ignore"):
        rem = a - q * w
    return q + (rem >= w).astype(np.uint64)


def draw_model(x, item_id, r, weight, magic, mask: int = MIX_MASK) -> np.ndarray:
    """One kernel draw (uint64), zero weights as u64 max."""
    u = hash32_3_model(x, item_id, r, mask) & _U32(0xFFFF)
    w = np.asarray(weight).astype(np.uint64)
    nd = div_magic_model(ln_neg_model(u), magic, np.maximum(w, np.uint64(1)))
    return np.where(w == 0, np.uint64(0xFFFFFFFFFFFFFFFF), nd)


_LN_CACHE: dict = {}


def _ln_stacked(device) -> torch.Tensor:
    """The kernels' crush_ln table block on ``device``: RH/LH[0..257]
    then LL[0..255], int64 (cached; uploaded on first use, which must
    come before any graph capture: a capture cannot copy from the host)."""
    hit = _LN_CACHE.get(device)
    if hit is None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the crush_ln table's first upload inside a graph capture: "
                               "run the program once before capturing it")
        block = np.concatenate([hashes._RH_LH_NP, hashes._LL_NP])
        hit = _LN_CACHE[device] = torch.from_numpy(block).to(device)
    return hit


# ---------------------------------------------------------------- K2


def _choose_by_draws(x, r, lidx, tb: DescendTables, lv: int, draw):
    ids, w, mg, ctnl, size = tb.level(lv)
    li = lidx.to(I64)
    ids_r = ids.index_select(0, li)
    nd = draw(x, r, ids_r, w.index_select(0, li), mg.index_select(0, li))
    amin = nd.argmin(dim=1, keepdim=True)  # first index on ties
    item = ids_r.gather(1, amin)[:, 0]
    ct = ctnl.index_select(0, li).gather(1, amin)[:, 0]
    return item, ct >> 16, ct & 0xFFFF, size.index_select(0, li)


def level_choose_plain(x, r, lidx, tb: DescendTables, lv: int):
    """Plain K2: gather the lane's row, draw every slot, first-index
    argmin, select the winner's fields."""
    return _choose_by_draws(x, r, lidx, tb, lv, negdraw_plain)


def level_choose_draws(x, r, lidx, tb: DescendTables, lv: int):
    """The ``draw`` mode's level: PyTorch gathers around K1."""
    return _choose_by_draws(x, r, lidx, tb, lv, negdraw)


def level_choose(x, r, lidx, tb: DescendTables, lv: int):
    """K2: one straw2 level choose for a [B] batch.

    x, r, lidx: int32 [B] (lidx indexes level ``lv``'s buckets).
    Returns (item, ctype, nlidx, size), int32 [B] each."""
    CALLS["level_choose"] += 1
    if x.device.type == "cpu":
        with plain_stand_in():
            return level_choose_plain(x, r, lidx, tb, lv)
    from .. import _cuda

    _check_cuda(x, r, lidx)
    if not (x.dtype == r.dtype == lidx.dtype == I32) or tb.device != x.device:
        raise TypeError("level_choose takes int32 x, r, lidx and tables on their device")
    B = x.shape[0]
    if x.shape != (B,) or r.shape != (B,) or lidx.shape != (B,):
        raise ValueError("level_choose takes [B] lanes")
    outs = [torch.empty(B, dtype=I32, device=x.device) for _ in range(4)]
    level = (ctypes.c_int * 4)(*tb.meta[lv])
    _cuda.launch("straw2", "straw2_level_choose", x.device, _cuda.ptr(x), _cuda.ptr(r),
                 _cuda.ptr(lidx), B, *_tables_args(tb), ctypes.addressof(level),
                 _cuda.ptr(_ln_stacked(x.device)), *(_cuda.ptr(o) for o in outs))
    _launched("level_choose")
    return tuple(outs)


# ---------------------------------------------------------------- K3


def descend_levels(x, r, lidx0, active, tb: DescendTables, target_type: int,
                   empty_is_hard: bool, max_devices: int, choose):
    """Level-by-level descent with ``choose(x, r, lidx, tb, lv)`` for
    each level; mirrors ``interp_batch.descend`` lane for lane.
    Returns (item int32, ok bool, hard bool, nlidx int32), all [B]."""
    B = x.shape[0]
    dev = x.device
    item = torch.full((B,), ITEM_NONE, dtype=I32, device=dev)
    ok = torch.zeros(B, dtype=torch.bool, device=dev)
    hard = torch.zeros(B, dtype=torch.bool, device=dev)
    done = ~active
    nlidx_out = torch.zeros(B, dtype=I32, device=dev)
    lidx = lidx0
    for lv in range(tb.n_levels):
        chosen, ctype, nlidx, size = choose(
            x, r, torch.where(done, torch.zeros_like(lidx), lidx), tb, lv)
        empty = size == 0
        is_bucket = chosen < 0
        reached = (ctype == target_type) if target_type != 0 else ~is_bucket
        wrong_dev = ~is_bucket & ~reached
        bad_dev = ~is_bucket & (chosen >= max_devices)
        bad_bucket = is_bucket & (ctype == CTYPE_DANGLING)
        if empty_is_hard:
            hard_now = empty | wrong_dev | bad_dev | bad_bucket
            soft_now = torch.zeros_like(empty)
        else:
            hard_now = ~empty & (wrong_dev | bad_dev | bad_bucket)
            soft_now = empty
        new_done = done | hard_now | soft_now | reached
        ok = torch.where(done, ok, reached & ~hard_now & ~soft_now)
        hard = torch.where(done, hard, hard_now)
        item = torch.where(done, item, chosen)
        nlidx_out = torch.where(done, nlidx_out, nlidx)
        lidx = torch.where(new_done, lidx, nlidx)
        done = new_done
    # lanes not done after all levels: soft failure (depth exhausted)
    return item, ok, hard, nlidx_out


def descend_plain(x, r, lidx0, active, tb, target_type, empty_is_hard, max_devices):
    """Plain K3: the level loop over plain K2."""
    return descend_levels(x, r, lidx0, active, tb, target_type, empty_is_hard,
                          max_devices, level_choose_plain)


def descend_fused(x, r, lidx0, active, tb: DescendTables, target_type: int,
                  empty_is_hard: bool, max_devices: int):
    """K3: the whole descent for a [B] batch in one launch.

    x, r, lidx0: int32 [B]; active: bool [B].
    Returns (item int32, ok bool, hard bool, nlidx int32), all [B]."""
    CALLS["descend"] += 1
    if x.device.type == "cpu":
        with plain_stand_in():
            return descend_plain(x, r, lidx0, active, tb, target_type, empty_is_hard,
                                 max_devices)
    from .. import _cuda

    _check_cuda(x, r, lidx0, active)
    if not (x.dtype == r.dtype == lidx0.dtype == I32 and active.dtype == torch.bool):
        raise TypeError("descend_fused takes int32 x, r, lidx0 and bool active")
    if tb.device != x.device:
        raise ValueError("tables and lanes on different devices")
    B = x.shape[0]
    if any(t.shape != (B,) for t in (x, r, lidx0, active)):
        raise ValueError("descend_fused takes [B] lanes")
    item = torch.empty(B, dtype=I32, device=x.device)
    nlidx = torch.empty(B, dtype=I32, device=x.device)
    ok = torch.empty(B, dtype=torch.bool, device=x.device)
    hard = torch.empty(B, dtype=torch.bool, device=x.device)
    meta = (ctypes.c_int * (4 * tb.n_levels))(*(v for row in tb.meta for v in row))
    _cuda.launch("straw2", "straw2_descend", x.device, _cuda.ptr(x), _cuda.ptr(r), _cuda.ptr(lidx0),
                 _cuda.ptr(active), B, *_tables_args(tb), ctypes.addressof(meta),
                 tb.n_levels, int(target_type), int(bool(empty_is_hard)), int(max_devices),
                 _cuda.ptr(_ln_stacked(x.device)), _cuda.ptr(item), _cuda.ptr(nlidx),
                 _cuda.ptr(ok), _cuda.ptr(hard))
    _launched("descend")
    return item, ok, hard, nlidx
