"""Level-synchronous batched CRUSH interpreter (the fast device path).

Semantics: identical to the reference package's ``crush/interp_batch.py``
(upstream ``src/crush/mapper.c :: crush_do_rule / crush_choose_firstn /
crush_choose_indep``), lane for lane, restructured batch-first:

- **Level-synchronous descent.**  All lanes walk one hierarchy level per
  step; levels are the BFS level sets of the map from the rule's take
  root, so each level's table holds only the buckets reachable at that
  depth.  The tables of one descent are stacked into one
  :class:`~ceph_tpu_torch.core.straw2.DescendTables`.
- **Three modes, chosen by the caller** (no environment flags, no
  silent fallback):

  - ``"draw"``: per level, a PyTorch row gather around the K1 draw
    kernel, then ``argmin`` and a column gather;
  - ``"level"``: per level, the K2 level-choose kernel;
  - ``"descend"``: the whole descent in one K3 launch.

  On CPU tensors every mode runs the kernels' plain versions.
- **Retry ladders over the batch.**  The reference's per-replica
  retry ladder (``r' = r + ftotal``) is a Python loop whose body
  re-descends the batch with per-lane r.  The ladders take the descent
  as a function, so the general engine (``interp.py``) runs the same
  ones over its own descent.  This engine runs every round masked over
  the whole batch, through :func:`_run_ladder`, which decides whether a
  round after the first runs: eagerly, by one ``.any()`` read on the
  host, one sync (counted in ``HOST_SYNCS``), and the loop ends when no
  lane is left; while a CUDA graph is captured on the lanes' device, on
  the card: the rounds after the first are the body of a WHILE node
  whose condition (a lane retries, rounds are left) is computed on the
  device, with the round number a device counter, so a replay stops at
  the first round no lane needs and reads nothing
  (:mod:`ceph_tpu_torch.core.graphs`).  A round no lane needs changes
  nothing, so the two give the same results bit for bit (and so does a
  ladder that runs out every round).  A round updates the ladder's
  state in place, as a graph needs.
- **Compacted-straggler retry** (the ladders' ``compact``, which the
  general engine sets for large batches): round 1 runs on the whole
  batch and every later round only on the lanes still unsettled.  One
  ``torch.nonzero`` a round takes the exact straggler set (the round's
  host sync); their seeds and state are gathered, the round runs, and
  the results are scattered back.  Each lane keeps its own round count,
  so its r sequence and its results are those of the masked rounds, bit
  for bit.  (The reference's fixed window of ``max(B // 16, 8192)`` lanes
  with a filler index is a static-shape workaround, not carried over.)
  This engine does not compact: its round is one K3 launch, the call is
  host-bound, and on the H100 the gathers and scatters cost the host
  more than the card saves (PERF.md).  No ladder compacts under a
  capture (the straggler count is a host read).
- **General rule programs.**  Multi-TAKE chains and chained choose
  steps run natively: each choose consumes the working vector entry by
  entry.  Working-vector bucket ids are translated to the next pack's
  local indices by matching against its root list.

Scope (checked by :func:`supports`): straw2 buckets only, bobtail+
tunables (no legacy local retries), take targets must be buckets.
Multi-EMIT programs that overflow ``result_max`` drop surplus at emit,
the reference's EMIT cap.  Chained chooses whose fan-out exceeds
``result_max`` need a per-lane dynamic inner cap: compile raises, and
``engine.make_batch_runner`` routes them to the exact C++ tier.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import graphs, hashes, straw2
from .map import (
    ALG_STRAW2,
    ITEM_NONE,
    DenseCrushMap,
    OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP,
    OP_CHOOSELEAF_FIRSTN,
    OP_CHOOSELEAF_INDEP,
    OP_EMIT,
    OP_SET_CHOOSE_TRIES,
    OP_SET_CHOOSELEAF_TRIES,
    OP_SET_CHOOSE_LOCAL_TRIES,
    OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    OP_SET_CHOOSELEAF_VARY_R,
    OP_SET_CHOOSELEAF_STABLE,
    OP_TAKE,
    Rule,
)

I32 = torch.int32
I64 = torch.int64

ITEM_UNDEF = 0x7FFFFFFE
MODES = ("draw", "level", "descend")
# measured on the card (PERF.md): the fused descent is the fastest mode
DEFAULT_MODE = "descend"

_CHOOSE_OPS = (
    OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP,
    OP_CHOOSELEAF_FIRSTN,
    OP_CHOOSELEAF_INDEP,
)

# child_type sentinel for a dangling bucket reference (child idx out of
# range); real type ids are capped below this by supports()
_CTYPE_DANGLING = straw2.CTYPE_DANGLING
assert straw2.ITEM_NONE == ITEM_NONE

# loop tests that read a device value on the host (one sync each)
HOST_SYNCS = 0

_MEMO_CAP = 64  # evict oldest beyond this (maps evolve in long processes)


def _memo_put(cache: dict, key, value) -> None:
    if len(cache) >= _MEMO_CAP:
        cache.pop(next(iter(cache)))
    cache[key] = value


def rule_signature(rule: Rule) -> tuple:
    return tuple((s.op, s.arg1, s.arg2) for s in rule.steps)


def _no_read_in_capture(t: torch.Tensor, what: str) -> None:
    if graphs.capturing(t):
        raise graphs.HostReadInCapture(f"{what} inside a CUDA graph capture")


def _any(t: torch.Tensor) -> bool:
    global HOST_SYNCS
    _no_read_in_capture(t, "the retry ladder's read")
    HOST_SYNCS += 1
    return bool(t.any())


def _stragglers(mask: torch.Tensor) -> torch.Tensor | None:
    """Indices (int64) of the lanes in ``mask``, or None when there are
    none: one host sync."""
    global HOST_SYNCS
    _no_read_in_capture(mask, "the compacted ladder's straggler read")
    HOST_SYNCS += 1
    idx = torch.nonzero(mask).squeeze(1)
    return idx if idx.numel() else None


def _run_ladder(like: torch.Tensor, tries: int, pending, round_) -> None:
    """Run ``round_(ft)`` for retry rounds ``ft = 0, 1, ... < tries``: the
    first always, each later one while ``pending()`` (the [B] mask of
    lanes that still retry) holds a lane -- eagerly one host read a round;
    under a capture a WHILE node over a device round counter (``ft`` a
    0-dim int32 tensor there).  ``round_`` updates the ladder's state in
    place."""
    if tries <= 0:
        return
    if graphs.capturing(like):
        round_(0)
        if tries > 1:
            ft = torch.ones((), dtype=I32, device=like.device)
            with graphs.while_node(lambda: pending().any() & (ft < tries)):
                round_(ft)
                ft.add_(1)
        return
    for ft in range(tries):
        # torchlint: disable=J003  # the retry ladder's one read a round: whether a lane retries
        if ft and not _any(pending()):
            break
        round_(ft)


def check_mode(mode: str | None) -> str:
    mode = DEFAULT_MODE if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {MODES}")
    return mode


def _level_arrays(
    dense: DenseCrushMap,
    bucket_idxs: list[int],
    next_map: dict[int, int],
    consumer_map: dict[int, int],
    target_type: int,
):
    """(ids, weights, ctype, nlidx, sizes) numpy arrays for one BFS level.

    ``next_map``: bucket idx -> local idx in this pack's next level.
    ``consumer_map``: bucket idx -> local idx at level 0 of the leaf
    pack (chooseleaf only).  A chosen child of ``target_type`` is
    consumed by the leaf pack; any other bucket child keeps descending
    in this pack, so one column serves both (usage is disjoint).
    """
    nb = max(len(bucket_idxs), 1)
    fanout = 1
    for b in bucket_idxs:
        fanout = max(fanout, int(dense.size[b]))
    ids = np.zeros((nb, fanout), np.uint32)
    ws = np.zeros((nb, fanout), np.uint32)
    ctype = np.zeros((nb, fanout), np.uint32)
    nlidx = np.zeros((nb, fanout), np.uint32)
    sizes = np.zeros((nb,), np.uint32)
    for row, b in enumerate(bucket_idxs):
        sz = int(dense.size[b])
        sizes[row] = sz
        for f in range(sz):
            item = int(dense.items[b, f])
            ids[row, f] = np.uint32(item & 0xFFFFFFFF)
            ws[row, f] = dense.weights[b, f]
            if item < 0:
                cidx = -1 - item
                if cidx < dense.n_buckets:
                    ct = int(dense.btype[cidx])
                    ctype[row, f] = ct
                    if ct == target_type and target_type != 0:
                        nlidx[row, f] = consumer_map.get(cidx, 0)
                    else:
                        nlidx[row, f] = next_map.get(cidx, 0)
                else:
                    # dangling bucket reference: descend() hard-fails on
                    # the sentinel (reference bad-bucket skip_rep;
                    # supports() guarantees real types stay < 255)
                    ctype[row, f] = _CTYPE_DANGLING
    return ids, ws, ctype, nlidx, sizes


def _bfs_levels(
    dense: DenseCrushMap, roots: list[int], stop_type: int, max_levels: int
) -> list[list[int]]:
    """BFS level sets of bucket indices from ``roots``.  Children of
    buckets whose type is ``stop_type`` are not expanded beyond level 0
    (descent stops there)."""
    levels = [list(roots)]
    while len(levels) < max_levels:
        nxt: list[int] = []
        seen: set[int] = set()
        for b in levels[-1]:
            if (
                stop_type != 0
                and len(levels) > 1
                and int(dense.btype[b]) == stop_type
            ):
                continue
            for f in range(int(dense.size[b])):
                item = int(dense.items[b, f])
                if item < 0:
                    cidx = -1 - item
                    if cidx < dense.n_buckets and cidx not in seen:
                        seen.add(cidx)
                        nxt.append(cidx)
        if not nxt:
            break
        levels.append(nxt)
    return levels


def _stop_buckets(
    dense: DenseCrushMap, roots: list[int], target_type: int
) -> list[int]:
    """Reachable target-type buckets in BFS order — build_pack's stop
    list without constructing any tables."""
    levels = _bfs_levels(dense, roots, target_type, dense.max_depth + 2)
    stop: list[int] = []
    seen: set[int] = set()
    for lvl in levels:
        for b in lvl:
            if int(dense.btype[b]) == target_type and b not in seen:
                seen.add(b)
                stop.append(b)
    return stop


def build_pack(
    dense: DenseCrushMap,
    roots: list[int],
    target_type: int,
    consumer_map: dict[int, int],
    device,
) -> tuple[straw2.DescendTables, list[int]]:
    """Stacked level tables for a descent from ``roots`` stopping at
    ``target_type``.  Returns (tables, stop_buckets) where stop_buckets
    lists the reachable target-type buckets in BFS order (the leaf
    pack's roots for chooseleaf, or the next choose's roots)."""
    levels = _bfs_levels(dense, roots, target_type, dense.max_depth + 2)
    maps = [{b: i for i, b in enumerate(lvl)} for lvl in levels]
    arrays = [
        _level_arrays(dense, lvl, maps[li + 1] if li + 1 < len(levels) else {},
                      consumer_map, target_type)
        for li, lvl in enumerate(levels)
    ]
    return (straw2.pack_descend_tables(arrays, device),
            _stop_buckets(dense, roots, target_type))


def descend(
    pack: straw2.DescendTables,
    x: torch.Tensor,       # [B] int32 (u32 bits)
    lidx0: torch.Tensor,   # [B] int32 level-0 local bucket index
    r: torch.Tensor,       # [B] int32 per-lane replica seed
    target_type: int,
    empty_is_hard: bool,
    active: torch.Tensor,  # [B] bool
    max_devices: int,
    mode: str,
):
    """Batched hierarchy walk; mirrors the reference's ``descend``.

    Returns (item, ok, hard, next_lidx), all [B]; ``next_lidx`` is the
    chosen bucket's local index in the consumer (leaf) pack, valid when
    the item is a target-type bucket.
    """
    if mode == "descend":
        return straw2.descend_fused(x, r, lidx0, active, pack, target_type,
                                    empty_is_hard, max_devices)
    choose = straw2.level_choose if mode == "level" else straw2.level_choose_draws
    return straw2.descend_levels(x, r, lidx0, active, pack, target_type,
                                 empty_is_hard, max_devices, choose)


def _is_out(osd_weight, item, x):
    wmax = osd_weight.shape[0]
    oob = item >= wmax
    w = osd_weight[item.clamp(0, wmax - 1).to(I64)]
    return oob | hashes.is_out(w, item, x)


def _collides(out: torch.Tensor, outpos: torch.Tensor, item: torch.Tensor):
    """item[b] in out[b, :outpos[b]]; out has small static width."""
    cap = out.shape[1]
    pos = torch.arange(cap, dtype=I32, device=out.device)[None, :]
    return ((pos < outpos[:, None]) & (out == item[:, None])).any(dim=1)


def _append_rows(acc, acc_pos, vals, counts):
    """Per-lane append: acc[b, acc_pos[b] : acc_pos[b]+counts[b]] =
    vals[b, :counts[b]] (the reference's ``o + osize`` pointer offset).
    Positions beyond acc's width are dropped."""
    rm = acc.shape[1]
    c = vals.shape[1]
    idx = torch.arange(rm, dtype=I32, device=acc.device)[None, :]
    shift = idx - acc_pos[:, None]  # [B, rm]
    src = vals.gather(1, shift.clamp(0, c - 1).to(I64))
    write = (shift >= 0) & (shift < counts[:, None])
    return torch.where(write, src, acc), acc_pos + counts


def _full(B, value, device, dtype=I32):
    return torch.full((B,), value, dtype=dtype, device=device)


# A descent, as the retry ladders below call it:
# ``descent(x, start, base, ft, active) -> (item, ok, hard, leaf_start, r)``
# walks each lane from its ``start`` bucket, for ``active`` lanes, at the
# r of retry round ``ft`` (an int or a per-lane tensor) over ``base``:
# ``base + ft`` for firstn, ``base + numrep * ft`` for indep (the general
# engine spaces indep by ``numrep + 1`` in a uniform bucket whose size
# numrep divides).  ``leaf_start`` is the chosen bucket's start for the leaf
# descent, ``r`` the r of the level where the walk stopped.  The fast
# engine builds its descents with :func:`_pack_descent`, the general
# engine (``interp.py``) over its per-lane bucket indices.


def _pack_descent(pack, target_type: int, empty_is_hard: bool, spacing: int,
                  max_devices: int, mode: str):
    """The fast engine's descent over one stacked pack (lane starts are
    level-0 local indices; r is the same at every level)."""
    def run(x, start, base, ft, active):
        r = base + spacing * ft
        item, ok, hard, nlidx = descend(pack, x, start, r, target_type, empty_is_hard,
                                        active, max_devices, mode)
        return item, ok, hard, nlidx, r
    return run


def _leaf_firstn(leaf, osd_weight, x, start, has_bucket, base, recurse_tries: int,
                 out2, outpos):
    """The leaf recursion of ``choose_firstn`` for the lanes in
    ``has_bucket``: one slot, target type 0, r = base + ftotal (base =
    the slot's rep plus the parent's sub-r).  Collisions are checked
    against the leaves ``out2[:, :outpos]``; a hard failure ends the
    slot.  Returns (leaf, ok)."""
    settled = torch.zeros_like(has_bucket)
    leaf_ok = torch.zeros_like(has_bucket)
    found = torch.full_like(x, ITEM_NONE)

    def round_(ft):
        active = has_bucket & ~settled
        it, ok, hard, _, _ = leaf(x, start, base, ft, active)
        rejected = ok & (_collides(out2, outpos, it) | _is_out(osd_weight, it, x))
        good = active & ok & ~rejected
        settled.bitwise_or_(good | (active & hard))
        leaf_ok.bitwise_or_(good)
        torch.where(good, it, found, out=found)

    _run_ladder(x, recurse_tries, lambda: has_bucket & ~settled, round_)
    return found, leaf_ok


def _choose_firstn_batch(top, leaf, osd_weight, x, start, start_active,
                         numrep: int, target_type: int, cap: int, tries: int,
                         recurse_tries: int, vary_r: int, stable: int, compact: bool):
    """Batched ``choose_firstn`` from each lane's ``start`` (one
    working-vector entry), through the descents ``top`` and ``leaf``
    (None: no leaf recursion).

    Runs every one of the numrep replica slots but places at most
    ``cap``; a slot whose retries run out is skipped.  Entry-local state,
    like the reference's per-entry ``choose_firstn(..., o + osize,
    /*outpos=*/0, ...)`` call: collision scope and the stable=0 leaf
    replica seed cover only this entry's segment.  Each slot's ladder
    visits r = rep + ftotal: masked rounds over the whole batch, or, with
    ``compact``, round 1 over the batch and each later round over the
    lanes still unsettled, each lane counting its own rounds (the same r
    sequence, so the same results bit for bit).
    Returns (out [B, cap], out2 [B, cap], outpos [B]).
    """
    B = x.shape[0]
    dev = x.device
    out = torch.full((B, cap), ITEM_NONE, dtype=I32, device=dev)
    out2 = out.clone()
    outpos = torch.zeros(B, dtype=I32, device=dev)
    col_ids = torch.arange(cap, dtype=I32, device=dev)[None, :]

    def one_round(idx, rep, ft, active):
        """One retry round for the lanes ``idx`` (None: all) at round
        ``ft``; returns (good, stop, item, leaf), all lane-local."""
        take = (lambda t: t) if idx is None else (lambda t: t.index_select(0, idx))
        xv, outv, out2v, outposv = take(x), take(out), take(out2), take(outpos)
        item, ok, hard, lstart, r = top(xv, take(start), torch.full_like(xv, rep), ft, active)
        collide = ok & _collides(outv, outposv, item)
        reject = torch.zeros_like(collide)
        found = item
        if leaf is not None:
            is_bucket = item < 0
            sub_r = (r >> (vary_r - 1)) if vary_r else torch.zeros_like(r)
            lf, lok = _leaf_firstn(
                leaf, osd_weight, xv, lstart, active & ok & ~collide & is_bucket,
                (0 if stable else outposv) + sub_r, recurse_tries, out2v, outposv)
            reject = reject | (ok & ~collide & is_bucket & ~lok)
            found = torch.where(is_bucket, lf, item)
        if target_type == 0:
            reject = reject | (ok & ~collide & _is_out(osd_weight, item, xv))
        good = active & ok & ~collide & ~reject
        stop = active & hard  # skip_rep: abandon this slot
        return good, stop, item, found

    compacted = compact and tries > 0
    for rep in range(numrep):
        if compacted:
            good, stop, item, found = one_round(None, rep, 0, start_active)
            settled = ~start_active | good | stop
            item_acc = torch.where(good, item, ITEM_NONE)
            leaf_acc = torch.where(good, found, ITEM_NONE)
            placed = good
            ftl = torch.ones(B, dtype=I32, device=dev)  # rounds each lane has run
            # the compacted ladder's one read a round: the stragglers' indices
            # torchlint: disable=J003
            while (idx := _stragglers(~settled & (ftl < tries))) is not None:
                ftl_v = ftl.index_select(0, idx)
                good, stop, item, found = one_round(
                    idx, rep, ftl_v, torch.ones_like(idx, dtype=torch.bool))
                item_acc[idx] = torch.where(good, item, item_acc.index_select(0, idx))
                leaf_acc[idx] = torch.where(good, found, leaf_acc.index_select(0, idx))
                placed[idx] = placed.index_select(0, idx) | good
                settled[idx] = good | stop
                ftl[idx] = ftl_v + 1
        else:
            settled = torch.zeros(B, dtype=torch.bool, device=dev)
            item_acc = _full(B, ITEM_NONE, dev)
            leaf_acc = _full(B, ITEM_NONE, dev)
            placed = torch.zeros_like(settled)

            def round_(ft):
                good, stop, item, found = one_round(None, rep, ft, start_active & ~settled)
                settled.bitwise_or_(good | stop)
                torch.where(good, item, item_acc, out=item_acc)
                torch.where(good, found, leaf_acc, out=leaf_acc)
                placed.bitwise_or_(good)

            # the retry ladder's one read a round: whether a lane retries
            # torchlint: disable=J003
            _run_ladder(x, tries, lambda: start_active & ~settled, round_)

        place = (placed & (outpos < cap))[:, None] & (col_ids == outpos[:, None])
        out = torch.where(place, item_acc[:, None], out)
        if leaf is not None:
            out2 = torch.where(place, leaf_acc[:, None], out2)
        outpos = outpos + place.any(dim=1).to(I32)
    return out, out2, outpos


def _leaf_indep(leaf, osd_weight, x, start, has_bucket, base, recurse_tries: int):
    """The leaf recursion of ``choose_indep`` for the lanes in
    ``has_bucket``: one slot, target type 0, base = the parent's r plus
    the slot.  A hard failure fails the slot for good.  Returns (leaf,
    ok)."""
    settled = torch.zeros_like(has_bucket)
    got = torch.zeros_like(has_bucket)
    found = torch.full_like(x, ITEM_NONE)

    def round_(ft):
        active = has_bucket & ~settled
        it, ok, hard, _, _ = leaf(x, start, base, ft, active)
        newly = active & ok & ~_is_out(osd_weight, it, x)
        settled.bitwise_or_(newly | (active & hard))
        got.bitwise_or_(newly)
        torch.where(newly, it, found, out=found)

    _run_ladder(x, recurse_tries, lambda: has_bucket & ~settled, round_)
    return torch.where(got, found, ITEM_NONE), got


def _choose_indep_batch(top, leaf, osd_weight, x, start, start_active,
                        out_size: int, target_type: int, tries: int, recurse_tries: int,
                        compact: bool):
    """Batched ``choose_indep`` (positional, EC; NONE holes on failure)
    from each lane's ``start`` (one working-vector entry), through the
    descents ``top`` and ``leaf`` (None: no leaf recursion).  Each round
    retries every slot still UNDEF at r = rep + numrep * ftotal; rounds
    are masked, or with ``compact`` run on the lanes that still hold an
    UNDEF slot, as in :func:`_choose_firstn_batch`.
    Returns (out [B, out_size], out2 [B, out_size])."""
    B = x.shape[0]
    dev = x.device
    out = torch.where(
        start_active[:, None],
        torch.full((B, out_size), ITEM_UNDEF, dtype=I32, device=dev),
        torch.full((B, out_size), ITEM_NONE, dtype=I32, device=dev),
    )
    out2 = out.clone()

    def one_round(idx, ft, activev, outv, out2v):
        """One retry round (every slot) for the lanes ``idx`` (None: all)
        at round ``ft``; updates ``outv``/``out2v`` (those lanes' rows of
        out/out2) in place."""
        take = (lambda t: t) if idx is None else (lambda t: t.index_select(0, idx))
        xv, startv = take(x), take(start)
        none = torch.full_like(xv, ITEM_NONE)
        for rep in range(out_size):
            active = activev & (outv[:, rep] == ITEM_UNDEF)
            item, ok, hard, lstart, r = top(xv, startv, torch.full_like(xv, rep), ft, active)
            # collisions see this round's earlier slots (in-place columns)
            good = ok & ~(outv == item[:, None]).any(dim=1)
            found = item
            if leaf is not None:
                is_bucket = item < 0
                # the leaf descent runs its own retry ladder (one read a round)
                # torchlint: disable=J003
                lf, lok = _leaf_indep(leaf, osd_weight, xv, lstart, active & good & is_bucket,
                                      r + rep, recurse_tries)
                good = good & (lok | ~is_bucket)
                found = torch.where(is_bucket, lf, item)
            if target_type == 0:
                good = good & ~_is_out(osd_weight, item, xv)
            write_item = active & good
            write_none = active & hard  # permanent NONE on a hard failure
            outv[:, rep] = torch.where(
                write_item, item, torch.where(write_none, none, outv[:, rep]))
            out2v[:, rep] = torch.where(
                write_item, found, torch.where(write_none, none, out2v[:, rep]))

    if compact and tries > 0:
        # a lane out of rounds keeps its UNDEF slots, which turn NONE
        # below, as the masked rounds leave them
        one_round(None, 0, start_active, out, out2)
        ftl = torch.ones(B, dtype=I32, device=dev)  # rounds each lane has run
        # the compacted ladder's one read a round: the stragglers' indices
        # torchlint: disable=J003
        while (idx := _stragglers((out == ITEM_UNDEF).any(dim=1) & (ftl < tries))) is not None:
            out_v, out2_v = out.index_select(0, idx), out2.index_select(0, idx)
            ftl_v = ftl.index_select(0, idx)
            one_round(idx, ftl_v, torch.ones_like(idx, dtype=torch.bool), out_v, out2_v)
            out[idx] = out_v
            out2[idx] = out2_v
            ftl[idx] = ftl_v + 1
    else:
        _run_ladder(x, tries, lambda: out == ITEM_UNDEF,
                    lambda ft: one_round(None, ft, start_active, out, out2))
    out = torch.where(out == ITEM_UNDEF, ITEM_NONE, out)
    out2 = torch.where(out2 == ITEM_UNDEF, ITEM_NONE, out2)
    return out, out2


def supports(dense: DenseCrushMap, rule: Rule) -> bool:
    """Whether this engine can run (dense, rule)."""
    if dense.algs_present() - {ALG_STRAW2}:
        return False
    tun = dense.tunables
    if tun.choose_local_tries or tun.choose_local_fallback_tries:
        return False
    # packed field widths: type ids live in one byte (255 is the
    # dangling-child sentinel), level-local indices in two
    if dense.n_buckets and (
        int(dense.btype.max(initial=0)) >= _CTYPE_DANGLING
        or dense.n_buckets > 0xFFFF
        or dense.max_fanout > 0xFFFF
    ):
        return False
    take: int | None = None
    for s in rule.steps:
        if s.op == OP_TAKE:
            if s.arg1 >= 0:
                return False
            take = s.arg1
        elif s.op in (OP_SET_CHOOSE_LOCAL_TRIES,
                      OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES):
            if s.arg1 > 0:
                return False
        elif s.op in _CHOOSE_OPS and take is None:
            return False
    return True


def as_i32(v, device) -> torch.Tensor:
    """u32 values (numpy, list or tensor) -> int32 bit patterns on device."""
    if isinstance(v, torch.Tensor):
        if v.dtype != I32:
            v = (v.to(I64) & 0xFFFFFFFF).to(I32)
        return v.to(device).contiguous()
    a = np.ascontiguousarray(np.asarray(v).astype(np.uint64).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


def compile_rule_batch(dense: DenseCrushMap, rule: Rule, result_max: int,
                       device, mode: str | None = None):
    """Build (packs, run, program_sig): ``run(packs, osd_weight, xs)``
    returns (results [B, result_max] int32, lens [B] int32) on ``device``.

    ``packs`` holds the stacked level tables of every choose step on the
    device; the step program is specialized on the rule here, once.
    """
    mode = check_mode(mode)
    tun = dense.tunables
    if not supports(dense, rule):
        raise NotImplementedError(
            "batch engine: straw2-only maps, modern tunables, and bucket "
            "take targets (the engine routes other shapes to the host tier)"
        )

    # ---- host-side plan + pack construction (one forward walk) ----
    plans: list[dict] = []
    choose_tries = tun.choose_total_tries
    chooseleaf_tries = 0
    vary_r = tun.chooseleaf_vary_r
    stable = tun.chooseleaf_stable
    roots: list[int] | None = None  # current descent roots (bucket idxs)
    for s in rule.steps:
        if s.op == OP_TAKE:
            roots = [-1 - s.arg1]
            plans.append({"op": "take", "bucket_id": s.arg1})
        elif s.op == OP_SET_CHOOSE_TRIES:
            if s.arg1 > 0:
                choose_tries = s.arg1
        elif s.op == OP_SET_CHOOSELEAF_TRIES:
            if s.arg1 > 0:
                chooseleaf_tries = s.arg1
        elif s.op == OP_SET_CHOOSELEAF_VARY_R:
            if s.arg1 >= 0:
                vary_r = s.arg1
        elif s.op == OP_SET_CHOOSELEAF_STABLE:
            if s.arg1 >= 0:
                stable = s.arg1
        elif s.op in _CHOOSE_OPS:
            firstn = s.op in (OP_CHOOSE_FIRSTN, OP_CHOOSELEAF_FIRSTN)
            recurse = s.op in (OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP)
            numrep = s.arg1
            if numrep <= 0:
                numrep += result_max
            p = {
                "op": "choose", "firstn": firstn, "recurse": recurse,
                "numrep": numrep, "type": s.arg2, "tries": choose_tries,
                "chooseleaf_tries": chooseleaf_tries,
                "vary_r": vary_r, "stable": stable,
                "pack": None, "leaf_pack": None, "root_ids": None,
            }
            if numrep > 0 and roots is not None:
                if recurse:
                    stop = _stop_buckets(dense, roots, s.arg2)
                    leaf_pack, _ = build_pack(dense, stop, 0, {}, device)
                    leaf0_map = {b: i for i, b in enumerate(stop)}
                    pk, _ = build_pack(dense, roots, s.arg2, leaf0_map, device)
                    p["pack"], p["leaf_pack"] = pk, leaf_pack
                    p["root_ids"] = [-1 - b for b in roots]
                    roots = None  # leaves are devices; not chainable
                else:
                    pk, stop = build_pack(dense, roots, s.arg2, {}, device)
                    p["pack"] = pk
                    p["root_ids"] = [-1 - b for b in roots]
                    roots = stop if s.arg2 != 0 else None
            else:
                # mapper.c: numrep <= 0 skips every entry, and a choose
                # over devices (no roots) finds no bucket, so the working
                # vector comes out empty until the next take
                roots = None
            plans.append(p)
        elif s.op == OP_EMIT:
            plans.append({"op": "emit"})

    # the working-vector widths run() will see, checked up front (the
    # reference raises the same error while tracing)
    width: int | None = None  # None: no working vector
    for p in plans:
        if p["op"] == "take":
            width = 1
        elif p["op"] == "choose" and p["pack"] is None:
            width = None
        elif p["op"] == "choose" and width is not None:
            if width > 1 and width * p["numrep"] > result_max:
                raise NotImplementedError(
                    "chained choose overflowing result_max trims per-lane "
                    "entry widths; not supported on the batch engine"
                )
            width = min(width * p["numrep"], result_max)
        elif p["op"] == "emit":
            width = None

    # the chained choose's root ids, uploaded here (a run may be captured)
    for p in plans:
        if p.get("root_ids") is not None:
            p["rid"] = torch.tensor(p["root_ids"], dtype=I32, device=device)

    pack_args = tuple(
        (p["pack"], p["leaf_pack"])
        for p in plans
        if p.get("op") == "choose" and p["pack"] is not None
    )
    max_devices = dense.max_devices

    def run(packs_, osd_weight, xs):
        x = as_i32(xs, device)
        osd_weight = as_i32(osd_weight, device)
        B = x.shape[0]
        dev = x.device
        result = torch.full((B, result_max), ITEM_NONE, dtype=I32, device=dev)
        result_len = torch.zeros(B, dtype=I32, device=dev)
        w_vals: torch.Tensor | None = None  # [B, W] working vector
        w_size = torch.zeros(B, dtype=I32, device=dev)
        take_pending: int | None = None
        choose_i = 0

        for p in plans:
            if p["op"] == "take":
                take_pending = p["bucket_id"]
                w_vals = None
            elif p["op"] == "choose":
                if p["pack"] is None:  # empties the working vector
                    take_pending = None
                    w_vals = None
                    w_size = torch.zeros(B, dtype=I32, device=dev)
                    continue
                pack, leaf_pack = packs_[choose_i]
                choose_i += 1
                if take_pending is not None:
                    entries = 1
                    ent_lidx = [torch.zeros(B, dtype=I32, device=dev)]
                    ent_active = [torch.ones(B, dtype=torch.bool, device=dev)]
                    take_pending = None
                else:
                    if w_vals is None:
                        continue
                    entries = w_vals.shape[1]
                    rid = p["rid"]
                    local = torch.arange(len(p["root_ids"]), dtype=I32, device=dev)
                    ent_lidx, ent_active = [], []
                    for e in range(entries):
                        hit = w_vals[:, e][:, None] == rid[None, :]
                        ent_lidx.append(
                            torch.where(hit, local[None, :], 0).sum(dim=1, dtype=I32))
                        ent_active.append(hit.any(dim=1) & (e < w_size))
                # per-entry segments appended at per-lane offsets (the
                # reference's ``o + osize`` pointer bump; skipped
                # entries advance nothing, so later ones compact left)
                acc_w = min(entries * p["numrep"], result_max)
                acc = torch.full((B, acc_w), ITEM_NONE, dtype=I32, device=dev)
                acc_pos = torch.zeros(B, dtype=I32, device=dev)
                if p["firstn"]:
                    cap = min(p["numrep"], result_max)
                    recurse_tries = (
                        p["chooseleaf_tries"]
                        if p["chooseleaf_tries"]
                        else (1 if tun.chooseleaf_descend_once else p["tries"])
                    )
                    top = _pack_descent(pack, p["type"], False, 1, max_devices, mode)
                    leaf = (_pack_descent(leaf_pack, 0, False, 1, max_devices, mode)
                            if p["recurse"] else None)
                    for e in range(entries):
                        # each rule entry's retry ladder reads once a round
                        # torchlint: disable=J003
                        out, out2, outpos = _choose_firstn_batch(
                            top, leaf, osd_weight, x, ent_lidx[e], ent_active[e],
                            p["numrep"], p["type"], cap, p["tries"], recurse_tries,
                            p["vary_r"], p["stable"], False,
                        )
                        vals = out2 if p["recurse"] else out
                        acc, acc_pos = _append_rows(acc, acc_pos, vals, outpos)
                else:
                    os_e = min(p["numrep"], result_max)
                    recurse_tries = (
                        p["chooseleaf_tries"] if p["chooseleaf_tries"] else 1
                    )
                    top = _pack_descent(pack, p["type"], True, p["numrep"], max_devices, mode)
                    leaf = (_pack_descent(leaf_pack, 0, True, p["numrep"], max_devices, mode)
                            if p["recurse"] else None)
                    for e in range(entries):
                        # each rule entry's retry ladder reads once a round
                        # torchlint: disable=J003
                        o, o2 = _choose_indep_batch(
                            top, leaf, osd_weight, x, ent_lidx[e], ent_active[e],
                            os_e, p["type"], p["tries"], recurse_tries, False,
                        )
                        vals = o2 if p["recurse"] else o
                        width = torch.where(ent_active[e], os_e, 0).to(I32)
                        acc, acc_pos = _append_rows(acc, acc_pos, vals, width)
                w_vals = acc
                w_size = acc_pos
            elif p["op"] == "emit":
                if w_vals is None:
                    if take_pending is not None:
                        w_vals = torch.full((B, 1), take_pending, dtype=I32, device=dev)
                        w_size = torch.ones(B, dtype=I32, device=dev)
                        take_pending = None
                    else:
                        continue
                result, _ = _append_rows(result, result_len, w_vals, w_size)
                result_len = torch.clamp(result_len + w_size, max=result_max)
                w_vals = None
                w_size = torch.zeros(B, dtype=I32, device=dev)

        return result, result_len

    program_sig = tuple(
        (p["op"], p.get("bucket_id"))
        if p["op"] != "choose"
        else (
            "choose", p["firstn"], p["recurse"], p["numrep"], p["type"],
            p["tries"], p["chooseleaf_tries"], p["vary_r"], p["stable"],
            tuple(p["root_ids"]) if p["root_ids"] is not None else None,
            p["pack"].signature if p["pack"] is not None else None,
            p["leaf_pack"].signature if p["leaf_pack"] is not None else None,
        )
        for p in plans
    )
    return pack_args, run, program_sig


_PACK_CACHE: dict = {}


def _packs_for(dense: DenseCrushMap, rule: Rule, result_max: int, device, mode: str):
    dev = torch.device(device)
    pkey = (id(dense), rule_signature(rule), result_max, str(dev), mode)
    hit = _PACK_CACHE.get(pkey)
    if hit is not None and hit[0] is dense:
        return hit[1], hit[2], hit[3]
    packs, run, program_sig = compile_rule_batch(dense, rule, result_max, dev, mode)
    _memo_put(_PACK_CACHE, pkey, (dense, packs, run, program_sig))
    return packs, run, program_sig


def fast_signature(dense: DenseCrushMap, rule: Rule, result_max: int,
                   mode: str | None = None) -> tuple:
    """Static signature of the program for (dense, rule, result_max):
    rule structure, tunables, pack shapes and the map-derived constants
    baked into the program (take ids, chained-choose root ids)."""
    mode = check_mode(mode)
    _, _, program_sig = _packs_for(dense, rule, result_max, "cpu", mode)
    return (program_sig, dense.tunables, result_max, dense.max_devices, mode)


def fast_runner(dense: DenseCrushMap, rule: Rule, result_max: int,
                mode: str | None = None, device="cuda"):
    """Cached (packs, run) for ``dense``/``rule`` on ``device``; the
    packs are built once per dense-map object."""
    packs, run, _ = _packs_for(dense, rule, result_max, device, check_mode(mode))
    return packs, run
