"""The general CRUSH engine: uniform and mixed uniform/straw2 maps.

The counterpart of the reference package's ``crush/interp.py`` (upstream
``src/crush/mapper.c :: crush_do_rule / crush_choose_firstn /
crush_choose_indep / crush_bucket_choose / bucket_perm_choose``), with
its names and semantics, restructured batch-first: where the reference
``vmap``s a per-object program of while-loops, every function here
takes the whole batch and walks it in masked steps.

- **Descent.**  :func:`_descend` walks the levels with a bucket index
  per lane; a lane that is done keeps its result and is masked.  The r
  of each level comes from ``level_r(bidx)``, so indep's uniform
  spacing can depend on each lane's bucket.  The reference walks
  ``max_depth + 1`` levels; here the walk stops after the most levels a
  lane can take from its start buckets before it stops
  (:meth:`StaticCrushMap.levels`, from the map on the host), after
  which the reference's further levels change nothing.
- **straw2 levels go through K1.**  :func:`_straw2_choose` gathers each
  lane's bucket row (ids, weights, magic reciprocals, ``[B, F]``) and
  calls :func:`ceph_tpu_torch.core.straw2.negdraw`, then takes a
  first-index ``argmin``: the reference's ``straw2_negdraw_magic`` over
  a row.  On CPU tensors ``negdraw`` runs its plain version.
- **Uniform buckets.**  :func:`_perm_choose` is the stateless form of
  upstream ``bucket_perm_choose``: a batch Fisher-Yates over a ``[B, F]``
  permutation in torch ops (the reference's is XLA code outside Pallas,
  so no kernel replaces it).  A mixed map selects per lane on the
  bucket's alg; a map of one kind skips the other branch.
- **The retry ladders are the fast engine's.**  ``_choose_firstn`` and
  ``_choose_indep`` run ``interp_batch``'s host-driven ladders, with
  their leaf recursions, over this engine's descent,
  :func:`_smap_descent`.  Each loop test after the first round is one
  host sync (counted in ``interp_batch.HOST_SYNCS``); a loop ends early
  when no lane is left, which leaves every result as the reference's
  full loop gives it.
- **Compacted-straggler retry from ``COMPACT_MIN_BATCH`` lanes up.**
  A round here costs the card many torch ops a level over ``[B, F]``
  rows, so the ladders' rounds after the first run on the unsettled
  lanes only (same results, bit for bit); on the H100 this made the
  mixed maps' calls of 1M objects ~40% faster (PERF.md).  A run that is
  being captured into a CUDA graph does not compact, whatever its size
  (the straggler count is a host read): its rounds are a WHILE node
  (``interp_batch._run_ladder``).

Scope, as the reference's: single-TAKE rules with one choose step per
take, taken from a bucket; uniform and straw2 buckets only (list, tree
and straw1 raise); the legacy local-retry tunables raise in
:func:`compile_rule`.  ``crush/engine.py`` routes every other shape to
the C++ tier.  One deliberate difference: a choose step whose effective
``numrep`` is <= 0 empties the working vector, as ``mapper.c`` and the
C++ tier do (the reference's engine emits the take there instead,
ROADMAP's R5).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import graphs, hashes, straw2
from . import interp_batch
from .interp_batch import _append_rows, as_i32
from .map import (
    ALG_STRAW2,
    ALG_UNIFORM,
    ITEM_NONE,
    DenseCrushMap,
    OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP,
    OP_CHOOSELEAF_FIRSTN,
    OP_CHOOSELEAF_INDEP,
    OP_EMIT,
    OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    OP_SET_CHOOSE_LOCAL_TRIES,
    OP_SET_CHOOSE_TRIES,
    OP_SET_CHOOSELEAF_STABLE,
    OP_SET_CHOOSELEAF_TRIES,
    OP_SET_CHOOSELEAF_VARY_R,
    OP_TAKE,
    Rule,
)

I32 = torch.int32
I64 = torch.int64
M32 = hashes.M32

# the smallest batch whose retry rounds after the first run on the
# stragglers only (the reference's threshold for its compacted rounds)
COMPACT_MIN_BATCH = 1 << 16


class StaticCrushMap:
    """The dense map's tensors on one device, with its static shape and
    tunables; the straw2 magic reciprocals are computed once here."""

    #: the map's tensors, by attribute (a CUDA graph copies them into its own)
    TENSORS = ("alg", "btype", "size", "items", "weights", "magic", "uniform")

    def __init__(self, dense: DenseCrushMap, device="cuda"):
        self.device = resolve_device(device)
        self.n_buckets = dense.n_buckets
        self.max_fanout = dense.max_fanout
        self.max_devices = dense.max_devices
        self.max_depth = max(dense.max_depth, 1)
        self.tunables = dense.tunables
        self.algs = frozenset(dense.algs_present())
        self.signature = dense_signature(dense)
        unsupported = self.algs - {ALG_UNIFORM, ALG_STRAW2}
        if unsupported:
            raise NotImplementedError(
                f"bucket algs {sorted(unsupported)} (list/tree/straw1) are "
                "legacy and not supported on the device path; use straw2/uniform"
            )
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        size = np.asarray(dense.size, np.int32)
        # padded slots carry weight 0, so they never win a straw2 draw
        valid = np.arange(dense.max_fanout)[None, :] < size[:, None]
        weights = np.where(valid, dense.weights, 0).astype(np.uint32)
        self.alg = t(np.asarray(dense.alg, np.int32))
        self.btype = t(np.asarray(dense.btype, np.int32))
        self.size = t(size).to(I64)
        self.items = t(np.asarray(dense.items, np.int32))
        self.weights = t(weights.view(np.int32))
        self.magic = t(hashes.magic_reciprocal(weights).view(np.int64))
        self.uniform = self.alg == ALG_UNIFORM
        # the permutation's width: the widest uniform bucket
        uni_sizes = size[np.asarray(dense.alg) == ALG_UNIFORM]
        self.perm_width = max(int(uni_sizes.max(initial=1)), 1)
        self._host = (np.asarray(dense.btype), size, np.asarray(dense.items))
        self._levels: dict = {}

    def levels(self, target_type: int) -> np.ndarray:
        """Per bucket, the most levels a descent toward ``target_type``
        started there can walk: one, plus the most of any child bucket
        it may descend into (not of the target type, not dangling);
        capped at the reference's ``max_depth + 1``."""
        hit = self._levels.get(target_type)
        if hit is None:
            btype, size, items = self._host
            nb = self.n_buckets
            cidx = -1 - items
            valid = np.arange(items.shape[1])[None, :] < size[:, None]
            inner = valid & (items < 0) & (cidx < nb)
            inner &= btype[np.clip(cidx, 0, max(nb - 1, 0))] != target_type
            hit = np.ones(nb, np.int64)
            for _ in range(self.max_depth + 1):
                child = np.where(inner, hit[np.clip(cidx, 0, max(nb - 1, 0))], 0)
                hit = np.minimum(1 + child.max(axis=1, initial=0), self.max_depth + 1)
            self._levels[target_type] = hit
        return hit

    def leaf_levels(self, bucket_type: int) -> int:
        """Levels of a leaf descent from any bucket of ``bucket_type``."""
        btype = self._host[0]
        return int(self.levels(0)[btype == bucket_type].max(initial=1))


def _straw2_choose(smap: StaticCrushMap, bidx, x, r):
    """items[argmin negdraw] of each lane's bucket row (K1 on the card);
    padded weights never win, and all-zero weights pick slot 0, the
    reference's scan start."""
    ids = smap.items.index_select(0, bidx)
    nd = straw2.negdraw(x, r, ids, smap.weights.index_select(0, bidx),
                        smap.magic.index_select(0, bidx))
    return ids.gather(1, nd.argmin(dim=1, keepdim=True))[:, 0]


def _perm_choose(smap: StaticCrushMap, bidx, x, r):
    """Uniform buckets: each lane's seeded Fisher-Yates permutation,
    stateless (``pr = r % size`` as u32, swaps while ``p <= pr`` and
    ``p < size - 1``, the swap index ``crush_hash32_3(x, u32(bucket id),
    p) % (size - p)``).  F is the widest uniform bucket's size: the
    draws of every step come from one [B, F - 1] hash, then the swaps run
    F - 1 steps over the [B, F] permutation.  (A lane in a wider straw2
    bucket of a mixed map gets a result here that its caller drops.)"""
    B, F = bidx.shape[0], smap.perm_width
    size = smap.size.index_select(0, bidx)
    pr = ((r.to(I64) & M32) % size.clamp(min=1)).clamp(max=F - 1)
    fits = size <= F
    p = torch.arange(F, dtype=I64, device=bidx.device)[None, :]
    steps = p[:, : F - 1]
    draw = hashes.crush_hash32_3(x[:, None], (-1 - bidx)[:, None], steps)
    draw = draw % (size[:, None] - steps).clamp(min=1)
    perm = p.expand(B, F).clone()
    for q in range(F - 1):
        i = draw[:, q]
        swap = (q <= pr) & (q < size - 1) & (i > 0) & fits
        j = (q + torch.where(swap, i, 0))[:, None]
        pq = perm[:, q].clone()
        pj = perm.gather(1, j)[:, 0]
        perm.scatter_(1, j, torch.where(swap, pq, pj)[:, None])
        perm[:, q] = torch.where(swap, pj, pq)
    col = perm.gather(1, pr[:, None])
    return smap.items.index_select(0, bidx).gather(1, col)[:, 0]


def _bucket_choose(smap: StaticCrushMap, bidx, x, r):
    if smap.algs <= {ALG_STRAW2}:
        return _straw2_choose(smap, bidx, x, r)
    if smap.algs <= {ALG_UNIFORM}:
        return _perm_choose(smap, bidx, x, r)
    return torch.where(smap.uniform.index_select(0, bidx), _perm_choose(smap, bidx, x, r),
                       _straw2_choose(smap, bidx, x, r))


def _descend(smap: StaticCrushMap, x, start_bidx, target_type: int, level_r, levels: int,
             empty_is_hard: bool = False, active=None):
    """Walk each lane down from its bucket until an item of
    ``target_type`` is chosen; ``level_r(bidx)`` gives each lane's r at
    each level, ``levels`` bounds the walk (:meth:`StaticCrushMap.levels`
    of the start buckets), ``active`` masks lanes whose result is not
    wanted.

    Returns (item, ok, hard, r_final), all [B]:
      ok   -- an item of target_type was chosen;
      hard -- unrecoverable failure (bad device id, a device met while a
              bucket type was wanted, malformed bucket id): the caller
              abandons the slot (the reference's skip_rep / NONE-break);
      neither -- soft failure (empty bucket, depth exhausted): retry;
      r_final -- the r of the level where the walk stopped (the
              chooseleaf-indep recursion's parent_r).
    ``empty_is_hard``: indep marks a slot NONE on an empty bucket, while
    firstn retries the descent.
    """
    B = x.shape[0]
    dev = x.device
    nb = max(smap.n_buckets, 1)
    bidx = start_bidx.to(I64)
    item = torch.full((B,), ITEM_NONE, dtype=I32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev) if active is None else ~active
    ok = torch.zeros(B, dtype=torch.bool, device=dev)
    hard = torch.zeros_like(ok)
    r_out = torch.zeros(B, dtype=I32, device=dev)
    for _ in range(levels):
        r = level_r(bidx)
        empty = smap.size.index_select(0, bidx) == 0
        chosen = _bucket_choose(smap, bidx, x, r)
        bad_dev = chosen >= smap.max_devices
        is_bucket = chosen < 0
        sub = -1 - chosen.to(I64)
        bad_bucket = is_bucket & (sub >= smap.n_buckets)
        sub_idx = sub.clamp(0, nb - 1)
        itemtype = torch.where(is_bucket, smap.btype.index_select(0, sub_idx), 0)
        reached = itemtype == target_type
        wrong_dev = ~is_bucket & ~reached
        if empty_is_hard:
            hard_now = empty | bad_dev | bad_bucket | wrong_dev
            soft_now = torch.zeros_like(empty)
        else:
            hard_now = ~empty & (bad_dev | bad_bucket | wrong_dev)
            soft_now = empty
        new_done = done | hard_now | soft_now | reached
        ok = torch.where(done, ok, reached & ~hard_now & ~soft_now)
        hard = torch.where(done, hard, hard_now)
        item = torch.where(done, item, chosen)
        r_out = torch.where(done, r_out, r)
        bidx = torch.where(~new_done & is_bucket, sub_idx, bidx)
        done = new_done
    # lanes not done after max_depth + 1 levels: soft failure (depth exhausted)
    return item, ok, hard, r_out


def _bucket_index(smap: StaticCrushMap, item):
    return (-1 - item.to(I64)).clamp(0, max(smap.n_buckets, 1) - 1)


def _indep_r(smap: StaticCrushMap, numrep: int, base, ftotal):
    """indep's r at a level: ``base + (numrep + 1) * ftotal`` in a uniform
    bucket whose size numrep divides, ``base + numrep * ftotal`` in any
    other (per lane and per level; ``ftotal`` an int or per lane)."""
    def level_r(bidx):
        spaced = smap.uniform.index_select(0, bidx) & (smap.size.index_select(0, bidx)
                                                       % numrep == 0)
        return (base + torch.where(spaced, (numrep + 1) * ftotal, numrep * ftotal)).to(I32)
    return level_r


def _smap_descent(smap: StaticCrushMap, target_type: int, empty_is_hard: bool,
                  indep_numrep: int | None, levels: int):
    """The general engine's descent, as ``interp_batch``'s retry ladders
    call it (lane starts are bucket indices): firstn's r is ``base +
    ftotal`` at every level, indep's comes from :func:`_indep_r` with
    ``indep_numrep``."""
    def run(x, start, base, ft, active):
        if indep_numrep is None:
            r = (base + ft).to(I32)
            level_r = lambda _bidx: r
        else:
            level_r = _indep_r(smap, indep_numrep, base, ft)
        item, ok, hard, r_final = _descend(smap, x, start, target_type, level_r, levels,
                                           empty_is_hard, active)
        return item, ok, hard, _bucket_index(smap, item), r_final
    return run


def _compacts(x: torch.Tensor) -> bool:
    """Whether the ladders over the lanes ``x`` compact their rounds."""
    return x.shape[0] >= COMPACT_MIN_BATCH and not graphs.capturing(x)


def _choose_firstn(smap: StaticCrushMap, osd_weight, x, take_bidx: int, numrep: int,
                   target_type: int, out_size: int, tries: int, recurse_tries: int,
                   recurse_to_leaf: bool, vary_r: int, stable: int):
    """FIRSTN selection below one take bucket: ``interp_batch``'s ladder
    (:func:`~ceph_tpu_torch.crush.interp_batch._choose_firstn_batch`, with
    its leaf recursion ``_leaf_firstn``) over this engine's descents.
    Returns (out [B, out_size], out2 [B, out_size], n_placed [B])."""
    B = x.shape[0]
    top = _smap_descent(smap, target_type, False, None,
                        int(smap.levels(target_type)[take_bidx]))
    leaf = (_smap_descent(smap, 0, False, None, smap.leaf_levels(target_type))
            if recurse_to_leaf else None)
    start = torch.full((B,), take_bidx, dtype=I64, device=x.device)
    every = torch.ones(B, dtype=torch.bool, device=x.device)
    return interp_batch._choose_firstn_batch(top, leaf, osd_weight, x, start, every, numrep,
                                             target_type, out_size, tries, recurse_tries,
                                             vary_r, stable, _compacts(x))


def _choose_indep(smap: StaticCrushMap, osd_weight, x, take_bidx: int, out_size: int, numrep: int,
                  target_type: int, tries: int, recurse_tries: int, recurse_to_leaf: bool):
    """INDEP (positional, EC) selection below one take bucket:
    ``interp_batch``'s ladder (``_choose_indep_batch``, with its leaf
    recursion ``_leaf_indep``) over this engine's descents.
    Returns (out [B, out_size], out2 [B, out_size])."""
    B = x.shape[0]
    top = _smap_descent(smap, target_type, True, numrep, int(smap.levels(target_type)[take_bidx]))
    leaf = (_smap_descent(smap, 0, True, numrep, smap.leaf_levels(target_type))
            if recurse_to_leaf else None)
    start = torch.full((B,), take_bidx, dtype=I64, device=x.device)
    every = torch.ones(B, dtype=torch.bool, device=x.device)
    return interp_batch._choose_indep_batch(top, leaf, osd_weight, x, start, every, out_size,
                                            target_type, tries, recurse_tries, _compacts(x))


_CHOOSE_OPS = (OP_CHOOSE_FIRSTN, OP_CHOOSE_INDEP, OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP)


def compile_rule(smap: StaticCrushMap, rule: Rule, result_max: int):
    """Plan the rule once; returns ``run(smap, osd_weight, xs) ->
    (results [B, result_max] int32, lens [B] int32)``.

    ``osd_weight`` and ``xs`` are int32 tensors of u32 bit patterns on
    the map's device.  SET_* steps fold into each choose's constants
    here, in step order, as the reference folds them while tracing."""
    tun = smap.tunables
    if tun.choose_local_tries or tun.choose_local_fallback_tries:
        raise NotImplementedError(
            "legacy local-retry tunables are CPU-reference-only; "
            "use the bobtail+ profiles on the device path")
    for s in rule.steps:
        if s.op in (OP_SET_CHOOSE_LOCAL_TRIES, OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES):
            if s.arg1 > 0:
                raise NotImplementedError(
                    "legacy local retry tunables not supported on the device path")

    plan: list[tuple] = []
    take: int | None = None
    choose_tries = tun.choose_total_tries
    chooseleaf_tries = 0
    vary_r = tun.chooseleaf_vary_r
    stable = tun.chooseleaf_stable
    for s in rule.steps:
        if s.op == OP_TAKE:
            take = s.arg1
            plan.append(("take", take))
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
            if take is None or take >= 0:
                raise NotImplementedError(
                    "the general engine runs single-TAKE single-choose rules; "
                    "this rule chains chooses or takes a raw device")
            numrep = s.arg1 if s.arg1 > 0 else s.arg1 + result_max
            take_bidx, take = -1 - take, None
            if numrep <= 0:
                # mapper.c: the working vector comes out empty
                plan.append(("empty",))
                continue
            recurse = s.op in (OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP)
            out_size = min(numrep, result_max)
            if s.op in (OP_CHOOSE_FIRSTN, OP_CHOOSELEAF_FIRSTN):
                leaf_tries = chooseleaf_tries or (
                    1 if tun.chooseleaf_descend_once else choose_tries)
                plan.append(("firstn", take_bidx, recurse, (
                    numrep, s.arg2, out_size, choose_tries, leaf_tries, recurse, vary_r,
                    stable)))
            else:
                plan.append(("indep", take_bidx, recurse, (
                    out_size, numrep, s.arg2, choose_tries, chooseleaf_tries or 1, recurse)))
        elif s.op == OP_EMIT:
            take = None
            plan.append(("emit",))

    def run(smap_: StaticCrushMap, osd_weight, xs):
        B = xs.shape[0]
        dev = xs.device
        result = torch.full((B, result_max), ITEM_NONE, dtype=I32, device=dev)
        result_len = torch.zeros(B, dtype=I32, device=dev)
        w = wsize = None  # the working vector after a choose
        take_item: int | None = None
        for op, *args in plan:
            if op == "take":
                take_item, w = args[0], None
            elif op == "empty":
                take_item = w = None
            elif op in ("firstn", "indep"):
                take_bidx, recurse, params = args
                if op == "firstn":
                    o, o2, wsize = _choose_firstn(smap_, osd_weight, xs, take_bidx, *params)
                else:
                    o, o2 = _choose_indep(smap_, osd_weight, xs, take_bidx, *params)
                    wsize = torch.full((B,), params[0], dtype=I32, device=dev)
                w = o2 if recurse else o
                take_item = None
            elif op == "emit":
                if w is None:
                    if take_item is None:
                        continue
                    # a bare take; emit emits the taken item
                    w = torch.full((B, 1), take_item, dtype=I32, device=dev)
                    wsize = torch.ones(B, dtype=I32, device=dev)
                    take_item = None
                result, _ = _append_rows(result, result_len, w, wsize)
                result_len = torch.clamp(result_len + wsize, max=result_max)
                w = None
        return result, result_len

    return run


def dense_signature(dense: DenseCrushMap) -> tuple:
    """Hashable static signature of the general engine's map: two maps
    with equal signatures run the same plan (the map's tensors are
    arguments, not constants)."""
    return (dense.n_buckets, dense.max_fanout, dense.max_devices, max(dense.max_depth, 1),
            dense.tunables, tuple(sorted(dense.algs_present())))


def program_constants(smap: StaticCrushMap, rule: Rule) -> tuple:
    """What :func:`compile_rule`'s program takes from ``smap``'s host
    arrays beyond :func:`dense_signature`: the permutation's width and,
    for each choose step, its descents' level bounds.  A captured
    program bakes them in (``recovery/pipeline.py`` keys on them)."""
    out: list = [smap.perm_width]
    take: int | None = None
    for s in rule.steps:
        if s.op == OP_TAKE:
            take = s.arg1
        elif s.op in _CHOOSE_OPS and take is not None and take < 0:
            out.append((int(smap.levels(s.arg2)[-1 - take]), smap.leaf_levels(s.arg2)))
            take = None
    return tuple(out)


def smap_signature(smap: StaticCrushMap) -> tuple:
    """:func:`dense_signature` of the map ``smap`` was built from."""
    return smap.signature


def rule_signature(rule: Rule) -> tuple:
    return tuple((s.op, s.arg1, s.arg2) for s in rule.steps)


_BATCH_CACHE: dict = {}


def batch_runner(smap: StaticCrushMap, rule: Rule, result_max: int):
    """Cached ``f(smap, osd_weight, xs) -> (results, lens)``, memoized by
    signature as the reference's; ``osd_weight`` and ``xs`` may be numpy
    arrays, lists or tensors of u32 values."""
    key = (smap_signature(smap), rule_signature(rule), result_max)
    fn = _BATCH_CACHE.get(key)
    if fn is None:
        run = compile_rule(smap, rule, result_max)

        def fn(smap_, osd_weight, xs):
            return run(smap_, as_i32(osd_weight, smap_.device), as_i32(xs, smap_.device))

        interp_batch._memo_put(_BATCH_CACHE, key, fn)
    return fn


def batch_do_rule(smap: StaticCrushMap, rule: Rule, xs, osd_weight, result_max: int):
    """Rule execution over a batch of x seeds on the map's device.

    Returns (results [n, result_max] int32, lens [n] int32)."""
    return batch_runner(smap, rule, result_max)(smap, osd_weight, xs)
