"""Whole-map PG->OSD batch mapping on the device.

The counterpart of the reference package's ``osdmap/mapping.py`` and of
upstream ``src/osd/OSDMapMapping.{h,cc}``: the entire pool mapping —
pps derivation, CRUSH rule execution, upmap application, up-set
filtering, primary selection and affinity, pg_temp overrides — runs as
batched tensor ops over every PG of the pool (``[n_pgs, size]``), with
the dynamic cluster state (weights, up/down bits, upmap tables) held as
device tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core.hashes import ceph_stable_mod, crush_hash32_2
from ..crush.engine import make_batch_runner, runner_signature
from ..crush.interp_batch import as_i32, check_mode
from ..crush.map import ITEM_NONE
from .map import (
    DEFAULT_PRIMARY_AFFINITY,
    EXISTS,
    MAX_PRIMARY_AFFINITY,
    UP,
    OSDMap,
    PGId,
    Pool,
)

I32 = torch.int32
I64 = torch.int64


@dataclass
class PoolMapState:
    """Dynamic cluster state for one pool's mapping, as device tensors.

    All tables are dense, PG-indexed; dict-shaped control-plane state
    (upmaps, temps) is compiled to fixed-width padded arrays.
    """

    osd_weight: torch.Tensor  # int32 [n_osd]  in/out reweight, 16.16
    osd_up: torch.Tensor  # bool [n_osd]  exists & up
    osd_exists: torch.Tensor  # bool [n_osd]  (the epoch loop's tape and tick read it)
    primary_affinity: torch.Tensor  # int64 [n_osd]
    upmap_full: torch.Tensor  # int32 [pg_num, size]  ITEM_NONE pad
    has_upmap: torch.Tensor  # bool [pg_num]
    upmap_items: torch.Tensor  # int32 [pg_num, max_items, 2]
    n_upmap_items: torch.Tensor  # int32 [pg_num]
    pg_temp: torch.Tensor  # int32 [pg_num, size]  ITEM_NONE pad
    n_pg_temp: torch.Tensor  # int32 [pg_num]
    primary_temp: torch.Tensor  # int32 [pg_num]  -1 = unset


def build_pool_state(m: OSDMap, pool: Pool, max_items: int = 8,
                     device="cuda") -> PoolMapState:
    """Compile an OSDMap's dict-shaped state into dense device tables."""
    dev = resolve_device(device)
    n_osd = max(m.max_osd, 1)
    size = pool.size
    pg_num = pool.pg_num
    state = np.array(m.osd_state + [0] * (n_osd - m.max_osd), np.int32)
    weight = np.zeros(n_osd, np.uint32)
    weight[: m.max_osd] = m.osd_weight
    aff = np.full(n_osd, DEFAULT_PRIMARY_AFFINITY, np.int64)
    aff[: m.max_osd] = m.osd_primary_affinity

    upmap_full = np.full((pg_num, size), ITEM_NONE, np.int32)
    has_upmap = np.zeros(pg_num, bool)
    for pg, um in m.pg_upmap.items():
        if pg.pool != pool.id or not (0 <= pg.ps < pg_num) or not um:
            continue  # empty overrides are ignored (host 'if um:' falsy)
        has_upmap[pg.ps] = True
        upmap_full[pg.ps, : min(len(um), size)] = um[:size]

    upmap_items = np.zeros((pg_num, max_items, 2), np.int32)
    n_items = np.zeros(pg_num, np.int32)
    for pg, items in m.pg_upmap_items.items():
        if pg.pool != pool.id or not (0 <= pg.ps < pg_num):
            continue
        if len(items) > max_items:
            raise ValueError(
                f"pg {pg} has {len(items)} upmap items > max_items={max_items}; "
                "rebuild the state with a larger max_items"
            )
        n_items[pg.ps] = len(items)
        for j, (frm, to) in enumerate(items):
            upmap_items[pg.ps, j] = (frm, to)

    pg_temp = np.full((pg_num, size), ITEM_NONE, np.int32)
    n_temp = np.zeros(pg_num, np.int32)
    for pg, t in m.pg_temp.items():
        if pg.pool != pool.id or not (0 <= pg.ps < pg_num):
            continue
        n_temp[pg.ps] = min(len(t), size)
        pg_temp[pg.ps, : n_temp[pg.ps]] = t[:size]

    ptemp = np.full(pg_num, -1, np.int32)
    for pg, p in m.primary_temp.items():
        if pg.pool == pool.id and 0 <= pg.ps < pg_num:
            ptemp[pg.ps] = p

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return PoolMapState(
        osd_weight=as_i32(weight, dev),
        osd_up=t((state & (EXISTS | UP)) == (EXISTS | UP)),
        osd_exists=t((state & EXISTS) != 0),
        primary_affinity=t(aff),
        upmap_full=t(upmap_full),
        has_upmap=t(has_upmap),
        upmap_items=t(upmap_items),
        n_upmap_items=t(n_items),
        pg_temp=t(pg_temp),
        n_pg_temp=t(n_temp),
        primary_temp=t(ptemp),
    )


def _first_valid(valid: torch.Tensor) -> torch.Tensor:
    """Per row, index of the first True in ``valid`` [N, S], else -1."""
    S = valid.shape[1]
    slot = torch.arange(S, dtype=I64, device=valid.device)[None, :]
    idx = torch.where(valid, slot, S).min(dim=1).values
    return torch.where(idx < S, idx, -1)


def _pick(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """rows[n, pos[n]] for pos >= 0 (pos clamped; callers mask pos < 0)."""
    return rows.gather(1, pos.clamp(min=0)[:, None])[:, 0]


def _compact_left(rows: torch.Tensor, valid: torch.Tensor):
    """Per row, stable left-shift of valid entries; invalid slots ->
    ITEM_NONE.  Returns (rows, count)."""
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    shifted = rows.gather(1, order)
    count = valid.sum(dim=1)
    slot = torch.arange(rows.shape[1], device=rows.device)[None, :]
    return torch.where(slot < count[:, None], shifted, ITEM_NONE), count


def pool_program_key(dense, pool: Pool, rule, mode: str | None = None) -> tuple:
    """Hashable static signature of one pool's mapping program: the
    CRUSH runner signature plus every pool constant baked into the
    program, and the straw2 kernel ``mode`` (it picks the kernel).  The
    fused placement->peering pipeline's cache key
    (:mod:`ceph_tpu_torch.recovery.pipeline`): incremental map epochs
    that change only state tensors share one entry."""
    return (
        runner_signature(dense, rule, pool.size, mode),
        pool.id,
        pool.size,
        pool.pgp_num,
        pool.hashpspool,
        pool.can_shift_osds(),
        check_mode(mode),
    )


def make_seeds(pool: Pool):
    """PG index -> (ps, pps) seed derivation for one pool (the
    reference's ``raw_pg_to_pps``), over a batch of PG indices."""
    pool_id = pool.id
    pgp_num = pool.pgp_num
    pgp_mask = pool.pgp_num_mask
    hashpspool = pool.hashpspool

    def seeds(pg_indices: torch.Tensor):
        ps = pg_indices.to(I64) & 0xFFFFFFFF
        folded = ceph_stable_mod(ps, pgp_num, pgp_mask)
        if hashpspool:
            pps = crush_hash32_2(folded, torch.full_like(folded, pool_id))
        else:
            pps = (folded + pool_id) & 0xFFFFFFFF
        return ps, pps

    return seeds


def make_post(pool: Pool):
    """The post-CRUSH stage of one pool over a batch of PG rows (the
    counterpart of the reference's vmapped ``make_post_one``):
    ``post(state, ps, pps, raw) -> (up, up_primary, acting,
    acting_primary)``, the reference's ``_apply_upmap -> _raw_to_up_osds
    -> _pick_primary -> _apply_primary_affinity -> _get_temp_osds`` with
    ``raw`` [N, size] int32 and every step batched over N."""
    size = pool.size
    shift = pool.can_shift_osds()

    def post(state: PoolMapState, ps, pps, raw):
        n_osd = state.osd_weight.shape[0]
        dev = raw.device
        in_range = lambda o: (o >= 0) & (o < n_osd)
        clip = lambda o: o.clamp(0, n_osd - 1).to(I64)
        slots = torch.arange(size, device=dev)[None, :]

        # ---- _apply_upmap ----
        psi = ps.to(I64)
        um = state.upmap_full[psi]
        um_w = state.osd_weight[clip(um)]
        # any in-range target marked out voids the full override
        um_void = ((um != ITEM_NONE) & in_range(um) & (um_w == 0)).any(dim=1)
        has_full = state.has_upmap[psi]
        raw = torch.where((has_full & ~um_void)[:, None], um, raw)

        items = state.upmap_items[psi]  # [N, max_items, 2]
        n_it = state.n_upmap_items[psi]
        for j in range(items.shape[1]):
            frm, to = items[:, j, 0], items[:, j, 1]
            to_out = ((to != ITEM_NONE) & in_range(to)
                      & (state.osd_weight[clip(to)] == 0))
            hit = raw == frm[:, None]
            first = _first_valid(hit)
            # reference guard: skip the rewrite when the replacement
            # target already appears anywhere in the raw set
            exists = (raw == to[:, None]).any(dim=1)
            # a voided full pg_upmap returns early in the reference, so
            # items are blocked only in that case; an *applied* full
            # upmap falls through and items apply on top of it
            do = ((j < n_it) & (first >= 0) & ~to_out & ~exists
                  & ~(has_full & um_void))
            raw = torch.where(do[:, None] & (slots == first[:, None]), to[:, None], raw)

        # ---- _raw_to_up_osds ----
        valid = (raw != ITEM_NONE) & in_range(raw) & state.osd_up[clip(raw)]
        if shift:
            up, _ = _compact_left(raw, valid)
        else:
            up = torch.where(valid, raw, ITEM_NONE)

        # ---- _pick_primary + _apply_primary_affinity ----
        uvalid = up != ITEM_NONE
        ppos = _first_valid(uvalid)
        up_primary = torch.where(ppos >= 0, _pick(up, ppos), -1)

        aff = state.primary_affinity[clip(up)]
        nondefault = (uvalid & (aff != DEFAULT_PRIMARY_AFFINITY)).any(dim=1)
        hv = crush_hash32_2(pps[:, None], up) >> 16
        reject = (aff < MAX_PRIMARY_AFFINITY) & (hv >= aff)
        first_ok = _first_valid(uvalid & ~reject)
        pos = torch.where(first_ok >= 0, first_ok, _first_valid(uvalid))
        aff_primary = torch.where(pos >= 0, _pick(up, pos), up_primary)
        up_primary = torch.where(nondefault, aff_primary, up_primary)

        # ---- _get_temp_osds ----
        t = state.pg_temp[psi]
        n_temp = state.n_pg_temp[psi]
        t_in = slots < n_temp[:, None]
        t_alive = t_in & (t != ITEM_NONE) & in_range(t) & state.osd_up[clip(t)]
        if shift:
            temp, t_count = _compact_left(t, t_alive)
            has_temp = t_count > 0
        else:
            # positional pools keep dead temp entries as NONE holes; a
            # fully-dead pg_temp still overrides (acting = all NONE)
            temp = torch.where(t_alive, t, ITEM_NONE)
            has_temp = n_temp > 0
        tpos = _first_valid(temp != ITEM_NONE)
        temp_primary = torch.where(tpos >= 0, _pick(temp, tpos), -1)
        ptv = state.primary_temp[psi]
        acting_primary = torch.where(
            ptv >= 0, ptv, torch.where(has_temp, temp_primary, up_primary))
        acting = torch.where(has_temp[:, None], temp, up)
        return up, up_primary.to(I32), acting, acting_primary.to(I32)

    return post


def compile_pool_mapping(dense, pool: Pool, rule, mode: str | None = None,
                         device="cuda"):
    """Build the pool mapping program; returns ``(crush_arg, fn)`` with
    ``fn(crush_arg, state, pg_indices) -> (up, up_primary, acting,
    acting_primary)``.

    ``pg_indices`` are folded PG seeds (0..pg_num-1); outputs are
    [n, size] int32 (ITEM_NONE padded) and [n] int32 primaries.  Covers
    the reference pipeline ``_pg_to_raw_osds -> _apply_upmap ->
    _raw_to_up_osds -> _pick_primary -> _apply_primary_affinity ->
    _get_temp_osds`` (upstream ``src/osd/OSDMap.cc``).  The CRUSH stage
    runs on the best tier of :func:`make_batch_runner`.
    """
    crush_arg, crush_fn = make_batch_runner(dense, rule, pool.size, mode, device)
    post = make_post(pool)
    seeds = make_seeds(pool)

    def fn(crush_arg, state: PoolMapState, pg_indices):
        ps, pps = seeds(pg_indices)
        raw, _raw_len = crush_fn(crush_arg, state.osd_weight, pps)
        return post(state, ps, pps, raw)

    return crush_arg, fn


class OSDMapMapping:
    """Precomputed full-map mapping + per-OSD PG counts (reference
    ``OSDMapMapping``), computed on ``device`` (the card by default)."""

    def __init__(self, m: OSDMap, max_items: int = 8, mode: str | None = None,
                 device="cuda"):
        self.osdmap = m
        self.max_items = max_items
        self.mode = mode
        self.device = resolve_device(device)
        self._fns: dict[int, tuple] = {}
        self._results: dict[int, tuple] = {}

    def _fn_for(self, pool: Pool):
        # keyed on everything baked into the program; a mutated crush
        # map or resized/renumbered pool rebuilds instead of serving
        # stale placements
        choose_args = self.osdmap.crush.choose_args_name_for_pool(pool.id)
        fp = (
            pool.pg_num,
            pool.pgp_num,
            pool.size,
            pool.kind,
            pool.crush_rule,
            pool.hashpspool,
            self.osdmap.crush.uid,  # process-unique, never reused
            self.osdmap.crush.version,
            self.osdmap.crush.tunables,
            choose_args,
        )
        cached = self._fns.get(pool.id)
        if cached is None or cached[0] != fp:
            dense = self.osdmap.crush.to_dense(choose_args=choose_args)
            rule = self.osdmap.crush.rules[pool.crush_rule]
            crush_arg, fn = compile_pool_mapping(dense, pool, rule, self.mode,
                                                 self.device)
            cached = (fp, crush_arg, fn)
            self._fns[pool.id] = cached
        return cached[1], cached[2]

    def update(self, pool_id: int | None = None) -> None:
        """Recompute mappings for one pool (or all) on the device."""
        pools = (
            [self.osdmap.pools[pool_id]]
            if pool_id is not None
            else list(self.osdmap.pools.values())
        )
        for pool in pools:
            crush_arg, fn = self._fn_for(pool)
            state = build_pool_state(self.osdmap, pool, self.max_items, self.device)
            pgs = torch.arange(pool.pg_num, dtype=I64, device=self.device)
            up, upp, acting, actp = fn(crush_arg, state, pgs)
            self._results[pool.id] = tuple(
                # torchlint: disable=J003  # the pool's four mapping tables are the result
                t.cpu().numpy() for t in (up, upp, acting, actp))

    def get(self, pgid: PGId):
        up, upp, acting, actp = self._results[pgid.pool]
        row = up[pgid.ps]
        arow = acting[pgid.ps]
        return (
            [int(o) for o in row if o != ITEM_NONE],
            int(upp[pgid.ps]),
            [int(o) for o in arow if o != ITEM_NONE],
            int(actp[pgid.ps]),
        )

    def pg_counts_by_osd(self, pool_id: int, acting: bool = True) -> np.ndarray:
        """PGs-per-OSD histogram for one pool (the balancer's input)."""
        res = self._results[pool_id][2 if acting else 0]
        n_osd = max(self.osdmap.max_osd, 1)
        flat = res.reshape(-1)
        sel = flat[(flat != ITEM_NONE) & (flat >= 0) & (flat < n_osd)]
        return np.bincount(sel, minlength=n_osd)
