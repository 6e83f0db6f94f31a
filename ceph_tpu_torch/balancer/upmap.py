"""Upmap optimizer: deviation-minimizing pg_upmap_items search.

The counterpart of the reference package's ``balancer/upmap.py`` and of
upstream ``OSDMap::calc_pg_upmaps`` (``src/osd/OSDMap.cc``), consumed
there by the mgr balancer module and ``osdmaptool --upmap``: compute
each OSD's expected PG share from CRUSH weights, then greedily move
single replicas from the most-overfull OSD to compatible underfull OSDs
via ``pg_upmap_items``, until the worst deviation is within
``max_deviation`` or no further progress.

Device structure: the full-pool remap (the part the reference runs on
the ``ParallelPGMapper`` threadpool) is one
:meth:`~ceph_tpu_torch.osdmap.mapping.OSDMapMapping.update` on the
mapping's device (the straw2 descent kernel on a card), re-run once per
round with the trial upmap tables as inputs.  Within a round every
(pg, from, to) candidate move out of the overfull OSDs is scored as one
batch of float64/int64 tensor ops on the same device
(:func:`_score_candidate_moves_device`), and the admissible candidates
come back to the host in one copy; the entry GC and the greedy
acceptance against a simulated deviation vector stay host bookkeeping,
so one remap validates many moves.  ``scorer="numpy"`` scores on the
host instead (:func:`_score_candidate_moves_np`, the plain version);
both give the same candidate stream, order included.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..common.log import get_logger
from ..crush.map import ITEM_NONE, CrushMap
from ..osdmap.map import Incremental, OSDMap, PGId, Pool
from ..osdmap.mapping import OSDMapMapping

SCORERS = ("device", "numpy")

_LOG = get_logger("balancer")

# Candidate-scoring truncation bounds: the [R, S, U] broadcasts of the
# scorers would blow past 1 GB unbounded at 10k-OSD/10k-PG scale, so
# rounds keep the worst rows and neediest targets — exactly the moves a
# round would accept anyway.  Module level so tests can shrink them.
MAX_ROWS = 8192
MAX_UNDER = 256

# sentinel failure-domain id for an invalid row slot (matches no real
# domain, including the -1 "unplaced" domain)
_DOM_NONE = np.int64(-(2**31))

#: hierarchy-walk memo for crush_device_weights / failure_domains,
#: keyed per (crush map identity, rule, width): both walks are pure
#: functions of the map revision, and calc_pg_upmaps calls them per
#: pool per invocation — on a 10k-OSD map the recursive Python walk
#: costs more than the device launches it feeds.  crush.uid is
#: process-unique (never reused) and crush.version bumps on every
#: mutation, so a stale hit is impossible.
_HIER_CACHE: dict = {}
_HIER_CACHE_MAX = 256


def _hier_cached(kind: str, crush: CrushMap, rule_id: int, n_osd: int, build):
    key = (kind, crush.uid, crush.version, rule_id, n_osd)
    hit = _HIER_CACHE.get(key)
    if hit is None:
        if len(_HIER_CACHE) >= _HIER_CACHE_MAX:
            _HIER_CACHE.clear()
        hit = _HIER_CACHE[key] = build()
    # callers scale/overwrite the result in place (expected_pg_share's
    # reweight multiply) — hand out a copy, never the cached array
    return hit.copy()


def crush_device_weights(crush: CrushMap, rule_id: int, n_osd: int) -> np.ndarray:
    """Effective CRUSH weight per OSD under the rule's TAKE root.
    Memoized per (map revision, rule, width); returns a fresh copy."""
    return _hier_cached(
        "weights", crush, rule_id, n_osd,
        lambda: _crush_device_weights_walk(crush, rule_id, n_osd),
    )


def _crush_device_weights_walk(
    crush: CrushMap, rule_id: int, n_osd: int
) -> np.ndarray:
    from ..crush.map import OP_TAKE

    rule = crush.rules[rule_id]
    roots = [s.arg1 for s in rule.steps if s.op == OP_TAKE]
    w = np.zeros(n_osd, np.float64)

    def walk(item: int, bucket_weight: int) -> None:
        if item >= 0:
            if item < n_osd:
                w[item] += bucket_weight / 0x10000
            return
        b = crush.buckets[item]
        for it, iw in zip(b.items, b.item_weights):
            walk(it, iw)

    for r in roots:
        walk(r, 0)
    return w


def failure_domains(crush: CrushMap, rule_id: int, n_osd: int) -> np.ndarray:
    """Failure-domain id for each OSD under the rule (its ancestor of
    the rule's chooseleaf/choose type); domain -1 = unplaced.
    Memoized per (map revision, rule, width); returns a fresh copy."""
    return _hier_cached(
        "domains", crush, rule_id, n_osd,
        lambda: _failure_domains_walk(crush, rule_id, n_osd),
    )


def _failure_domains_walk(
    crush: CrushMap, rule_id: int, n_osd: int
) -> np.ndarray:
    from ..crush.map import (
        OP_CHOOSE_FIRSTN,
        OP_CHOOSE_INDEP,
        OP_CHOOSELEAF_FIRSTN,
        OP_CHOOSELEAF_INDEP,
    )

    rule = crush.rules[rule_id]
    fd_type = 0
    for s in rule.steps:
        if s.op in (
            OP_CHOOSE_FIRSTN,
            OP_CHOOSE_INDEP,
            OP_CHOOSELEAF_FIRSTN,
            OP_CHOOSELEAF_INDEP,
        ):
            fd_type = s.arg2
            break
    dom = np.full(n_osd, -1, np.int64)
    if fd_type == 0:
        # failure domain is the device itself
        dom[:] = np.arange(n_osd)
        return dom

    def walk(item: int, current: int) -> None:
        if item >= 0:
            if item < n_osd:
                dom[item] = current
            return
        b = crush.buckets[item]
        nxt = b.id if b.type_id == fd_type else current
        for it in b.items:
            walk(it, nxt)

    for bid, b in crush.buckets.items():
        if crush.parent_of(bid) is None:
            walk(bid, -1)
    return dom


def expected_pg_share(m: OSDMap, pool: Pool, n_osd: int) -> np.ndarray | None:
    """Per-OSD fair share of the pool's PG replicas (crush weight x
    reweight proportional); None if the rule subtree has no weight.
    Shared between the optimizer and the balancer's Eval so they agree
    on what 'balanced' means."""
    cw = crush_device_weights(m.crush, pool.crush_rule, n_osd)
    cw *= np.asarray(m.osd_weight, np.float64)[:n_osd] / 0x10000
    total = cw.sum()
    if total <= 0:
        return None
    return pool.pg_num * pool.size * cw / total


@dataclass
class UpmapRunStats:
    """Device accounting for one calc_pg_upmaps invocation.

    ``mapping_launches`` counts the rounds' pool remaps and
    ``score_launches`` the device scorer's calls (``np_score_calls`` the
    numpy scorer's): with the device scorer every round costs one remap
    plus at most one scoring call (the greedy acceptance and entry GC
    are host bookkeeping), so ``launches_per_round`` is <= 2 whatever
    the map size.  ``candidates_scored`` counts the (pg-row x
    underfull-target) pairs evaluated."""

    rounds: int = 0
    mapping_launches: int = 0
    score_launches: int = 0
    np_score_calls: int = 0
    candidates_scored: int = 0
    pools: int = 0

    @property
    def launches_per_round(self) -> float:
        if self.rounds == 0:
            return 0.0
        return (self.mapping_launches + self.score_launches) / self.rounds

    def as_dict(self) -> dict:
        return {
            "rounds": self.rounds,
            "mapping_launches": self.mapping_launches,
            "score_launches": self.score_launches,
            "np_score_calls": self.np_score_calls,
            "candidates_scored": self.candidates_scored,
            "pools": self.pools,
            "launches_per_round": self.launches_per_round,
        }


#: stats of the most recent calc_pg_upmaps call (benches read this)
LAST_RUN_STATS = UpmapRunStats()


def _candidate_rows(
    up_all: np.ndarray,
    deviation: np.ndarray,
    underfull: np.ndarray,
    n_osd: int,
):
    """Host-side row/target selection shared by both scoring paths:
    picks each PG's most-overfull member, keeps rows with positive
    deviation, and applies the worst-first / neediest-first truncation
    bounds.  This is [P, S] work — trivial next to the [R, S, U]
    scoring broadcasts — and keeping it on the host guarantees the two
    paths score the exact same candidate set in the exact same order."""
    valid = (up_all != ITEM_NONE) & (up_all >= 0) & (up_all < n_osd)
    up_c = np.clip(up_all, 0, n_osd - 1)
    dev_row = np.where(valid, deviation[up_c], -np.inf)  # [P, S]
    frm_slot = dev_row.argmax(axis=1)  # [P]
    rows = np.arange(up_all.shape[0])
    frm = up_c[rows, frm_slot]  # [P]
    frm_dev = dev_row[rows, frm_slot]  # [P]
    r_sel = np.nonzero(frm_dev > 0.0)[0]
    if len(r_sel) == 0 or len(underfull) == 0:
        return valid, up_c, frm, frm_dev, r_sel[:0], underfull[:0]
    if len(r_sel) > MAX_ROWS:
        _LOG.info(
            "candidate truncation: keeping %d of %d overfull PG rows "
            "(worst-first); later rounds revisit the rest",
            MAX_ROWS, len(r_sel),
        )
        worst = np.argsort(-frm_dev[r_sel], kind="stable")[:MAX_ROWS]
        r_sel = r_sel[worst]
    if len(underfull) > MAX_UNDER:
        _LOG.info(
            "candidate truncation: keeping %d of %d underfull targets "
            "(neediest-first)",
            MAX_UNDER, len(underfull),
        )
        neediest = np.argsort(deviation[underfull], kind="stable")[:MAX_UNDER]
        underfull = underfull[neediest]
    return valid, up_c, frm, frm_dev, r_sel, underfull


def _empty_candidates():
    empty = np.empty(0, np.int64)
    return empty.astype(np.float64), empty, empty, empty


def _score_candidate_moves_np(
    up_all: np.ndarray,
    deviation: np.ndarray,
    dom: np.ndarray,
    underfull: np.ndarray,
    max_deviation: float,
    n_osd: int,
    stats: UpmapRunStats | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host numpy scorer of every (pg, from, to) candidate move, the
    plain version of :func:`_score_candidate_moves_device`.

    For each PG row the ``from`` is its most-overfull member (the
    reference empties the most-overfull OSD first); ``to`` ranges over
    all underfull OSDs.  Returns flat arrays (gain, pg, frm, to) of
    admissible candidates, row-major over (worst rows, underfull
    targets), which the caller's stable gain sort depends on; a
    candidate is admissible when

    - the move strictly improves balance (gain = dev[frm]-dev[to] > 1),
    - it addresses an actual violation: frm above +max_deviation or
      to below -max_deviation (both sides count — an OSD stuck 4 PGs
      under its share is as unbalanced as one 4 over),
    - ``to`` is not already in the row, and
    - ``to``'s failure domain differs from ``frm``'s only if it is not
      already used by another member (the reference's domain guard).
    """
    valid, up_c, frm, frm_dev, r_sel, underfull = _candidate_rows(
        up_all, deviation, underfull, n_osd
    )
    if len(r_sel) == 0 or len(underfull) == 0:
        return _empty_candidates()
    if stats is not None:
        stats.np_score_calls += 1
        stats.candidates_scored += len(r_sel) * len(underfull)
    sub_up = up_c[r_sel]  # [R, S]
    sub_valid = valid[r_sel]
    sub_frm = frm[r_sel]  # [R]
    # to already in the row?
    in_row = (
        (sub_up[:, :, None] == underfull[None, None, :]) & sub_valid[:, :, None]
    ).any(axis=1)  # [R, U]
    # failure-domain guard
    row_doms = np.where(sub_valid, dom[sub_up], _DOM_NONE)  # [R, S]
    to_dom = dom[underfull]  # [U]
    dom_used = (row_doms[:, :, None] == to_dom[None, None, :]).any(axis=1)
    dom_conflict = dom_used & (to_dom[None, :] != dom[sub_frm][:, None])
    to_dev = deviation[underfull]  # [U]
    gain = frm_dev[r_sel][:, None] - to_dev[None, :]  # [R, U]
    violates = (frm_dev[r_sel][:, None] > max_deviation) | (
        to_dev[None, :] < -max_deviation
    )
    ok = ~in_row & ~dom_conflict & (gain > 1.0) & violates
    ri, ui = np.nonzero(ok)
    return (
        gain[ri, ui],
        r_sel[ri].astype(np.int64),
        sub_frm[ri].astype(np.int64),
        underfull[ui].astype(np.int64),
    )


def _score_candidate_moves_device(
    up_all: np.ndarray,
    deviation: np.ndarray,
    dom: np.ndarray,
    underfull: np.ndarray,
    max_deviation: float,
    n_osd: int,
    device: torch.device,
    stats: UpmapRunStats | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`_score_candidate_moves_np` with the [R, S, U] in-row and
    failure-domain broadcasts and the [R, U] gain and violation tests as
    tensor ops on ``device``, over the exact ``[n_rows, n_under]`` of the
    round.  Deviations stay float64 and ids int64, so every subtract and
    compare is IEEE-identical to numpy's; ``nonzero`` is row-major, as
    ``np.nonzero`` is, so the candidate stream (order included) is the
    numpy scorer's.  The admissible (gain, flat index) pairs come back
    to the host in one copy."""
    valid, up_c, frm, frm_dev, r_sel, underfull = _candidate_rows(
        up_all, deviation, underfull, n_osd
    )
    n_r, n_u = len(r_sel), len(underfull)
    if n_r == 0 or n_u == 0:
        return _empty_candidates()
    if stats is not None:
        stats.score_launches += 1
        stats.candidates_scored += n_r * n_u

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    sub_up = put(up_c[r_sel], np.int64)  # [R, S]
    sub_valid = put(valid[r_sel], np.bool_)
    sub_frm = put(frm[r_sel], np.int64)  # [R]
    sub_frm_dev = put(frm_dev[r_sel], np.float64)
    under = put(underfull, np.int64)  # [U]
    dev_t = put(deviation, np.float64)  # [N]
    dom_t = put(dom, np.int64)

    to_dev = dev_t[under]
    in_row = (
        (sub_up[:, :, None] == under[None, None, :]) & sub_valid[:, :, None]
    ).any(dim=1)  # [R, U]
    row_doms = torch.where(sub_valid, dom_t[sub_up], int(_DOM_NONE))
    to_dom = dom_t[under]
    dom_used = (row_doms[:, :, None] == to_dom[None, None, :]).any(dim=1)
    dom_conflict = dom_used & (to_dom[None, :] != dom_t[sub_frm][:, None])
    gain = sub_frm_dev[:, None] - to_dev[None, :]  # [R, U] float64
    violates = (sub_frm_dev[:, None] > max_deviation) | (
        to_dev[None, :] < -max_deviation
    )
    ok = ~in_row & ~dom_conflict & (gain > 1.0) & violates
    flat = ok.reshape(-1).nonzero().squeeze(1)  # row-major
    # one copy: the gains' float64 bits beside their flat indices
    picked = torch.stack([gain.reshape(-1)[flat].view(torch.int64), flat])
    host = picked.cpu().numpy()
    ri, ui = np.divmod(host[1], n_u)
    return (
        host[0].view(np.float64),
        r_sel[ri].astype(np.int64),
        frm[r_sel][ri].astype(np.int64),
        underfull[ui].astype(np.int64),
    )


def calc_pg_upmaps(
    m: OSDMap,
    max_deviation: float = 1.0,
    max_entries: int = 100,
    pools: list[int] | None = None,
    mapping: OSDMapMapping | None = None,
    max_rounds: int = 16,
    device="cuda",
    scorer: str = "device",
) -> Incremental:
    """Compute pg_upmap_items moves; returns an Incremental (possibly
    empty).  ``max_deviation`` is in PGs, like the reference's
    ``upmap_max_deviation``.

    The pool remaps run on ``mapping``'s device; without a ``mapping``
    one is built on ``device`` (the card by default, which raises when
    there is none).  ``scorer="device"`` scores candidates on that
    device, ``"numpy"`` on the host; both give the same plan.

    Trial moves are staged in a scratch upmap table on the SAME map
    object (restored on exit), so the already-built pool programs are
    reused — only the upmap input tables change between rounds.  The
    Incremental is diffed from the final validated trial state, so the
    committed epoch always equals what the optimizer scored.
    """
    global LAST_RUN_STATS
    if scorer not in SCORERS:
        raise ValueError(f"scorer {scorer!r} not in {SCORERS}")
    stats = UpmapRunStats()
    inc = Incremental(epoch=m.epoch + 1)
    pool_ids = pools or sorted(m.pools)
    mapping = mapping or OSDMapMapping(m, device=resolve_device(device))
    n_osd = max(m.max_osd, 1)
    entries = 0
    original_items = m.pg_upmap_items

    for pool_id in pool_ids:
        pool = m.pools[pool_id]
        expect = expected_pg_share(m, pool, n_osd)
        if expect is None:
            continue
        cw = crush_device_weights(m.crush, pool.crush_rule, n_osd)
        cw *= np.asarray(m.osd_weight, np.float64)[:n_osd] / 0x10000
        dom = failure_domains(m.crush, pool.crush_rule, n_osd)

        stats.pools += 1
        mapping.update(pool_id)
        base_counts = mapping.pg_counts_by_osd(pool_id, acting=False)

        pool_entries = 0
        pool_removed = 0
        # raw (pre-upmap) rows for every PG carrying entries, computed
        # in ONE batched CRUSH call (raw depends only on crush+weights,
        # constant during this optimization): the GC below simulates
        # _apply_upmap against them
        entry_ps = sorted({
            pg.ps for pg in original_items if pg.pool == pool_id
        })
        raw_rows: dict[int, list[int]] = (
            m.pg_to_raw_osds_batch(pool_id, entry_ps) if entry_ps else {}
        )
        trial_items = dict(original_items)
        m.pg_upmap_items = trial_items  # staged; restored below
        up_vec = np.fromiter(
            (m.is_up(o) for o in range(n_osd)), bool, count=n_osd
        )
        try:
            for _round in range(max_rounds):
                if entries + pool_entries >= max_entries:
                    break
                # ONE remap per round re-maps the whole pool on the
                # mapping's device with the trial upmap tables as inputs
                stats.rounds += 1
                stats.mapping_launches += 1
                mapping.update(pool_id)
                up_all, _, _, _ = mapping._results[pool_id]
                counts = mapping.pg_counts_by_osd(pool_id, acting=False)
                deviation = counts - expect
                # balanced means NO osd beyond +-max_deviation (weightless
                # devices excluded: they cannot receive PGs)
                weighted = cw > 0
                worst = max(
                    float(deviation[weighted].max(initial=0.0)),
                    float(-deviation[weighted & up_vec].min(initial=0.0)),
                )
                if worst <= max_deviation:
                    break
                # --- entry GC first: reverse existing trial entries
                # whose removal now helps balance.  Upmap entries are
                # mon-map state the reference treats as precious
                # (OSDMap::calc_pg_upmaps considers existing items for
                # removal before adding new ones); each reversal here is
                # a free rebalancing move that SHRINKS the table.
                pg_touched: set[int] = set()
                gc_removed = 0

                def _apply_pairs(raw: list[int], items) -> list[int]:
                    """Mirror _apply_upmap's sequential pair semantics:
                    each pair rewrites the first f in the EVOLVING row,
                    skipped when t already present or weight-zero."""
                    row = list(raw)
                    for f2, t in items:
                        if (
                            0 <= t < n_osd
                            and m.osd_weight[t] == 0
                        ):
                            continue
                        if t in row or f2 not in row:
                            continue
                        row[row.index(f2)] = t
                    return row

                for pg in list(trial_items):
                    if pg.pool != pool_id or pg.ps in pg_touched:
                        continue
                    raw = raw_rows.get(pg.ps)
                    if raw is None:  # entry added this call; rare
                        raw = raw_rows[pg.ps] = m.pg_to_raw_osds_batch(
                            pool_id, [pg.ps]
                        )[pg.ps]
                    # _apply_upmap applies pairs ON TOP of a full
                    # pg_upmap override when one is in effect
                    um = m.pg_upmap.get(pg)
                    if um is not None:
                        void = any(
                            0 <= o < n_osd and m.osd_weight[o] == 0
                            for o in um
                            if o != ITEM_NONE
                        )
                        if void:
                            continue  # items blocked entirely; leave
                        raw = list(um)
                    row = up_all[pg.ps]
                    rowv = row[(row != ITEM_NONE) & (row >= 0) & (row < n_osd)]
                    items = list(trial_items[pg])
                    changed = False
                    for idx in range(len(items) - 1, -1, -1):
                        f, t2 = items[idx]
                        if not (0 <= f < n_osd and 0 <= t2 < n_osd):
                            continue
                        # what does removing this pair actually change?
                        # (pairs interact through the evolving row, so
                        # test by re-simulating _apply_upmap)
                        with_pair = _apply_pairs(raw, items)
                        without = _apply_pairs(
                            raw, items[:idx] + items[idx + 1:]
                        )
                        delta = [
                            (a, b)
                            for a, b in zip(with_pair, without)
                            if a != b
                        ]
                        if not delta:
                            # inert entry: drop for free (upstream
                            # clean_pg_upmaps), no deviation change
                            del items[idx]
                            gc_removed += 1
                            changed = True
                            continue
                        if len(delta) != 1:
                            continue  # cascading effect: leave alone
                        lose, gain_o = delta[0]
                        if not (0 <= lose < n_osd and 0 <= gain_o < n_osd):
                            continue
                        # removal moves one replica lose -> gain_o
                        if deviation[lose] - deviation[gain_o] <= 1.0:
                            continue
                        if (
                            deviation[lose] <= max_deviation
                            and deviation[gain_o] >= -max_deviation
                        ):
                            continue
                        if not (up_vec[gain_o] and cw[gain_o] > 0):
                            continue
                        if gain_o in rowv:
                            continue
                        others = rowv[rowv != lose]
                        if dom[gain_o] != -1 and (
                            dom[others] == dom[gain_o]
                        ).any():
                            continue
                        del items[idx]
                        deviation[lose] -= 1.0
                        deviation[gain_o] += 1.0
                        # keep the effective row current for the next
                        # removal's in-row/domain guards on this PG
                        rowv = np.where(rowv == lose, gain_o, rowv)
                        gc_removed += 1
                        changed = True
                    if changed:
                        if items:
                            trial_items[pg] = tuple(items)
                        else:
                            trial_items.pop(pg, None)
                        pg_touched.add(pg.ps)

                under = np.nonzero((deviation < -1e-9) & (cw > 0) & up_vec)[0]
                if len(under) == 0:
                    under = np.nonzero(
                        (deviation < deviation.max() - 1) & (cw > 0) & up_vec
                    )[0]
                if len(under) == 0 and gc_removed == 0:
                    break
                if scorer == "device":
                    # the scored candidates go back to the host, which picks the round's moves
                    # torchlint: disable=J003
                    gains, pgs, frms, tos = _score_candidate_moves_device(
                        up_all, deviation, dom, under, max_deviation, n_osd,
                        mapping.device, stats=stats,
                    )
                else:
                    gains, pgs, frms, tos = _score_candidate_moves_np(
                        up_all, deviation, dom, under, max_deviation, n_osd,
                        stats=stats,
                    )
                if len(gains) == 0 and gc_removed == 0:
                    break
                # Greedy batched acceptance against a simulated deviation
                # vector: each accepted move shifts one PG replica, so
                # dev[frm] -= 1 and dev[to] += 1.  One move per PG per
                # round; a move must still help at acceptance time.
                pool_removed += gc_removed
                order = np.argsort(-gains, kind="stable")
                dev_sim = deviation.copy()
                accepted = gc_removed
                for ci in order:
                    if entries + pool_entries >= max_entries:
                        break
                    ps, frm, to = int(pgs[ci]), int(frms[ci]), int(tos[ci])
                    if ps in pg_touched:
                        continue
                    if dev_sim[frm] - dev_sim[to] <= 1.0:
                        continue  # move no longer helps
                    if (
                        dev_sim[frm] <= max_deviation
                        and dev_sim[to] >= -max_deviation
                    ):
                        continue  # neither side still violates
                    pg = PGId(pool_id, ps)
                    items = list(trial_items.get(pg, ()))
                    if len(items) >= 4:  # keep per-pg item lists short
                        continue
                    # collapse chains: a->b then b->c becomes a->c
                    for idx, (f0, t0) in enumerate(items):
                        if t0 == frm:
                            items[idx] = (f0, to)
                            break
                    else:
                        items.append((frm, to))
                    items = [(f, t) for f, t in items if f != t]
                    if items:
                        trial_items[pg] = tuple(items)
                    else:
                        trial_items.pop(pg, None)
                    pg_touched.add(ps)
                    dev_sim[frm] -= 1.0
                    dev_sim[to] += 1.0
                    pool_entries += 1
                    accepted += 1
                if accepted == 0:
                    break

            # validation: trial deviation must not be worse than base
            mapping.update(pool_id)
            final_counts = mapping.pg_counts_by_osd(pool_id, acting=False)
        finally:
            m.pg_upmap_items = original_items
            mapping.update(pool_id)  # restore cached results to reality

        if pool_entries == 0 and pool_removed == 0:
            continue
        if np.abs(final_counts - expect).max() > np.abs(
            base_counts - expect
        ).max():
            continue  # reject this pool's moves wholesale
        entries += pool_entries
        # diff trial vs live state for this pool only; sorted so the
        # incremental's entry order is rank- and hashseed-identical
        for pg in sorted(set(trial_items) | set(original_items)):
            if pg.pool != pool_id:
                continue
            new = trial_items.get(pg)
            old = original_items.get(pg)
            if new == old:
                continue
            if new:
                inc.new_pg_upmap_items[pg] = new
            else:
                inc.old_pg_upmap_items.append(pg)
    LAST_RUN_STATS = stats
    return inc
