"""crush-compat balancer mode: per-device weight-set descent.

Parity with the reference's second balancer mode (upstream
``src/pybind/mgr/balancer/module.py :: do_crush_compat`` over
``CrushWrapper::choose_args``): instead of emitting pg_upmap_items, it
maintains an alternate per-item weight set (the "compat" choose_args)
that placement itself consumes, nudging each device's effective weight
toward its fair PG share.  Old clients that predate pg-upmap support
still see balanced placement because the weight set travels with the
crush map.

Device shape: the reference trial-remaps through its C++ mapper per
iteration; here each iteration is one batch remap per pool on the
mapping's device.  Each weight-set edit bumps ``crush.version``, so the
mapping rebuilds the pool's placement program once per iteration.
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..osdmap.map import OSDMap
from ..osdmap.mapping import OSDMapMapping
from .upmap import expected_pg_share

COMPAT_WEIGHT_SET = "compat"


def _leaf_positions(crush) -> dict[int, tuple[int, int]]:
    """osd id -> (bucket id, index within bucket)."""
    pos: dict[int, tuple[int, int]] = {}
    for bid, b in crush.buckets.items():
        for idx, item in enumerate(b.items):
            if item >= 0:
                pos[item] = (bid, idx)
    return pos


def _propagate_sums(crush, name: str) -> None:
    """Recompute every weight-set entry for bucket children as the sum
    of the child's own weight-set row (straw2 parents select children
    proportionally to these, so sums must stay consistent)."""
    per = crush.choose_args[name]
    memo: dict[int, int] = {}

    def subtree_sum(bid: int) -> int:
        if bid in memo:
            return memo[bid]
        b = crush.buckets[bid]
        row = per[bid]
        total = 0
        for idx, item in enumerate(b.items):
            if item < 0:
                row[idx] = subtree_sum(item)
            total += row[idx]
        memo[bid] = total
        return total

    for bid in crush.buckets:
        subtree_sum(bid)


def do_crush_compat(
    m: OSDMap,
    pools: list[int] | None = None,
    max_iterations: int = 25,
    step: float = 0.5,
    max_deviation: float = 1.0,
    mapping: OSDMapMapping | None = None,
    device="cuda",
) -> bool:
    """Optimize the compat weight set; returns True if it changed.

    Each iteration: remap every pool on the device with the current weight
    set, aggregate per-OSD actual vs fair-share PG counts, move each
    device's weight-set weight a ``step`` fraction toward
    ``actual/target`` correction, re-propagate bucket sums, and keep
    the best state seen (the reference's keep-if-better retry loop).
    The remaps run on ``mapping``'s device; without a ``mapping`` one is
    built on ``device`` (the card by default).
    """
    crush = m.crush
    mapping = mapping or OSDMapMapping(m, device=resolve_device(device))
    pool_ids = pools or sorted(m.pools)
    n_osd = max(m.max_osd, 1)
    created = COMPAT_WEIGHT_SET not in crush.choose_args
    if created:
        crush.create_choose_args(COMPAT_WEIGHT_SET)
    initial = {
        bid: list(row)
        for bid, row in crush.choose_args[COMPAT_WEIGHT_SET].items()
    }
    leaf_pos = _leaf_positions(crush)
    up = np.fromiter((m.is_up(o) for o in range(n_osd)), bool, count=n_osd)

    def measure() -> tuple[np.ndarray, np.ndarray]:
        counts = np.zeros(n_osd, np.float64)
        target = np.zeros(n_osd, np.float64)
        for pid in pool_ids:
            pool = m.pools[pid]
            expect = expected_pg_share(m, pool, n_osd)
            if expect is None:
                continue
            mapping.update(pid)
            counts += mapping.pg_counts_by_osd(pid, acting=False)
            target += expect
        return counts, target

    best_rows: dict[int, list[int]] | None = None
    best_worst = np.inf
    worst = 0.0
    # one extra trip so the last mutation still gets measured
    for it in range(max_iterations + 1):
        counts, target = measure()
        active = (target > 0) & up
        if not active.any():
            break
        dev = counts - target
        worst = float(np.abs(dev[active]).max(initial=0.0))
        if worst < best_worst:
            best_worst = worst
            best_rows = {
                bid: list(row)
                for bid, row in crush.choose_args[COMPAT_WEIGHT_SET].items()
            }
        if worst <= max_deviation or it == max_iterations:
            break
        per = crush.choose_args[COMPAT_WEIGHT_SET]
        for osd in np.nonzero(active)[0]:
            t, a = target[osd], counts[osd]
            ratio = min(t / a, 4.0) if a > 0 else 4.0
            bid, idx = leaf_pos[int(osd)]
            cur = per[bid][idx]
            neww = int(round(cur * (1.0 - step + step * ratio)))
            per[bid][idx] = max(neww, 1)
        _propagate_sums(crush, COMPAT_WEIGHT_SET)
        crush._mutated()

    # the loop always ends on a measured state (mutate -> re-measure),
    # so the last measured worst is the final worst; restore the best
    # state when the descent ended somewhere worse
    if best_rows is not None and worst > best_worst:
        crush.choose_args[COMPAT_WEIGHT_SET] = {
            bid: list(row) for bid, row in best_rows.items()
        }
        crush._mutated()

    changed = crush.choose_args[COMPAT_WEIGHT_SET] != initial
    if created and not changed:
        crush.rm_choose_args(COMPAT_WEIGHT_SET)
    return changed
