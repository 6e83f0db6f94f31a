"""Balancer module: evaluation + optimize/execute loop.

Parity with the reference's mgr balancer
(``src/pybind/mgr/balancer/module.py`` :: ``Module.serve`` /
``Eval`` / ``optimize`` / ``do_upmap`` / ``execute``), minus the mgr
daemon plumbing: the caller owns the tick loop; ``optimize`` returns a
plan (an Incremental), ``execute`` commits it as a new epoch.  The
balancer's mapping, and with it every remap and the upmap scorer, runs
on ``device`` (the card by default; ``device="cpu"`` runs the plain
versions).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..osdmap.map import Incremental, OSDMap
from ..osdmap.mapping import OSDMapMapping
from .crush_compat import do_crush_compat
from .upmap import calc_pg_upmaps, crush_device_weights, expected_pg_share


@dataclass
class Eval:
    """Distribution quality of a map (reference balancer ``Eval``)."""

    pool_scores: dict[int, float] = field(default_factory=dict)
    pool_stddev: dict[int, float] = field(default_factory=dict)
    pool_max_deviation: dict[int, float] = field(default_factory=dict)

    @property
    def score(self) -> float:
        """0 = perfectly balanced; higher = worse."""
        if not self.pool_scores:
            return 0.0
        return float(np.mean(list(self.pool_scores.values())))


class Balancer:
    def __init__(
        self,
        osdmap: OSDMap,
        mode: str = "upmap",
        max_deviation: float = 1.0,
        max_optimizations: int = 100,
        device="cuda",
    ):
        if mode not in ("upmap", "crush-compat"):
            raise ValueError(
                f"mode {mode!r} not supported (upmap / crush-compat)"
            )
        self.osdmap = osdmap
        self.mode = mode
        self.max_deviation = max_deviation
        self.max_optimizations = max_optimizations
        self.mapping = OSDMapMapping(osdmap, device=device)

    def evaluate(self, pools: list[int] | None = None) -> Eval:
        ev = Eval()
        n_osd = max(self.osdmap.max_osd, 1)
        for pool_id in pools or sorted(self.osdmap.pools):
            pool = self.osdmap.pools[pool_id]
            self.mapping.update(pool_id)
            counts = self.mapping.pg_counts_by_osd(pool_id, acting=False)
            expect = expected_pg_share(self.osdmap, pool, n_osd)
            if expect is None:
                continue
            cw = crush_device_weights(
                self.osdmap.crush, pool.crush_rule, n_osd
            )
            cw *= np.asarray(self.osdmap.osd_weight, np.float64)[:n_osd] / 0x10000
            active = cw > 0
            dev = counts[active] - expect[active]
            ev.pool_stddev[pool_id] = float(dev.std())
            ev.pool_max_deviation[pool_id] = float(np.abs(dev).max())
            # reference-style score: normalized sum of squared deviation
            denom = max(expect[active].sum(), 1.0)
            ev.pool_scores[pool_id] = float((dev**2).sum() / denom)
        return ev

    def optimize(self, pools: list[int] | None = None) -> Incremental:
        """One balancing step (upmap mode); empty Incremental means
        balanced."""
        if self.mode != "upmap":
            raise ValueError("optimize() returns a plan only in upmap "
                             "mode; use tick() for crush-compat")
        return calc_pg_upmaps(
            self.osdmap,
            max_deviation=self.max_deviation,
            max_entries=self.max_optimizations,
            pools=pools,
            mapping=self.mapping,
        )

    def execute(self, plan: Incremental) -> bool:
        """Commit the plan as a new epoch; False if it was empty."""
        if not (plan.new_pg_upmap_items or plan.old_pg_upmap_items
                or plan.new_pg_upmap or plan.old_pg_upmap):
            return False
        self.osdmap.apply_incremental(plan)
        return True

    def tick(self, pools: list[int] | None = None) -> bool:
        """One serve-loop iteration: optimize + execute.

        upmap mode emits pg_upmap_items through an Incremental;
        crush-compat mode descends the compat choose_args weight set
        (placement consumes it directly) and bumps the epoch when it
        changed — the reference commits the same two ways
        (``do_upmap`` vs ``do_crush_compat``).
        """
        if self.mode == "crush-compat":
            changed = do_crush_compat(
                self.osdmap,
                pools=pools,
                max_deviation=self.max_deviation,
                mapping=self.mapping,
            )
            if changed:
                self.osdmap.epoch += 1
            return changed
        return self.execute(self.optimize(pools))
