"""Epoch-versioned cluster map: the OSDMap-parity layer.

Semantically equivalent to the reference's ``src/osd/OSDMap.{h,cc}``
object->PG->OSD pipeline (``object_locator_to_pg``, ``raw_pg_to_pg``,
``pg_pool_t::raw_pg_to_pps``, ``_pg_to_raw_osds``, ``_apply_upmap``,
``_raw_to_up_osds``, ``_pick_primary``, ``_apply_primary_affinity``,
``_get_temp_osds``, ``pg_to_up_acting_osds``) and its
``OSDMap::Incremental`` epoch deltas, re-designed for a device pipeline:
the mutable Python model here is the *control plane*; placement math is
compiled to dense arrays and executed as whole-batch tensor programs
(:mod:`ceph_tpu_torch.osdmap.mapping`).

This module also carries the exact scalar host pipeline (ground truth
for differential tests; the CRUSH step itself delegates to the C++ CPU
reference tier in :mod:`ceph_tpu_torch.testing.cppref` or to the Python
oracle).

Spec provenance: SURVEY.md §2.1 item 8-9.  All weights are 16.16 fixed
point u32 (0x10000 == 1.0); ``osd_weight`` is the in/out reweight
vector, distinct from CRUSH bucket weights.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field, asdict
from typing import NamedTuple

import numpy as np

from ..core import ref
from ..crush.map import CrushMap, ITEM_NONE

# osd_state bits (reference: CEPH_OSD_EXISTS / CEPH_OSD_UP)
EXISTS = 1
UP = 2

MAX_PRIMARY_AFFINITY = 0x10000
DEFAULT_PRIMARY_AFFINITY = 0x10000


class PGId(NamedTuple):
    """(pool, seed) placement-group id — reference ``pg_t``."""

    pool: int
    ps: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.ps:x}"


@dataclass
class Pool:
    """Reference ``pg_pool_t`` subset relevant to placement."""

    id: int
    name: str
    kind: str = "replicated"  # "replicated" | "erasure"
    size: int = 3
    min_size: int = 2
    pg_num: int = 32
    pgp_num: int = 32
    crush_rule: int = 0
    hashpspool: bool = True
    # reference pg_pool_t::object_hash (CEPH_STR_HASH_RJENKINS = 0x2
    # default; CEPH_STR_HASH_LINUX = 0x1 selectable)
    object_hash: int = 2
    # erasure pools carry their profile name (the EC registry)
    erasure_code_profile: str = ""

    @property
    def pg_num_mask(self) -> int:
        return ref.pg_num_mask(self.pg_num)

    @property
    def pgp_num_mask(self) -> int:
        return ref.pg_num_mask(self.pgp_num)

    def can_shift_osds(self) -> bool:
        """Replicated pools compact holes; EC pools are positional."""
        return self.kind == "replicated"

    def raw_pg_to_pg(self, ps: int) -> int:
        """Fold a raw hash seed onto an actual PG (stable-mod bucketing)."""
        return ref.ceph_stable_mod(ps, self.pg_num, self.pg_num_mask)

    def raw_pg_to_pps(self, ps: int) -> int:
        """PG -> placement seed fed to CRUSH (pool-salted when hashpspool)."""
        folded = ref.ceph_stable_mod(ps, self.pgp_num, self.pgp_num_mask)
        if self.hashpspool:
            return ref.crush_hash32_2(folded, self.id)
        return (folded + self.id) & 0xFFFFFFFF


class OSDMap:
    """Mutable epoch-versioned cluster map (control plane)."""

    def __init__(self, crush: CrushMap | None = None, epoch: int = 1):
        self.epoch = epoch
        self.crush = crush or CrushMap()
        self.max_osd = 0
        self.osd_state: list[int] = []  # EXISTS|UP bits
        self.osd_weight: list[int] = []  # 16.16 in/out reweight
        self.osd_primary_affinity: list[int] = []
        self.pools: dict[int, Pool] = {}
        # pg_upmap: full explicit mapping override per PG
        self.pg_upmap: dict[PGId, tuple[int, ...]] = {}
        # pg_upmap_items: pairwise (from, to) rewrites per PG
        self.pg_upmap_items: dict[PGId, tuple[tuple[int, int], ...]] = {}
        # recovery-time overrides
        self.pg_temp: dict[PGId, tuple[int, ...]] = {}
        self.primary_temp: dict[PGId, int] = {}

    # ---- osd lifecycle ----

    def set_max_osd(self, n: int) -> None:
        while self.max_osd < n:
            self.osd_state.append(0)
            self.osd_weight.append(0)
            self.osd_primary_affinity.append(DEFAULT_PRIMARY_AFFINITY)
            self.max_osd += 1
        del self.osd_state[n:]
        del self.osd_weight[n:]
        del self.osd_primary_affinity[n:]
        self.max_osd = n

    def add_osd(self, osd: int, weight: int = 0x10000, up: bool = True) -> None:
        if osd >= self.max_osd:
            self.set_max_osd(osd + 1)
        self.osd_state[osd] = EXISTS | (UP if up else 0)
        self.osd_weight[osd] = int(weight)

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and bool(self.osd_state[osd] & EXISTS)

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and bool(self.osd_state[osd] & UP)

    def is_out(self, osd: int) -> bool:
        return not (0 <= osd < self.max_osd) or self.osd_weight[osd] == 0

    def mark_down(self, osd: int) -> None:
        self.osd_state[osd] &= ~UP

    def mark_up(self, osd: int) -> None:
        self.osd_state[osd] |= UP

    def mark_out(self, osd: int) -> None:
        self.osd_weight[osd] = 0

    def mark_in(self, osd: int, weight: int = 0x10000) -> None:
        self.osd_weight[osd] = int(weight)

    # ---- pools ----

    def add_pool(self, pool: Pool) -> Pool:
        if pool.id in self.pools:
            raise ValueError(f"pool {pool.id} exists")
        self.pools[pool.id] = pool
        return pool

    def pool_by_name(self, name: str) -> Pool:
        for p in self.pools.values():
            if p.name == name:
                return p
        raise KeyError(name)

    # ---- object -> PG ----

    def object_locator_to_pg(self, name: str | bytes, pool_id: int) -> PGId:
        """Object name -> raw PG (pre-fold).  Reference
        ``OSDMap::object_locator_to_pg``; hashes with the pool's
        ``object_hash`` algorithm (rjenkins default, linux)."""
        if isinstance(name, str):
            name = name.encode()
        pool = self.pools.get(pool_id)
        alg = pool.object_hash if pool is not None else ref.CEPH_STR_HASH_RJENKINS
        ps = ref.ceph_str_hash(alg, name)
        return PGId(pool_id, ps)

    def raw_pg_to_pg(self, pgid: PGId) -> PGId:
        pool = self.pools[pgid.pool]
        return PGId(pgid.pool, pool.raw_pg_to_pg(pgid.ps))

    # ---- PG -> OSDs (exact scalar host pipeline) ----

    def _pg_to_raw_osds(self, pool: Pool, pgid: PGId) -> tuple[list[int], int]:
        """CRUSH placement for one (folded) PG; returns (raw, pps)."""
        pps = pool.raw_pg_to_pps(pgid.ps)
        raw = self._crush_do_rule(pool, pps)
        return raw, pps

    def _crush_do_rule(self, pool: Pool, pps: int) -> list[int]:
        return self._crush_do_rule_batch(pool, [pps])[0]

    def _crush_do_rule_batch(
        self, pool: Pool, pps_list: list[int]
    ) -> list[list[int]]:
        """CRUSH placement for many pps seeds on the exact C++ tier —
        the one source of raw rows for the scalar pipeline AND bulk
        consumers (the upmap GC), so cached rows can never mix
        engines."""
        from ..testing import cppref

        rule = self.crush.rules[pool.crush_rule]
        dense = self.crush.to_dense(
            choose_args=self.crush.choose_args_name_for_pool(pool.id)
        )
        steps = [(s.op, s.arg1, s.arg2) for s in rule.steps]
        wfull = np.zeros(max(dense.max_devices, self.max_osd), np.uint32)
        wfull[: self.max_osd] = self.osd_weight
        res, lens = cppref.do_rule_batch(
            dense, steps, np.asarray(pps_list, np.uint32), wfull, pool.size
        )
        return [
            [int(o) for o in res[i, : lens[i]]]
            for i in range(len(pps_list))
        ]

    def pg_to_raw_osds_batch(
        self, pool_id: int, ps_list: list[int]
    ) -> dict[int, list[int]]:
        """Pre-upmap raw rows for many folded PG seeds (reference
        ``_pg_to_raw_osds`` without the per-PG loop)."""
        pool = self.pools[pool_id]
        rows = self._crush_do_rule_batch(
            pool, [pool.raw_pg_to_pps(ps) for ps in ps_list]
        )
        return dict(zip(ps_list, rows))

    def _upmap_target_out(self, osd: int) -> bool:
        """Reference ``_apply_upmap`` target test: only in-range,
        zero-weight targets void/skip; out-of-range ids pass through
        (they are dropped later by the up-set existence filter)."""
        return (
            osd != ITEM_NONE
            and 0 <= osd < self.max_osd
            and self.osd_weight[osd] == 0
        )

    def _apply_upmap(self, pool: Pool, pgid: PGId, raw: list[int]) -> list[int]:
        pg = self.raw_pg_to_pg(pgid)
        um = self.pg_upmap.get(pg)
        if um:
            for osd in um:
                if self._upmap_target_out(osd):
                    # any out target rejects the explicit mapping outright
                    # (items are NOT applied either — reference returns here)
                    return raw
            raw = list(um)
            # fall through: pg_upmap_items still apply on top of pg_upmap
        items = self.pg_upmap_items.get(pg)
        if items:
            raw = list(raw)
            for frm, to in items:
                if self._upmap_target_out(to):
                    continue
                # reference guard: never rewrite when the replacement
                # target already appears in the raw set (would place two
                # replicas of the PG on one OSD)
                pos = -1
                exists = False
                for i, osd in enumerate(raw):
                    if osd == to:
                        exists = True
                        break
                    if pos < 0 and osd == frm:
                        pos = i
                if not exists and pos >= 0:
                    raw[pos] = to
        return raw

    def _raw_to_up_osds(self, pool: Pool, raw: list[int]) -> list[int]:
        if pool.can_shift_osds():
            return [o for o in raw if o != ITEM_NONE and self.is_up(o)]
        return [
            o if (o != ITEM_NONE and self.is_up(o)) else ITEM_NONE for o in raw
        ]

    @staticmethod
    def _pick_primary(osds: list[int]) -> int:
        for o in osds:
            if o != ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(
        self, pps: int, osds: list[int], primary: int
    ) -> int:
        """Deterministic proportional primary re-pick (reference
        ``_apply_primary_affinity``): each candidate o is skipped with
        probability 1 - affinity[o], drawn from hash(pps, o)."""
        if all(
            o == ITEM_NONE
            or self.osd_primary_affinity[o] == DEFAULT_PRIMARY_AFFINITY
            for o in osds
        ):
            return primary
        pos = -1
        for i, o in enumerate(osds):
            if o == ITEM_NONE:
                continue
            a = self.osd_primary_affinity[o]
            if a < MAX_PRIMARY_AFFINITY and (
                (ref.crush_hash32_2(pps, o) >> 16) >= a
            ):
                if pos < 0:
                    pos = i  # fallback if everyone declines
                continue
            pos = i
            break
        if pos < 0:
            return primary
        return osds[pos]

    def _get_temp_osds(self, pool: Pool, pgid: PGId) -> tuple[list[int], int]:
        pg = self.raw_pg_to_pg(pgid)
        temp: list[int] = []
        for o in self.pg_temp.get(pg, ()):
            if not self.exists(o) or not self.is_up(o):
                if pool.can_shift_osds():
                    continue
                temp.append(ITEM_NONE)
            else:
                temp.append(o)
        tp = self.primary_temp.get(pg, -1)
        if tp < 0 and temp:
            tp = self._pick_primary(temp)
        return temp, tp

    def pg_to_up_acting_osds(
        self, pgid: PGId
    ) -> tuple[list[int], int, list[int], int]:
        """Full pipeline: returns (up, up_primary, acting, acting_primary)."""
        pool = self.pools[pgid.pool]
        raw, pps = self._pg_to_raw_osds(pool, pgid)
        raw = self._apply_upmap(pool, pgid, raw)
        up = self._raw_to_up_osds(pool, raw)
        up_primary = self._pick_primary(up)
        up_primary = self._apply_primary_affinity(pps, up, up_primary)
        acting, acting_primary = self._get_temp_osds(pool, pgid)
        if not acting:
            acting = list(up)
            if acting_primary < 0:  # a bare primary_temp is still honored
                acting_primary = up_primary
        elif acting_primary < 0:
            acting_primary = self._pick_primary(acting)
        return up, up_primary, acting, acting_primary

    def map_object(self, name: str | bytes, pool_id: int):
        pgid = self.raw_pg_to_pg(self.object_locator_to_pg(name, pool_id))
        return self.pg_to_up_acting_osds(pgid)

    # ---- epochs ----

    def apply_incremental(self, inc: "Incremental") -> None:
        if inc.epoch != self.epoch + 1:
            raise ValueError(f"incremental {inc.epoch} != epoch {self.epoch}+1")
        self.epoch = inc.epoch
        if inc.new_max_osd is not None:
            self.set_max_osd(inc.new_max_osd)
        for osd, w in inc.new_weight.items():
            self.osd_weight[osd] = w
        for osd, st in inc.new_state.items():
            self.osd_state[osd] ^= st  # xor like the reference's state deltas
        for osd, a in inc.new_primary_affinity.items():
            self.osd_primary_affinity[osd] = a
        for pg, um in inc.new_pg_upmap.items():
            self.pg_upmap[pg] = tuple(um)
        for pg in inc.old_pg_upmap:
            self.pg_upmap.pop(pg, None)
        for pg, items in inc.new_pg_upmap_items.items():
            self.pg_upmap_items[pg] = tuple(tuple(p) for p in items)
        for pg in inc.old_pg_upmap_items:
            self.pg_upmap_items.pop(pg, None)
        for pg, t in inc.new_pg_temp.items():
            if t:
                self.pg_temp[pg] = tuple(t)
            else:
                self.pg_temp.pop(pg, None)
        for pg, p in inc.new_primary_temp.items():
            if p >= 0:
                self.primary_temp[pg] = p
            else:
                self.primary_temp.pop(pg, None)
        for pool in inc.new_pools.values():
            self.pools[pool.id] = copy.deepcopy(pool)

    def clone(self) -> "OSDMap":
        return copy.deepcopy(self)

    # ---- serialization (framework-native versioned JSON) ----

    def to_obj(self) -> dict:
        return {
            "version": 1,
            "epoch": self.epoch,
            "crush": self.crush.to_obj(),
            "max_osd": self.max_osd,
            "osd_state": list(self.osd_state),
            "osd_weight": list(self.osd_weight),
            "osd_primary_affinity": list(self.osd_primary_affinity),
            "pools": {str(k): asdict(v) for k, v in self.pools.items()},
            "pg_upmap": [[list(k), list(v)] for k, v in self.pg_upmap.items()],
            "pg_upmap_items": [
                [list(k), [list(p) for p in v]]
                for k, v in self.pg_upmap_items.items()
            ],
            "pg_temp": [[list(k), list(v)] for k, v in self.pg_temp.items()],
            "primary_temp": [
                [list(k), v] for k, v in self.primary_temp.items()
            ],
        }

    def encode(self) -> bytes:
        return json.dumps(self.to_obj(), sort_keys=True).encode()

    @staticmethod
    def from_obj(obj: dict) -> "OSDMap":
        m = OSDMap(CrushMap.from_obj(obj["crush"]), epoch=obj["epoch"])
        m.max_osd = obj["max_osd"]
        m.osd_state = list(obj["osd_state"])
        m.osd_weight = list(obj["osd_weight"])
        m.osd_primary_affinity = list(obj["osd_primary_affinity"])
        m.pools = {int(k): Pool(**v) for k, v in obj["pools"].items()}
        m.pg_upmap = {PGId(*k): tuple(v) for k, v in obj["pg_upmap"]}
        m.pg_upmap_items = {
            PGId(*k): tuple(tuple(p) for p in v)
            for k, v in obj["pg_upmap_items"]
        }
        m.pg_temp = {PGId(*k): tuple(v) for k, v in obj["pg_temp"]}
        m.primary_temp = {PGId(*k): v for k, v in obj["primary_temp"]}
        return m

    @staticmethod
    def decode(data: bytes) -> "OSDMap":
        return OSDMap.from_obj(json.loads(data.decode()))


@dataclass
class Incremental:
    """Epoch delta — reference ``OSDMap::Incremental``."""

    epoch: int
    new_max_osd: int | None = None
    new_weight: dict[int, int] = field(default_factory=dict)
    new_state: dict[int, int] = field(default_factory=dict)  # xor masks
    new_primary_affinity: dict[int, int] = field(default_factory=dict)
    new_pg_upmap: dict[PGId, tuple[int, ...]] = field(default_factory=dict)
    old_pg_upmap: list[PGId] = field(default_factory=list)
    new_pg_upmap_items: dict[PGId, tuple[tuple[int, int], ...]] = field(
        default_factory=dict
    )
    old_pg_upmap_items: list[PGId] = field(default_factory=list)
    new_pg_temp: dict[PGId, tuple[int, ...]] = field(default_factory=dict)
    new_primary_temp: dict[PGId, int] = field(default_factory=dict)
    new_pools: dict[int, Pool] = field(default_factory=dict)
