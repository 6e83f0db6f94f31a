"""Whole-cluster peering pass: epoch diff -> per-PG state, on the device.

The counterpart of the reference package's ``recovery/peering.py``, a
replacement for upstream's per-PG peering state machine
(``src/osd/PeeringState.cc``): where upstream walks every PG through an
event-driven FSM (AdvMap -> Reset -> Peering -> Active...), here the
*entire pool* is classified at once — the mapping program
(:func:`ceph_tpu_torch.osdmap.mapping.compile_pool_mapping`) computes
up/acting for the previous and current epochs as two
:class:`~ceph_tpu_torch.osdmap.mapping.PoolMapState` evaluations of the
SAME program, and a batched classifier diffs the two epochs per PG.

State flags (subset of upstream's ``pg_state_t`` relevant to
placement/recovery):

- ``PG_STATE_DEGRADED``   — fewer than ``pool.size`` slots still hold
  their data: a slot is a *survivor* only if it is alive AND mapped to
  the same OSD as the previous epoch.  This covers both failure modes:
  a down-but-in OSD leaves a hole in acting, and a down+out OSD gets
  CRUSH-remapped to a fresh (empty) OSD — either way the shard's bytes
  are gone from where they should be.
- ``PG_STATE_UNDERSIZED`` — acting set has actual holes (fewer live
  members than ``pool.size``).
- ``PG_STATE_INACTIVE``   — live members below ``pool.min_size``; the
  PG could not serve I/O.
- ``PG_STATE_REMAPPED``   — up != acting (a temp mapping is steering
  I/O away from the CRUSH placement).
- ``PG_STATE_BACKFILL``   — the up set contains members that were not
  in the previous epoch's acting set: they hold no data yet and need a
  copy (upstream's backfill reservation trigger).
- ``PG_STATE_CLEAN``      — none of the above.

The classifier also emits, per PG, the **survivor bitmask**: bit ``s``
is set iff acting slot ``s`` is alive AND holds the same OSD as the
previous epoch (a freshly remapped slot is not a survivor even though
it is alive).  For EC pools (positional slots == shard ids) this mask
IS the erasure pattern the repair planner groups by
(:mod:`ceph_tpu_torch.recovery.planner`).  On the device it rides in
int64 (CPU PyTorch has no u32 shifts); the host result is u32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..crush.map import ITEM_NONE
from ..osdmap.map import OSDMap
from ..osdmap.mapping import PoolMapState, build_pool_state, compile_pool_mapping

PG_STATE_CLEAN = 1
PG_STATE_REMAPPED = 2
PG_STATE_DEGRADED = 4
PG_STATE_UNDERSIZED = 8
PG_STATE_BACKFILL = 16
PG_STATE_INACTIVE = 32
# data-integrity flags: not emitted by the device classifier (only a
# scrubber can see shard BYTES); kept so flag sets render alike
PG_STATE_INCONSISTENT = 64
PG_STATE_SCRUBBING = 128

FLAG_NAMES = {
    PG_STATE_CLEAN: "clean",
    PG_STATE_REMAPPED: "remapped",
    PG_STATE_DEGRADED: "degraded",
    PG_STATE_UNDERSIZED: "undersized",
    PG_STATE_BACKFILL: "backfill",
    PG_STATE_INACTIVE: "inactive",
    PG_STATE_INCONSISTENT: "inconsistent",
    PG_STATE_SCRUBBING: "scrubbing",
}

I32 = torch.int32
I64 = torch.int64


def classify_rows(prev_acting, up, acting, min_size: int):
    """Per-PG state flags + survivor bitmask over the whole pool.

    Inputs are ``[pg_num, size]`` int32 tensors (ITEM_NONE holes) and
    the pool's ``min_size``.  Returns (flags [pg] int32, survivor_mask
    [pg] int64, n_alive [pg] int32).
    """
    size = acting.shape[1]
    alive = acting != ITEM_NONE
    n_alive = alive.sum(dim=1, dtype=I32)
    # survivor: slot alive and unchanged since the previous epoch (a
    # remap target is alive but holds no data yet)
    survivor = alive & (acting == prev_acting)
    degraded = survivor.sum(dim=1) < size
    undersized = n_alive < size
    inactive = n_alive < min_size
    remapped = (up != acting).any(dim=1)
    # membership test: an up member present anywhere in prev acting
    in_prev = (up[:, :, None] == prev_acting[:, None, :]).any(dim=2)
    backfill = ((up != ITEM_NONE) & ~in_prev).any(dim=1)
    weights = torch.ones(size, dtype=I64, device=acting.device) << torch.arange(
        size, dtype=I64, device=acting.device)
    mask = (survivor.to(I64) * weights).sum(dim=1)
    flags = (remapped.to(I32) * PG_STATE_REMAPPED
             | degraded.to(I32) * PG_STATE_DEGRADED
             | undersized.to(I32) * PG_STATE_UNDERSIZED
             | backfill.to(I32) * PG_STATE_BACKFILL
             | inactive.to(I32) * PG_STATE_INACTIVE)
    flags = torch.where(flags == 0, PG_STATE_CLEAN, flags).to(I32)
    return flags, mask, n_alive


@dataclass
class PeeringResult:
    """One pool's whole-cluster peering pass output (host arrays).

    The classifier outputs also ride along as device tensors (``dev_*``)
    so a device consumer can take them without a host->device upload;
    host-array consumers are unaffected.
    """

    pool_id: int
    epoch_prev: int
    epoch_cur: int
    size: int
    min_size: int
    up: np.ndarray  # [pg, size] i32, ITEM_NONE holes
    up_primary: np.ndarray  # [pg] i32
    acting: np.ndarray  # [pg, size] i32
    acting_primary: np.ndarray  # [pg] i32
    prev_acting: np.ndarray  # [pg, size] i32
    flags: np.ndarray  # [pg] i32 (PG_STATE_* bits)
    survivor_mask: np.ndarray  # [pg] u32 (bit s = shard s data survived)
    n_alive: np.ndarray  # [pg] i32
    # device twins of the classifier outputs
    dev_survivor_mask: object = None  # [pg] int64 tensor
    dev_n_alive: object = None  # [pg] int32 tensor
    dev_acting_primary: object = None  # [pg] int32 tensor

    @property
    def pg_num(self) -> int:
        return len(self.flags)

    def pgs_with(self, flag: int) -> np.ndarray:
        """PG seeds carrying a state flag."""
        return np.nonzero((self.flags & flag) != 0)[0]

    def counts(self) -> dict[str, int]:
        """Flag -> PG count (the ``ceph status`` PG summary analog)."""
        out = {name: int(((self.flags & bit) != 0).sum())
               for bit, name in FLAG_NAMES.items()}
        out["total"] = self.pg_num
        return out

    def n_survivors(self) -> np.ndarray:
        """Per-PG surviving-shard count (survivor_mask popcount)."""
        v = self.survivor_mask.astype(np.uint32)
        return sum(((v >> s) & 1).astype(np.int64) for s in range(self.size))

    def degraded_shards(self) -> int:
        """Total lost shard-slots across degraded PGs (the numerator of
        upstream's degraded-object ratio, in shard units)."""
        deg = (self.flags & PG_STATE_DEGRADED) != 0
        return int((self.size - self.n_survivors()[deg]).sum())

    def peer_counts(self, n_osds: int) -> np.ndarray:
        """Per-OSD count of distinct co-serving peers ([n_osds] i32):
        OSDs that share at least one acting set.  This is the failure-
        reporter pool the liveness detector consults — only heartbeat
        peers can report an OSD down, so an OSD nobody co-serves with
        can never collect ``mon_osd_min_down_reporters`` reports."""
        adj = np.zeros((n_osds, n_osds), bool)
        act = self.acting
        for i in range(self.size):
            a = act[:, i]
            av = a != ITEM_NONE
            for j in range(self.size):
                if i == j:
                    continue
                b = act[:, j]
                both = av & (b != ITEM_NONE)
                adj[a[both], b[both]] = True
        return adj.sum(axis=1).astype(np.int32)


def _host(t: torch.Tensor, dtype=None) -> np.ndarray:
    a = t.cpu().numpy()
    return a if dtype is None else a.astype(dtype)


class PeeringEngine:
    """Peering pass for one pool on one device.

    Holds the pool's mapping program; :meth:`run` evaluates it for two
    :class:`PoolMapState` epochs and classifies the diff.  All dynamic
    state is data, so any number of trial epochs (the fault injector's
    output, balancer what-ifs) reuse the same program.

    By default :meth:`run` is the fused placement->peering program of
    :mod:`ceph_tpu_torch.recovery.pipeline` (cached per program key): on
    the card one CUDA graph replay, captured on the key's first call, on
    the CPU the same program run eagerly.  Maps on the host C++ CRUSH
    tier, and runs under ``CEPH_TPU_FUSED_PIPELINE=0``, take the staged
    pass (:meth:`run_staged`: map the previous epoch, map the current
    one, classify the diff, each retry round a host read); both give the
    same result bit for bit (``tests/test_torch_pipeline.py``).
    """

    def __init__(self, m: OSDMap, pool_id: int, mode: str | None = None, device="cuda"):
        from . import pipeline

        self.osdmap = m
        self.pool = m.pools[pool_id]
        self.device = resolve_device(device)
        choose_args = m.crush.choose_args_name_for_pool(pool_id)
        dense = m.crush.to_dense(choose_args=choose_args)
        rule = m.crush.rules[self.pool.crush_rule]
        self._crush_arg, self._fn = compile_pool_mapping(
            dense, self.pool, rule, mode, self.device
        )
        self._fused_arg, self._fused = pipeline.compile_fused_peering(
            dense, self.pool, rule, mode=mode, device=self.device)
        self._pgs = torch.arange(self.pool.pg_num, dtype=I64, device=self.device)

    def map_epoch(self, state: PoolMapState):
        """(up, up_primary, acting, acting_primary) for one epoch's
        dynamic state, as device tensors."""
        return self._fn(self._crush_arg, state, self._pgs)

    def repeer(
        self,
        prev_result: PeeringResult,
        state_prev: PoolMapState,
        state_cur: PoolMapState,
        epoch_cur: int = 0,
    ) -> tuple[PeeringResult, np.ndarray]:
        """Incremental re-peer after a mid-flight epoch advance.

        Returns ``(result, changed_pgs)`` where ``changed_pgs`` are the
        PG seeds whose up/acting/survivor state differs from
        ``prev_result`` — the only PGs a mid-flight re-plan needs to
        touch (:func:`ceph_tpu_torch.recovery.planner.invalidated_groups`).
        The device pass stays full-width (the same program as
        :meth:`run`); the epoch delta is extracted host-side by diffing
        against the previous result.
        """
        result = self.run(
            state_prev, state_cur,
            epoch_prev=prev_result.epoch_prev, epoch_cur=epoch_cur,
        )
        changed = np.nonzero(
            np.any(result.acting != prev_result.acting, axis=1)
            | np.any(result.up != prev_result.up, axis=1)
            | (result.survivor_mask != prev_result.survivor_mask)
            | (result.flags != prev_result.flags)
        )[0]
        return result, changed

    def run(
        self, state_prev: PoolMapState, state_cur: PoolMapState,
        epoch_prev: int = 0, epoch_cur: int = 0,
    ) -> PeeringResult:
        if self._fused is None:
            return self.run_staged(state_prev, state_cur, epoch_prev, epoch_cur)
        up, upp, act, actp, pact, flags, mask, n_alive = self._fused(
            self._fused_arg, state_prev, state_cur, self._pgs, self.pool.min_size)
        return self._result(epoch_prev, epoch_cur, up, upp, act, actp, pact, flags, mask,
                            n_alive)

    def run_staged(
        self, state_prev: PoolMapState, state_cur: PoolMapState,
        epoch_prev: int = 0, epoch_cur: int = 0,
    ) -> PeeringResult:
        """The three-step pass (map prev, map cur, classify): the host
        CRUSH tier's path, and the differential the fused program is
        held against."""
        _pup, _pupp, pact, _pactp = self.map_epoch(state_prev)
        up, upp, act, actp = self.map_epoch(state_cur)
        flags, mask, n_alive = classify_rows(pact, up, act, self.pool.min_size)
        return self._result(epoch_prev, epoch_cur, up, upp, act, actp, pact, flags, mask,
                            n_alive)

    def _result(self, epoch_prev, epoch_cur, up, upp, act, actp, pact, flags, mask,
                n_alive) -> PeeringResult:
        return PeeringResult(
            pool_id=self.pool.id,
            epoch_prev=epoch_prev,
            epoch_cur=epoch_cur,
            size=self.pool.size,
            min_size=self.pool.min_size,
            up=_host(up),
            up_primary=_host(upp),
            acting=_host(act),
            acting_primary=_host(actp),
            prev_acting=_host(pact),
            flags=_host(flags),
            survivor_mask=_host(mask, np.uint32),
            n_alive=_host(n_alive),
            dev_survivor_mask=mask,
            dev_n_alive=n_alive,
            dev_acting_primary=actp,
        )


def peer_pool(
    m_prev: OSDMap, m_cur: OSDMap, pool_id: int, max_items: int = 8,
    mode: str | None = None, device="cuda",
) -> PeeringResult:
    """Peer one pool across two map epochs on ``device``.

    The program is keyed on static structure only; when the two epochs
    share a crush map (the failure-injection case — only state bits
    changed) both evaluations run the same program.
    """
    engine = PeeringEngine(m_cur, pool_id, mode, device)
    state_prev = build_pool_state(m_prev, m_prev.pools[pool_id], max_items, engine.device)
    state_cur = build_pool_state(m_cur, m_cur.pools[pool_id], max_items, engine.device)
    return engine.run(
        state_prev, state_cur, epoch_prev=m_prev.epoch, epoch_cur=m_cur.epoch
    )
