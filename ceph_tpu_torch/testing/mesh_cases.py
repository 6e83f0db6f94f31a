"""The port's side of the mesh differentials: one function a case.

Each case is called as ``case(mesh, **inputs)`` on every rank of a world
(:func:`ceph_tpu_torch.testing.world.run_world` on the CPU, or a world
of one on the card) and returns plain Python and numpy values, which
the caller holds against the reference package's mesh on the same
inputs or against the port's single-device path.  Maps cross as the
reference's encodings (``OSDMap.encode()`` bytes, ``CrushMap.to_obj()``
dicts); shard stores are made per PG from a seed (:func:`pg_chunks`), so
every rank, the reference and the port read the same bytes in any
order.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import convert
from ..common.config import Config
from ..crush.map import ITEM_NONE
from ..ec import gf
from ..ec.backend import MatrixCodec, TableEncoder
from ..parallel import multihost
from ..parallel.placement import sharded_placement_step, sharded_rebalance_sim


def config(overrides: dict | None = None) -> Config:
    cfg = Config(env={})
    for key, val in (overrides or {}).items():
        cfg.set(key, val)
    return cfg


def pg_chunks(pg: int, matrix: np.ndarray, chunk: int, seed: int) -> np.ndarray:
    """PG ``pg``'s ``[k + m, chunk]`` shards of a systematic code
    ``[I; matrix]``: seeded data rows, then their parity."""
    m, k = matrix.shape
    data = np.random.default_rng(seed * 1_000_003 + int(pg)).integers(
        0, 256, (k, chunk), dtype=np.uint8)
    return np.vstack([data, gf.matrix_encode(matrix, data)])


def store_reader(matrix: np.ndarray, chunk: int, seed: int):
    """``(store, read_shard)`` over :func:`pg_chunks`."""
    store: dict[int, np.ndarray] = {}

    def read_shard(pg, s):
        if pg not in store:
            store[pg] = pg_chunks(pg, matrix, chunk, seed)
        return store[pg][s]

    return store, read_shard


def synth_peering(k: int, m_par: int, masks):
    """One degraded PG per survivor mask (the reference tests' shape)."""
    from ..recovery.peering import PG_STATE_DEGRADED, PeeringResult

    size = k + m_par
    n = len(masks)
    prev = np.arange(n * size, dtype=np.int32).reshape(n, size)
    acting = prev.copy()
    mask_arr = np.zeros(n, np.uint32)
    for i, mask in enumerate(masks):
        for s in range(size):
            if not (mask >> s) & 1:
                acting[i, s] = ITEM_NONE
        mask_arr[i] = mask
    return PeeringResult(
        pool_id=1, epoch_prev=1, epoch_cur=2, size=size, min_size=k,
        up=acting.copy(), up_primary=acting[:, 0].copy(),
        acting=acting, acting_primary=acting[:, 0].copy(),
        prev_acting=prev, flags=np.full(n, PG_STATE_DEGRADED, np.int32),
        survivor_mask=mask_arr,
        n_alive=(acting != ITEM_NONE).sum(axis=1).astype(np.int32),
    )


def _shards(shards: dict) -> dict:
    return {int(pg): {int(s): np.asarray(v).copy() for s, v in row.items()}
            for pg, row in shards.items()}


# ---------------------------------------------------------------- 4a


def local_shard(mesh, batches) -> list:
    """``multihost.local_shard(n, pad)`` for each ``(n, pad)``, or the
    ValueError's text."""
    out = []
    for n, pad in batches:
        try:
            out.append(tuple(multihost.local_shard(n, pad=pad)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def placement(mesh, crush_obj: dict, rule: str, weights, xs, result_max: int = 3,
              gather: bool = True) -> dict:
    cm = convert.crushmap_from_reference(crush_obj)
    step = sharded_placement_step(mesh, cm.to_dense(), cm.rule_by_name(rule), result_max,
                                  gather=gather)
    res, lens, hist = step(np.asarray(weights, np.uint32), np.asarray(xs, np.uint32))
    return {"results": res.cpu().numpy(), "lens": lens.cpu().numpy(),
            "hist": hist.cpu().numpy()}


def rebalance(mesh, crush_obj: dict, rule: str, w_before, w_after, chunk: int,
              n_chunks: int, starts) -> list:
    cm = convert.crushmap_from_reference(crush_obj)
    step = sharded_rebalance_sim(mesh, cm.to_dense(), cm.rule_by_name(rule), 3, chunk, n_chunks)
    return [int(step(np.asarray(w_before, np.uint32), np.asarray(w_after, np.uint32), s))
            for s in starts]


# ---------------------------------------------------------------- 4b


def sharded_decode(mesh, matrix, src, chunk: int, gather: bool) -> dict:
    from ..recovery.sharded import ShardedDecoder

    dec = ShardedDecoder(mesh, gather=gather)
    out, nb, sh = dec.decode(TableEncoder(matrix, mesh.device), src, chunk)
    return {"out": out, "bytes": nb, "shards": sh, "n_devices": dec.n_devices}


def _result_fields(res, names) -> dict:
    return {n: getattr(res, n) for n in names}


EXECUTOR_FIELDS = ("launches", "sharded_launches", "psum_bytes_rebuilt", "psum_shards_rebuilt",
                   "bytes_recovered", "shards_rebuilt", "worksteal_launches",
                   "stolen_subshards", "hedged_launches", "hedge_wasted_bytes",
                   "chip_convictions", "idle_fraction_per_chip",
                   "static_idle_fraction_per_chip")


def executor(mesh, k: int, m_par: int, masks, chunk: int, seed: int, overrides=None,
             use_mesh: bool = True, chip_faults=None, dispatch_devices=None,
             dispatch_seed: int = 0) -> dict:
    """A synthetic plan (one degraded PG per mask) through
    ``RecoveryExecutor``, over the mesh or (``use_mesh=False``) on the
    rank's device alone."""
    from ..recovery import RecoveryExecutor, build_plan

    matrix = gf.vandermonde_matrix(k, m_par)
    codec = MatrixCodec(matrix, device=mesh.device)
    plan = build_plan(synth_peering(k, m_par, masks), codec)
    _, read_shard = store_reader(matrix, chunk, seed)
    devs = None if dispatch_devices is None else [mesh.device] * int(dispatch_devices)
    ex = RecoveryExecutor(codec, config=config(overrides), mesh=mesh if use_mesh else None,
                          chip_faults=chip_faults, dispatch_devices=devs,
                          dispatch_seed=dispatch_seed, device=mesh.device)
    res = ex.run(plan, read_shard)
    return {"shards": _shards(res.shards), "n_patterns": plan.n_patterns,
            **_result_fields(res, EXECUTOR_FIELDS)}


def supervised(mesh, map_bytes: bytes, failure: str | None, timeline, k: int, m_par: int,
               chunk: int, seed: int, overrides=None, use_mesh: bool = True,
               chip_faults=None, dispatch_devices=None) -> dict:
    """``SupervisedRecovery`` of pool 1 after ``failure`` under the chaos
    ``timeline`` (``[(t, spec), ...]``): the summary, the shards, and
    the launch order by (mask, PGs)."""
    from .. import recovery as rec
    from ..recovery.dispatch import strip_chip_specs

    m = convert.osdmap_from_reference(map_bytes)
    m_prev = copy.deepcopy(m)
    if failure:
        rec.inject(m, failure)
    tl, chip_specs = strip_chip_specs(rec.ChaosTimeline.from_pairs(list(timeline)))
    chaos = rec.ChaosEngine(m, tl, device=mesh.device)
    matrix = gf.vandermonde_matrix(k, m_par)
    codec = MatrixCodec(matrix, device=mesh.device)
    _, read_shard = store_reader(matrix, chunk, seed)
    launched = []
    faults = list(chip_specs) + list(chip_faults or [])
    devs = None if dispatch_devices is None else [mesh.device] * int(dispatch_devices)
    sup = rec.SupervisedRecovery(
        codec, chaos, config=config(overrides), mesh=mesh if use_mesh else None,
        chip_faults=faults or None, dispatch_devices=devs, seed=seed,
        on_decode_launch=lambda g, n: launched.append(
            (int(g.mask), tuple(int(p) for p in g.pgs))),
        device=mesh.device)
    res = sup.run(m_prev, 1, read_shard)
    summary = res.summary()
    return {"summary": summary, "shards": _shards(res.shards),
            "completed": sorted(res.completed_pgs), "launched": launched,
            "coscheduled_windows": res.coscheduled_windows,
            "idle_fraction_per_chip": list(res.idle_fraction_per_chip),
            "static_idle_fraction_per_chip": list(res.static_idle_fraction_per_chip),
            "psum_bytes_rebuilt": res.psum_bytes_rebuilt}


# ---------------------------------------------------------------- 4d


def _peering(arrays: dict):
    from ..recovery.peering import PeeringResult

    n = len(arrays["survivor_mask"])
    size = int(arrays["size"])
    z = np.zeros((n, size), np.int32)
    return PeeringResult(
        pool_id=1, epoch_prev=1, epoch_cur=int(arrays.get("epoch", 2)), size=size,
        min_size=int(arrays["min_size"]), up=z, up_primary=np.zeros(n, np.int32),
        acting=z, acting_primary=np.asarray(arrays.get("acting_primary", np.zeros(n)), np.int32),
        prev_acting=z, flags=np.asarray(arrays.get("flags", np.zeros(n)), np.int32),
        survivor_mask=np.asarray(arrays["survivor_mask"], np.uint32),
        n_alive=np.asarray(arrays["n_alive"], np.int32))


TRAFFIC_FIELDS = ("ops", "served", "degraded", "blocked", "p50_ms", "p95_ms", "p99_ms",
                  "mean_ms", "qd_p50", "qd_p99", "slow_ops", "max_osd_utilization")


def traffic(mesh, arrays: dict, engine_args: tuple, engine_kwargs: dict,
            use_mesh: bool = True) -> dict:
    """One ``TrafficEngine.observe`` of a synthetic peering."""
    from ..recovery.chaos import VirtualClock
    from ..workload import TrafficEngine

    clock = VirtualClock()
    eng = TrafficEngine(clock.now, *engine_args, mesh=mesh if use_mesh else None,
                        device=mesh.device, **engine_kwargs)
    s = eng.observe(_peering(arrays))
    return {**{f: getattr(s, f) for f in TRAFFIC_FIELDS},
            "cum_lat_hist": eng._cum_lat_hist.copy()}


def traffic_step(mesh, arrays: dict, n_ops: int, n_osds: int, scalars: tuple,
                 use_mesh: bool = True) -> list:
    """The raw step's seven outputs (the mesh step with ``n_ops`` valid
    ops over ``ceil(n_ops / size)`` a rank)."""
    from ..workload.traffic import sharded_traffic_step, traffic_step as step1

    dev = mesh.device
    mask = torch.from_numpy(np.asarray(arrays["survivor_mask"], np.uint32).astype(np.int64)).to(dev)
    alive = torch.from_numpy(np.asarray(arrays["n_alive"], np.int32)).to(dev)
    prim = torch.from_numpy(np.asarray(arrays["acting_primary"], np.int32)).to(dev)
    if use_mesh:
        step = sharded_traffic_step(mesh, -(-n_ops // mesh.size), n_osds)
        outs = step(mask, alive, prim, *scalars, n_ops)
    else:
        outs = step1(n_ops, n_osds)(mask, alive, prim, *scalars)
    return [o.cpu().numpy() for o in outs]


def pg_states(mesh, arrays: dict, k, use_mesh: bool = True) -> tuple:
    from ..obs import PGStateClassifier

    cls = PGStateClassifier(mesh if use_mesh else None, device=mesh.device)
    return cls(_peering(arrays), k)


def timeline(mesh, passes, k: int, use_mesh: bool = True) -> list:
    """A ``HealthTimeline`` fed ``passes`` (``[(t, arrays, bytes)]``):
    its ``series()``."""
    from ..obs import HealthTimeline

    now = [0.0]
    tl = HealthTimeline(lambda: now[0], k=k, mesh=mesh if use_mesh else None,
                        device=mesh.device)
    for t, arrays, nbytes in passes:
        now[0] = t
        tl.snapshot(_peering(arrays), epoch=int(arrays.get("epoch", 2)),
                    bytes_recovered=nbytes)
    return tl.series()


def scrub(mesh, chunks, checksum_chunks, use_mesh: bool = True) -> dict:
    """A ``Scrubber`` pass: checksums from ``checksum_chunks``
    ``[n_pgs, n_shards, chunk]``, the pass over ``chunks``."""
    from ..recovery.scrub import Scrubber

    n_pgs, n_shards = chunks.shape[:2]
    sc = Scrubber(n_pgs, n_shards, mesh=mesh if use_mesh else None, device=mesh.device)
    sc.build_checksums(lambda pg, s: checksum_chunks[pg, s])
    r = sc.scrub(lambda pg, s: chunks[pg, s])
    return {"mask": r.inconsistent_mask, "hist": r.hist, "n_bad": r.n_inconsistent,
            "bytes": r.scrubbed_bytes, "checksums": sc.checksums.copy()}


def _state_lanes(state) -> list:
    return [np.asarray(a).copy() for a in convert.state_lanes(state)]


def reconcile(mesh, map_bytes: bytes, timeline, n_epochs: int, overrides=None,
              seed: int = 0, n_ops: int = 16) -> dict:
    """A ``RankReconciler`` run: its rounds, the merged view's lanes and
    this rank's own view's lanes."""
    from .. import recovery as rec
    from ..recovery.reconcile import RankReconciler

    m = convert.osdmap_from_reference(map_bytes)
    tl = rec.ChaosTimeline.from_pairs(list(timeline))
    rr = RankReconciler(m, tl, mesh=mesh, config=config(overrides), seed=seed, n_ops=n_ops)
    try:
        res = rr.run(n_epochs)
    except rec.RankStalledError as e:
        return {"stalled": str(e), "cur": rr.cur}
    return {"rounds": res.rounds, "converged": res.converged, "laggy": res.laggy,
            "total_steps": res.total_steps, "merged": _state_lanes(res.merged),
            "state": _state_lanes(res.states[0])}


def rank_identical(mesh, differ_on: int | None) -> dict:
    """``assert_rank_identical`` on an operand that rank ``differ_on``
    changes (None: every rank passes the same): each rank's verdict."""
    from ..analysis.runtime_guard import RankDivergenceError, assert_rank_identical

    a = np.arange(16, dtype=np.int32)
    if differ_on is not None and mesh.rank == differ_on:
        a = a.copy()
        a[3] += 1
    try:
        assert_rank_identical("seam", a, np.int64(7), mesh=mesh)
        return {"raised": None}
    except RankDivergenceError as e:
        return {"raised": str(e)}


def stall(mesh, seconds: float) -> None:
    """Rank 0 waits in a barrier that the other ranks reach only after
    ``seconds`` (a world of one sleeps): the world limit's check."""
    import time

    if mesh.rank != 0 or mesh.size == 1:
        time.sleep(seconds)
    mesh.barrier()


def stalled_worksteal(mesh, k: int, m_par: int, masks) -> dict:
    """Every chip of the world stalls (one a rank): each rank's
    dispatcher convicts its own chip and raises the typed error — the
    work-stealing path holds no collective, so no rank waits on
    another."""
    from ..recovery import ChipLostError

    try:
        executor(mesh, k, m_par, masks, 97, 7,
                 {"recovery_shard_min_bytes": 0, "recovery_work_stealing": "on"},
                 chip_faults=[f"chipstall:{c}.0" for c in range(mesh.size)])
    except ChipLostError as e:
        return {"error": "ChipLostError", "chips": e.chips}
    return {"error": None}


def recovery_cli(mesh, argv) -> tuple:
    """``python -m ceph_tpu_torch.cli.recovery ARGV`` on this rank of the
    world (its ``--mesh`` finds the formed group): (exit code, stdout)."""
    import contextlib
    import io

    from ..cli import recovery

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = recovery.main(list(argv))
    return rc, out.getvalue()
