"""The port's other mesh paths (ROADMAP §1 item 4d) vs the reference
package's and vs the port's own single-device and in-process paths.

The port runs gloo worlds of W = 1, 2 and 4 processes on the CPU
(``ceph_tpu_torch.testing.world``, each world spawned once for this
module, under a wall-clock limit); the reference runs in this process
on ``make_mesh(W)``.  On the same seeded inputs:

- ``TrafficEngine(mesh=)`` (each rank's op ids from its rank, the
  per-OSD load summed before the queue model): the reference mesh's
  outcome counts, percentiles, peak utilization and cumulative latency
  histogram exactly, ``mean_ms`` at ``rtol=1e-6`` (the packages sum in
  different orders, as tests/test_torch_traffic.py states), with the op
  axis padded (1001 ops); the raw ``sharded_traffic_step`` equals the
  port's single-device step bit for bit, ``sums`` included (each rank's
  fixed pairwise partial, then the partials in rank order: over 4096
  ops split evenly this rounds as the one-batch pairwise sum does);
- ``PGStateClassifier(mesh)`` over a padded PG axis and
  ``HealthTimeline(mesh=)``: the reference's histograms and series;
- ``Scrubber(mesh=)`` (K8's plain version on each rank's PGs): the
  reference mesh's checksums, inconsistent bitmask, histogram and count;
- ``RankReconciler`` (one process a rank, ``ViewMerger``'s collectives):
  every round, the merged view and each rank's own view equal the port's
  in-process ``DivergentDriver`` with as many ranks, bit for bit, under
  a cross-epoch skew and a ``rankdrop`` window; under a permanent stall
  every rank raises the driver's ``RankStalledError`` in the same round.
"""

import copy
from functools import lru_cache

import numpy as np
import pytest

from ceph_tpu import recovery as ref_rec
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.obs import HealthTimeline as RefTimeline
from ceph_tpu.obs import PGStateClassifier as RefClassifier
from ceph_tpu.parallel.placement import make_mesh as ref_make_mesh
from ceph_tpu.recovery.peering import PeeringResult as RefPeeringResult
from ceph_tpu.recovery.scrub import Scrubber as RefScrubber
from ceph_tpu.workload import TrafficEngine as RefTrafficEngine
from ceph_tpu_torch import convert
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.recovery import reconcile as rc
from ceph_tpu_torch.recovery.chaos import ChaosTimeline
from ceph_tpu_torch.recovery.peering import PG_STATE_BACKFILL, PG_STATE_REMAPPED
from ceph_tpu_torch.testing import mesh_cases
from ceph_tpu_torch.testing.world import run_world

WORLDS = (1, 2, 4)
CASES = "ceph_tpu_torch.testing.mesh_cases"
SUMS_RTOL = 1e-6
N_OPS = (4096, 1001)
ENGINE = ((8, 32, 4, 6, 5), {"osd_capacity_ops_per_s": 1e6, "seed": 9})
STEP_SCALARS = (0x5EED, 32, 31, 4, 6, 5, 250, 0.5, 64.0, 0.1)
SKEW = [(0.05, "rankdelay:1.2500"), (0.30, "osd:3:down_out"), (0.80, "osd:9:down_out")]
DROP = [(0.30, "osd:3:down_out"), (0.50, "rankdrop:1")]
STALL = [(0.30, "osd:3:down_out"), (1.00, "rankstall:1.0")]
EPOCHS = {"skew": 16, "drop": 8, "stall": 12}
RECONCILE_CFG = {"reconcile_every_epochs": 4}


@lru_cache(maxsize=None)
def _traffic_arrays():
    masks = [0b111111, 0b011111, 0b000111, 0b001111] * 8
    alive = [6, 5, 3, 4] * 8
    return {"survivor_mask": np.array(masks, np.uint32), "n_alive": np.array(alive, np.int32),
            "acting_primary": np.arange(32, dtype=np.int32) % 8, "size": 6, "min_size": 5}


@lru_cache(maxsize=None)
def _pool(seed=0, n=301, size=6):
    rng = np.random.default_rng(seed)
    full = (1 << size) - 1
    masks = np.where(rng.random(n) < 0.4, full, rng.integers(0, full + 1, n))
    alive = np.where(rng.random(n) < 0.7, size, rng.integers(0, size + 1, n))
    flags = np.zeros(n, np.int32)
    for bit in (PG_STATE_BACKFILL, PG_STATE_REMAPPED):
        flags |= np.where(rng.random(n) < 0.2, bit, 0).astype(np.int32)
    return {"survivor_mask": masks.astype(np.uint32), "n_alive": alive.astype(np.int32),
            "flags": flags, "size": size, "min_size": 4}


def _passes():
    out, t = [], 0.0
    for i in range(4):
        arrays = dict(_pool(10 + i, n=37))
        arrays["epoch"] = 2 + i
        t += 0.75 + 0.5 * i
        out.append((t, arrays, 640 * i))
    return out


@lru_cache(maxsize=None)
def _scrub_data():
    rng = np.random.default_rng(5)
    clean = rng.integers(0, 256, (13, 6, 64), dtype=np.uint8)
    rot = clean.copy()
    for pg, s, b in ((2, 1, 7), (11, 5, 0), (12, 0, 63), (12, 3, 5)):
        rot[pg, s, b] ^= 0x5A
    return clean, rot


@lru_cache(maxsize=None)
def _map_bytes() -> bytes:
    return ref_build_osdmap(32, pg_num=64, size=6, pool_kind="erasure").encode()


def _reconcile_case(pairs, n_epochs):
    return (f"{CASES}:reconcile", {"map_bytes": _map_bytes(), "timeline": pairs,
                                   "n_epochs": n_epochs, "overrides": RECONCILE_CFG,
                                   "seed": 4, "n_ops": 16})


def _cases(size: int) -> list:
    out = []
    for n_ops in N_OPS:
        args, kw = ENGINE
        out.append((f"{CASES}:traffic", {"arrays": _traffic_arrays(), "engine_args": args,
                                         "engine_kwargs": {**kw, "ops_per_step": n_ops}}))
    for use_mesh in (True, False):
        out.append((f"{CASES}:traffic_step", {"arrays": _traffic_arrays(), "n_ops": 4096,
                                              "n_osds": 8, "scalars": STEP_SCALARS,
                                              "use_mesh": use_mesh}))
    for k in (None, 3):
        out.append((f"{CASES}:pg_states", {"arrays": _pool(), "k": k}))
    out.append((f"{CASES}:timeline", {"passes": _passes(), "k": 4}))
    clean, rot = _scrub_data()
    out.append((f"{CASES}:scrub", {"chunks": rot, "checksum_chunks": clean}))
    out.append(_reconcile_case(SKEW if size > 1 else SKEW[1:], EPOCHS["skew"]))
    if size == 2:
        out.append(_reconcile_case(DROP, EPOCHS["drop"]))
        out.append(_reconcile_case(STALL, EPOCHS["stall"]))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: run_world(w, _cases(w), str(tmp_path_factory.mktemp(f"world{w}")),
                         timeout_s=300.0, device="cpu")
            for w in WORLDS}


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """Put the reference's program caches back after this module."""
    from ceph_tpu.crush import interp, interp_batch as ib
    from ceph_tpu.osdmap import mapping
    from ceph_tpu.recovery import pipeline

    caches = (ib._FAST_CACHE, ib._PACK_CACHE, interp._BATCH_CACHE, mapping._POOL_FN_CACHE,
              pipeline.PIPELINES._entries)
    saved = [copy.copy(c) for c in caches]
    counts = (pipeline.PIPELINES.hits, pipeline.PIPELINES.misses, pipeline.PIPELINES.evictions)
    yield
    for cache, before in zip(caches, saved):
        cache.clear()
        cache.update(before)
    pipeline.PIPELINES.hits, pipeline.PIPELINES.misses, pipeline.PIPELINES.evictions = counts


def _ref_peering(arrays):
    n = len(arrays["survivor_mask"])
    size = int(arrays["size"])
    z = np.zeros((n, size), np.int32)
    return RefPeeringResult(
        pool_id=1, epoch_prev=1, epoch_cur=int(arrays.get("epoch", 2)), size=size,
        min_size=int(arrays["min_size"]), up=z, up_primary=np.zeros(n, np.int32), acting=z,
        acting_primary=np.asarray(arrays.get("acting_primary", np.zeros(n)), np.int32),
        prev_acting=z, flags=np.asarray(arrays.get("flags", np.zeros(n)), np.int32),
        survivor_mask=np.asarray(arrays["survivor_mask"], np.uint32),
        n_alive=np.asarray(arrays["n_alive"], np.int32))


@pytest.mark.parametrize("size", WORLDS)
@pytest.mark.parametrize("which", range(len(N_OPS)), ids=[f"ops{n}" for n in N_OPS])
def test_mesh_step_matches_single_device(worlds, size, which):
    args, kw = ENGINE
    clock = ref_rec.VirtualClock()
    eng = RefTrafficEngine(clock.now, *args, ops_per_step=N_OPS[which],
                           mesh=ref_make_mesh(size, axis="ops"), **kw)
    s = eng.observe(_ref_peering(_traffic_arrays()))
    for rank in range(size):
        got = worlds[size][rank][which]
        for f in mesh_cases.TRAFFIC_FIELDS:
            if f == "mean_ms":
                assert got[f] == pytest.approx(s.mean_ms, rel=SUMS_RTOL)
            else:
                assert got[f] == getattr(s, f), f
        assert got["served"] + got["degraded"] + got["blocked"] == N_OPS[which]
        np.testing.assert_array_equal(got["cum_lat_hist"], eng._cum_lat_hist)


@pytest.mark.parametrize("size", WORLDS)
def test_raw_mesh_step_equals_the_single_device_step(worlds, size):
    for rank in range(size):
        mesh_out, single = worlds[size][rank][2], worlds[size][rank][3]
        for a, b in zip(mesh_out, single):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert int(mesh_out[0].sum()) == 4096


@pytest.mark.parametrize("size", WORLDS)
def test_pg_state_classifier_mesh_matches_single(worlds, size):
    for j, k in enumerate((None, 3)):
        r_hist, r_aux = RefClassifier(ref_make_mesh(size, axis="pgs"))(
            _ref_peering(_pool()), k)
        for rank in range(size):
            hist, aux = worlds[size][rank][4 + j]
            np.testing.assert_array_equal(hist, np.asarray(r_hist))
            np.testing.assert_array_equal(aux, np.asarray(r_aux))
            assert hist.sum() == 301


@pytest.mark.parametrize("size", WORLDS)
def test_health_timeline_mesh_identical_series(worlds, size):
    now = [0.0]
    tl = RefTimeline(lambda: now[0], k=4, mesh=ref_make_mesh(size, axis="pgs"))
    for t, arrays, nbytes in _passes():
        now[0] = t
        tl.snapshot(_ref_peering(arrays), epoch=int(arrays["epoch"]), bytes_recovered=nbytes)
    for rank in range(size):
        assert worlds[size][rank][6] == tl.series()


@pytest.mark.parametrize("size", WORLDS)
def test_mesh_scrub_matches_the_reference_mesh(worlds, size):
    clean, rot = _scrub_data()
    sc = RefScrubber(13, 6, mesh=ref_make_mesh(size, axis="pgs"))
    sc.build_checksums(lambda pg, s: clean[pg, s])
    r = sc.scrub(lambda pg, s: rot[pg, s])
    assert r.n_inconsistent == 4 and list(r.pgs) == [2, 11, 12]
    for rank in range(size):
        got = worlds[size][rank][7]
        np.testing.assert_array_equal(got["checksums"], sc.checksums)
        np.testing.assert_array_equal(got["mask"], r.inconsistent_mask)
        np.testing.assert_array_equal(got["hist"], np.asarray(r.hist))
        assert (got["n_bad"], got["bytes"]) == (r.n_inconsistent, r.scrubbed_bytes)


def _driver(pairs, n_ranks):
    cfg = Config(env={})
    for key, val in RECONCILE_CFG.items():
        cfg.set(key, val)
    m = convert.osdmap_from_reference(_map_bytes())
    return rc.DivergentDriver(m, ChaosTimeline.from_pairs(pairs), n_ranks, config=cfg, seed=4,
                              n_ops=16, device="cpu")


def _lanes_equal(got: list, state) -> bool:
    want = mesh_cases._state_lanes(state)
    return len(got) == len(want) and all(
        a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("size,name", [(1, "skew"), (2, "skew"), (2, "drop"), (2, "stall"),
                                       (4, "skew")])
def test_rank_reconciler_equals_the_in_process_driver(worlds, size, name):
    """(A world of one runs the skew scenario without its rank-1 spec.)"""
    pairs = {"skew": SKEW if size > 1 else SKEW[1:], "drop": DROP, "stall": STALL}[name]
    idx = 8 + ["skew", "drop", "stall"].index(name)
    d = _driver(pairs, size)
    if name == "stall":
        with pytest.raises(rc.RankStalledError) as e:
            d.run(EPOCHS[name])
        for rank in range(size):
            got = worlds[size][rank][idx]
            assert got["stalled"] == str(e.value)
            assert got["cur"] == d.cur[rank]
        return
    res = d.run(EPOCHS[name])
    for rank in range(size):
        got = worlds[size][rank][idx]
        assert got["rounds"] == res.rounds
        assert (got["converged"], got["laggy"]) == (res.converged, res.laggy)
        assert got["total_steps"] == d.cur[rank]
        assert _lanes_equal(got["merged"], res.merged)
        assert _lanes_equal(got["state"], res.states[rank])
    if name == "skew" and size > 1:
        assert res.detection_to_convergence_rounds() is not None
