"""The port's sharded decode and the executor's mesh (ROADMAP §1 item
4b) vs the reference package's.

The port runs gloo worlds of W = 1, 2 and 4 processes on the CPU
(``ceph_tpu_torch.testing.world``, each world spawned once for this
module, under a wall-clock limit), K4 in its plain version on each
rank's byte slice; the reference runs in this process on
``make_mesh(W)``.  On the same seeded inputs (shards made per PG by
``mesh_cases.pg_chunks``):

- ``ShardedDecoder`` over an odd width (padding live): the gathered
  output is the reference's, each rank's un-gathered output its
  reference shard, and the counters (over the unpadded width) the
  reference's psum'd ones;
- ``RecoveryExecutor(mesh=)`` with ``recovery_shard_min_bytes=0``: every
  launch sharded, the shards and counters equal the reference mesh's
  and the port's single-device executor's;
- the default threshold keeps a small group on the rank's device;
- ``SupervisedRecovery(mesh=)`` with nothing sharding co-schedules
  windows of small groups: summary, launch order and shards equal the
  reference mesh's, and the bytes equal the store;
- partial-launch salvage: an OSD killed mid-window voids only the PGs
  that read from it; the rest of the window's output is committed, as
  the reference's mesh run commits it;
- ``cli/recovery.py --chaos ... --mesh 0`` on every rank of the world
  prints what the reference's CLI prints with ``--mesh W``.

All comparisons exact.
"""

import copy
from functools import lru_cache

import numpy as np
import pytest

from ceph_tpu import recovery as ref_rec
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.crush.map import ITEM_NONE
from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.ec.backend import MatrixCodec as RefMatrixCodec
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.parallel.placement import make_mesh as ref_make_mesh
from ceph_tpu.recovery.peering import PG_STATE_DEGRADED, PeeringResult as RefPeeringResult
from ceph_tpu_torch.testing.mesh_cases import pg_chunks
from ceph_tpu_torch.testing.world import run_world

WORLDS = (1, 2, 4)
CASES = "ceph_tpu_torch.testing.mesh_cases"
K, M = 4, 2
MASKS = [0b001111, 0b110011, 0b011110]
CHUNK, SEED = 97, 7  # odd width: the padding path is always live
SUP_CHUNK, SUP_SEED = 64, 3
FIRST = "host:host0_1:down_out"
# OSD 25 serves one PG of the first window's launches after FIRST (found
# by dry runs): killing it at 0.55 s, inside that window, voids that PG
# and salvages the others
KILL = (0.55, "osd:25:down")
NOTHING_SHARDS = {"recovery_shard_min_bytes": 1 << 40}
CLI_ARGV = ["--chaos", "mid-repair-loss", "--pg-num", "64", "--chunk-size", "512", "--seed", "3",
            "--shard-min-bytes", "0"]


@lru_cache(maxsize=None)
def _decode_input():
    mat = ref_gf.vandermonde_matrix(4, 2)
    src = np.random.default_rng(0).integers(0, 256, (4, 997), dtype=np.uint8)
    return mat, src


@lru_cache(maxsize=None)
def _map_bytes() -> bytes:
    return ref_build_osdmap(64, pg_num=32, size=K + M, pool_kind="erasure").encode()


def _cases(size: int) -> list:
    mat, src = _decode_input()
    sup = {"map_bytes": _map_bytes(), "k": K, "m_par": M, "chunk": SUP_CHUNK, "seed": SUP_SEED}
    return [
        (f"{CASES}:sharded_decode", {"matrix": mat, "src": src, "chunk": 10, "gather": True}),
        (f"{CASES}:sharded_decode", {"matrix": mat, "src": src, "chunk": 10, "gather": False}),
        (f"{CASES}:executor", {"k": K, "m_par": M, "masks": MASKS, "chunk": CHUNK, "seed": SEED,
                               "overrides": {"recovery_shard_min_bytes": 0}}),
        (f"{CASES}:executor", {"k": K, "m_par": M, "masks": MASKS, "chunk": CHUNK, "seed": SEED,
                               "use_mesh": False}),
        (f"{CASES}:executor", {"k": K, "m_par": M, "masks": [0b001111], "chunk": 64,
                               "seed": 9}),
        (f"{CASES}:supervised", {**sup, "failure": FIRST, "timeline": [],
                                 "overrides": NOTHING_SHARDS}),
        (f"{CASES}:supervised", {**sup, "failure": None, "timeline": [(0.1, FIRST), KILL],
                                 "overrides": NOTHING_SHARDS}),
        (f"{CASES}:recovery_cli", {"argv": CLI_ARGV + ["--mesh", "0", "--device", "cpu"]}),
    ]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: run_world(w, _cases(w), str(tmp_path_factory.mktemp(f"world{w}")),
                         timeout_s=240.0, device="cpu")
            for w in WORLDS}


def _ref_codec():
    return RefMatrixCodec(ref_gf.vandermonde_matrix(K, M))


def _ref_store(chunk, seed):
    mat = ref_gf.vandermonde_matrix(K, M)
    store = {}

    def read_shard(pg, s):
        if pg not in store:
            store[pg] = pg_chunks(pg, mat, chunk, seed)
        return store[pg][s]

    return store, read_shard


def _ref_cfg(overrides):
    cfg = RefConfig(env={})
    for key, val in overrides.items():
        cfg.set(key, val)
    return cfg


def _synth_ref_peering(masks):
    size = K + M
    n = len(masks)
    prev = np.arange(n * size, dtype=np.int32).reshape(n, size)
    acting = prev.copy()
    mask_arr = np.zeros(n, np.uint32)
    for i, mask in enumerate(masks):
        for s in range(size):
            if not (mask >> s) & 1:
                acting[i, s] = ITEM_NONE
        mask_arr[i] = mask
    return RefPeeringResult(
        pool_id=1, epoch_prev=1, epoch_cur=2, size=size, min_size=K,
        up=acting.copy(), up_primary=acting[:, 0].copy(), acting=acting,
        acting_primary=acting[:, 0].copy(), prev_acting=prev,
        flags=np.full(n, PG_STATE_DEGRADED, np.int32), survivor_mask=mask_arr,
        n_alive=(acting != ITEM_NONE).sum(axis=1).astype(np.int32))


def _assert_shards_equal(got: dict, want: dict):
    assert sorted(got) == sorted(int(p) for p in want)
    for pg in want:
        assert sorted(got[int(pg)]) == sorted(int(s) for s in want[pg])
        for s in want[pg]:
            np.testing.assert_array_equal(got[int(pg)][int(s)], want[pg][s])


@pytest.mark.parametrize("size", WORLDS)
def test_sharded_decoder_byte_exact_odd_width(worlds, size):
    mat, src = _decode_input()
    luts = ref_gf.mul_table()[mat]
    want = ref_gf.matrix_encode(mat, src)
    ref = ref_rec.ShardedDecoder(ref_make_mesh(size, axis="bytes"), gather=True)
    r_out, r_nb, r_sh = ref.decode(luts, src, 10)
    np.testing.assert_array_equal(r_out, want)
    w = -(-997 // size)
    for rank in range(size):
        full, local = worlds[size][rank][0], worlds[size][rank][1]
        assert full["n_devices"] == size
        np.testing.assert_array_equal(full["out"], want)
        np.testing.assert_array_equal(local["out"], want[:, rank * w:(rank + 1) * w])
        for got in (full, local):
            assert (got["bytes"], got["shards"]) == (r_nb, r_sh) == (2 * 997, 2 * 997 // 10)


@lru_cache(maxsize=None)
def _ref_executor(size: int, overrides: tuple, masks: tuple, chunk: int, seed: int):
    codec = _ref_codec()
    plan = ref_rec.build_plan(_synth_ref_peering(list(masks)), codec)
    _, read_shard = _ref_store(chunk, seed)
    ex = ref_rec.RecoveryExecutor(codec, config=_ref_cfg(dict(overrides)),
                                  mesh=ref_make_mesh(size, axis="bytes"))
    return plan, ex.run(plan, read_shard)


@pytest.mark.parametrize("size", WORLDS)
def test_executor_sharded_byte_exact_vs_single_device(worlds, size):
    plan, ref = _ref_executor(size, (("recovery_shard_min_bytes", 0),), tuple(MASKS), CHUNK,
                              SEED)
    assert ref.sharded_launches == ref.launches == plan.n_patterns
    for rank in range(size):
        got, single = worlds[size][rank][2], worlds[size][rank][3]
        assert got["sharded_launches"] == got["launches"] == plan.n_patterns
        assert got["psum_bytes_rebuilt"] == got["bytes_recovered"] == ref.psum_bytes_rebuilt > 0
        assert got["psum_shards_rebuilt"] == got["shards_rebuilt"] == ref.psum_shards_rebuilt
        assert single["sharded_launches"] == 0 and single["launches"] == plan.n_patterns
        _assert_shards_equal(got["shards"], ref.shards)
        _assert_shards_equal(single["shards"], ref.shards)


@pytest.mark.parametrize("size", WORLDS)
def test_executor_min_bytes_keeps_small_groups_single_device(worlds, size):
    _, ref = _ref_executor(size, (), (0b001111,), 64, 9)
    assert ref.launches == 1 and ref.sharded_launches == 0
    for rank in range(size):
        got = worlds[size][rank][4]
        assert got["launches"] == 1 and got["sharded_launches"] == 0
        assert got["psum_bytes_rebuilt"] == 0
        _assert_shards_equal(got["shards"], ref.shards)


@lru_cache(maxsize=None)
def _ref_supervised(size: int, failure, timeline: tuple):
    m = ref_build_osdmap(64, pg_num=32, size=K + M, pool_kind="erasure")
    m_prev = copy.deepcopy(m)
    if failure:
        ref_rec.inject(m, failure)
    chaos = ref_rec.ChaosEngine(m, ref_rec.ChaosTimeline.from_pairs(list(timeline)))
    store, read_shard = _ref_store(SUP_CHUNK, SUP_SEED)
    launched = []
    sup = ref_rec.SupervisedRecovery(
        _ref_codec(), chaos, config=_ref_cfg(NOTHING_SHARDS), seed=SUP_SEED,
        mesh=ref_make_mesh(size, axis="bytes"),
        on_decode_launch=lambda g, n: launched.append(
            (int(g.mask), tuple(int(p) for p in g.pgs))))
    return sup.run(m_prev, 1, read_shard), launched, store


def _assert_supervised_equal(got: dict, ref, launched):
    want = ref.summary()
    assert got["summary"] == want
    assert got["launched"] == launched
    assert got["coscheduled_windows"] == ref.coscheduled_windows
    assert got["completed"] == sorted(ref.completed_pgs)
    _assert_shards_equal(got["shards"], ref.shards)


@pytest.mark.parametrize("size", WORLDS)
def test_supervised_coschedules_small_groups_with_mesh(worlds, size):
    ref, launched, store = _ref_supervised(size, FIRST, ())
    assert ref.converged and ref.coscheduled_windows >= 1 and ref.sharded_launches == 0
    for rank in range(size):
        got = worlds[size][rank][5]
        _assert_supervised_equal(got, ref, launched)
        for pg in got["completed"]:
            for s, data in got["shards"][pg].items():
                np.testing.assert_array_equal(data, store[pg][s])


@pytest.mark.parametrize("size", WORLDS)
def test_partial_launch_salvage(worlds, size):
    ref, launched, store = _ref_supervised(size, None, ((0.1, FIRST), KILL))
    assert ref.stale_launches >= 1 and ref.salvaged_pgs >= 1
    assert ref.converged and not ref.failed_pgs
    for rank in range(size):
        got = worlds[size][rank][6]
        _assert_supervised_equal(got, ref, launched)
        assert got["summary"]["salvaged_pgs"] >= 1
        for pg in got["completed"]:
            for s, data in got["shards"][pg].items():
                np.testing.assert_array_equal(data, store[pg][s])


@pytest.mark.parametrize("size", WORLDS)
def test_recovery_cli_mesh_matches_the_reference(worlds, size, capsys):
    from ceph_tpu.cli import recovery as ref_cli

    rc = ref_cli.main(CLI_ARGV + ["--mesh", str(size)])
    want = capsys.readouterr().out
    assert rc == 0 and f"over {size} devices" in want
    for rank in range(size):
        assert worlds[size][rank][7] == (0, want)
