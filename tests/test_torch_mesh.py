"""The port's mesh (ROADMAP §1 item 4a) vs the reference package's.

The port runs one process a rank: gloo worlds of W = 1, 2 and 4
processes on the CPU (``ceph_tpu_torch.testing.world``, each world spawned
once for this module, every case run in it, under a wall-clock limit).
The reference runs in this process on ``ceph_tpu.parallel.make_mesh(W)``
over its 8 virtual devices.  On the same seeded inputs:

- the padding helpers are the reference's;
- ``multihost.local_shard`` gives each rank the reference's slice (and
  its ValueError) when the reference's devices are W, one a process;
- ``sharded_placement_step`` (fast engine, K3's plain version) gives
  every rank the reference's results, lens and psum'd histogram, and
  each rank's un-gathered slice is the reference's shard;
- ``sharded_rebalance_sim`` moves the reference's counts over the
  reference's seed layout (``start + rank * chunk * n_chunks``), at two
  starts;
- ``assert_rank_identical`` passes when every rank holds the same
  operand and raises on every rank when one rank's differs.

All comparisons exact.
"""

from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ceph_tpu.crush import interp_batch as jib
from ceph_tpu.models.clusters import build_simple
from ceph_tpu.parallel import multihost as ref_multihost
from ceph_tpu.parallel import padding as ref_padding
from ceph_tpu.parallel.placement import make_mesh as ref_make_mesh
from ceph_tpu.parallel.placement import sharded_placement_step as ref_placement_step
from ceph_tpu.parallel.placement import sharded_rebalance_sim as ref_rebalance_sim
from ceph_tpu_torch.parallel import Mesh, make_mesh, multihost, padding
from ceph_tpu_torch.testing.world import WorldError, WorldTimeout, run_world

WORLDS = (1, 2, 4)
CASES = "ceph_tpu_torch.testing.mesh_cases"
BATCHES = [(10, False), (10, True), (16, False), (12, True), (0, False)]
N_OBJECTS = 64
CHUNK, N_CHUNKS, STARTS = 16, 2, (0, 4_000_000_000)
DIFFER_ON = {1: None, 2: 1, 4: 2}


@lru_cache(maxsize=None)
def _map():
    m = build_simple(32)
    dense = m.to_dense()
    w = np.full(dense.max_devices, 0x10000, np.uint32)
    wa = w.copy()
    wa[[3, 17]] = 0
    xs = np.random.default_rng(4).integers(0, 2**32, N_OBJECTS, dtype=np.uint32)
    return m, dense, w, wa, xs


def _cases(size: int) -> list:
    m, _, w, wa, xs = _map()
    obj = m.to_obj()
    return [
        (f"{CASES}:local_shard", {"batches": BATCHES}),
        (f"{CASES}:placement", {"crush_obj": obj, "rule": "replicated_rule", "weights": wa,
                                "xs": xs, "gather": True}),
        (f"{CASES}:placement", {"crush_obj": obj, "rule": "replicated_rule", "weights": wa,
                                "xs": xs, "gather": False}),
        (f"{CASES}:rebalance", {"crush_obj": obj, "rule": "replicated_rule", "w_before": w,
                                "w_after": wa, "chunk": CHUNK, "n_chunks": N_CHUNKS,
                                "starts": STARTS}),
        (f"{CASES}:rank_identical", {"differ_on": None}),
        (f"{CASES}:rank_identical", {"differ_on": DIFFER_ON[size]}),
    ]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world size spawned once; ``worlds[W][rank][case]``."""
    return {w: run_world(w, _cases(w), str(tmp_path_factory.mktemp(f"world{w}")),
                         timeout_s=150.0, device="cpu")
            for w in WORLDS}


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """Put the reference's program caches back after this module (see
    tests/test_torch_crush_batch.py)."""
    from ceph_tpu.crush import interp
    from ceph_tpu.osdmap import mapping

    caches = (jib._FAST_CACHE, jib._PACK_CACHE, interp._BATCH_CACHE, mapping._POOL_FN_CACHE)
    saved = [dict(c) for c in caches]
    yield
    for cache, before in zip(caches, saved):
        cache.clear()
        cache.update(before)


def test_padding_is_the_reference_copy():
    for size, mult in [(0, 8), (1, 8), (16, 8), (17, 8), (997, 4), (5, 1)]:
        assert padding.padded_size(size, mult) == ref_padding.padded_size(size, mult)
    for bad in (0, -2):
        with pytest.raises(ValueError):
            padding.padded_size(4, bad)
    a = np.arange(12, dtype=np.uint8).reshape(2, 6)
    for mult in (4, 3, 5):
        got, size = padding.pad_to_multiple(a, mult, axis=1)
        want, wsize = ref_padding.pad_to_multiple(a, mult, axis=1)
        assert size == wsize
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(padding.trim_to_size(got, size, axis=1), a)
    assert padding.pad_to_multiple(a, 3, axis=1)[0] is a
    assert padding.trim_to_size(a, 6, axis=1) is a


def test_world_of_one_without_a_group():
    mesh = make_mesh(device="cpu")
    assert isinstance(mesh, Mesh) and mesh.group is None
    assert (mesh.rank, mesh.size, mesh.axis_index()) == (0, 1, 0)
    assert multihost.process_count() == 1
    assert multihost.local_shard(10) == (0, 10)
    t = torch.tensor([True, False])
    assert torch.equal(mesh.all_gather(t), t) and torch.equal(mesh.pmax(t), t)
    assert torch.equal(mesh.psum_ordered(torch.tensor([0.25])), torch.tensor([0.25]))
    with pytest.raises(ValueError, match="asked for 2 devices.*1 rank"):
        make_mesh(2, device="cpu")
    with pytest.raises(TypeError):
        mesh.psum(torch.tensor([0.5]))


def test_init_refuses_what_it_cannot_form():
    with pytest.raises(ValueError, match="does not serve"):
        multihost.init("file:///nonexistent", world_size=1, rank=0, backend="nccl",
                       device="cpu")
    with pytest.raises(ValueError, match="finite"):
        multihost.init("file:///nonexistent", world_size=1, rank=0, device="cpu",
                       timeout=float("inf"))


def test_world_limit_kills_every_rank(tmp_path):
    """A world whose ranks block in a collective past the limit is
    killed, rank by rank, and the caller gets WorldTimeout."""
    with pytest.raises(WorldTimeout):
        run_world(2, [(f"{CASES}:stall", {"seconds": 600})], str(tmp_path), timeout_s=6.0,
                  device="cpu")


def test_world_reports_a_failing_rank(tmp_path):
    with pytest.raises(WorldError, match="rank 0"):
        run_world(1, [(f"{CASES}:local_shard", {"batches": None})], str(tmp_path),
                  timeout_s=60.0, device="cpu")


@pytest.mark.parametrize("size", WORLDS)
def test_local_shard_matches_the_reference(worlds, size, monkeypatch):
    """The reference's slice with W devices, one a process."""
    monkeypatch.setattr(ref_multihost, "_global_devices",
                        lambda: [SimpleNamespace(process_index=i, id=i) for i in range(size)])
    for rank in range(size):
        monkeypatch.setattr(ref_multihost.jax, "process_index", lambda r=rank: r)
        want = []
        for n, pad in BATCHES:
            try:
                want.append(tuple(ref_multihost.local_shard(n, pad=pad)))
            except ValueError as e:
                want.append(("ValueError", str(e)))
        assert worlds[size][rank][0] == want
    if size == 4:
        assert worlds[4][1][0][0][0] == "ValueError"  # 10 over 4 ranks, unpadded


@lru_cache(maxsize=None)
def _reference_placement(size: int):
    _, dense, _, wa, xs = _map()
    m = _map()[0]
    with jib._force_kernel_mode("0"):
        step = ref_placement_step(ref_make_mesh(size), dense, m.rule_by_name("replicated_rule"), 3)
        res, lens, hist = step(wa, xs)
        return np.asarray(res), np.asarray(lens), np.asarray(hist)


@pytest.mark.parametrize("size", WORLDS)
def test_placement_matches_the_reference_mesh(worlds, size):
    res, lens, hist = _reference_placement(size)
    per = N_OBJECTS // size
    for rank in range(size):
        full, local = worlds[size][rank][1], worlds[size][rank][2]
        np.testing.assert_array_equal(full["results"], res)
        np.testing.assert_array_equal(full["lens"], lens)
        np.testing.assert_array_equal(full["hist"], hist)
        np.testing.assert_array_equal(local["results"], res[rank * per:(rank + 1) * per])
        np.testing.assert_array_equal(local["lens"], lens[rank * per:(rank + 1) * per])
        np.testing.assert_array_equal(local["hist"], hist)
    assert hist.sum() == N_OBJECTS * 3 and not hist[[3, 17]].any()


@lru_cache(maxsize=None)
def _reference_moved(size: int) -> list:
    m, dense, w, wa, _ = _map()
    with jib._force_kernel_mode("0"):
        step = ref_rebalance_sim(ref_make_mesh(size), dense, m.rule_by_name("replicated_rule"),
                                 3, CHUNK, N_CHUNKS)
        return [int(step(w, wa, np.uint32(s))) for s in STARTS]


@pytest.mark.parametrize("size", WORLDS)
def test_rebalance_sim_matches_the_reference_mesh(worlds, size):
    want = _reference_moved(size)
    assert all(0 < n < size * CHUNK * N_CHUNKS for n in want)
    for rank in range(size):
        assert worlds[size][rank][3] == want


@pytest.mark.parametrize("size", WORLDS)
def test_rank_identical_raises_on_every_rank(worlds, size):
    for rank in range(size):
        assert worlds[size][rank][4] == {"raised": None}
        verdict = worlds[size][rank][5]["raised"]
        if DIFFER_ON[size] is None:
            assert verdict is None
        else:
            assert "rank-divergent" in verdict and "seam" in verdict
