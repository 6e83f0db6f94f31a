"""The port's placement step and rebalance sim vs the reference package.

``ceph_tpu_torch.parallel.placement.sharded_rebalance_sim`` without a
mesh runs on one device, so ``n_chunks * 8`` chunks of it cover what the reference's
``sharded_rebalance_sim`` covers with ``n_chunks`` chunks on each of
the 8 virtual devices of ``make_mesh(8)``: the moved counts must be
equal, over the same object range, and equal to the reference on
``make_mesh(1)`` on chunks of ``COMPACT_MIN_BATCH`` seeds, on a straw2
map (the fast engine's masked retry rounds) and a uniform one (the
general engine's compacted rounds, which engage there); a start offset
moves the range.  ``sharded_placement_step``'s histogram is ``bincount`` of its
results.  Everything on the CPU; all comparisons exact.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from ceph_tpu.crush import interp_batch as jib
from ceph_tpu.crush.map import ALG_UNIFORM
from ceph_tpu.models.clusters import build_hierarchy, build_simple
from ceph_tpu.parallel.placement import make_mesh
from ceph_tpu.parallel.placement import sharded_rebalance_sim as ref_rebalance_sim
from ceph_tpu.testing import cppref
from ceph_tpu_torch.convert import crushmap_from_reference
from ceph_tpu_torch.crush import interp, interp_batch
from ceph_tpu_torch.parallel.placement import sharded_placement_step, sharded_rebalance_sim

CHUNK = 256
N_CHUNKS = 2
START = 4_000_000_000  # near the top of u32: the seeds wrap past 2^32


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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many test workers share the CPU: one intra-op thread a worker keeps
    these batches from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@lru_cache(maxsize=None)
def _setup(kind: str = "straw2"):
    """A 64-OSD map (``build_simple``: the fast engine; ``uniform``: a
    uniform hierarchy, the general engine) with 3 OSDs out after."""
    jm = build_simple(64) if kind == "straw2" else build_hierarchy(
        [("rack", 4), ("host", 4)], 4, alg=ALG_UNIFORM)
    dense = jm.to_dense()
    wb = np.full(dense.max_devices, 0x10000, np.uint32)
    wa = wb.copy()
    wa[np.random.default_rng(0).choice(64, 3, replace=False)] = 0
    tm = crushmap_from_reference(jm.to_obj())
    return jm, tm, wb, wa


@lru_cache(maxsize=None)
def _reference_moved(n_devices: int, n_chunks: int, start: int, chunk: int = CHUNK,
                     kind: str = "straw2") -> int:
    jm, _, wb, wa = _setup(kind)
    with jib._force_kernel_mode("0"):
        step = ref_rebalance_sim(make_mesh(n_devices), jm.to_dense(),
                                 jm.rule_by_name("replicated_rule"), 3, chunk, n_chunks)
        return int(step(wb, wa, np.uint32(start)))


def _port_moved(n_chunks: int, start: int, chunk: int = CHUNK,
                kind: str = "straw2") -> torch.Tensor:
    _, tm, wb, wa = _setup(kind)
    step = sharded_rebalance_sim(None, tm.to_dense(), tm.rule_by_name("replicated_rule"), 3,
                                 chunk, n_chunks, device="cpu")
    return step(wb, wa, start)


@pytest.mark.parametrize("start", [0, START])
def test_rebalance_sim_matches_the_reference_on_eight_devices(start):
    moved = _port_moved(N_CHUNKS * 8, start)
    assert moved.dtype == torch.int64 and moved.device.type == "cpu"
    assert int(moved) == _reference_moved(8, N_CHUNKS, start) > 0


@pytest.mark.parametrize("kind", ["straw2", "uniform"])
def test_rebalance_sim_matches_the_reference_on_one_device(kind, monkeypatch):
    """Chunks of COMPACT_MIN_BATCH seeds: the fast engine's masked rounds
    (straw2), or the general engine's compacted ones (uniform)."""
    chunk = interp.COMPACT_MIN_BATCH
    rounds = []
    monkeypatch.setattr(interp_batch, "_stragglers",
                        lambda mask, real=interp_batch._stragglers: rounds.append(1) or real(mask))
    want = _reference_moved(1, 1, START, chunk, kind)
    assert int(_port_moved(1, START, chunk, kind)) == want > 0
    assert bool(rounds) == (kind == "uniform")


def test_rebalance_sim_start_offset_and_cpp():
    """The moved count of [start, start + n) is C++'s over the same seeds,
    and another start counts another range."""
    _, tm, wb, wa = _setup()
    dense = tm.to_dense()
    steps = [(s.op, s.arg1, s.arg2) for s in tm.rule_by_name("replicated_rule").steps]
    counts = []
    for start in (0, 1000, START):
        xs = ((start + np.arange(CHUNK * N_CHUNKS)) % 2**32).astype(np.uint32)
        rb, _ = cppref.do_rule_batch(dense, steps, xs, wb, 3)
        ra, _ = cppref.do_rule_batch(dense, steps, xs, wa, 3)
        want = int((rb != ra).any(axis=1).sum())
        assert int(_port_moved(N_CHUNKS, start)) == want
        counts.append(want)
    assert len(set(counts)) > 1


def test_placement_step_histogram_is_bincount_of_results():
    _, tm, wb, wa = _setup()
    dense = tm.to_dense()
    rule = tm.rule_by_name("replicated_rule")
    step = sharded_placement_step(None, dense, rule, 3, device="cpu")
    xs = np.random.default_rng(3).integers(0, 2**32, 2000, dtype=np.uint32)
    res, lens, hist = step(wa, xs)
    assert hist.shape == (dense.max_devices,) and hist.dtype == torch.int32
    placed = res[res != 0x7FFFFFFF].to(torch.int64)
    assert torch.equal(hist, torch.bincount(placed, minlength=dense.max_devices).to(torch.int32))
    assert int(hist.sum()) == int(lens.sum()) == 2000 * 3
    assert not bool(hist[torch.from_numpy(wa == 0)].any())  # out OSDs hold nothing
    steps = [(s.op, s.arg1, s.arg2) for s in rule.steps]
    cres, clens = cppref.do_rule_batch(dense, steps, xs, wa, 3)
    np.testing.assert_array_equal(res.numpy(), cres)
    np.testing.assert_array_equal(lens.numpy(), clens)
