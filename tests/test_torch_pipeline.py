"""The port's fused placement->peering pipeline
(``ceph_tpu_torch/recovery/pipeline.py``) on the CPU, against the
reference package's.

Each case of the reference's ``tests/test_fused_pipeline.py`` (a basic
down OSD, the full state zoo: full and item upmaps, pg_temp,
primary_temp, primary affinity, down and reweighted OSDs; weighted
skew) runs on the fast tier (straw2 maps) and on the general tier (the
same maps with uniform host buckets): the port's ``compile_fused_peering``
program, the port's ``run_staged``, the reference's
``compile_fused_peering`` program and the reference's ``run_staged``
give the same eight outputs.  These are integers: exact equality.

Besides: the program cache (shared entries, the LRU bound, evictions
that free an entry's graphs), ``CEPH_TPU_FUSED_PIPELINE=0``, ``(None,
None)`` on a host-tier map, ``dump_placement_caches()``'s keys against
the reference's, a first result left as it was by a second call, and
the graph's input buffers: every tensor of a CRUSH argument is listed
by its class, and a second map's tables copied into a first map's
buffers give the second map's result.  The ladder tests hold the
capture's semantics on the CPU: every round run masked (the ladder's
read made to say "a lane retries" every time, what a graph does when
its WHILE nodes run out their rounds) equals the eager ladder that
breaks early, on maps whose ladders retry (collisions, out OSDs).  The
card's graph is held in ``tests/test_torch_cuda.py``.
"""

import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.crush.map import ALG_UNIFORM as REF_ALG_UNIFORM
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.models.clusters import build_skewed_osdmap as ref_build_skewed_osdmap
from ceph_tpu.osdmap.map import PGId as RefPGId
from ceph_tpu.osdmap.mapping import build_pool_state as ref_build_pool_state
from ceph_tpu.recovery import pipeline as ref_pipeline
from ceph_tpu.recovery.peering import PeeringEngine as RefPeeringEngine
from ceph_tpu_torch import convert
from ceph_tpu_torch.analysis import runtime_guard
from ceph_tpu_torch.crush import interp_batch
from ceph_tpu_torch.crush.engine import runner_signature
from ceph_tpu_torch.crush.map import ALG_LIST
from ceph_tpu_torch.models.clusters import build_osdmap
from ceph_tpu_torch.osdmap.mapping import build_pool_state, pool_program_key
from ceph_tpu_torch.recovery import pipeline
from ceph_tpu_torch.recovery.peering import PeeringEngine

CPU = torch.device("cpu")
FIELDS = ("up", "up_primary", "acting", "acting_primary", "prev_acting", "flags",
          "survivor_mask", "n_alive")


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """Put the reference's process-wide program caches and pipeline
    counters back after this module (as tests/test_torch_cli.py does)."""
    from ceph_tpu.crush import interp, interp_batch as ib
    from ceph_tpu.osdmap import mapping

    caches = (ib._FAST_CACHE, ib._PACK_CACHE, interp._BATCH_CACHE, mapping._POOL_FN_CACHE,
              ref_pipeline.PIPELINES._entries)
    saved = [dict(c) for c in caches]
    counts = (ref_pipeline.PIPELINES.hits, ref_pipeline.PIPELINES.misses,
              ref_pipeline.PIPELINES.evictions)
    yield
    for cache, before in zip(caches, saved):
        cache.clear()
        cache.update(before)
    (ref_pipeline.PIPELINES.hits, ref_pipeline.PIPELINES.misses,
     ref_pipeline.PIPELINES.evictions) = counts


# ---------------------------------------------------------------- the cases
# Each builds reference maps (prev, cur): the port's come across with
# convert.osdmap_from_reference.


def _basic_down_osd():
    m = ref_build_osdmap(32, pg_num=64)
    prev = copy.deepcopy(m)
    m.mark_down(3)
    m.mark_down(17)
    return prev, m


def _state_zoo():
    rng = random.Random(7)
    m = ref_build_osdmap(40, pg_num=64)
    pool = m.pools[1]
    for ps in range(0, 64, 5):
        m.pg_upmap[RefPGId(1, ps)] = tuple(rng.sample(range(40), pool.size))
    for ps in range(1, 64, 7):
        m.pg_upmap_items[RefPGId(1, ps)] = ((ps % 40, (ps * 3) % 40),)
    for ps in range(2, 64, 9):
        m.pg_temp[RefPGId(1, ps)] = tuple(rng.sample(range(40), pool.size))
        m.primary_temp[RefPGId(1, ps)] = rng.randrange(40)
    for o in range(0, 40, 3):
        m.osd_primary_affinity[o] = 0x4000  # 25%
    prev = copy.deepcopy(m)
    m.mark_down(5)
    m.osd_weight[11] = 0x8000
    return prev, m


def _weighted_skew():
    prev = ref_build_skewed_osdmap(24, 48, 3, seed=5)
    m = ref_build_skewed_osdmap(24, 48, 3, seed=5)
    m.mark_down(2)
    return prev, m


CASES = {"basic_down_osd": _basic_down_osd, "state_zoo": _state_zoo,
         "weighted_skew": _weighted_skew}


def _uniform_hosts(m):
    """The general tier's form of a map: every host bucket uniform."""
    host = [t for t, name in m.crush.types.items() if name == "host"][0]
    for b in m.crush.buckets.values():
        if b.type_id == host:
            b.alg = REF_ALG_UNIFORM
    m.crush._mutated()
    return m


def _maps(case: str, tier: str):
    prev, cur = CASES[case]()
    if tier == "general":
        prev, cur = _uniform_hosts(prev), _uniform_hosts(cur)
    return prev, cur


def _ref_outputs(prev, cur):
    """(fused, staged) outputs of the reference, as numpy arrays."""
    pool = cur.pools[1]
    dense = cur.crush.to_dense()
    rule = cur.crush.rules[pool.crush_rule]
    sp, sc = ref_build_pool_state(prev, prev.pools[1]), ref_build_pool_state(cur, pool)
    crush_arg, fn = ref_pipeline.compile_fused_peering(dense, pool, rule,
                                                       ref_pipeline.PipelineCache())
    assert fn is not None
    fused = fn(crush_arg, sp, sc, jnp.arange(pool.pg_num, dtype=jnp.uint32),
               jnp.int32(pool.min_size))
    staged = RefPeeringEngine(cur, 1).run_staged(sp, sc)
    return ([np.asarray(a) for a in fused], [getattr(staged, f) for f in FIELDS])


def _port(prev_ref, cur_ref):
    prev = convert.osdmap_from_reference(prev_ref.encode())
    cur = convert.osdmap_from_reference(cur_ref.encode())
    sp = build_pool_state(prev, prev.pools[1], device=CPU)
    sc = build_pool_state(cur, cur.pools[1], device=CPU)
    return prev, cur, sp, sc


def _fused_fn(cur, cache=None, mode=None):
    pool = cur.pools[1]
    dense = cur.crush.to_dense()
    return pipeline.compile_fused_peering(dense, pool, cur.crush.rules[pool.crush_rule],
                                          cache=cache, mode=mode, device=CPU)


def _equal(got, want, what):
    for name, a, b in zip(FIELDS, got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a.astype(np.int64), np.asarray(b).astype(np.int64),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("tier", ["fast", "general"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_equals_reference_and_staged(case, tier):
    prev_ref, cur_ref = _maps(case, tier)
    ref_fused, ref_staged = _ref_outputs(prev_ref, cur_ref)
    _prev, cur, sp, sc = _port(prev_ref, cur_ref)
    pool = cur.pools[1]
    dense = cur.crush.to_dense()
    assert runner_signature(dense, cur.crush.rules[pool.crush_rule], pool.size)[0] == tier
    crush_arg, fn = _fused_fn(cur, cache=pipeline.PipelineCache())
    got = fn(crush_arg, sp, sc, torch.arange(pool.pg_num, dtype=torch.int64), pool.min_size)
    staged = PeeringEngine(cur, 1, device=CPU).run_staged(sp, sc)
    _equal(got, ref_fused, "port fused vs reference fused")
    _equal(got, ref_staged, "port fused vs reference staged")
    _equal(got, [getattr(staged, f) for f in FIELDS], "port fused vs port staged")
    assert got[1].dtype == got[3].dtype == got[5].dtype == torch.int32
    assert got[6].dtype == torch.int64  # survivor masks ride in int64 on the device


@pytest.mark.parametrize("tier", ["fast", "general"])
def test_engine_run_is_the_fused_program(tier):
    """PeeringEngine.run goes through the fused program (a cache entry),
    and its result equals run_staged's field for field."""
    prev_ref, cur_ref = _maps("state_zoo", tier)
    _prev, cur, sp, sc = _port(prev_ref, cur_ref)
    eng = PeeringEngine(cur, 1, device=CPU)
    assert isinstance(eng._fused, pipeline.FusedPeering)
    assert any(e is eng._fused for e in pipeline.PIPELINES._entries.values())
    fused, staged = eng.run(sp, sc, 4, 5), eng.run_staged(sp, sc, 4, 5)
    _equal([getattr(fused, f) for f in FIELDS], [getattr(staged, f) for f in FIELDS],
           "run vs run_staged")
    assert (fused.epoch_prev, fused.epoch_cur) == (4, 5)
    np.testing.assert_array_equal(fused.dev_survivor_mask.numpy().astype(np.uint32),
                                  fused.survivor_mask)


# ---------------------------------------------------------------- the ladder


def _retrying_maps():
    """(name, prev, cur) port maps whose retry ladders retry: a narrow EC
    pool over few hosts (collisions), and a map with out OSDs."""
    ec = ref_build_osdmap(24, pg_num=64, size=6, pool_kind="erasure", osds_per_host=4,
                          hosts_per_rack=8)
    ec_prev = copy.deepcopy(ec)
    ec.mark_down(1)
    ec.osd_weight[9] = 0
    out = ref_build_osdmap(32, pg_num=64, size=3)
    out_prev = copy.deepcopy(out)
    for o in (0, 4, 5, 13, 21, 30):
        out.osd_weight[o] = 0
    out.osd_weight[7] = 0x4000
    return [("collisions_ec", ec_prev, ec), ("out_osds", out_prev, out)]


@pytest.mark.parametrize("tier", ["fast", "general"])
@pytest.mark.parametrize("which", [0, 1], ids=["collisions_ec", "out_osds"])
def test_every_round_masked_equals_the_eager_ladder(which, tier, monkeypatch):
    """The capture's semantics: each round run masked (as a graph whose
    WHILE nodes run out their rounds: the ladder's read made to say that
    a lane retries, compaction off) gives what the eager ladder that
    breaks early gives; the eager ladder really retried."""
    from ceph_tpu_torch.crush import interp

    _name, prev_ref, cur_ref = _retrying_maps()[which]
    if tier == "general":
        prev_ref, cur_ref = _uniform_hosts(prev_ref), _uniform_hosts(cur_ref)
    _prev, cur, sp, sc = _port(prev_ref, cur_ref)
    pool = cur.pools[1]
    crush_arg, fn = _fused_fn(cur, cache=pipeline.PipelineCache())
    pgs = torch.arange(pool.pg_num, dtype=torch.int64)
    reads = []
    orig = interp_batch._any

    def recording(t):
        reads.append(orig(t))
        return reads[-1]

    monkeypatch.setattr(interp_batch, "_any", recording)
    eager = fn(crush_arg, sp, sc, pgs, pool.min_size)
    assert not all(reads), "no ladder ended early: the case tests nothing"
    assert any(reads), "no ladder retried: the case tests nothing"
    every = []
    monkeypatch.setattr(interp_batch, "_any", lambda t: every.append(1) or True)
    monkeypatch.setattr(interp, "COMPACT_MIN_BATCH", 1 << 30)
    masked = fn(crush_arg, sp, sc, pgs, pool.min_size)
    assert len(every) > len(reads)  # more rounds ran
    _equal(masked, eager, "every round masked vs eager")


def test_every_round_turns_compaction_off(monkeypatch):
    """The general engine's compacted ladders (a host read a round) are
    not entered under a capture (``interp._compacts``), whatever the
    batch; compacted and masked ladders give the same results."""
    from ceph_tpu_torch.core import graphs
    from ceph_tpu_torch.crush import interp

    _name, prev_ref, cur_ref = _retrying_maps()[1]
    _prev, cur, sp, sc = _port(_uniform_hosts(prev_ref), _uniform_hosts(cur_ref))
    pool = cur.pools[1]
    crush_arg, fn = _fused_fn(cur, cache=pipeline.PipelineCache())
    pgs = torch.arange(pool.pg_num, dtype=torch.int64)
    monkeypatch.setattr(interp, "COMPACT_MIN_BATCH", 16)
    calls = []
    orig = interp_batch._stragglers
    monkeypatch.setattr(interp_batch, "_stragglers", lambda m: calls.append(1) or orig(m))
    compacted = fn(crush_arg, sp, sc, pgs, pool.min_size)
    assert calls, "the compacted ladder did not run"
    assert interp._compacts(pgs)
    monkeypatch.setattr(graphs, "capturing", lambda t: True)
    assert not interp._compacts(pgs)
    monkeypatch.undo()
    monkeypatch.setattr(interp, "COMPACT_MIN_BATCH", 1 << 30)
    masked = fn(crush_arg, sp, sc, pgs, pool.min_size)
    _equal(masked, compacted, "masked vs compacted")


# ---------------------------------------------------------------- the cache


def _port_map(n=16, pg_num=16):
    return build_osdmap(n, pg_num=pg_num)


def test_pipeline_cache_shares_entries():
    cache = pipeline.PipelineCache()
    m = _port_map()
    _, fn1 = _fused_fn(m, cache)
    m2 = copy.deepcopy(m)
    m2.mark_down(2)  # another epoch: state only, the same key
    _, fn2 = _fused_fn(m2, cache)
    assert fn1 is fn2
    assert cache.stats() == {"entries": 1, "hits": 1, "misses": 1, "evictions": 0}
    _, fn3 = _fused_fn(m, cache, mode="draw")  # the kernel mode is in the key
    assert fn3 is not fn1 and cache.stats()["entries"] == 2
    pool, rule = m.pools[1], m.crush.rules[m.pools[1].crush_rule]
    dense = m.crush.to_dense()
    assert pool_program_key(dense, pool, rule) == pool_program_key(
        m2.crush.to_dense(), m2.pools[1], rule)
    assert pool_program_key(dense, pool, rule) != pool_program_key(dense, pool, rule, "level")


def test_pipeline_cache_lru_bound_frees_evicted_entries():
    released = []

    class Entry:
        def __init__(self, i):
            self.i = i

        def release(self):
            released.append(self.i)

    cache = pipeline.PipelineCache(max_entries=2)
    for i in range(4):
        cache.get(("k", i), lambda i=i: Entry(i))
    assert len(cache) == 2 and cache.stats()["evictions"] == 2
    assert released == [0, 1]
    cache.get(("k", 3), lambda: Entry(-1))  # a hit refreshes the entry
    cache.get(("k", 9), lambda: Entry(9))
    assert ("k", 3) in cache._entries and ("k", 2) not in cache._entries
    assert released == [0, 1, 2]
    # the real entry frees its graphs (none on the CPU) and survives it
    _, fn = _fused_fn(_port_map(), pipeline.PipelineCache())
    fn.release()
    assert fn.graphs() == []


def test_env_lever_pins_the_staged_path(monkeypatch):
    m = _port_map()
    monkeypatch.setenv("CEPH_TPU_FUSED_PIPELINE", "0")
    assert not pipeline.fused_pipeline_enabled()
    assert _fused_fn(m) == (None, None)
    eng = PeeringEngine(m, 1, device=CPU)
    assert eng._fused is None
    sp = build_pool_state(m, m.pools[1], device=CPU)
    res = eng.run(sp, sp)  # the staged pass
    assert (res.flags == 1).all()  # PG_STATE_CLEAN


def test_host_tier_map_returns_none():
    """A map the device tiers cannot run (legacy list buckets) has no
    fused program; the engine takes the staged pass there."""
    m = _port_map()
    for b in m.crush.buckets.values():
        if m.crush.types[b.type_id] == "host":
            b.alg = ALG_LIST
    m.crush._mutated()
    pool = m.pools[1]
    assert runner_signature(m.crush.to_dense(), m.crush.rules[pool.crush_rule],
                            pool.size)[0] == "host"
    stats = pipeline.PIPELINES.stats()
    assert _fused_fn(m) == (None, None)
    assert pipeline.PIPELINES.stats() == stats  # nothing counted
    eng = PeeringEngine(m, 1, device=CPU)
    sp = build_pool_state(m, pool, device=CPU)
    m.mark_down(1)
    sc = build_pool_state(m, pool, device=CPU)
    _equal([getattr(eng.run(sp, sc), f) for f in FIELDS],
           [getattr(eng.run_staged(sp, sc), f) for f in FIELDS], "host tier run")


def test_dump_placement_caches_has_the_reference_keys():
    got, want = pipeline.dump_placement_caches(), ref_pipeline.dump_placement_caches()
    assert set(got) == set(want) == {"pipeline", "schedule"}
    for k in got:
        assert set(got[k]) == set(want[k]), k
        assert all(isinstance(v, int) for v in got[k].values())
    before = got["pipeline"]
    PeeringEngine(_port_map(), 1, device=CPU)
    after = pipeline.dump_placement_caches()["pipeline"]
    assert after["hits"] + after["misses"] == before["hits"] + before["misses"] + 1


def test_a_second_call_leaves_the_first_result_as_it_was():
    m = _port_map(32, 64)
    crush_arg, fn = _fused_fn(m, cache=pipeline.PipelineCache())
    pool = m.pools[1]
    pgs = torch.arange(pool.pg_num, dtype=torch.int64)
    sp = build_pool_state(m, pool, device=CPU)
    first = fn(crush_arg, sp, sp, pgs, pool.min_size)
    kept = [t.clone() for t in first]
    m.mark_down(0)
    m.mark_down(9)
    second = fn(crush_arg, sp, build_pool_state(m, pool, device=CPU), pgs, pool.min_size)
    assert not torch.equal(first[2], second[2])  # the epochs differ
    for name, a, b in zip(FIELDS, first, kept):
        assert torch.equal(a, b), name


def test_peer_hist_is_the_current_epoch_half():
    """FusedPeering.peer_hist: the current epoch against a fixed previous
    acting table, then the PG-state reduction, as the program's outputs
    and pg_state_reduce give them."""
    from ceph_tpu_torch.obs.pg_states import pg_state_reduce

    m = _port_map(32, 64)
    pool = m.pools[1]
    crush_arg, fn = _fused_fn(m, cache=pipeline.PipelineCache())
    pgs = torch.arange(pool.pg_num, dtype=torch.int64)
    sp = build_pool_state(m, pool, device=CPU)
    m.mark_down(4)
    sc = build_pool_state(m, pool, device=CPU)
    full = fn(crush_arg, sp, sc, pgs, pool.min_size)
    half = fn.peer_hist(crush_arg, sc, full[4], pgs, pool.min_size, 1)
    for a, b in zip(half[:4] + half[4:7], full[:4] + full[5:]):
        assert torch.equal(a, b)
    hist, aux = pg_state_reduce(full[6], full[7], full[5], 1, pool.size)
    assert torch.equal(half[7], hist) and torch.equal(half[8], aux)


def test_epoch_loop_dense_branch_equals_the_lever_off(monkeypatch):
    """EpochDriver's dense dirty branch through the fused half equals the
    eager mapping program (the lever off), epoch for epoch."""
    from ceph_tpu_torch import recovery as rec

    m = build_osdmap(32, pg_num=32, size=6, pool_kind="erasure")
    fused = rec.EpochDriver(m, rec.build_scenario("flap", m), n_ops=64, device=CPU)
    assert fused._fused is not None
    a = fused.run_superstep(12)
    monkeypatch.setenv("CEPH_TPU_FUSED_PIPELINE", "0")
    staged = rec.EpochDriver(m, rec.build_scenario("flap", m), n_ops=64, device=CPU)
    assert staged._fused is None
    assert a.diff(staged.run_superstep(12)) == []
    assert int(a.dirty.sum()) > 0


# ---------------------------------------------------------------- the graph plumbing


def test_while_node_outside_a_capture_raises():
    from ceph_tpu_torch.core import graphs

    with pytest.raises(RuntimeError, match="needs a capture"):
        with graphs.while_node(lambda: torch.ones((), dtype=torch.bool)):
            pass
    assert not graphs.capturing(torch.ones(2))


def test_captures_count_as_builds_and_replays_as_launches():
    from ceph_tpu_torch.core import straw2

    with runtime_guard.CompileCounter() as cc:
        runtime_guard.note_capture()
    assert cc.captures == 1 and cc.n_compiles == 1
    with pytest.raises(AssertionError, match="1 graph capture"):
        with runtime_guard.assert_no_recompile("a capture"):
            runtime_guard.note_capture()
    with pytest.raises(AssertionError, match="compile budget 0"):
        with runtime_guard.CompileBudget(0, "a capture"):
            runtime_guard.note_capture()
    before = dict(straw2.REPLAYS)
    with runtime_guard.LaunchCounter() as lc:
        runtime_guard.note_replay({"descend": 3})
    assert lc.replays == lc.launches == {"descend": 3} and lc.calls == {}
    assert straw2.REPLAYS["descend"] == before["descend"] + 3


def test_launch_check_counts_captured_calls_and_replayed_launches(monkeypatch):
    """On the card a captured call runs nothing (it ticks CALLS only) and
    a replay's launches tick LAUNCHES and REPLAYS: the check holds every
    call outside a capture to a launch of its own."""
    from ceph_tpu_torch.core import straw2

    monkeypatch.setitem(straw2.CALLS, "descend", straw2.CALLS["descend"])
    monkeypatch.setitem(straw2.LAUNCHES, "descend", straw2.LAUNCHES["descend"])
    monkeypatch.setitem(straw2.REPLAYS, "descend", straw2.REPLAYS["descend"])
    with runtime_guard.LaunchCounter(check_launches=True) as lc:
        straw2.CALLS["descend"] += 3          # the capture's calls
        runtime_guard.note_capture({"descend": 3})
        runtime_guard.note_replay({"descend": 7})  # a replay ran seven launches
        straw2.CALLS["descend"] += 1          # and one eager call that launched
        straw2.LAUNCHES["descend"] += 1
    assert lc.captured == {"descend": 3} and lc.calls == {"descend": 4}
    assert lc.launches == {"descend": 8} and lc.replays == {"descend": 7}
    with pytest.raises(AssertionError, match="did not launch"):
        with runtime_guard.LaunchCounter(check_launches=True):
            straw2.CALLS["descend"] += 1      # a call outside a capture, no launch
    assert runtime_guard.CAPTURE_LISTENERS == []


def test_forbid_host_reads_passes_cpu_tensors_and_undoes_its_patches():
    before = dict(torch.Tensor.__dict__)
    nz = torch.nonzero
    t = torch.arange(4)
    with runtime_guard.forbid_host_reads("a test"):
        assert t.tolist() == [0, 1, 2, 3] and int(t[1]) == 1 and bool(t.any())
        assert torch.nonzero(t).shape == (3, 1)
    assert dict(torch.Tensor.__dict__) == before and torch.nonzero is nz


# ---------------------------------------------------------------- the graph's buffers


@pytest.mark.parametrize("tier", ["fast", "general"])
def test_crush_arg_tensors_are_listed_by_their_class(tier):
    """The graph copies a CRUSH argument through the tensors its class
    lists (``TENSORS``): every tensor attribute is listed."""
    from ceph_tpu_torch.core.straw2 import DescendTables
    from ceph_tpu_torch.crush.interp import StaticCrushMap

    prev_ref, cur_ref = _maps("state_zoo", tier)
    _prev, cur, _sp, _sc = _port(prev_ref, cur_ref)
    crush_arg, _fn = _fused_fn(cur, cache=pipeline.PipelineCache())
    objs = [crush_arg] if tier == "general" else [
        t for pair in crush_arg for t in pair if t is not None]
    assert objs and all(isinstance(o, (DescendTables, StaticCrushMap)) for o in objs)
    for o in objs:
        tensors = {a for a, v in vars(o).items() if isinstance(v, torch.Tensor)}
        assert tensors == set(type(o).TENSORS), type(o).__name__


def _reweighted(m):
    """A CRUSH reweight: the same shapes (so the same key), other weights."""
    from ceph_tpu_torch.crush.map import ALG_STRAW2

    m = copy.deepcopy(m)
    buckets = [b for b in m.crush.buckets.values() if b.alg == ALG_STRAW2 and len(b.items) > 1]
    for b in buckets[:4]:
        b.item_weights[0] = b.item_weights[0] // 2 + 1
    m.crush._mutated()
    return m


@pytest.mark.parametrize("tier", ["fast", "general"])
def test_a_second_map_copied_into_the_buffers_gives_its_result(tier):
    """A reweighted map hits the first map's entry; its CRUSH tables
    copied into a clone of the first map's (what a replay reads) give
    the reweighted map's staged result, not the first map's."""
    prev_ref, cur_ref = _maps("basic_down_osd", tier)
    prev, cur, sp, sc = _port(prev_ref, cur_ref)
    cache = pipeline.PipelineCache()
    arg_a, fn = _fused_fn(cur, cache=cache)
    heavy = _reweighted(cur)
    arg_b, fn_b = _fused_fn(heavy, cache=cache)
    assert fn_b is fn and cache.stats()["hits"] == 1
    buffers = pipeline._clone(arg_a)
    pipeline._copy_into(buffers, arg_b)
    for a, b in zip(pipeline._leaves(buffers), pipeline._leaves(arg_b), strict=True):
        assert torch.equal(a, b)
    pool = heavy.pools[1]
    pgs = torch.arange(pool.pg_num, dtype=torch.int64)
    sh = build_pool_state(heavy, pool, device=CPU)
    got = fn(buffers, sp, sh, pgs, pool.min_size)
    want = PeeringEngine(heavy, 1, device=CPU).run_staged(sp, sh)
    _equal(got, [getattr(want, f) for f in FIELDS], "copied tables vs staged")
    old = fn(arg_a, sp, sh, pgs, pool.min_size)
    assert not all(torch.equal(a, b) for a, b in zip(old, got))  # the weights matter
