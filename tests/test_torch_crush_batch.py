"""The port's batch CRUSH runner vs the reference package and the C++ tier.

For every rule shape, ``ceph_tpu_torch.crush.engine.make_batch_runner``
in each mode (on the CPU every mode runs the kernels' plain versions)
must equal the reference's ``make_batch_runner`` (jnp path, kernel mode
"0") and ``cppref.do_rule_batch``.  Maps are built in the reference
package and carried across with ``ceph_tpu_torch.convert``.  Rules
whose choose step empties the working vector are held against the C++
tier alone (the reference's engine differs there, ROADMAP's R5).  All
comparisons are integer: exact equality.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from ceph_tpu.crush import engine as jengine
from ceph_tpu.crush import interp_batch as jib
from ceph_tpu.crush.map import (
    ALG_STRAW2,
    CrushMap,
    OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP,
    OP_CHOOSELEAF_FIRSTN,
    OP_EMIT,
    OP_TAKE,
    Step,
    Tunables,
)
from ceph_tpu.models.clusters import build_flat, build_hierarchy, build_simple, build_skewed
from ceph_tpu.testing import cppref
from ceph_tpu_torch.convert import crushmap_from_reference
from ceph_tpu_torch.crush import engine, interp_batch

N = 256


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """The reference memoizes its compiled placement programs process-wide
    (keyed by program signature); put its caches back after this module,
    so a later test file in the same worker finds what it would have
    found without this one."""
    from ceph_tpu.crush import interp, interp_batch as ib
    from ceph_tpu.osdmap import mapping

    caches = (ib._FAST_CACHE, ib._PACK_CACHE, interp._BATCH_CACHE, mapping._POOL_FN_CACHE)
    saved = [dict(c) for c in caches]
    yield
    for cache, before in zip(caches, saved):
        cache.clear()
        cache.update(before)


def _two_root_map():
    """ssd + hdd roots over separate hosts (the shadow-tree shape device
    classes compile to)."""
    m = CrushMap()
    m.add_type(1, "root")
    m.add_type(2, "host")
    osd = 0
    roots = {}
    for cls in ("ssd", "hdd"):
        root = m.add_bucket(f"{cls}root", "root", alg=ALG_STRAW2)
        roots[cls] = root.id
        for h in range(4):
            host = m.add_bucket(f"{cls}host{h}", "host", alg=ALG_STRAW2)
            for _ in range(2):
                m.insert_item(host.id, osd, 0x10000)
                osd += 1
            m.insert_item(root.id, host.id, 0x20000)
    return m, roots


def _replicated(m, rm=3):
    return m, m.rule_by_name("replicated_rule"), rm


def _simple_reweighted():
    return _replicated(build_simple(64))


def _erasure():
    m = build_simple(48)
    m.make_erasure_rule("ec", "default", "host")
    return m, m.rule_by_name("ec"), 6


def _multi_take(leaf: bool):
    def build():
        m, roots = _two_root_map()
        op = OP_CHOOSELEAF_FIRSTN if leaf else OP_CHOOSE_FIRSTN
        t = m.type_id("host") if leaf else 0
        steps = [Step(OP_TAKE, roots["ssd"]), Step(op, 1 if leaf else 2, t), Step(OP_EMIT),
                 Step(OP_TAKE, roots["hdd"]), Step(op, 2 if leaf else 1, t), Step(OP_EMIT)]
        return m, m.add_rule("hybrid", steps), 3
    return build


def _chained(first_op, second_op, n1, n2, rm, spec=(("rack", 4), ("host", 4)),
             per_leaf=2, tunables=None):
    def build():
        m = build_hierarchy(list(spec), per_leaf, tunables=tunables)
        steps = [Step(OP_TAKE, m.bucket_by_name("default").id),
                 Step(first_op, n1, m.type_id("rack")),
                 Step(second_op, n2, m.type_id("host")), Step(OP_EMIT)]
        return m, m.add_rule("chain", steps), rm
    return build


def _multi_emit_overflow():
    m = build_simple(32)
    root = m.bucket_by_name("default").id
    host = m.type_id("host")
    steps = [Step(OP_TAKE, root), Step(OP_CHOOSELEAF_FIRSTN, 3, host), Step(OP_EMIT),
             Step(OP_TAKE, root), Step(OP_CHOOSELEAF_FIRSTN, 3, host), Step(OP_EMIT)]
    return m, m.add_rule("multi_emit", steps), 4


# name -> (builder, osd weights to change: {osd: weight}, expected tier)
CASES = {
    "simple_reweighted": (_simple_reweighted, {3: 0, 7: 0x8000, 20: 0x4000, 41: 0}, "fast"),
    "flat": (lambda: _replicated(build_flat(32)), {5: 0}, "fast"),
    "hierarchy": (lambda: _replicated(build_hierarchy([("rack", 3), ("host", 4)], 4)), {},
                  "fast"),
    # deep, ragged fanouts and mixed device weights
    "skewed": (lambda: _replicated(build_skewed(48)), {3: 0x8000, 7: 0}, "fast"),
    "erasure_indep": (_erasure, {2: 0, 9: 0xC000}, "fast"),
    "multi_take_leaf": (_multi_take(True), {}, "fast"),
    "multi_take_osd": (_multi_take(False), {1: 0}, "fast"),
    "chained_firstn": (_chained(OP_CHOOSE_FIRSTN, OP_CHOOSELEAF_FIRSTN, 2, 2, 4), {}, "fast"),
    "chained_indep": (_chained(OP_CHOOSE_INDEP, OP_CHOOSE_INDEP, 2, 2, 4), {}, "fast"),
    "chained_indep_holes": (_chained(OP_CHOOSE_INDEP, OP_CHOOSE_INDEP, 3, 2, 6,
                                     spec=(("rack", 2), ("host", 3))), {}, "fast"),
    "chained_stable0": (_chained(OP_CHOOSE_FIRSTN, OP_CHOOSELEAF_FIRSTN, 2, 2, 4,
                                 tunables=Tunables.profile("firefly")), {}, "fast"),
    "multi_emit_overflow": (_multi_emit_overflow, {}, "fast"),
    "chained_overflow_firstn": (_chained(OP_CHOOSE_FIRSTN, OP_CHOOSELEAF_FIRSTN, 3, 3, 5),
                                {}, "host"),
    "chained_overflow_indep": (_chained(OP_CHOOSE_INDEP, OP_CHOOSE_INDEP, 3, 2, 4), {}, "host"),
}


@lru_cache(maxsize=None)
def _reference(name: str):
    """(port map, port rule, result_max, xs, osd_weight, reference
    results, C++ results, reference tier) for one case; one reference
    compile each."""
    build, reweights, _ = CASES[name]
    jm, jrule, rm = build()
    dense = jm.to_dense()
    w = np.full(dense.max_devices, 0x10000, np.uint32)
    for osd, wt in reweights.items():
        w[osd] = wt
    xs = np.random.default_rng(len(name)).integers(0, 2**32, N, dtype=np.uint32)
    with jib._force_kernel_mode("0"):
        ca, fn = jengine.make_batch_runner(dense, jrule, rm)
        jres, jlens = (np.asarray(v) for v in fn(ca, w, xs))
    steps = [(s.op, s.arg1, s.arg2) for s in jrule.steps]
    cres, clens = cppref.do_rule_batch(dense, steps, xs, w, rm)
    tm = crushmap_from_reference(jm.to_obj())
    jtier = jengine.runner_signature(dense, jrule, rm)[0]
    return tm, tm.rules[jrule.id], rm, xs, w, (jres, jlens), (cres, clens), jtier


@pytest.mark.parametrize("mode", interp_batch.MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_runner_matches_reference_and_cpp(name, mode):
    tm, rule, rm, xs, w, (jres, jlens), (cres, clens), jtier = _reference(name)
    dense = tm.to_dense()
    tier = engine.runner_signature(dense, rule, rm, mode)[0]
    assert tier == jtier == CASES[name][2]
    ca, fn = engine.make_batch_runner(dense, rule, rm, mode=mode, device="cpu")
    res, lens = fn(ca, w, xs)
    assert res.dtype == lens.dtype == torch.int32 and res.shape == (N, rm)
    np.testing.assert_array_equal(res.numpy(), jres)  # exact
    np.testing.assert_array_equal(lens.numpy(), jlens)
    np.testing.assert_array_equal(res.numpy(), cres)
    np.testing.assert_array_equal(lens.numpy(), clens)


def test_overflowing_chain_raises_on_the_fast_engine():
    tm, rule, rm, *_ = _reference("chained_overflow_firstn")
    with pytest.raises(NotImplementedError):
        interp_batch.compile_rule_batch(tm.to_dense(), rule, rm, "cpu")


def test_run_batch_accepts_tensors():
    tm, rule, rm, xs, w, (jres, jlens), *_ = _reference("simple_reweighted")
    res, lens = engine.run_batch(
        tm.to_dense(), rule, torch.from_numpy(xs.astype(np.int64)),
        torch.from_numpy(w.astype(np.int64)), rm, device="cpu")
    np.testing.assert_array_equal(res.numpy(), jres)  # exact
    np.testing.assert_array_equal(lens.numpy(), jlens)


def test_unknown_mode_raises():
    tm, rule, rm, *_ = _reference("flat")
    with pytest.raises(ValueError):
        engine.make_batch_runner(tm.to_dense(), rule, rm, mode="fused", device="cpu")


def _emptying(kind: str):
    """Rules in which a choose step empties the working vector: an
    effective ``numrep = arg1 + result_max <= 0`` (F1's inputs), or a
    choose over a vector of devices, where no entry is a bucket."""
    def build():
        if kind == "flat_numrep_neg":
            m = build_flat(4)
            root = m.bucket_by_name("default").id
            return m, [Step(OP_TAKE, root), Step(OP_CHOOSE_FIRSTN, -1, 0), Step(OP_EMIT)], 1
        m = build_simple(16)
        root, host = m.bucket_by_name("default").id, m.type_id("host")
        steps = {
            "chained_numrep_neg": [Step(OP_TAKE, root), Step(OP_CHOOSE_FIRSTN, 2, host),
                                   Step(OP_CHOOSE_FIRSTN, -3, 0), Step(OP_EMIT)],
            # the emptied vector, then a new take that places normally
            "take_after_emptied": [Step(OP_TAKE, root), Step(OP_CHOOSE_FIRSTN, -3, host),
                                   Step(OP_EMIT), Step(OP_TAKE, root),
                                   Step(OP_CHOOSELEAF_FIRSTN, 0, host), Step(OP_EMIT)],
            "choose_after_emptied": [Step(OP_TAKE, root), Step(OP_CHOOSE_FIRSTN, -3, host),
                                     Step(OP_CHOOSELEAF_FIRSTN, 2, host), Step(OP_EMIT)],
            "choose_over_devices": [Step(OP_TAKE, root), Step(OP_CHOOSE_FIRSTN, 2, 0),
                                    Step(OP_CHOOSE_FIRSTN, 1, host), Step(OP_EMIT)],
            "choose_after_leaf": [Step(OP_TAKE, root), Step(OP_CHOOSELEAF_FIRSTN, 2, host),
                                  Step(OP_CHOOSE_INDEP, 1, 0), Step(OP_EMIT)],
        }[kind]
        return m, steps, 3
    return build


EMPTYING = ("flat_numrep_neg", "chained_numrep_neg", "take_after_emptied",
            "choose_after_emptied", "choose_over_devices", "choose_after_leaf")


@pytest.mark.parametrize("mode", interp_batch.MODES)
@pytest.mark.parametrize("kind", EMPTYING)
def test_emptied_working_vector_matches_cpp(kind, mode):
    """A choose that empties the working vector leaves nothing for a later
    choose or the emit until the next take (``mapper.c::crush_do_rule``,
    ``cpp/crush_ref.cpp``'s choose case).  Held against the C++ tier only:
    the reference engine makes the error logged as R5 and gives ``[-1]``
    on ``flat_numrep_neg`` and ``[-5, -4]`` on ``chained_numrep_neg``;
    the port follows the C++ tier there on purpose.  Exact equality."""
    jm, steps, rm = _emptying(kind)()
    jrule = jm.add_rule("emptying", steps)
    xs = np.random.default_rng(len(kind)).integers(0, 2**32, N, dtype=np.uint32)
    w = np.full(jm.to_dense().max_devices, 0x10000, np.uint32)
    cres, clens = cppref.do_rule_batch(
        jm.to_dense(), [(s.op, s.arg1, s.arg2) for s in jrule.steps], xs, w, rm)
    tm = crushmap_from_reference(jm.to_obj())
    dense, rule = tm.to_dense(), tm.rules[jrule.id]
    assert engine.runner_signature(dense, rule, rm, mode)[0] == "fast"
    ca, fn = engine.make_batch_runner(dense, rule, rm, mode=mode, device="cpu")
    res, lens = fn(ca, w, xs)
    np.testing.assert_array_equal(res.numpy(), cres)  # exact
    np.testing.assert_array_equal(lens.numpy(), clens)
    if kind != "take_after_emptied":
        assert not clens.any()
    else:
        assert (clens == rm).all()
