"""The port's general CRUSH engine vs the reference package and the C++ tier.

For each case (uniform and mixed uniform/straw2 maps, firstn and indep
rules, reweighted and out OSDs, size-1 and empty buckets, and uniform
buckets whose size the indep numrep divides), the port's
``ceph_tpu_torch.crush.interp.batch_do_rule`` on the CPU must equal the
reference's ``ceph_tpu.crush.interp.batch_do_rule`` and
``cppref.do_rule_batch`` on the same 3000 seeds, and the port's router
must pick the general tier for it, as the reference's does.  Maps are
built in the reference package and carried across with
``ceph_tpu_torch.convert``.  The router's other tiers: straw2 maps stay
on the fast engine, and the legacy local-retry tunables go to the C++
tier (ROADMAP's R6; the reference's general engine raises there).
All comparisons are integer: exact equality.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from ceph_tpu.crush import engine as jengine
from ceph_tpu.crush import interp as jinterp
from ceph_tpu.crush.map import (
    ALG_STRAW2,
    ALG_UNIFORM,
    CrushMap,
    OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP,
    OP_CHOOSELEAF_FIRSTN,
    OP_CHOOSELEAF_INDEP,
    OP_EMIT,
    OP_SET_CHOOSE_LOCAL_TRIES,
    OP_SET_CHOOSELEAF_TRIES,
    OP_SET_CHOOSELEAF_VARY_R,
    OP_TAKE,
    Step,
    Tunables,
)
from ceph_tpu.models.clusters import build_flat, build_hierarchy, build_simple
from ceph_tpu.testing import cppref
from ceph_tpu_torch.convert import crushmap_from_reference
from ceph_tpu_torch.crush import engine, interp

N = 3000


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """Put the reference's program caches back after this module (see
    tests/test_torch_crush_batch.py)."""
    from ceph_tpu.crush import interp_batch as ib
    from ceph_tpu.osdmap import mapping

    caches = (ib._FAST_CACHE, ib._PACK_CACHE, jinterp._BATCH_CACHE, mapping._POOL_FN_CACHE)
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


def _tree(levels, per_leaf, root_alg, tunables=None, empty_leaf=False, lone_leaf=False):
    """root -> levels (outer to inner: ``(type, count, alg)``) -> OSDs,
    every bucket weighted by its OSDs.  ``empty_leaf`` adds an empty
    leaf bucket to every parent of leaves; ``lone_leaf`` gives the first
    leaf a single OSD."""
    m = CrushMap(tunables)
    m.add_type(1, "root")
    for i, (tname, _, _) in enumerate(levels):
        m.add_type(2 + i, tname)
    osd = [0]

    def grow(parent, depth, prefix):
        tname, count, alg = levels[depth]
        total = 0
        for c in range(count):
            b = m.add_bucket(f"{tname}{prefix}_{c}", tname, alg=alg)
            if depth + 1 < len(levels):
                w = grow(b, depth + 1, f"{prefix}_{c}")
            else:
                n = 1 if (lone_leaf and osd[0] == 0) else per_leaf
                for _ in range(n):
                    m.insert_item(b.id, osd[0], 0x10000)
                    osd[0] += 1
                w = n * 0x10000
            m.insert_item(parent.id, b.id, w)
            total += w
        if empty_leaf and depth + 1 == len(levels):
            m.insert_item(parent.id, m.add_bucket(f"empty{prefix}", tname, alg=alg).id, 0)
        return total

    grow(m.add_bucket("default", "root", alg=root_alg), 0, "")
    m.make_replicated_rule("replicated_rule", "default", levels[-1][0])
    m.make_erasure_rule("ec", "default", levels[-1][0])
    return m


def _mixed(tunables=None):
    """straw2 root and racks over uniform hosts, with an empty host in
    every rack (weight 0 in a straw2 rack: never drawn) and a first host
    of one OSD."""
    return _tree([("rack", 4, ALG_STRAW2), ("host", 3, ALG_UNIFORM)], 3, ALG_STRAW2,
                 tunables, empty_leaf=True, lone_leaf=True)


def _uniform_with_empty():
    """A uniform hierarchy with an empty rack under the root, an empty
    host in every rack and a first host of one OSD: a uniform parent
    picks an empty bucket whatever its weight.  Descending into the
    empty rack, firstn retries and indep leaves a NONE hole; the empty
    host fails the leaf recursion."""
    m = _tree([("rack", 3, ALG_UNIFORM), ("host", 3, ALG_UNIFORM)], 3, ALG_UNIFORM,
              empty_leaf=True, lone_leaf=True)
    empty = m.add_bucket("emptyrack", "rack", alg=ALG_UNIFORM)
    m.insert_item(m.bucket_by_name("default").id, empty.id, 0)
    return m


def _rule(m, name, steps):
    return m.add_rule(name, [Step(OP_TAKE, m.bucket_by_name("default").id), *steps,
                             Step(OP_EMIT)])


def _flat_uniform():
    m = build_flat(10, alg=ALG_UNIFORM)
    return m, m.rule_by_name("replicated_rule"), 3


def _hierarchy(tunables=None):
    def build():
        m = build_hierarchy([("rack", 3), ("host", 4)], 4, alg=ALG_UNIFORM, tunables=tunables)
        return m, m.rule_by_name("replicated_rule"), 3
    return build


def _spaced_indep():
    """Uniform buckets whose sizes numrep = 4 divides (root 8 hosts, hosts
    of 4 OSDs): indep's r steps by numrep + 1 at every level."""
    m = build_hierarchy([("host", 8)], 4, alg=ALG_UNIFORM)
    return m, _rule(m, "spaced", [Step(OP_SET_CHOOSELEAF_TRIES, 5),
                                  Step(OP_CHOOSELEAF_INDEP, 0, m.type_id("host"))]), 4


def _spaced_mixed():
    """The same spacing in one level only: a uniform root of 6 racks (6 %
    6 == 0) over straw2 racks over uniform hosts of 3 OSDs (3 % 6 != 0)."""
    m = _tree([("rack", 6, ALG_STRAW2), ("host", 2, ALG_UNIFORM)], 3, ALG_UNIFORM)
    return m, _rule(m, "spaced", [Step(OP_SET_CHOOSELEAF_TRIES, 3),
                                  Step(OP_CHOOSELEAF_INDEP, 6, m.type_id("host"))]), 6


def _flat_indep():
    m = build_flat(12, alg=ALG_UNIFORM)
    return m, _rule(m, "indep_osd", [Step(OP_CHOOSE_INDEP, 4, 0)]), 4


def _mixed_rule(rule_name, rm):
    def build():
        m = _mixed()
        return m, m.rule_by_name(rule_name), rm
    return build


def _vary_r2():
    m = _mixed(tunables=Tunables.profile("bobtail"))
    return m, _rule(m, "vary_r2", [Step(OP_SET_CHOOSELEAF_VARY_R, 2),
                                   Step(OP_CHOOSELEAF_FIRSTN, 0, m.type_id("host"))]), 3


def _two_takes():
    """Two take/choose/emit pairs on one uniform map."""
    m = build_hierarchy([("rack", 2), ("host", 3)], 2, alg=ALG_UNIFORM)
    steps = []
    for r in range(2):
        steps += [Step(OP_TAKE, m.bucket_by_name(f"rack{r}").id),
                  Step(OP_CHOOSELEAF_FIRSTN, 1, m.type_id("host")), Step(OP_EMIT)]
    return m, m.add_rule("two_takes", steps), 3


def _choose_osds():
    m = _mixed()
    return m, _rule(m, "osds", [Step(OP_CHOOSE_FIRSTN, 0, 0)]), 4


# name -> (map and rule factory, osd reweights {osd: weight})
CASES = {
    "flat_uniform": (_flat_uniform, {}),
    "flat_uniform_out": (_flat_uniform, {2: 0, 7: 0x8000}),
    "hierarchy": (_hierarchy(), {}),
    "hierarchy_reweighted": (_hierarchy(), {3: 0, 9: 0x8000, 20: 0x4000, 41: 0}),
    "hierarchy_firefly": (_hierarchy(Tunables.profile("firefly")), {5: 0, 6: 0x8000}),
    "hierarchy_no_descend_once": (_hierarchy(Tunables(50, 0, 0, 0, 0, 0)), {5: 0, 30: 0}),
    "mixed": (_mixed_rule("replicated_rule", 3), {}),
    "mixed_out": (_mixed_rule("replicated_rule", 3), {0: 0, 4: 0, 5: 0x8000, 11: 0}),
    "mixed_ec": (_mixed_rule("ec", 6), {1: 0, 7: 0xC000}),
    "mixed_ec_out": (_mixed_rule("ec", 6), {0: 0, 2: 0, 9: 0x8000}),
    "uniform_empty_firstn": (lambda: (lambda m: (m, m.rule_by_name("replicated_rule"), 3))(
        _uniform_with_empty()), {1: 0}),
    "uniform_empty_ec": (lambda: (lambda m: (m, m.rule_by_name("ec"), 5))(
        _uniform_with_empty()), {1: 0, 4: 0x8000}),
    "spaced_indep": (_spaced_indep, {3: 0, 12: 0x8000}),
    "spaced_mixed": (_spaced_mixed, {0: 0, 7: 0}),
    "flat_indep": (_flat_indep, {4: 0}),
    "vary_r2": (_vary_r2, {3: 0}),
    "two_takes": (_two_takes, {0: 0}),
    "choose_osds": (_choose_osds, {2: 0, 3: 0x8000}),
}


@lru_cache(maxsize=None)
def _case(name: str):
    """(port map, port rule, result_max, xs, weights, reference results,
    C++ results, reference tier) for one case; one reference compile."""
    build, reweights = CASES[name]
    jm, jrule, rm = build()
    dense = jm.to_dense()
    w = np.full(dense.max_devices, 0x10000, np.uint32)
    for osd, wt in reweights.items():
        w[osd] = wt
    xs = np.random.default_rng(len(name)).integers(0, 2**32, N, dtype=np.uint32)
    jres, jlens = (np.asarray(v) for v in jinterp.batch_do_rule(
        jinterp.StaticCrushMap(dense), jrule, xs, w, rm))
    cres, clens = cppref.do_rule_batch(dense, [(s.op, s.arg1, s.arg2) for s in jrule.steps],
                                       xs, w, rm)
    tm = crushmap_from_reference(jm.to_obj())
    jtier = jengine.runner_signature(dense, jrule, rm)[0]
    return tm, tm.rules[jrule.id], rm, xs, w, (jres, jlens), (cres, clens), jtier


@pytest.mark.parametrize("name", list(CASES))
def test_general_engine_matches_reference_and_cpp(name):
    tm, rule, rm, xs, w, (jres, jlens), (cres, clens), jtier = _case(name)
    dense = tm.to_dense()
    assert jtier == "vmap"
    assert engine.runner_signature(dense, rule, rm)[0] == "general"
    res, lens = interp.batch_do_rule(interp.StaticCrushMap(dense, "cpu"), rule, xs, w, rm)
    assert res.dtype == lens.dtype == torch.int32 and res.shape == (N, rm)
    np.testing.assert_array_equal(res.numpy(), jres)  # exact
    np.testing.assert_array_equal(lens.numpy(), jlens)
    np.testing.assert_array_equal(res.numpy(), cres)
    np.testing.assert_array_equal(lens.numpy(), clens)
    # and through the router, as OSDMapMapping and crushtool call it
    res2, lens2 = engine.run_batch(dense, rule, xs, w, rm, device="cpu")
    assert torch.equal(res2, res) and torch.equal(lens2, lens)


def test_cases_cover_the_traps():
    """The cases reach what the general engine adds: retries and NONE
    holes, uniform spacing under indep, and both algs in one map."""
    spaced = _case("spaced_indep")
    assert (spaced[6][0] == 0x7FFFFFFF).sum() == 0  # every slot placed
    holes = _case("uniform_empty_ec")[6][0]
    assert (holes == 0x7FFFFFFF).any()  # an empty host met by indep: a NONE hole
    tm = _case("mixed")[0]
    assert tm.to_dense().algs_present() == {ALG_STRAW2, ALG_UNIFORM}


def test_straw2_routes_to_the_fast_engine():
    m = crushmap_from_reference(build_simple(32).to_obj())
    assert engine.runner_signature(m.to_dense(), m.rule_by_name("replicated_rule"), 3)[0] == \
        "fast"


@pytest.mark.parametrize("where", ["tunables", "rule_step"])
@pytest.mark.parametrize("alg", [ALG_STRAW2, ALG_UNIFORM])
def test_local_retry_tunables_run_on_the_cpp_tier(where, alg):
    """R6: the reference routes such maps to its general engine, which
    raises; the port answers on the exact C++ tier."""
    tun = Tunables.profile("argonaut") if where == "tunables" else None
    jm = build_flat(8, alg=alg, tunables=tun)
    jrule = jm.rule_by_name("replicated_rule")
    if where == "rule_step":
        jrule = _rule(jm, "local", [Step(OP_SET_CHOOSE_LOCAL_TRIES, 2),
                                    Step(OP_CHOOSE_FIRSTN, 0, 0)])
    dense = jm.to_dense()
    with pytest.raises(NotImplementedError):
        jinterp.compile_rule(jinterp.StaticCrushMap(dense), jrule, 3)
    tm = crushmap_from_reference(jm.to_obj())
    tdense, rule = tm.to_dense(), tm.rules[jrule.id]
    assert engine.runner_signature(tdense, rule, 3)[0] == "host"
    with pytest.raises(NotImplementedError):
        interp.compile_rule(interp.StaticCrushMap(tdense, "cpu"), rule, 3)
    xs = np.random.default_rng(6).integers(0, 2**32, 500, dtype=np.uint32)
    w = np.full(tdense.max_devices, 0x10000, np.uint32)
    w[2] = 0
    res, lens = engine.run_batch(tdense, rule, xs, w, 3, device="cpu")
    cres, clens = cppref.do_rule_batch(dense, [(s.op, s.arg1, s.arg2) for s in jrule.steps],
                                       xs, w, 3)
    np.testing.assert_array_equal(res.numpy(), cres)
    np.testing.assert_array_equal(lens.numpy(), clens)


@pytest.mark.parametrize("kind", ["numrep_neg", "take_emit", "emit_then_choose",
                                  "device_take_choose"])
def test_uniform_edge_rules_match_cpp(kind):
    """Rules at the edge of the general engine's scope on a uniform map,
    held against the C++ tier: a choose whose effective numrep is <= 0
    empties the working vector (the reference's engine emits the take
    there, R5); a bare take; emit; a choose after an emit and a choose
    after a take of a device (C++ tier: nothing to choose from)."""
    jm = build_hierarchy([("rack", 2), ("host", 2)], 2, alg=ALG_UNIFORM)
    root = jm.bucket_by_name("default").id
    host = jm.type_id("host")
    steps = {
        "numrep_neg": [Step(OP_TAKE, root), Step(OP_CHOOSELEAF_FIRSTN, -3, host), Step(OP_EMIT)],
        "take_emit": [Step(OP_TAKE, root), Step(OP_EMIT), Step(OP_TAKE, 3), Step(OP_EMIT)],
        "emit_then_choose": [Step(OP_TAKE, root), Step(OP_EMIT),
                             Step(OP_CHOOSELEAF_FIRSTN, 1, host), Step(OP_EMIT)],
        "device_take_choose": [Step(OP_TAKE, 3), Step(OP_CHOOSE_FIRSTN, 1, 0), Step(OP_EMIT)],
    }[kind]
    jrule = jm.add_rule("edge", steps)
    dense = jm.to_dense()
    xs = np.random.default_rng(len(kind)).integers(0, 2**32, 300, dtype=np.uint32)
    w = np.full(dense.max_devices, 0x10000, np.uint32)
    cres, clens = cppref.do_rule_batch(dense, [(s.op, s.arg1, s.arg2) for s in steps], xs, w, 3)
    tm = crushmap_from_reference(jm.to_obj())
    rule = tm.rules[jrule.id]
    tier = engine.runner_signature(tm.to_dense(), rule, 3)[0]
    assert tier == ("general" if kind in ("numrep_neg", "take_emit") else "host")
    res, lens = engine.run_batch(tm.to_dense(), rule, xs, w, 3, device="cpu")
    np.testing.assert_array_equal(res.numpy(), cres)  # exact
    np.testing.assert_array_equal(lens.numpy(), clens)


def test_general_engine_counts_k1_draws_on_straw2_levels():
    """A mixed map's straw2 levels call K1's wrapper (its plain version on
    the CPU); a uniform map's never do."""
    from ceph_tpu_torch.core import straw2

    calls = []
    real = straw2.negdraw_plain
    try:
        straw2.negdraw_plain = lambda *a: calls.append(a[2].shape) or real(*a)
        for name, want in (("mixed", True), ("hierarchy", False)):
            calls.clear()
            tm, rule, rm, xs, w, *_ = _case(name)
            interp.batch_do_rule(interp.StaticCrushMap(tm.to_dense(), "cpu"), rule, xs[:64],
                                 w, rm)
            assert bool(calls) == want
    finally:
        straw2.negdraw_plain = real
