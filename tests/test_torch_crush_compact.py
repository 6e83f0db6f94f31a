"""The general engine's compacted-straggler retry vs its masked rounds and C++.

From ``B = 1 << 16`` lanes (``interp.COMPACT_MIN_BATCH``) the general
engine runs every retry round after the first on the stragglers only.
At that size, the compacted rounds must equal the masked rounds (the
threshold raised above the batch) and ``cppref.do_rule_batch``: on
``build_skewed`` with out and reweighted OSDs, so that lanes retry, for
firstn, indep and multi-take rules (the reference package's
``tests/test_crush_batch.py`` holds its own compaction to the C++ tier
the same way; the router sends these straw2 maps to the fast engine,
which must not compact and gives the same results), and on uniform and
mixed maps.  The straggler rounds must really run on fewer lanes than
the batch, and a smaller batch must not compact.  Everything runs on
the CPU (the kernels' plain versions).  All comparisons are integer:
exact equality.
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import engine, interp, interp_batch
from ceph_tpu_torch.crush.map import (
    ALG_STRAW2,
    ALG_UNIFORM,
    CrushMap,
    OP_CHOOSELEAF_FIRSTN,
    OP_CHOOSELEAF_INDEP,
    OP_EMIT,
    OP_SET_CHOOSELEAF_TRIES,
    OP_TAKE,
    Step,
)
from ceph_tpu_torch.models.clusters import build_hierarchy, build_skewed
from ceph_tpu_torch.testing import cppref

B = interp.COMPACT_MIN_BATCH


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many test workers share the CPU: one intra-op thread a worker keeps
    these 65,536-lane batches from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skewed(kind):
    """``build_skewed(96)`` (dc, rack, host, OSD; ragged, mixed weights)
    with out and reweighted OSDs, under a firstn, an indep or a
    multi-take rule."""
    m = build_skewed(96, seed=1)
    root, dc, host = (m.bucket_by_name("default").id, m.type_id("dc"), m.type_id("host"))
    w = np.full(m.max_devices, 0x10000, np.uint32)
    if kind == "firstn":
        w[[3, 7, 11, 40, 41]] = 0
        w[[5, 9]] = 0x8000
        return m, m.rule_by_name("replicated_rule"), w, 3
    w[3] = 0
    if kind == "indep":
        steps = [Step(OP_SET_CHOOSELEAF_TRIES, 5), Step(OP_TAKE, root),
                 Step(OP_CHOOSELEAF_INDEP, 3, host), Step(OP_EMIT)]
    else:  # two takes, one under each of the first two dcs
        dcs = [b.id for b in sorted(m.buckets.values(), key=lambda b: -b.id)
               if b.type_id == dc][:2]
        steps = [Step(OP_TAKE, dcs[0]), Step(OP_CHOOSELEAF_FIRSTN, 1, host), Step(OP_EMIT),
                 Step(OP_TAKE, dcs[1]), Step(OP_CHOOSELEAF_FIRSTN, 2, host), Step(OP_EMIT)]
    return m, m.add_rule(kind, steps), w, 3


CASES = ("firstn", "indep", "multi_take")


def _spy_stragglers(monkeypatch) -> list:
    """Record the lane count of every straggler round."""
    rounds = []
    real = interp_batch._stragglers

    def spy(mask):
        idx = real(mask)
        rounds.append(0 if idx is None else idx.numel())
        return idx

    monkeypatch.setattr(interp_batch, "_stragglers", spy)
    return rounds


def _compacted_and_masked(monkeypatch, run, cpp):
    """``run()`` at B lanes compacted, then masked: both equal ``cpp``
    (results, lens), and the straggler rounds ran on fewer lanes."""
    rounds = _spy_stragglers(monkeypatch)
    res_c, lens_c = run()
    assert 0 < max(rounds) < B  # rounds after the first ran on stragglers only
    assert rounds[-1] == 0
    rounds.clear()
    monkeypatch.setattr(interp, "COMPACT_MIN_BATCH", B + 1)
    res, lens = run()
    assert not rounds  # masked below the threshold
    assert torch.equal(res_c, res) and torch.equal(lens_c, lens)
    np.testing.assert_array_equal(res_c.numpy(), cpp[0])  # exact
    np.testing.assert_array_equal(lens_c.numpy(), cpp[1])


@pytest.mark.parametrize("name", CASES)
def test_compacted_retry_equals_masked_rounds_and_cpp(name, monkeypatch):
    m, rule, w, rm = _skewed(name)
    dense = m.to_dense()
    xs = np.random.default_rng(len(name)).integers(0, 2**32, B, dtype=np.uint32)
    cppref.reset_retry_stats()
    cpp = cppref.do_rule_batch(dense, [(s.op, s.arg1, s.arg2) for s in rule.steps], xs, w, rm)
    assert cppref.retry_stats()[0] >= 1, "no lane retried; compaction untested"
    rounds = _spy_stragglers(monkeypatch)
    assert engine.runner_signature(dense, rule, rm)[0] == "fast"
    res, lens = engine.run_batch(dense, rule, xs, w, rm, device="cpu")
    assert not rounds  # the fast engine's rounds are masked
    np.testing.assert_array_equal(res.numpy(), cpp[0])
    np.testing.assert_array_equal(lens.numpy(), cpp[1])
    smap = interp.StaticCrushMap(dense, "cpu")
    _compacted_and_masked(monkeypatch, lambda: interp.batch_do_rule(smap, rule, xs, w, rm), cpp)


def test_compaction_needs_a_large_batch(monkeypatch):
    """Below the threshold the masked rounds run."""
    m, rule, w, _ = _general("mixed")
    calls = []
    monkeypatch.setattr(interp_batch, "_stragglers", lambda mask: calls.append(1))
    xs = np.arange(4096, dtype=np.uint32)
    assert engine.runner_signature(m.to_dense(), rule, 3)[0] == "general"
    res, lens = engine.run_batch(m.to_dense(), rule, xs, w, 3, device="cpu")
    assert not calls
    cres, clens = cppref.do_rule_batch(m.to_dense(), [(s.op, s.arg1, s.arg2) for s in rule.steps],
                                       xs, w, 3)
    np.testing.assert_array_equal(res.numpy(), cres)
    np.testing.assert_array_equal(lens.numpy(), clens)


def _mixed(hosts: int):
    """straw2 root and 4 straw2 racks over ``hosts`` uniform hosts of 3
    OSDs each."""
    m = CrushMap()
    for tid, name in ((1, "root"), (2, "rack"), (3, "host")):
        m.add_type(tid, name)
    root = m.add_bucket("default", "root", alg=ALG_STRAW2)
    osd = 0
    for r in range(4):
        rack = m.add_bucket(f"rack{r}", "rack", alg=ALG_STRAW2)
        for h in range(hosts):
            host = m.add_bucket(f"host{r}_{h}", "host", alg=ALG_UNIFORM)
            for _ in range(3):
                m.insert_item(host.id, osd, 0x10000)
                osd += 1
            m.insert_item(rack.id, host.id, 3 * 0x10000)
        m.insert_item(root.id, rack.id, hosts * 3 * 0x10000)
    m.make_replicated_rule("replicated_rule", "default", "host")
    return m


def _indep(m, slots: int, leaf_tries: int):
    return m.add_rule("indep", [Step(OP_SET_CHOOSELEAF_TRIES, leaf_tries),
                                Step(OP_TAKE, m.bucket_by_name("default").id),
                                Step(OP_CHOOSELEAF_INDEP, slots, m.type_id("host")),
                                Step(OP_EMIT)])


def _general(kind):
    """Maps of the general engine with out OSDs, each small enough for
    the masked rounds at B lanes on the CPU: a uniform hierarchy
    (firstn); a uniform one under indep (4 slots; racks of 4 hosts step
    r by 5, hosts of 2 OSDs by 4, so a leaf retry meets the same out OSD
    again and the slot waits for the next round); straw2 racks over
    uniform hosts, firstn and indep (3 slots)."""
    if kind == "uniform":
        m = build_hierarchy([("rack", 4), ("host", 4)], 4, alg=ALG_UNIFORM)
        rule, rm = m.rule_by_name("replicated_rule"), 3
    elif kind == "uniform_indep":
        m = build_hierarchy([("rack", 2), ("host", 4)], 2, alg=ALG_UNIFORM)
        rule, rm = _indep(m, 4, 3), 4
    elif kind == "mixed":
        m = _mixed(3)
        rule, rm = m.rule_by_name("replicated_rule"), 3
    else:
        m = _mixed(4)
        rule, rm = _indep(m, 3, 5), 3
    w = np.full(m.max_devices, 0x10000, np.uint32)
    w[[1, 6, 13]] = 0
    w[9] = 0x8000
    return m, rule, w, rm


@pytest.mark.parametrize("kind", ["uniform", "uniform_indep", "mixed", "mixed_indep"])
def test_general_engine_compacted_retry_equals_masked_rounds_and_cpp(kind, monkeypatch):
    m, rule, w, rm = _general(kind)
    dense = m.to_dense()
    assert engine.runner_signature(dense, rule, rm)[0] == "general"
    xs = np.random.default_rng(7).integers(0, 2**32, B, dtype=np.uint32)
    cpp = cppref.do_rule_batch(dense, [(s.op, s.arg1, s.arg2) for s in rule.steps], xs, w, rm)
    smap = interp.StaticCrushMap(dense, "cpu")
    _compacted_and_masked(monkeypatch, lambda: interp.batch_do_rule(smap, rule, xs, w, rm), cpp)
