"""The port's CLAY and LRC codecs vs the reference package's.

CLAY k=4 m=2 (d=5), k=4 m=3 d=5 and k=4 m=3 d=4: encode; decode of
1..m erasures (every pattern against the original chunks, a sample
against the reference's decode); repair of every chunk from the
minimal helper sub-chunks, against the reference's ``repair`` and the
original.  LRC k=4 m=2 l=3: decode of lost chunks against the
reference, and ``create_rule`` on a port ``CrushMap``.  The port runs
with ``device="cpu"`` (K4 and K7 as their plain versions).  All
comparisons are integer: exact equality.
"""

import itertools
from functools import lru_cache

import numpy as np
import pytest

from ceph_tpu.crush.engine import run_batch
from ceph_tpu.ec import create as ref_create
from ceph_tpu.models import build_simple as ref_build_simple
from ceph_tpu_torch.crush.engine import make_batch_runner
from ceph_tpu_torch.ec import ErasureCodeError, create
from ceph_tpu_torch.models.clusters import build_simple

CLAY = {
    "clay_4_2": {"plugin": "clay", "k": "4", "m": "2"},
    "clay_4_3_d5": {"plugin": "clay", "k": "4", "m": "3", "d": "5"},
    "clay_4_3_d4": {"plugin": "clay", "k": "4", "m": "3", "d": "4"},
}
LRC = {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """The reference memoizes its compiled placement programs process-wide
    (``run_batch`` below fills them); put its caches back after this
    module, so a later test file in the same worker finds what it would
    have found without this one."""
    from ceph_tpu.crush import interp, interp_batch as ib
    from ceph_tpu.osdmap import mapping

    caches = (ib._FAST_CACHE, ib._PACK_CACHE, interp._BATCH_CACHE, mapping._POOL_FN_CACHE)
    saved = [dict(c) for c in caches]
    yield
    for cache, before in zip(caches, saved):
        cache.clear()
        cache.update(before)


@lru_cache(maxsize=None)
def _pair(name):
    """(reference codec, port codec, encoded chunks) for one profile."""
    prof = CLAY[name]
    ref = ref_create(prof)
    port = create(prof, device="cpu")
    rng = np.random.default_rng(len(name))
    data = rng.integers(0, 256, 4 * ref.get_sub_chunk_count() * 8 * 13, dtype=np.uint8)
    chunks = ref.encode(set(range(ref.get_chunk_count())), data)
    return ref, port, data, chunks


@pytest.mark.parametrize("name", list(CLAY))
def test_clay_encode_matches_reference(name):
    ref, port, data, want = _pair(name)
    got = port.encode(set(range(port.get_chunk_count())), data)
    assert port.get_sub_chunk_count() == ref.get_sub_chunk_count()
    for i in want:
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"{name} chunk {i}")


@pytest.mark.parametrize("name", list(CLAY))
def test_clay_decode_every_pattern(name):
    ref, port, _, full = _pair(name)
    n, m = ref.get_chunk_count(), ref.get_coding_chunk_count()
    patterns = [p for r in range(1, m + 1) for p in itertools.combinations(range(n), r)]
    for lost in patterns:
        avail = {i: c.copy() for i, c in full.items() if i not in lost}
        got = port.decode_chunks(set(lost), avail)
        for i in lost:
            np.testing.assert_array_equal(got[i], full[i], err_msg=f"{name} lost {lost}")
    # the reference's own decode on a sample: singles and m-erasures
    for lost in [(0,), (n - 1,), tuple(range(m)), tuple(range(n - m, n))]:
        avail = {i: c.copy() for i, c in full.items() if i not in lost}
        want = ref.decode_chunks(set(lost), dict(avail))
        got = port.decode_chunks(set(lost), dict(avail))
        for i in lost:
            np.testing.assert_array_equal(got[i], want[i], err_msg=f"{name} lost {lost}")


@pytest.mark.parametrize("name", list(CLAY))
def test_clay_repair_every_chunk(name):
    ref, port, _, full = _pair(name)
    n = ref.get_chunk_count()
    Z = ref.get_sub_chunk_count()
    sub = len(full[0]) // Z
    for lost in range(n):
        helpers, planes = port.minimum_to_decode_subchunks(lost, set(range(n)) - {lost})
        assert (helpers, planes) == ref.minimum_to_decode_subchunks(lost, set(range(n)) - {lost})
        assert len(helpers) == port.d and len(planes) == Z // port.q
        helper_subchunks = {i: {int(z): full[i][z * sub:(z + 1) * sub] for z in planes}
                            for i in helpers}
        got = port.repair(lost, helper_subchunks)
        np.testing.assert_array_equal(got, full[lost], err_msg=f"{name} lost {lost}")
        np.testing.assert_array_equal(got, ref.repair(lost, helper_subchunks))


def test_clay_repair_rejects_wrong_helpers():
    """k=4 m=3 d=5: q=2, lost node 0 sits in grid row {0, 1}, so node 1
    must help; five other survivors are refused."""
    _, port, _, full = _pair("clay_4_3_d5")
    Z = port.get_sub_chunk_count()
    sub = len(full[0]) // Z
    helpers, planes = port.minimum_to_decode_subchunks(0, set(range(1, 7)))
    assert 1 in helpers
    bad = {i: {int(z): full[i][z * sub:(z + 1) * sub] for z in planes} for i in (2, 3, 4, 5, 6)}
    with pytest.raises(ErasureCodeError):
        port.repair(0, bad)


def test_clay_rejects_bad_d_and_too_many_erasures():
    with pytest.raises(ErasureCodeError):
        create({"plugin": "clay", "k": "4", "m": "2", "d": "3"}, device="cpu")
    _, port, _, full = _pair("clay_4_2")
    with pytest.raises(ErasureCodeError):
        port.decode_chunks({0, 1, 2}, {i: full[i] for i in (3, 4, 5)})


@lru_cache(maxsize=None)
def _lrc():
    ref = ref_create(LRC)
    port = create(LRC, device="cpu")
    data = np.random.default_rng(9).integers(0, 256, 12_345, dtype=np.uint8)
    return ref, port, ref.encode(set(range(ref.get_chunk_count())), data)


@pytest.mark.parametrize("lost", [(0,), (2,), (3,), (5,), (7,), (2, 3), (1, 6), (2, 7)])
def test_lrc_decode_matches_reference(lost):
    ref, port, full = _lrc()
    assert port.mapping == ref.mapping
    avail = {i: c.copy() for i, c in full.items() if i not in lost}
    want = ref.decode(set(lost), dict(avail), len(full[0]))
    got = port.decode(set(lost), dict(avail), len(full[0]))
    for i in lost:
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"lost {lost}")
        np.testing.assert_array_equal(got[i], full[i], err_msg=f"lost {lost}")
    if len(lost) == 1:
        assert port.minimum_to_decode(set(lost), set(avail)) == ref.minimum_to_decode(
            set(lost), set(avail))


@pytest.mark.parametrize("profile", [
    {"plugin": "jerasure", "k": "4", "m": "2", "crush-failure-domain": "rack"},
    {"plugin": "lrc", "k": "4", "m": "2", "l": "3",
     "crush-steps": '[["choose", "rack", 2], ["chooseleaf", "host", 4]]'},
])
def test_create_rule_on_a_port_crushmap(profile):
    """The same rule steps as the reference's on the same map, and the
    port's batch engine places with it as the reference's does."""
    ref_m, port_m = ref_build_simple(192), build_simple(192)
    ref_rule = ref_create(profile).create_rule("ecpool", ref_m)
    ec = create(profile, device="cpu")
    rule = ec.create_rule("ecpool", port_m)
    assert rule.kind == "erasure" and port_m.rule_by_name("ecpool") is rule
    assert [(s.op, s.arg1, s.arg2) for s in rule.steps] == [
        (s.op, s.arg1, s.arg2) for s in ref_rule.steps]
    n = ec.get_chunk_count()
    xs = np.arange(256, dtype=np.uint32)
    w = np.full(port_m.max_devices, 0x10000, np.uint32)
    want, wlens = run_batch(ref_m.to_dense(), ref_rule, xs, w, n)
    ca, fn = make_batch_runner(port_m.to_dense(), rule, n, device="cpu")
    got, lens = fn(ca, w, xs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(wlens))
