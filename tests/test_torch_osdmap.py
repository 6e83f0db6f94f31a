"""The port's OSDMapMapping vs the reference package's.

``OSDMapMapping.update`` on build_osdmap(64, pg_num=256) with upmap
items, a full pg_upmap, pg_temp, a primary_temp, primary affinity, a
down and an out OSD: the port's up/acting/primary tables (each CRUSH
mode, plain versions on the CPU) must equal the reference's, and the
port's scalar pipeline on a sample.  The map is built in the reference
package and carried across as ``OSDMap.encode()`` bytes.  All
comparisons are integer: exact equality.
"""

from functools import lru_cache

import numpy as np
import pytest

from ceph_tpu.models.clusters import build_osdmap
from ceph_tpu.osdmap import OSDMapMapping as RefMapping
from ceph_tpu.osdmap.map import PGId as RefPGId
from ceph_tpu_torch.convert import osdmap_from_reference
from ceph_tpu_torch.crush.map import ITEM_NONE
from ceph_tpu_torch.crush.interp_batch import MODES
from ceph_tpu_torch.osdmap import OSDMapMapping, PGId

PG_NUM = 256


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


def _decorate(m):
    rng = np.random.default_rng(99)
    m.pg_upmap_items[RefPGId(1, 3)] = ((0, 9), (5, 60))
    m.pg_upmap_items[RefPGId(1, 7)] = ((1, 2),)
    for ps, raw in m.pg_to_raw_osds_batch(1, list(range(20, 40))).items():
        to = int(rng.integers(64))
        if to not in raw:
            m.pg_upmap_items[RefPGId(1, ps)] = ((raw[-1], to),)
    m.pg_upmap[RefPGId(1, 11)] = (4, 20, 40)
    m.pg_upmap[RefPGId(1, 12)] = (6, 22, 33)  # voided below: osd 33 goes out
    m.pg_temp[RefPGId(1, 17)] = (8, 30, 50)
    m.pg_temp[RefPGId(1, 18)] = (13, 31)  # osd 13 goes down
    m.primary_temp[RefPGId(1, 19)] = 12
    for o in range(0, 64, 5):
        m.osd_primary_affinity[o] = int(rng.integers(0, 0x10000))
    m.mark_down(13)
    m.mark_out(33)
    return m


@lru_cache(maxsize=None)
def _reference(kind: str):
    size = 3 if kind == "replicated" else 6
    m = _decorate(build_osdmap(64, pg_num=PG_NUM, size=size, pool_kind=kind))
    ref = RefMapping(m)
    ref.update()
    return m.encode(), tuple(np.asarray(v) for v in ref._results[1])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["replicated", "erasure"])
def test_mapping_matches_reference(kind, mode):
    blob, want = _reference(kind)
    m = osdmap_from_reference(blob)
    mp = OSDMapMapping(m, mode=mode, device="cpu")
    mp.update()
    for got, w in zip(mp._results[1], want):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, w)  # exact


def _rows(mp, m, ps):
    """(table rows, scalar pipeline padded to the table's width): EC
    pools keep positional ITEM_NONE holes, which ``get()`` drops."""
    up, upp, acting, actp = (t[ps] for t in mp._results[1])
    s_up, s_upp, s_acting, s_actp = m.pg_to_up_acting_osds(PGId(1, ps))
    pad = lambda v: list(v) + [ITEM_NONE] * (len(up) - len(v))
    return ((up.tolist(), int(upp), acting.tolist(), int(actp)),
            (pad(s_up), s_upp, pad(s_acting), s_actp))


@pytest.mark.parametrize("kind", ["replicated", "erasure"])
def test_mapping_matches_scalar_pipeline(kind):
    m = osdmap_from_reference(_reference(kind)[0])
    mp = OSDMapMapping(m, device="cpu")
    mp.update(1)
    for ps in list(range(0, 40)) + list(range(40, PG_NUM, 13)):
        got, want = _rows(mp, m, ps)
        assert got == want
    counts = mp.pg_counts_by_osd(1)
    assert counts.shape == (64,) and counts[33] == 0


def test_mapping_follows_a_map_change():
    """A CRUSH change after the first update rebuilds the program."""
    m = osdmap_from_reference(_reference("replicated")[0])
    mp = OSDMapMapping(m, device="cpu")
    mp.update()
    host = m.crush.bucket_by_name("host0_0")
    m.crush.adjust_item_weight(host.id, host.items[0], 0)
    mp.update()
    for ps in range(0, PG_NUM, 7):
        assert mp.get(PGId(1, ps)) == m.pg_to_up_acting_osds(PGId(1, ps))
