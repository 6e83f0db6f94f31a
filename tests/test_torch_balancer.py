"""The port's balancer vs the reference package's.

Maps are built in the reference package and carried across as
``OSDMap.encode()`` bytes; the port runs on the CPU (``device="cpu"``:
the plain CRUSH versions and the device scorer as torch ops on the
CPU).  Compared exactly: the hierarchy walks and fair shares, the three
candidate scorers (the port's device and numpy scorers against the
reference's numpy scorer, on seeded random inputs with ties, ITEM_NONE
holes, empty targets and shrunken truncation bounds), ``calc_pg_upmaps``
Incrementals and run statistics on four maps, a ``Balancer`` loop with
its ``Eval`` after every round, a crush-compat tick, the pg_num
autoscaler, and the BASELINE config-3 table digest the port stores.
``PGId`` differs between the packages, so Incrementals are compared as
sorted ``(pool, ps, pairs)`` tuples.
"""

import numpy as np
import pytest

from ceph_tpu.balancer import Balancer as RefBalancer
from ceph_tpu.balancer import upmap as rup
from ceph_tpu.balancer.pg_autoscaler import PgAutoscaler as RefAutoscaler
from ceph_tpu.models.clusters import build_osdmap, build_skewed_osdmap
from ceph_tpu.osdmap.map import Pool as RefPool
from ceph_tpu.osdmap.map import PGId as RefPGId
from ceph_tpu_torch.balancer import Balancer
from ceph_tpu_torch.balancer import upmap as pup
from ceph_tpu_torch.balancer.pg_autoscaler import PgAutoscaler
from ceph_tpu_torch.convert import osdmap_from_reference
from ceph_tpu_torch.crush.map import ITEM_NONE
from ceph_tpu_torch.osdmap import OSDMapMapping
from ceph_tpu_torch.testing import golden


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


@pytest.fixture(autouse=True)
def _reference_state_left_as_found(monkeypatch):
    """Each test leaves the reference's last-run statistics and its
    scorer switch as it found them."""
    monkeypatch.setattr(rup, "LAST_RUN_STATS", rup.LAST_RUN_STATS)
    monkeypatch.delenv("CEPH_TPU_VMAPPED_UPMAP", raising=False)


def _port(ref):
    return osdmap_from_reference(ref.encode())


def _inc(inc):
    new = sorted((pg.pool, pg.ps, tuple(items)) for pg, items in inc.new_pg_upmap_items.items())
    old = sorted((pg.pool, pg.ps) for pg in inc.old_pg_upmap_items)
    return inc.epoch, new, old


def _table(m):
    return sorted((pg.pool, pg.ps, tuple(items)) for pg, items in m.pg_upmap_items.items())


MAPS = {
    "osdmap16": lambda: build_osdmap(16, pg_num=32),
    "osdmap32": lambda: build_osdmap(32, pg_num=64, osds_per_host=4),
    "skewed128": lambda: build_skewed_osdmap(128, pg_num=256),
}


@pytest.mark.parametrize("name", list(MAPS))
def test_hierarchy_walks_and_shares_match(name):
    ref = MAPS[name]()
    ref.osd_weight[1] = 0x8000  # a reweight shows in the share, not the walk
    port = _port(ref)
    n = ref.max_osd
    rule = ref.pools[1].crush_rule
    assert np.array_equal(pup.crush_device_weights(port.crush, rule, n),
                          rup.crush_device_weights(ref.crush, rule, n))
    assert np.array_equal(pup.failure_domains(port.crush, rule, n),
                          rup.failure_domains(ref.crush, rule, n))
    assert np.array_equal(pup.expected_pg_share(port, port.pools[1], n),
                          rup.expected_pg_share(ref, ref.pools[1], n))


def _scorer_inputs(seed, n_osd=48, rows=200, size=3, empty_under=False):
    rng = np.random.default_rng(seed)
    up = np.stack([rng.choice(n_osd, size, replace=False) for _ in range(rows)]).astype(np.int32)
    up[rng.random(up.shape) < 0.08] = ITEM_NONE  # holes
    deviation = rng.integers(-8, 9, n_osd) / 2.0  # ties, and gains of exactly 1
    deviation[:4] = [3.5, 3.5, -2.5, -2.5]
    dom = rng.integers(-1, 12, n_osd).astype(np.int64)  # -1: unplaced
    under = np.zeros(0, np.int64) if empty_under else np.nonzero(deviation < 0)[0]
    return up, deviation, dom, under


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bounds", ["full", "shrunk"])
@pytest.mark.parametrize("empty_under", [False, True])
def test_scorers_match_reference(monkeypatch, seed, bounds, empty_under):
    if bounds == "shrunk":
        for mod in (rup, pup):
            monkeypatch.setattr(mod, "MAX_ROWS", 16)
            monkeypatch.setattr(mod, "MAX_UNDER", 8)
    up, deviation, dom, under = _scorer_inputs(seed, empty_under=empty_under)
    args = (up, deviation, dom, under, 1.0, len(deviation))
    want = rup._score_candidate_moves_np(*args)
    stats = pup.UpmapRunStats()
    got_np = pup._score_candidate_moves_np(*args, stats=stats)
    got_dev = pup._score_candidate_moves_device(*args, "cpu", stats=stats)
    assert empty_under or len(want[0]) > 0
    for got in (got_np, got_dev):
        assert got[0].dtype == np.float64
        assert np.array_equal(got[0].view(np.int64), want[0].view(np.int64))
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == np.int64 and np.array_equal(a, b)
    calls = 0 if empty_under else 1
    assert (stats.np_score_calls, stats.score_launches) == (calls, calls)


def _gc_map():
    """The reference's GC scenario: harmful entries divert PGs onto
    osd 0, so the optimizer must remove them."""
    m = build_osdmap(32, pg_num=256)
    injected = 0
    for ps in range(m.pools[1].pg_num):
        pg = RefPGId(1, ps)
        raw, _ = m._pg_to_raw_osds(m.pools[1], pg)
        if 0 in raw or not raw:
            continue
        m.pg_upmap_items[pg] = ((raw[0], 0),)
        injected += 1
        if injected >= 24:
            break
    return m


CALC_CASES = {
    "skewed128": (lambda: build_skewed_osdmap(128, pg_num=1024), {"max_entries": 100}),
    "osdmap32": (lambda: build_osdmap(32, pg_num=64, osds_per_host=4),
                 {"max_deviation": 0.5, "max_entries": 60}),
    "gc": (_gc_map, {"max_entries": 200}),
    "truncated": (lambda: build_skewed_osdmap(64, pg_num=512), {"max_entries": 300}),
}


@pytest.mark.parametrize("scorer", ["device", "numpy"])
@pytest.mark.parametrize("case", list(CALC_CASES))
def test_calc_pg_upmaps_matches_reference(monkeypatch, case, scorer):
    build, kw = CALC_CASES[case]
    if case == "truncated":
        for mod in (rup, pup):
            monkeypatch.setattr(mod, "MAX_ROWS", 16)
            monkeypatch.setattr(mod, "MAX_UNDER", 8)
    if scorer == "numpy":
        monkeypatch.setenv("CEPH_TPU_VMAPPED_UPMAP", "0")
    ref = build()
    port = _port(ref)
    before = _table(port)
    want = rup.calc_pg_upmaps(ref, **kw)
    got = pup.calc_pg_upmaps(port, device="cpu", scorer=scorer, **kw)
    assert _inc(got) == _inc(want)
    assert got.new_pg_upmap_items or got.old_pg_upmap_items
    assert _table(port) == before  # the trial table was put back
    assert pup.LAST_RUN_STATS.as_dict() == rup.LAST_RUN_STATS.as_dict()
    if case == "gc":
        assert len(got.old_pg_upmap_items) >= 12


def test_balancer_loop_matches_reference():
    ref = build_skewed_osdmap(128, pg_num=1024)
    port = _port(ref)
    rb = RefBalancer(ref, max_deviation=1.0, max_optimizations=100)
    pb = Balancer(port, max_deviation=1.0, max_optimizations=100, device="cpu")
    assert pb.mapping.device.type == "cpu"
    for _ in range(8):
        want, got = rb.optimize(), pb.optimize()
        assert _inc(got) == _inc(want)
        assert pb.execute(got) == rb.execute(want)
        assert _table(port) == _table(ref) and port.epoch == ref.epoch
        assert pb.evaluate().__dict__ == rb.evaluate().__dict__
        if not (want.new_pg_upmap_items or want.old_pg_upmap_items):
            break


def test_crush_compat_tick_matches_reference():
    ref = build_osdmap(32, pg_num=256)
    port = _port(ref)
    rb = RefBalancer(ref, mode="crush-compat")
    pb = Balancer(port, mode="crush-compat", device="cpu")
    assert pb.tick() == rb.tick()
    assert port.crush.choose_args == ref.crush.choose_args
    assert "compat" in port.crush.choose_args and port.epoch == ref.epoch
    rb.mapping.update(1)
    pb.mapping.update(1)
    for a, b in zip(pb.mapping._results[1], rb.mapping._results[1]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert pb.evaluate().__dict__ == rb.evaluate().__dict__


def _autoscaler_cases():
    def ratio_split(m, a):
        m.add_pool(RefPool(id=2, name="big", size=3, pg_num=64, pgp_num=64,
                           crush_rule=m.pools[1].crush_rule))
        a.set_target_size_ratio(2, 0.75)

    def half_out(m, a):
        for o in range(15):
            m.mark_out(o)

    return {
        "undersized": (8, None),
        "within_threshold": (512, None),
        "ratio_split": (64, ratio_split),
        "out_osds": (8, half_out),
    }


@pytest.mark.parametrize("case", list(_autoscaler_cases()))
def test_pg_autoscaler_matches_reference(case):
    pg_num, setup = _autoscaler_cases()[case]
    ref = build_osdmap(30, pg_num=pg_num)
    ra = RefAutoscaler(ref, target_pgs_per_osd=100)
    if setup:
        setup(ref, ra)
    port = _port(ref)
    pa = PgAutoscaler(port, target_pgs_per_osd=100)
    pa.target_size_ratio = dict(ra.target_size_ratio)
    assert [r.__dict__ for r in pa.recommend()] == [r.__dict__ for r in ra.recommend()]
    assert pa.apply() == ra.apply()
    assert port.epoch == ref.epoch
    assert {p: (q.pg_num, q.pgp_num) for p, q in port.pools.items()} == \
        {p: (q.pg_num, q.pgp_num) for p, q in ref.pools.items()}


def test_config3_digest_is_the_reference_outcome():
    """The constant ``chip_smoke.py`` holds the card to is what the
    reference's own balancer loop leaves at BASELINE config 3."""
    m = build_skewed_osdmap(1024, pg_num=10240)
    b = RefBalancer(m, max_deviation=1.0, max_optimizations=2000)
    for _ in range(32):
        if not b.execute(b.optimize()):
            break
    assert max(b.evaluate().pool_max_deviation.values()) <= 1.0
    assert golden.upmap_table_sha256(m.pg_upmap_items) == golden.CONFIG3_UPMAP_SHA256


def test_the_port_is_bit_equal_on_an_update_after_the_plan():
    """After a port plan is applied, the port's mapping equals its scalar
    pipeline (the chip phase's sample gate, here on every PG)."""
    ref = build_skewed_osdmap(64, pg_num=256)
    port = _port(ref)
    mapping = OSDMapMapping(port, device="cpu")
    port.apply_incremental(pup.calc_pg_upmaps(port, mapping=mapping, max_entries=50))
    mapping.update(1)
    from ceph_tpu_torch.osdmap import PGId

    for ps in range(256):
        pg = PGId(1, ps)
        assert mapping.get(pg) == port.pg_to_up_acting_osds(pg)
