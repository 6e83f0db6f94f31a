"""The port's recovery pipeline vs the reference package's.

Failure injection produces the same map epochs (``encode()`` bytes);
the peering pass gives the same up/acting/flags/survivor masks as the
reference's fused and staged paths on ``build_osdmap(64, pg_num=128,
size=6, pool_kind="erasure")`` for an OSD, a host and a rack failure; the
planner builds the same pattern groups; and ``RecoveryExecutor.run``
rebuilds the same bytes as the reference's executor on the identical
plan (carried across with ``convert.plan_from_reference``) under the
``auto``, ``on`` and ``off`` engines.  ``recover_pool`` runs end to end
with its launch hook, counters and Prometheus text.  Maps are built in
the reference package and carried across as ``encode()`` bytes; shard
data is made from seeds with numpy; everything runs with
``device="cpu"`` (every kernel wrapper takes its plain version).  All
comparisons are integer: exact equality.
"""

import copy
from functools import lru_cache

import numpy as np
import pytest
import torch

from ceph_tpu import recovery as ref_rec
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.ec import create as ref_create
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu_torch import convert
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.common import prometheus
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.crush.map import ITEM_NONE
from ceph_tpu_torch.ec import create, kernels
from ceph_tpu_torch.models.clusters import build_osdmap
from ceph_tpu_torch.osdmap.mapping import build_pool_state

SPECS = ["osd:3", "host:host0_1", "host:host0_1:down_out", "rack:0:down_out"]
PROFILES = {
    "rs_4_2": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2"},
    "cauchy_good_4_2": {"plugin": "jerasure", "technique": "cauchy_good", "k": "4", "m": "2",
                        "packetsize": "64"},
    "liberation_4_2_w5": {"plugin": "jerasure", "technique": "liberation", "k": "4", "m": "2",
                          "w": "5", "packetsize": "8"},
}


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """The reference memoizes its compiled placement and peering programs
    process-wide; put its caches back after this module, so a later test
    file in the same worker finds what it would have found without this
    one."""
    from ceph_tpu.crush import interp, interp_batch as ib
    from ceph_tpu.osdmap import mapping
    from ceph_tpu.recovery import pipeline

    caches = (ib._FAST_CACHE, ib._PACK_CACHE, interp._BATCH_CACHE, mapping._POOL_FN_CACHE,
              pipeline.PIPELINES._entries)
    saved = [copy.copy(c) for c in caches]
    counts = (pipeline.PIPELINES.hits, pipeline.PIPELINES.misses, pipeline.PIPELINES.evictions)
    yield
    for cache, before in zip(caches, saved):
        cache.clear()
        cache.update(before)
    pipeline.PIPELINES.hits, pipeline.PIPELINES.misses, pipeline.PIPELINES.evictions = counts


# ---- failure injection ----------------------------------------------------


@pytest.mark.parametrize("spec", SPECS + [["host:host0_1:down_out", "osd:40:out"],
                                          "rack:1:out"])
def test_inject_matches_reference(spec):
    ref = ref_build_osdmap(64, pg_num=128, size=6, pool_kind="erasure")
    port = convert.osdmap_from_reference(ref.encode())
    ref_inc = ref_rec.inject(ref, spec)
    inc = rec.inject(port, spec)
    assert port.encode() == ref.encode()
    assert (inc.epoch, inc.new_state, inc.new_weight) == (
        ref_inc.epoch, ref_inc.new_state, ref_inc.new_weight)
    # idempotent: re-injecting an applied event edits nothing
    again = rec.build_incremental(port, spec)
    assert not again.new_state and not again.new_weight


def test_flap_and_parse_match_reference():
    ref = ref_build_osdmap(16, pg_num=16)
    port = convert.osdmap_from_reference(ref.encode())
    fr, ref_fr = rec.flap(port, "osd:2", cycles=3), ref_rec.flap(ref, "osd:2", cycles=3)
    assert port.encode() == ref.encode() and fr.osds == ref_fr.osds == [2]
    assert len(fr.incrementals) == 6
    for text in ("rack:0:down_out", "osd:007", "host:host0_1:in"):
        assert str(rec.parse_spec(text)) == str(ref_rec.parse_spec(text))
    with pytest.raises(ValueError):
        rec.parse_spec("osd:5:explode")
    with pytest.raises(ValueError):
        rec.resolve_targets(port, rec.parse_spec("rack:host0_1"))


# ---- peering --------------------------------------------------------------


@lru_cache(maxsize=None)
def _maps(spec):
    """(prev, cur) reference maps around one injected failure."""
    cur = ref_build_osdmap(64, pg_num=128, size=6, pool_kind="erasure")
    prev = copy.deepcopy(cur)
    ref_rec.inject(cur, spec)
    return prev, cur


@lru_cache(maxsize=None)
def _ref_peering(spec):
    prev, cur = _maps(spec)
    return ref_rec.peer_pool(prev, cur, 1)


def _port_maps(spec):
    prev, cur = _maps(spec)
    return convert.osdmap_from_reference(prev.encode()), convert.osdmap_from_reference(cur.encode())


FIELDS = ("up", "up_primary", "acting", "acting_primary", "prev_acting", "flags",
          "survivor_mask", "n_alive")


def _assert_same_peering(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        # n_alive is documented int32 on both sides; the reference's sum
        # widens it to int64 when JAX runs with 64-bit types
        assert a.dtype == b.dtype or f == "n_alive", f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.size, got.min_size, got.epoch_prev, got.epoch_cur) == (
        want.size, want.min_size, want.epoch_prev, want.epoch_cur)
    assert got.counts() == want.counts()
    assert got.degraded_shards() == want.degraded_shards()


@pytest.mark.parametrize("spec", SPECS)
def test_peer_pool_fused_matches_reference(spec):
    """The port's peering pass against the reference's fused placement→
    peering program."""
    prev, cur = _port_maps(spec)
    got = rec.peer_pool(prev, cur, 1, device="cpu")
    _assert_same_peering(got, _ref_peering(spec))
    assert got.counts()["degraded"] > 0


@pytest.mark.parametrize("spec", SPECS)
def test_peer_pool_staged_matches_reference(spec, monkeypatch):
    """The port's peering pass against the reference's staged three-call
    path (its ``CEPH_TPU_FUSED_PIPELINE=0`` lever)."""
    ref_prev, ref_cur = _maps(spec)
    monkeypatch.setenv("CEPH_TPU_FUSED_PIPELINE", "0")
    want = ref_rec.peer_pool(ref_prev, ref_cur, 1)
    prev, cur = _port_maps(spec)
    _assert_same_peering(rec.peer_pool(prev, cur, 1, device="cpu"), want)


def test_peering_result_carries_device_twins():
    """The classifier's outputs ride along as tensors equal to the host
    arrays, on the engine's device."""
    prev, cur = _port_maps("rack:0:down_out")
    got = rec.peer_pool(prev, cur, 1, device="cpu")
    for name, host in (("dev_survivor_mask", got.survivor_mask), ("dev_n_alive", got.n_alive),
                       ("dev_acting_primary", got.acting_primary)):
        t = getattr(got, name)
        assert t.device.type == "cpu", name
        np.testing.assert_array_equal(t.numpy().astype(host.dtype), host, err_msg=name)


def test_repeer_reports_changed_pgs():
    prev, cur = _port_maps("host:host0_1")
    engine = rec.PeeringEngine(cur, 1, device="cpu")
    s0 = build_pool_state(prev, prev.pools[1], device="cpu")
    s1 = build_pool_state(cur, cur.pools[1], device="cpu")
    first = engine.run(s0, s0)
    assert (first.flags == rec.PG_STATE_CLEAN).all()
    second, changed = engine.repeer(first, s0, s1, epoch_cur=cur.epoch)
    np.testing.assert_array_equal(changed, second.pgs_with(rec.PG_STATE_DEGRADED))
    assert len(changed) > 0


def _numpy_classify(prev, up, acting, size, min_size):
    """Independent reference of the classifier (as in test_recovery)."""
    flags = np.zeros(len(acting), np.int32)
    mask = np.zeros(len(acting), np.uint32)
    for i in range(len(acting)):
        alive = acting[i] != ITEM_NONE
        surv = alive & (acting[i] == prev[i])
        f = 0
        if (up[i] != acting[i]).any():
            f |= rec.PG_STATE_REMAPPED
        if int(surv.sum()) < size:
            f |= rec.PG_STATE_DEGRADED
        if int(alive.sum()) < size:
            f |= rec.PG_STATE_UNDERSIZED
        if int(alive.sum()) < min_size:
            f |= rec.PG_STATE_INACTIVE
        if any(u != ITEM_NONE and u not in prev[i] for u in up[i]):
            f |= rec.PG_STATE_BACKFILL
        flags[i] = f or rec.PG_STATE_CLEAN
        mask[i] = sum(1 << s for s in range(size) if surv[s])
    return flags, mask


@pytest.mark.parametrize("seed", range(3))
def test_classify_rows_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    n, size = 200, 11
    prev = rng.integers(0, 20, (n, size)).astype(np.int32)
    prev[rng.random((n, size)) < 0.1] = ITEM_NONE
    acting = np.where(rng.random((n, size)) < 0.8, prev, rng.integers(0, 20, (n, size)))
    acting = acting.astype(np.int32)
    acting[rng.random((n, size)) < 0.1] = ITEM_NONE
    up = np.where(rng.random((n, size)) < 0.9, acting, ITEM_NONE).astype(np.int32)
    t = torch.from_numpy
    flags, mask, n_alive = rec.classify_rows(t(prev), t(up), t(acting), 8)
    want_flags, want_mask = _numpy_classify(prev, up, acting, size, 8)
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    np.testing.assert_array_equal(mask.numpy().astype(np.uint32), want_mask)
    np.testing.assert_array_equal(n_alive.numpy(), (acting != ITEM_NONE).sum(1))


# ---- planning -------------------------------------------------------------


def _assert_same_groups(got, want):
    assert (got.k, got.m, got.n_patterns) == (want.k, want.m, want.n_patterns)
    np.testing.assert_array_equal(got.unrecoverable, want.unrecoverable)
    for a, b in zip(got.groups, want.groups):
        assert (a.mask, a.survivors, a.rows, a.missing, a.w, a.packetsize) == (
            b.mask, b.survivors, b.rows, b.missing, b.w, b.packetsize)
        np.testing.assert_array_equal(a.pgs, b.pgs)
        for f in ("repair_matrix", "repair_bitmatrix"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("spec", ["host:host0_1:down_out", "rack:0:down_out"])
def test_build_plan_matches_reference(spec, profile):
    prev, cur = _port_maps(spec)
    plan = rec.build_plan(rec.peer_pool(prev, cur, 1, device="cpu"),
                          create(PROFILES[profile], device="cpu"))
    want = ref_rec.build_plan(_ref_peering(spec), ref_create(PROFILES[profile]))
    _assert_same_groups(plan, want)
    _assert_same_groups(convert.plan_from_reference(want), want)


# ---- the executor on the reference's plan ---------------------------------


@lru_cache(maxsize=None)
def _ref_case(profile):
    """A reference plan for a rack failure and a seeded shard store."""
    codec = ref_create(PROFILES[profile])
    plan = ref_rec.build_plan(_ref_peering("rack:0:down_out"), codec)
    inner = codec.codec
    k = inner.k
    chunk = 2 * getattr(inner, "w", 8) * inner.packetsize
    rng = np.random.default_rng(17)
    store = {}
    for g in plan.groups:
        for pg in g.pgs:
            data = rng.integers(0, 256, (k, chunk), dtype=np.uint8)
            store[int(pg)] = np.vstack([data, inner.encoder.encode(data)])
    return codec, plan, store


def _ref_run(profile, mode):
    codec, plan, store = _ref_case(profile)
    cfg = RefConfig(env={})
    cfg.set("recovery_xor_schedule", mode)
    return ref_rec.RecoveryExecutor(codec, config=cfg).run(plan, lambda pg, s: store[pg][s])


@pytest.mark.parametrize("profile,mode", [("rs_4_2", "auto"), ("rs_4_2", "on"),
                                          ("cauchy_good_4_2", "auto"),
                                          ("cauchy_good_4_2", "off"),
                                          ("liberation_4_2_w5", "auto"),
                                          ("liberation_4_2_w5", "off")])
def test_executor_matches_reference_on_the_same_plan(profile, mode):
    ref_codec, ref_plan, store = _ref_case(profile)
    plan = convert.plan_from_reference(ref_plan)
    cfg = Config(env={})
    cfg.set("recovery_xor_schedule", mode)
    launches = []
    ex = rec.RecoveryExecutor(create(PROFILES[profile], device="cpu"), config=cfg,
                              on_decode_launch=lambda g, n: launches.append(g.mask),
                              device="cpu")
    got = ex.run(plan, lambda pg, s: store[pg][s])
    want = _ref_run(profile, mode)
    assert launches == [g.mask for g in plan.groups]
    assert (got.launches, got.schedule_launches, got.shards_rebuilt, got.bytes_recovered) == (
        want.launches, want.schedule_launches, want.shards_rebuilt, want.bytes_recovered)
    bit_level = plan.groups[0].repair_matrix is None or mode == "on"
    assert got.schedule_launches == (plan.n_patterns if bit_level and mode != "off" else 0)
    assert got.shards.keys() == want.shards.keys()
    for pg, shards in want.shards.items():
        assert got.shards[pg].keys() == shards.keys()
        for s, chunk in shards.items():
            np.testing.assert_array_equal(got.shards[pg][s], chunk)
            np.testing.assert_array_equal(got.shards[pg][s], store[pg][s])


def test_executor_launches_no_kernel_on_the_cpu():
    _, ref_plan, store = _ref_case("cauchy_good_4_2")
    before = dict(kernels.LAUNCHES)
    rec.RecoveryExecutor(create(PROFILES["cauchy_good_4_2"], device="cpu"), device="cpu").run(
        convert.plan_from_reference(ref_plan), lambda pg, s: store[pg][s])
    assert kernels.LAUNCHES == before


class _Verifier:
    """A decode verifier over the seeded store: rejects the first launch
    of every pattern when ``first_bad`` (as a miscompiled schedule would
    ship), every launch when ``always_bad``, else the PGs whose rebuilt
    bytes differ from the store."""

    def __init__(self, store, first_bad=True, always_bad=False):
        self.store, self.first_bad, self.always_bad = store, first_bad, always_bad
        self.seen = set()

    def bad_pgs(self, g, out, chunk, read_shard=None):
        if self.always_bad or (self.first_bad and g.mask not in self.seen):
            self.seen.add(g.mask)
            return {int(pg) for pg in g.pgs}
        return {int(pg) for i, pg in enumerate(g.pgs) for j, s in enumerate(g.missing)
                if not np.array_equal(out[j, i * chunk:(i + 1) * chunk], self.store[int(pg)][s])}


@pytest.mark.parametrize("profile,mode", [("cauchy_good_4_2", "auto"), ("rs_4_2", "on")])
def test_verifier_quarantines_a_bad_schedule_and_rederives(profile, mode):
    """A schedule launch that fails verification is quarantined and its
    group re-derived through the dense / byte-LUT reference engine."""
    _, ref_plan, store = _ref_case(profile)
    plan = convert.plan_from_reference(ref_plan)
    cfg = Config(env={})
    cfg.set("recovery_xor_schedule", mode)
    ex = rec.RecoveryExecutor(create(PROFILES[profile], device="cpu"), config=cfg, device="cpu")
    ex.verifier = _Verifier(store)
    got = ex.run(plan, lambda pg, s: store[pg][s])
    n = plan.n_patterns
    assert (got.launches, got.schedule_launches, got.verify_retries) == (2 * n, n, n)
    assert not got.inconsistent_unrecoverable
    layout = "packet" if mode == "auto" else "bitplane"
    assert all(ex._schedules.is_quarantined((layout, g.mask)) for g in plan.groups)
    for g in plan.groups:
        for pg in g.pgs:
            for s in g.missing:
                np.testing.assert_array_equal(got.shards[int(pg)][s], store[int(pg)][s])
    # a second run goes straight to the reference engines
    ex.verifier = _Verifier(store, first_bad=False)
    again = ex.run(plan, lambda pg, s: store[pg][s])
    assert (again.launches, again.schedule_launches, again.verify_retries) == (n, 0, 0)


def test_verifier_never_commits_bytes_that_fail_everywhere():
    _, ref_plan, store = _ref_case("cauchy_good_4_2")
    plan = convert.plan_from_reference(ref_plan)
    ex = rec.RecoveryExecutor(create(PROFILES["cauchy_good_4_2"], device="cpu"), device="cpu")
    ex.verifier = _Verifier(store, always_bad=True)
    got = ex.run(plan, lambda pg, s: store[pg][s])
    assert got.shards == {} and got.shards_rebuilt == 0
    assert got.inconsistent_unrecoverable == {int(pg) for g in plan.groups for pg in g.pgs}
    assert got.verify_retries == plan.n_patterns


# ---- throttle -------------------------------------------------------------


def test_token_bucket_deterministic():
    t = [0.0]
    slept = []

    def sleep(s):
        slept.append(s)
        t[0] += s

    tb = rec.TokenBucket(100.0, 50.0, clock=lambda: t[0], sleep=sleep)
    assert tb.take(40) == 0.0  # within burst
    assert tb.take(60) == pytest.approx(0.5)  # 10 left, debt 50 -> 0.5 s
    t[0] += 10.0  # refill fully (capped at burst)
    assert tb.take(50) == 0.0
    assert tb.waited_s == pytest.approx(sum(slept))
    capped = rec.TokenBucket(10.0, 5.0, clock=lambda: t[0], sleep=sleep, max_debt=20.0)
    assert capped.take(10**9) == pytest.approx(2.0)  # the debt clamp bounds the stall


def test_token_bucket_disabled():
    tb = rec.TokenBucket(0.0, 0.0, clock=lambda: 0.0, sleep=lambda s: pytest.fail("slept"))
    assert tb.take(10**12) == 0.0


def test_executor_respects_config_throttle():
    _, ref_plan, store = _ref_case("rs_4_2")
    cfg = Config(env={})
    cfg.set("recovery_max_bytes_per_sec", 1000.0)
    cfg.set("recovery_burst_bytes", 64)
    t = [0.0]
    ex = rec.RecoveryExecutor(create(PROFILES["rs_4_2"], device="cpu"), config=cfg,
                              clock=lambda: t[0], sleep=lambda s: t.__setitem__(0, t[0] + s),
                              device="cpu")
    before = ex.pc.dump()["recovery"]["throttle_waits"]
    res = ex.run(convert.plan_from_reference(ref_plan), lambda pg, s: store[pg][s])
    assert res.throttle_wait_s > 0
    assert ex.pc.dump()["recovery"]["throttle_waits"] >= before + 1


# ---- end to end -----------------------------------------------------------


@pytest.mark.parametrize("profile", ["rs_4_2", "cauchy_good_4_2"])
def test_recover_pool_end_to_end_with_counters(profile):
    prev, cur = _port_maps("host:host0_1:down_out")
    codec = create(PROFILES[profile], device="cpu")
    inner = codec.codec
    chunk = 2 * 8 * inner.packetsize
    rng = np.random.default_rng(3)
    store = {}

    def read_shard(pg, s):
        if pg not in store:
            data = rng.integers(0, 256, (4, chunk), dtype=np.uint8)
            store[pg] = np.vstack([data, inner.encode(data)])
        return store[pg][s]

    pc = rec.recovery_counters()
    before = pc.dump()["recovery"]
    launches = []
    peering, plan, result = rec.recover_pool(
        prev, cur, 1, codec, read_shard,
        on_decode_launch=lambda g, n: launches.append(g.mask), device="cpu")
    assert result.launches == plan.n_patterns == len(launches) > 0
    assert result.bytes_recovered == plan.bytes_to_write(chunk)
    assert plan.n_pgs == len(peering.pgs_with(rec.PG_STATE_DEGRADED))
    for g in plan.groups:
        for pg in g.pgs:
            for s in g.missing:
                np.testing.assert_array_equal(result.shards[int(pg)][s], store[int(pg)][s])
    dump = pc.dump()["recovery"]
    assert dump["l_peering"]["avgcount"] == before["l_peering"]["avgcount"] + 1
    assert dump["l_plan"]["avgcount"] == before["l_plan"]["avgcount"] + 1
    assert dump["decode_launches"] == before["decode_launches"] + plan.n_patterns
    assert dump["degraded_pgs"] == plan.n_pgs
    text = prometheus.render()
    assert "ceph_tpu_recovery_decode_launches" in text
    assert "ceph_tpu_recovery_bytes_recovered" in text
    assert "ceph_tpu_ec_schedule_schedules_compiled" in text or profile == "rs_4_2"


def test_entry_points_default_to_the_card():
    prev, cur = _port_maps("osd:3")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    codec = create(PROFILES["rs_4_2"], device="cpu")
    with pytest.raises(RuntimeError):
        rec.peer_pool(prev, cur, 1)
    with pytest.raises(RuntimeError):
        rec.RecoveryExecutor(codec)
    with pytest.raises(RuntimeError):
        rec.recover_pool(prev, cur, 1, codec, lambda pg, s: None)


def test_port_build_osdmap_matches_reference():
    """``chip_smoke.py`` builds its erasure-coded map with the port's
    ``build_osdmap``: it is the reference's map, byte for byte."""
    assert build_osdmap(64, pg_num=128, size=6, pool_kind="erasure").encode() == \
        ref_build_osdmap(64, pg_num=128, size=6, pool_kind="erasure").encode()
