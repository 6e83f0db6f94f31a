"""The port's foreground-traffic model vs the reference package's.

The same seeded inputs (numpy ``default_rng``) go through the
reference's ``ceph_tpu.workload`` and the port's
``ceph_tpu_torch.workload`` on the CPU (``device="cpu"``).

Equal, exactly: ``bucket_edges``, ``percentile(s)``,
``count_at_least``, ``_skew_ids``, ``dirty_fraction``; the traffic
step's outcome counts, per-PG ``written``/``deg_read`` scatters and
``max_rho``; the latency and queue-depth histograms, except ops whose
quotient ``v / lat_min`` lies within 4 ulps of a power of two, where the
reference's float32 ``log2`` is not exact (ROADMAP §3, R8): there the
difference must be exactly what the reference's ``bucketize`` makes of
those ops' values, and nothing else.  The port's ``bucketize`` is the
exact floor of log2 on every value.

Within a tolerance: the step's two float32 ``sums`` and each sample's
``mean_ms`` (their quotient), ``rtol=1e-6``, and the ``op_latency_ms``
histogram's ``sum``, ``rtol=1e-6``: the packages reduce in different
orders.  ``ops_per_sec_wall`` (a wall-clock rate) is left out.

Engines run through the reference test module's scenarios (classifying
palette, overload window, recovery term, arbiter admission, the pause
flag, the named mixes) and ``SupervisedRecovery(traffic=...)`` through
``flap`` (plain and with an mclock arbiter), ``scrub-storm`` (a
``Scrubber`` and the engine's integrity loop, ROADMAP §3 R9) and the
chip's traffic pass at config 6's bench size (1024 OSDs, 256 PGs,
without and with the arbiter, then the overload): summaries, samples,
health series, SLO reports and perf counters equal.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu import recovery as ref_rec
from ceph_tpu import workload as ref_wl
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.ec.backend import MatrixCodec as RefMatrixCodec
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.obs import HealthTimeline as RefTimeline, SLOSpec as RefSLOSpec
from ceph_tpu.obs import evaluate as ref_evaluate
from ceph_tpu.recovery.peering import PeeringResult as RefPeeringResult
from ceph_tpu.workload import histogram as ref_hist
from ceph_tpu.workload import traffic as ref_traffic
from ceph_tpu_torch import convert
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch import workload as wl
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ec.backend import MatrixCodec
from ceph_tpu_torch.obs import HealthTimeline, SLOSpec, evaluate
from ceph_tpu_torch.recovery.peering import PeeringResult
from ceph_tpu_torch.workload import histogram, traffic

RTOL = 1e-6
NB, LAT_MIN = histogram.N_BUCKETS, histogram.LAT_MIN_MS


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """Put the reference's program caches back after this module."""
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


def exact_bucket(values, n_buckets=NB, lat_min=LAT_MIN) -> np.ndarray:
    """numpy's exact floor(log2(max(v, lat_min) / lat_min)), clipped."""
    lm = np.float32(lat_min)
    q = np.maximum(np.asarray(values, np.float32), lm) / lm
    _mant, exp = np.frexp(q)
    return np.clip(exp - 1, 0, n_buckets - 1).astype(np.int32)


def near_power_of_two(values, lat_min=LAT_MIN, ulps=4) -> np.ndarray:
    """R8's band: the float32 quotient ``max(v, lat_min) / lat_min``
    lies within ``ulps`` of a power of two (positive float32 bit
    patterns are ordered, so their difference counts ulps)."""
    lm = np.float32(lat_min)
    q = np.maximum(np.asarray(values, np.float32), lm) / lm
    frac = q.view(np.int32) & 0x7FFFFF
    return np.minimum(frac, 0x800000 - frac) <= ulps


# ---- histogram -------------------------------------------------------


@pytest.mark.parametrize("n_buckets,lat_min", [(24, 0.0625), (8, 0.0625), (4, 1.0), (30, 0.3)])
def test_histogram_host_pieces_match_reference(n_buckets, lat_min):
    rng = np.random.default_rng(n_buckets)
    edges = histogram.bucket_edges(n_buckets, lat_min)
    np.testing.assert_array_equal(edges, ref_hist.bucket_edges(n_buckets, lat_min))
    for counts in (rng.integers(0, 100, n_buckets), np.zeros(n_buckets, int),
                   np.eye(n_buckets, dtype=int)[n_buckets // 2] * 7):
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert histogram.percentile(counts, edges, q) == ref_hist.percentile(counts, edges, q)
        assert histogram.percentiles(counts, edges) == ref_hist.percentiles(counts, edges)
        for floor in (0.0, *edges[::3], float(edges[1]) * 1.5, 1e12):
            assert (histogram.count_at_least(counts, edges, floor)
                    == ref_hist.count_at_least(counts, edges, floor))


def test_bucketize_is_the_exact_floor_of_log2():
    rng = np.random.default_rng(0)
    pow2 = LAT_MIN * np.exp2(np.arange(-3, NB + 3)).astype(np.float32)
    edges = np.concatenate([pow2, np.nextafter(pow2, np.float32(0)),
                            np.nextafter(pow2, np.float32(np.inf))]).astype(np.float32)
    vals = np.concatenate([edges, np.float32([0.0, 0.01, 1e9]),
                           (np.exp2(rng.uniform(-6, 24, 200_000)) * LAT_MIN).astype(np.float32)])
    got = histogram.bucketize(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, exact_bucket(vals))
    # R8 pinned: the reference puts 512 and 2048 ms one bucket low
    r8 = np.float32([256, 512, 1024, 2048, 4096])
    assert histogram.bucketize(torch.from_numpy(r8)).tolist() == [12, 13, 14, 15, 16]
    assert np.asarray(ref_hist.bucketize(jnp.asarray(r8))).tolist() == [12, 12, 14, 14, 16]


def test_bucketize_matches_reference_outside_r8_band():
    rng = np.random.default_rng(1)
    vals = (np.exp2(rng.uniform(-5, NB + 2, 1_000_000)) * LAT_MIN).astype(np.float32)
    got = histogram.bucketize(torch.from_numpy(vals)).numpy()
    ref = np.asarray(ref_hist.bucketize(jnp.asarray(vals)))
    differ = got != ref
    band = near_power_of_two(vals)
    assert not (differ & ~band).any(), vals[differ & ~band][:8]
    np.testing.assert_array_equal(got, exact_bucket(vals))


def test_scatter_hist_drops_zero_weights():
    idx = torch.tensor([0, 3, 3, 23, 5], dtype=torch.int32)
    w = torch.tensor([1, 1, 0, 1, 1], dtype=torch.int32)
    got = histogram.scatter_hist(idx, w).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_hist.scatter_hist(
        jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()))))


# ---- traffic step ----------------------------------------------------

CODES = {"k4": (4, 6, 5), "k8": (8, 11, 9)}
# (pg_num, n_osds, n_ops): a power of two and not
SHAPES = {"pow2": (256, 64, 4096), "npot": (1000, 96, 6000)}
STEP_CASES = [(code, shape, wp, service)
              for code in CODES for shape in SHAPES
              for wp, service in ((100, 0.5), (250, 3.7), (450, 0.5))]


def _step_inputs(code, shape, wp, service):
    k, size, min_size = CODES[code]
    pg_num, n_osds, n_ops = SHAPES[shape]
    rng = np.random.default_rng([k, pg_num, wp])
    mask = rng.integers(0, 1 << size, pg_num).astype(np.uint32)
    # mostly whole PGs, so every outcome is common
    mask = np.where(rng.random(pg_num) < 0.5, (1 << size) - 1, mask).astype(np.uint32)
    alive = rng.integers(0, size + 1, pg_num).astype(np.int32)
    prim = rng.integers(-1, n_osds, pg_num).astype(np.int32)
    bmask = (1 << max(pg_num - 1, 1).bit_length()) - 1
    # capacity about twice the mean load, so rho spreads over (0, 0.97]
    cap = np.float32(2.0 * n_ops * 3.0 / n_osds)
    scal = dict(salt=int(rng.integers(0, 2**32)), pg_b=pg_num, pg_bmask=bmask, k=k, size=size,
                min_size=min_size, write_permille=wp, service_ms=np.float32(service),
                cap_ops=cap, rho_recovery=np.float32(0.125))
    return mask, alive, prim, scal, n_ops, n_osds


@pytest.mark.parametrize("code,shape,wp,service", STEP_CASES)
def test_traffic_step_matches_reference(code, shape, wp, service):
    mask, alive, prim, s, n_ops, n_osds = _step_inputs(code, shape, wp, service)
    order = ("salt", "pg_b", "pg_bmask", "k", "size", "min_size", "write_permille",
             "service_ms", "cap_ops", "rho_recovery")
    types = (np.uint32, np.uint32, np.uint32, np.int32, np.int32, np.int32, np.int32,
             np.float32, np.float32, np.float32)
    ref = [np.asarray(x) for x in ref_traffic.traffic_step(n_ops, n_osds)(
        mask, alive, prim, *(t(s[n]) for n, t in zip(order, types)))]
    dev = (torch.from_numpy(mask.astype(np.int64)), torch.from_numpy(alive),
           torch.from_numpy(prim))
    port = [x.numpy() for x in traffic.traffic_step(n_ops, n_osds)(
        *dev, *(s[n] for n in order))]
    names = ("counts", "lat_hist", "qd_hist", "sums", "max_rho", "written", "deg_read")
    for name, r, p in zip(names, ref, port):
        assert r.shape == p.shape, name
        if name == "sums":
            np.testing.assert_allclose(p, r, rtol=RTOL)
        elif name not in ("lat_hist", "qd_hist"):
            assert r.dtype == p.dtype and np.array_equal(r, p), name
    counts = port[0]
    assert counts.sum() == n_ops and counts.min() > 0  # every outcome occurs
    # the histograms, op by op: the port's are the exact floor of log2
    # of its per-op values, and the reference's differ only in R8's band
    ids = torch.arange(n_ops, dtype=torch.int64)
    pg, p_, is_write, blocked, degraded, cost = traffic._route(
        *dev, ids, s["salt"], s["pg_b"], s["pg_bmask"], s["k"], s["size"], s["min_size"],
        s["write_permille"])
    idx, valid = traffic._osd_index(p_, n_osds)
    load = traffic._scatter_load(idx, valid, blocked, cost, n_osds)
    _rho, qd, lat = traffic._queue_model(load, idx, is_write, degraded, s["k"], s["service_ms"],
                                         s["cap_ops"], s["rho_recovery"])
    ok = (~blocked).numpy()
    for vals, p_hist, r_hist in ((lat.numpy(), port[1], ref[1]), (qd.numpy(), port[2], ref[2])):
        v = vals[ok]
        np.testing.assert_array_equal(p_hist, np.bincount(exact_bucket(v), minlength=NB))
        band = v[near_power_of_two(v)]
        r8 = (np.bincount(exact_bucket(band), minlength=NB)
              - np.bincount(np.asarray(ref_hist.bucketize(jnp.asarray(band))), minlength=NB))
        np.testing.assert_array_equal(p_hist.astype(np.int64) - r_hist, r8)
    assert float(port[4]) == pytest.approx(traffic.RHO_MAX) or port[4] < traffic.RHO_MAX


def test_route_gives_every_op_one_outcome_and_the_reference_primary_semantics():
    """A primary of -1 (a PG with no acting primary) reads the last OSD's
    load and adds to it, as the reference's indexing does; anything below
    -n_osds reads OSD 0 and adds nowhere."""
    prim = torch.tensor([-1, -9, 0, 7, 8], dtype=torch.int64)
    idx, valid = traffic._osd_index(prim, 8)
    assert idx.tolist() == [7, 0, 0, 7, 7] and valid.tolist() == [True, False, True, True, False]
    load = jnp.zeros(8).at[jnp.asarray(prim.numpy())].add(jnp.ones(5))
    got = traffic._scatter_load(idx, valid, torch.zeros(5, dtype=torch.bool), torch.ones(5), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(load, np.float32))


@pytest.mark.parametrize("hot_permille,hot_objects", [(0, 64), (400, 256), (800, 64), (1000, 7)])
def test_skew_ids_matches_reference(hot_permille, hot_objects):
    rng = np.random.default_rng(hot_permille)
    ids = rng.integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32)
    salt = np.uint32(rng.integers(0, 2**32))
    ref = np.asarray(ref_traffic._skew_ids(jnp.asarray(ids), jnp.uint32(salt), hot_permille,
                                           hot_objects))
    got = traffic._skew_ids(torch.from_numpy(ids.astype(np.int64)), int(salt), hot_permille,
                            hot_objects).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_mixes_and_dirty_fraction_match_reference():
    assert sorted(wl.TRAFFIC_MIXES) == sorted(ref_wl.TRAFFIC_MIXES)
    for name, mix in wl.TRAFFIC_MIXES.items():
        assert vars(mix) == vars(ref_wl.TRAFFIC_MIXES[name])
        assert wl.resolve_mix(name) is mix
    assert wl.resolve_mix(None) is None
    with pytest.raises(ValueError, match="unknown traffic mix"):
        wl.resolve_mix("nope")

    class Series:
        def __init__(self, dirty):
            self.dirty = dirty

        def __len__(self):
            return len(self.dirty)

    for dirty in ([], [0, 1, 1, 0, 1], [1] * 9):
        assert traffic.dirty_fraction(Series(dirty)) == ref_traffic.dirty_fraction(Series(dirty))


# ---- the engine ------------------------------------------------------

# PG palette: full redundancy / degraded-readable / read-blocked
# (nsurv < k) / write-blocked-only (readable, alive < min_size)
_PG_MASKS = [0b111111, 0b011111, 0b000111, 0b001111] * 8
_PG_ALIVE = [6, 5, 3, 4] * 8


def _synth(port: bool, masks, alive, size=6, min_size=5, on_device=False):
    n = len(masks)
    z = np.zeros((n, size), np.int32)
    zp = np.arange(n, dtype=np.int32) % 8
    kw = {}
    if on_device:
        kw = dict(dev_survivor_mask=torch.tensor(masks, dtype=torch.int64),
                  dev_n_alive=torch.tensor(alive, dtype=torch.int32),
                  dev_acting_primary=torch.from_numpy(zp))
    return (PeeringResult if port else RefPeeringResult)(
        pool_id=1, epoch_prev=1, epoch_cur=2, size=size, min_size=min_size,
        up=z, up_primary=zp, acting=z, acting_primary=zp, prev_acting=z,
        flags=np.zeros(n, np.int32), survivor_mask=np.array(masks, np.uint32),
        n_alive=np.array(alive, np.int32), **kw)


def _arbiter(port: bool, clock):
    cfg = (Config if port else RefConfig)(env={})
    cfg.set("osd_mclock_client_res_bps", 4e6)
    cfg.set("osd_mclock_recovery_res_bps", 2e3)
    cfg.set("osd_mclock_recovery_lim_bps", 5e3)
    return (wl if port else ref_wl).MClockArbiter.from_config(
        8e6, cfg, clock=clock.now, sleep=clock.sleep)


def _engine_run(port: bool, scenario: str):
    """One scenario of the reference test module through either package:
    (samples, summary, engine, arbiter)."""
    R, W = (rec, wl) if port else (ref_rec, ref_wl)
    clock = R.VirtualClock()
    dev = {"device": "cpu"} if port else {}
    kw = dict(ops_per_step=2048, osd_capacity_ops_per_s=1e6, seed=5)
    clean = _synth(port, [0b111111] * 32, [6] * 32)
    palette = _synth(port, _PG_MASKS, _PG_ALIVE, on_device=port and scenario == "device_tensors")
    steps = [(palette, 1.0, 0)] * 3
    arbiter = None
    if scenario == "overload":
        kw.update(slow_ms=5.0)
        steps = [(clean, 12.0, 0), (clean, 10.0, 0), (clean, 0.0, 0)]
    elif scenario == "recovery_term":
        kw.update(osd_capacity_ops_per_s=1e9, recovery_capacity_bps=1e5)
        steps = [(clean, 1.0, 0), (clean, 1.0, 90_000), (palette, 0.1, 400_000)]
    elif scenario == "arbiter":
        arbiter = kw["arbiter"] = _arbiter(port, clock)
        kw.update(op_bytes=128, recovery_capacity_bps=2e4)
        steps = [(palette, 0.5, 1000 * i) for i in range(6)]
    elif scenario == "pause":
        kw["flags"] = set()
    elif scenario in ("ssd-burst", "ssd-skew"):
        kw.update(mix=scenario, osd_capacity_ops_per_s=300.0)
    eng = W.TrafficEngine(clock.now, 8, 32, 4, 6, 5, **kw, **dev)
    if scenario == "overload":
        eng.set_overload(10.0, 20.0, 1e5)
    samples = []
    for i, (peering, adv, nbytes) in enumerate(steps):
        if scenario == "pause":
            eng.flags.clear()
            if i == 1:
                eng.flags.add("pause")
        samples.append(eng.observe(peering, bytes_recovered=nbytes))
        clock.advance(adv)
    return samples, eng.summary(), eng, arbiter


def _sample_view(s) -> dict:
    d = dict(vars(s))
    d.pop("ops_per_sec_wall")
    return d


def assert_samples_equal(port_samples, ref_samples):
    assert len(port_samples) == len(ref_samples)
    for p, r in zip(port_samples, ref_samples):
        pd, rd = _sample_view(p), _sample_view(r)
        assert pd.pop("mean_ms") == pytest.approx(rd.pop("mean_ms"), rel=RTOL)
        assert pd == rd


def _summary_view(s: dict) -> dict:
    return {k: v for k, v in s.items() if k != "ops_per_sec_wall"}


ENGINE_SCENARIOS = ["palette", "device_tensors", "overload", "recovery_term", "arbiter", "pause",
                    "ssd-burst", "ssd-skew"]


@pytest.mark.parametrize("scenario", ENGINE_SCENARIOS)
def test_engine_sequence_matches_reference(scenario):
    from ceph_tpu.workload.traffic import workload_counters as ref_counters

    before = (wl.workload_counters().dump()["workload"], ref_counters().dump()["workload"])
    ref_samples, ref_summary, ref_eng, ref_arb = _engine_run(False, scenario)
    samples, summary, eng, arb = _engine_run(True, scenario)
    assert_samples_equal(samples, ref_samples)
    assert _summary_view(summary) == _summary_view(ref_summary)
    assert summary["ops_per_sec_wall"] > 0
    np.testing.assert_array_equal(eng._cum_lat_hist, ref_eng._cum_lat_hist)
    assert eng._cum_lat_sum_ms == pytest.approx(ref_eng._cum_lat_sum_ms, rel=RTOL)
    # the perf counters: u64 deltas, gauges, the wholesale histogram
    after = (wl.workload_counters().dump()["workload"], ref_counters().dump()["workload"])
    for name in ("ops_served", "ops_degraded", "ops_blocked", "slow_ops"):
        assert after[0][name] - before[0][name] == after[1][name] - before[1][name], name
    for name in ("p99_ms", "max_osd_utilization"):
        assert after[0][name] == after[1][name], name
    ph, rh = after[0]["op_latency_ms"], after[1]["op_latency_ms"]
    assert ph["sum"] == pytest.approx(rh["sum"], rel=RTOL)
    assert {**ph, "sum": 0} == {**rh, "sum": 0}
    if arb is not None:
        assert arb.summary() == ref_arb.summary()
        assert arb.granted("client") == 6 * 2048 * 128
    if scenario == "pause":
        assert samples[1].ops == 0 and summary["paused_steps"] == 1
    if scenario == "overload":
        assert samples[1].slow_ops > 0 and samples[0].slow_ops == samples[2].slow_ops == 0


def test_engine_rejects_the_mesh_and_a_peering_on_another_device():
    """The mesh seam (once refused) on a world of one: the engine's
    samples equal the single-device engine's bit for bit and the
    reference's on ``make_mesh(1)`` (``mean_ms`` at RTOL, as above), and
    the raw mesh step is the single-device step, padded op tail
    included (gloo worlds of 2 and 4: tests/test_torch_mesh_paths.py).
    A peering's device tensors on another device are still refused."""
    from ceph_tpu.parallel.placement import make_mesh as ref_make_mesh
    from ceph_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axis="ops", device="cpu")
    samples = []
    for kind in ("mesh", "single", "ref"):
        clock = (rec.VirtualClock if kind != "ref" else ref_rec.VirtualClock)()
        kw = dict(ops_per_step=1001, osd_capacity_ops_per_s=1e6, seed=9)
        if kind == "ref":
            eng = ref_wl.TrafficEngine(clock.now, 8, 32, 4, 6, 5,
                                       mesh=ref_make_mesh(1, axis="ops"), **kw)
        else:
            eng = wl.TrafficEngine(clock.now, 8, 32, 4, 6, 5, device="cpu",
                                   mesh=mesh if kind == "mesh" else None, **kw)
        out = []
        for _ in range(3):
            d = eng.observe(_synth(kind != "ref", _PG_MASKS, _PG_ALIVE)).to_dict()
            d.pop("ops_per_sec_wall")
            out.append(d)
            clock.advance(1.0)
        samples.append(out)
    assert samples[0] == samples[1]
    for got, want in zip(samples[0], samples[2]):
        assert got["mean_ms"] == pytest.approx(want["mean_ms"], rel=RTOL)
        assert {**got, "mean_ms": 0} == {**want, "mean_ms": 0}
    dev_in = (torch.tensor(_PG_MASKS, dtype=torch.int64), torch.tensor(_PG_ALIVE, dtype=torch.int32),
              torch.arange(32, dtype=torch.int32) % 8)
    scalars = (77, 32, 31, 4, 6, 5, 250, 0.5, 40.0, 0.0)
    one = wl.traffic_step(1000, 8)(*dev_in, *scalars)
    sharded = wl.sharded_traffic_step(mesh, 1024, 8)(*dev_in, *scalars, 1000)
    for a, b in zip(sharded, one):
        assert a.dtype == b.dtype and torch.equal(a, b)

    class Elsewhere:
        device = torch.device("meta")

    peering = _synth(True, _PG_MASKS, _PG_ALIVE)
    peering.dev_survivor_mask = peering.dev_n_alive = peering.dev_acting_primary = Elsewhere()
    eng = wl.TrafficEngine(lambda: 0.0, 8, 32, 4, 6, 5, ops_per_step=64, device="cpu")
    with pytest.raises(ValueError, match="traffic engine on cpu"):
        eng.observe(peering)


# ---- SupervisedRecovery(traffic=...) ---------------------------------

K, M = 4, 2


def _store(seed=3, width=256):
    raw = RefMatrixCodec(ref_gf.vandermonde_matrix(K, M))
    rng = np.random.default_rng(seed)
    out = {}
    for pg in range(32):
        data = rng.integers(0, 256, (K, width), dtype=np.uint8)
        out[pg] = np.vstack([data, np.asarray(raw.encode(data), np.uint8)])
    return out


def _supervised(port: bool, case: str):
    R, W = (rec, wl) if port else (ref_rec, ref_wl)
    dev = {"device": "cpu"} if port else {}
    ref_map = ref_build_osdmap(64, pg_num=32, size=K + M, pool_kind="erasure")
    m = convert.osdmap_from_reference(ref_map.encode()) if port else ref_map
    m_prev = copy.deepcopy(m)
    clock = R.VirtualClock()
    scenario = "scrub-storm" if case == "scrub-storm" else "flap"
    store = _store()
    rotted, refreshed = set(), set()

    def corrupt(pg, s, off, mask):
        rotted.add((pg, s))
        R.apply_bitrot(store[pg][s], off, mask)

    def write_shard(pg, s, buf):
        rotted.discard((pg, s))
        store[pg][s] = np.asarray(buf, np.uint8)

    chaos = R.ChaosEngine(m, R.build_scenario(scenario, m), clock=clock, corrupt=corrupt, **dev)
    codec = (MatrixCodec(gf.vandermonde_matrix(K, M), device="cpu") if port
             else RefMatrixCodec(ref_gf.vandermonde_matrix(K, M)))
    spec = (SLOSpec if port else RefSLOSpec)(max_p99_latency_ms=3.0, max_slow_op_fraction=0.01)
    tl = (HealthTimeline if port else RefTimeline)(clock.now, k=K,
                                                   sample_status=spec.sample_status, **dev)
    arbiter = _arbiter(port, clock) if case == "arbiter" else None
    read_shard = lambda pg, s: store[pg][s]  # noqa: E731
    kw = {}
    if case == "scrub-storm":
        scrubber = kw["scrubber"] = R.Scrubber(32, K + M, clock=clock.now, **dev)
        kw["write_shard"] = write_shard
        note_write = scrubber.note_write

        def noting(pg, rs):
            if any(p == pg for p, _ in rotted):
                refreshed.add(int(pg))
            note_write(pg, rs)

        scrubber.note_write = noting
    eng = W.TrafficEngine(
        clock.now, 64, 32, K, K + M, K + 1, ops_per_step=2048, osd_capacity_ops_per_s=300.0,
        recovery_capacity_bps=2e4, op_bytes=64, slow_ms=2.0, seed=1, arbiter=arbiter,
        scrubber=kw.get("scrubber"), read_shard=read_shard if kw else None, **dev)
    sup = R.SupervisedRecovery(codec, chaos, config=(Config if port else RefConfig)(env={}),
                               health=tl, traffic=eng, arbiter=arbiter, **kw, **dev)
    res = sup.run(m_prev, 1, read_shard)
    report = (evaluate if port else ref_evaluate)(tl, spec)
    return res, eng, tl, report, arbiter, refreshed


@pytest.mark.parametrize("case", ["flap", "arbiter", "scrub-storm"])
def test_supervised_run_with_traffic_matches_reference(case):
    ref_res, ref_eng, ref_tl, ref_report, ref_arb, ref_refreshed = _supervised(False, case)
    res, eng, tl, report, arb, refreshed = _supervised(True, case)
    assert res.summary() == ref_res.summary()
    # R9: under scrub-storm the integrity loop refreshes the checksum rows
    # of the first 16 written PGs a step from the store's bytes, rot
    # included, so exactly the rotted PGs it reaches before their repair
    # end inconsistent-unrecoverable, in both packages
    assert res.converged == (case != "scrub-storm")
    assert res.inconsistent_unrecoverable == refreshed == ref_refreshed
    assert bool(refreshed) == (case == "scrub-storm")
    assert len(eng.samples) == len(ref_eng.samples) >= 3
    assert [(s.served, s.degraded, s.blocked) for s in eng.samples] == [
        (s.served, s.degraded, s.blocked) for s in ref_eng.samples]
    assert_samples_equal(eng.samples, ref_eng.samples)
    assert _summary_view(eng.summary()) == _summary_view(ref_eng.summary())
    assert all(s.traffic is not None for s in tl.samples)
    series = tl.series()
    assert series == ref_tl.series() and "traffic_p99_ms" in series
    assert report.to_dict() == ref_report.to_dict()
    assert {"SLO_P99_LATENCY", "SLO_SLOW_OPS"} <= {c.name for c in report.checks}
    assert eng.summary()["degraded"] > 0
    if arb is not None:
        assert arb.summary() == ref_arb.summary()
        assert arb.granted("client") == sum(s.ops for s in eng.samples) * 64
    if case == "scrub-storm":
        s = eng.summary()
        assert s["writes_checksummed"] > 0 and s["degraded_reads_verified"] > 0


def _traffic_pass(port: bool, arbiter_on: bool):
    """``chip_smoke.traffic_run``'s traffic pass (config 6's constants,
    mid-repair-loss, the overload after convergence) at config 6's own
    bench size (``bench/config6_recovery.py``: 1024 OSDs, 256 PGs, RS
    k=8 m=3, 4 KiB shards) through either package."""
    import chip_smoke as cs

    R, W = (rec, wl) if port else (ref_rec, ref_wl)
    dev = {"device": "cpu"} if port else {}
    n_osds, pg_num, chunk = 1024, 256, 4096
    ref_map = ref_build_osdmap(n_osds, pg_num=pg_num, size=11, pool_kind="erasure")
    m = convert.osdmap_from_reference(ref_map.encode()) if port else ref_map
    m_prev = copy.deepcopy(m)
    store = np.random.default_rng(6).integers(0, 256, (11, pg_num * chunk), dtype=np.uint8)
    clock = R.VirtualClock()
    chaos = R.ChaosEngine(m, R.build_scenario(cs.TRAFFIC_SCENARIO, m), clock=clock, **dev)
    codec = (MatrixCodec(gf.vandermonde_matrix(8, 3), device="cpu") if port
             else RefMatrixCodec(ref_gf.vandermonde_matrix(8, 3)))
    spec = (SLOSpec if port else RefSLOSpec)(**cs.TRAFFIC_SLO)
    tl = (HealthTimeline if port else RefTimeline)(clock.now, k=8,
                                                   sample_status=spec.sample_status, **dev)
    arbiter = None
    if arbiter_on:
        cfg = (Config if port else RefConfig)(env={})
        cap = cs.TRAFFIC_ARBITER_CAP_BPS
        for key, v in (("client_res", cap / 2), ("recovery_res", cap / 8),
                       ("recovery_lim", cap / 4)):
            cfg.set(f"osd_mclock_{key}_bps", v)
        arbiter = W.MClockArbiter.from_config(cap, cfg, clock=clock.now, sleep=clock.sleep)
    eng = W.TrafficEngine(
        clock.now, n_osds, pg_num, 8, 11, 9, ops_per_step=cs.TRAFFIC_OPS,
        service_ms=cs.TRAFFIC_SERVICE_MS, osd_capacity_ops_per_s=cs.TRAFFIC_OSD_CAP_OPS,
        recovery_capacity_bps=cs.TRAFFIC_REC_CAP_BPS, op_bytes=cs.TRAFFIC_OP_BYTES,
        slow_ms=cs.TRAFFIC_SLOW_MS, seed=cs.TRAFFIC_SEED, arbiter=arbiter, **dev)
    sup = R.SupervisedRecovery(codec, chaos, config=(Config if port else RefConfig)(env={}),
                               seed=0, health=tl, traffic=eng, arbiter=arbiter, **dev)
    res = sup.run(m_prev, 1, lambda pg, s: store[s, pg * chunk:(pg + 1) * chunk])
    clean = (rec.peer_pool(chaos.osdmap, chaos.osdmap, 1, device="cpu") if port
             else ref_rec.peer_pool(chaos.osdmap, chaos.osdmap, 1))
    t0 = clock.now()
    eng.set_overload(t0 + cs.OVERLOAD_START_S, t0 + cs.OVERLOAD_END_S, cs.OVERLOAD_FACTOR)
    for _ in range(cs.POST_STEPS):
        clock.advance(1.0)
        sample = eng.observe(clean, epoch=chaos.epoch, bytes_recovered=res.bytes_recovered)
        tl.snapshot(clean, epoch=chaos.epoch, bytes_recovered=res.bytes_recovered, traffic=sample)
    return res, eng, tl, (evaluate if port else ref_evaluate)(tl, spec), arbiter


def test_traffic_pass_matches_reference():
    """Both runs of the chip's traffic pass, at config 6's bench size:
    equal to the reference run for run.  The arbiter run rebuilds fewer
    bytes than the other in both packages (an epoch lands on a launch in
    flight, whose salvage commits fewer shards), so the two runs' bytes
    are not a gate of the pass."""
    bytes_ = {}
    for arbiter_on in (False, True):
        ref_res, ref_eng, ref_tl, ref_report, ref_arb = _traffic_pass(False, arbiter_on)
        res, eng, tl, report, arb = _traffic_pass(True, arbiter_on)
        assert res.summary() == ref_res.summary() and res.converged
        assert_samples_equal(eng.samples, ref_eng.samples)
        assert _summary_view(eng.summary()) == _summary_view(ref_eng.summary())
        assert tl.series() == ref_tl.series()
        assert report.to_dict() == ref_report.to_dict()
        if arb is not None:
            assert arb.summary() == ref_arb.summary()
        healths = [s.health for s in tl.samples][-10:]
        assert healths[0] == healths[-1] == "HEALTH_OK" and "HEALTH_WARN" in healths
        bytes_[arbiter_on] = (res.bytes_recovered, ref_res.bytes_recovered)
    assert bytes_[False][0] > bytes_[True][0] > 0
