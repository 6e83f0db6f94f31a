"""The port's scenario fleets and Monte Carlo durability vs the reference's.

The map is the reference tests' own (``build_osdmap(32, pg_num=16,
size=6, erasure)``), built in the reference package and carried across
as ``encode()`` bytes; each package samples the same jittered fleet on
its own map (FLEET 4, 16 epochs, ``FleetDriver(m, seed=7, n_ops=64)``,
the port on the CPU).

Equal, exactly: ``sample_timelines`` and ``stack_tapes`` against the
reference's; every port lane against the port's own sequential run
(``run_sequential``, and a plain ``EpochDriver`` for one lane:
``EpochSeries.diff == []``); a fleet of 3 against the first 3 lanes of a
fleet of 4.  Against the reference's ``FleetSeries`` lane, the rules of
``tests/test_torch_superstep.py``: every integer lane, ``now`` and
``max_rho`` exact; ``hist`` by value (the reference's widens to int64,
ROADMAP §3 R10); the float32 ``sums`` at ``rtol=1e-6`` (the packages
reduce in different orders); the latency and queue-depth histograms
exact except ops whose quotient ``v / lat_min`` lies within 4 ulps of a
power of two (R8), where the difference must be exactly what the
reference's ``bucketize`` makes of those ops' values, recomputed from
the port's state after that epoch.

Durability, on the same ``hist`` and ``counts`` arrays: ``_outcome_reduce``
exact; the point fields of ``DurabilityEstimate`` exact (``n_lost``,
survival, MTTDL, ``mttdl_censored``, the worst cluster, the means); the
bootstrap CI, computed from the reference's own ``jax.random.randint``
indices, at ``rtol=1e-12`` (the float64 resample means reduce in
different orders).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.obs.pg_states import pg_state_step as ref_pg_state_step
from ceph_tpu.recovery import durability as ref_dur
from ceph_tpu.recovery.fleet import (
    FleetDriver as RefFleetDriver,
    sample_timelines as ref_sample_timelines,
    stack_tapes as ref_stack_tapes,
)
from ceph_tpu.recovery.superstep import compile_event_tape as ref_compile_event_tape
from ceph_tpu.workload import histogram as ref_hist
from ceph_tpu_torch import convert
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.obs.pg_states import N_STATES, STATE_ACTIVE_CLEAN, pg_state_reduce
from ceph_tpu_torch.recovery import durability
from ceph_tpu_torch.recovery.fleet import FleetDriver, sample_timelines, stack_tapes
from ceph_tpu_torch.recovery.superstep import compile_event_tape
from ceph_tpu_torch.workload import histogram, traffic

ZOO = ("flap", "rack-cascade", "mid-repair-loss", "ssd-burst")
FLEET = 4
EPOCHS = 16
N_OPS = 64
SEED = 7
RTOL = 1e-6
NB, LAT_MIN = histogram.N_BUCKETS, histogram.LAT_MIN_MS
EXACT = ("now", "epoch", "dirty", "aux", "counts", "max_rho", "writes", "deg_reads",
         "down_total", "eff_down", "eff_up", "eff_out", "down_checksum", "scrub_due")


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


def _maps(n_osd=32, pg_num=16):
    ref = ref_build_osdmap(n_osd, pg_num=pg_num, size=6, pool_kind="erasure")
    return ref, convert.osdmap_from_reference(ref.encode())


@pytest.fixture(scope="module")
def drivers():
    ref_m, m = _maps()
    return (RefFleetDriver(ref_m, seed=SEED, n_ops=N_OPS),
            FleetDriver(m, seed=SEED, n_ops=N_OPS, device="cpu"))


def _tape_sigs(tls, m, compile_fn):
    tapes = [compile_fn(tl, m) for tl in tls]
    return [tuple(np.asarray(getattr(tp, f)).tobytes() for f in ("t", "kind", "osd", "bump"))
            for tp in tapes]


def exact_bucket(values) -> np.ndarray:
    """numpy's exact floor(log2(max(v, lat_min) / lat_min)), clipped."""
    lm = np.float32(LAT_MIN)
    q = np.maximum(np.asarray(values, np.float32), lm) / lm
    _mant, exp = np.frexp(q)
    return np.clip(exp - 1, 0, NB - 1).astype(np.int32)


def near_power_of_two(values, ulps=4) -> np.ndarray:
    """R8's band: the float32 quotient lies within ``ulps`` of a power of two."""
    lm = np.float32(LAT_MIN)
    q = np.maximum(np.asarray(values, np.float32), lm) / lm
    frac = q.view(np.int32) & 0x7FFFFF
    return np.minimum(frac, 0x800000 - frac) <= ulps


def _op_values(driver, state, step):
    """Per-op ``(lat, qd, ok)`` of epoch ``step``'s traffic over ``state``
    (no workload mix: the capacity is the driver's)."""
    salt = (driver.salt_base + step * 40503) & 0xFFFFFFFF
    ids = torch.arange(driver.n_ops, dtype=torch.int64)
    pg_bmask = (1 << max(driver.pg_num - 1, 1).bit_length()) - 1
    _pg, prim, is_write, blocked, degraded, cost = traffic._route(
        state.survivor_mask, state.n_alive, state.acting_primary, ids, salt, driver.pg_num,
        pg_bmask, driver.k, driver.size, driver.min_size, driver.write_permille)
    idx, valid = traffic._osd_index(prim, state.n_osds)
    load = traffic._scatter_load(idx, valid, blocked, cost, state.n_osds)
    _rho, qd, lat = traffic._queue_model(
        load, idx, is_write, degraded, driver.k, np.float32(driver.service_ms),
        np.float32(driver.cap_ops), np.float32(driver.rho_recovery))
    return lat.numpy(), qd.numpy(), (~blocked).numpy()


def assert_lane_matches_reference(port, ref, m, timeline, seed):
    """One fleet lane against the reference's, under the rules above."""
    for f in EXACT:
        want = np.asarray(getattr(ref, f))
        got = getattr(port, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert port.hist.dtype == np.int32
    np.testing.assert_array_equal(port.hist, np.asarray(ref.hist))
    np.testing.assert_allclose(port.sums, np.asarray(ref.sums), rtol=RTOL, atol=0)
    r_lat, r_qd = np.asarray(ref.lat_hist), np.asarray(ref.qd_hist)
    differ = np.nonzero((port.lat_hist != r_lat).any(1) | (port.qd_hist != r_qd).any(1))[0]
    if not differ.size:
        return
    driver = rec.EpochDriver(m, timeline, seed=seed, n_ops=N_OPS, device="cpu")
    states = {}

    def keep(start, _part):
        if start in differ:
            states[start] = driver.final_state

    driver.run_superstep(len(port), snapshot_every=1, on_snapshot=keep)
    for e in differ:
        lat, qd, ok = _op_values(driver, states[e], int(e))
        for vals, p_hist, r_hist in ((lat, port.lat_hist[e], r_lat[e]),
                                     (qd, port.qd_hist[e], r_qd[e])):
            v = vals[ok]
            np.testing.assert_array_equal(p_hist, np.bincount(exact_bucket(v), minlength=NB))
            band = v[near_power_of_two(v)]
            r8 = (np.bincount(exact_bucket(band), minlength=NB)
                  - np.bincount(np.asarray(ref_hist.bucketize(jnp.asarray(band))),
                                minlength=NB))
            np.testing.assert_array_equal(p_hist.astype(np.int64) - r_hist, r8)


def test_sample_timelines_and_stack_tapes_match_reference():
    ref_m, m = _maps()
    for seed, n, scenario, kw in ((11, 6, "ssd-burst", {}), (3, 3, "flap", {}),
                                  (11, 3, "flap", {"jitter": 0.0}),
                                  (5, 5, "rack-cascade", {"cycles": 2})):
        tls = sample_timelines(seed, n, scenario, m, **kw)
        ref_tls = ref_sample_timelines(seed, n, scenario, ref_m, **kw)
        assert (_tape_sigs(tls, m, compile_event_tape)
                == _tape_sigs(ref_tls, ref_m, ref_compile_event_tape))
        ft = stack_tapes([compile_event_tape(tl, m) for tl in tls])
        rft = ref_stack_tapes([ref_compile_event_tape(tl, ref_m) for tl in ref_tls])
        assert (ft.n_clusters, ft.fleet_pad, ft.rows_pad) == (
            rft.n_clusters, rft.fleet_pad, rft.rows_pad)
        for f in ("t", "kind", "osd", "bump"):
            got, want = getattr(ft, f), np.asarray(getattr(rft, f))
            assert got.dtype == want.dtype and np.array_equal(got, want), f
    # prefix-stable: cluster i depends on (seed, i) only
    a = _tape_sigs(sample_timelines(11, 6, "ssd-burst", m), m, compile_event_tape)
    assert a[:3] == _tape_sigs(sample_timelines(11, 3, "ssd-burst", m), m, compile_event_tape)
    t, kind, _osd, _bump = ft.device("cpu")
    assert t.dtype == torch.float64 and torch.equal(kind, torch.from_numpy(ft.kind))
    with pytest.raises(ValueError):
        stack_tapes([])


@pytest.mark.parametrize("scenario", ZOO)
def test_fleet_lanes_equal_sequential_and_reference_over_zoo(drivers, scenario):
    ref_fd, fd = drivers
    tls = fd.sample(FLEET, scenario)
    fs = fd.run_fleet(EPOCHS, tls)
    seqs = fd.run_sequential(EPOCHS, tls)
    assert fs.n_clusters == FLEET and len(fs) == EPOCHS
    for k in range(FLEET):
        assert fs.cluster(k).diff(seqs[k]) == [], (scenario, k)
    # traffic conservation per lane per epoch
    assert (fs.counts.sum(axis=2) == N_OPS).all()
    # not vacuous: every scenario of the zoo moves the map
    assert fs.dirty.sum() > 0 and fd.stats["peered"] > 0
    ref_fs = ref_fd.run_fleet(EPOCHS, ref_fd.sample(FLEET, scenario))
    for k in range(FLEET):
        assert_lane_matches_reference(fs.cluster(k), ref_fs.cluster(k), fd.m, tls[k],
                                      SEED + k)


def test_fleet_lane_matches_plain_epoch_driver(drivers):
    _ref_fd, fd = drivers
    tls = fd.sample(FLEET, "ssd-burst")
    fs = fd.run_fleet(EPOCHS, tls)
    k = 2
    d = rec.EpochDriver(fd.m, tls[k], seed=fd.seed + k, n_ops=N_OPS, device="cpu")
    assert fs.cluster(k).diff(d.run_superstep(EPOCHS)) == []
    # the final state is every lane's: the plain driver's scalars and tables
    st = fd.final_state
    for f in ("up", "acting", "survivor_mask", "pg_hist", "down", "last_ack"):
        assert torch.equal(getattr(st, f)[k], getattr(d.final_state, f)), f
    for f in ("epoch", "step", "tape_cursor", "now", "last_tick"):
        assert getattr(st, f)[k].item() == getattr(d.final_state, f).item(), f


def test_fleet_of_three_is_the_first_three_of_four(drivers):
    _ref_fd, fd = drivers
    tls = fd.sample(4, "flap")
    four = fd.run_fleet(EPOCHS, tls)
    three = fd.run_fleet(EPOCHS, tls[:3])
    assert three.n_clusters == 3
    for k in range(3):
        assert three.cluster(k).diff(four.cluster(k)) == []
    # rows left on the device: the same series once pulled
    state, rows = fd.run_fleet(EPOCHS, tls, pull=False)
    assert tuple(rows.packed.shape[:2]) == (EPOCHS, 4) and state is fd.final_state
    pulled = rec.FleetSeries.from_device(rows, 4)
    assert all(pulled.cluster(k).diff(four.cluster(k)) == [] for k in range(4))


def test_netsplit_fleet_ticks_lanes_apart():
    """Lanes whose netsplits start at different epochs tick the detector
    on different epochs (each lane its own decay and idle skip), mark
    down, auto-out and up again, each equal to its own run."""
    _ref_m, m = _maps()
    cfg = Config(env={})
    cfg.set("osd_heartbeat_grace", 0.5)
    cfg.set("mon_osd_down_out_interval", 1.0)
    fd = FleetDriver(m, seed=3, n_ops=N_OPS, config=cfg, device="cpu")
    tls = [rec.ChaosTimeline.from_pairs([(t0, ("netsplit:3", "netsplit:9")),
                                         (t0 + 4.0, ("netsplit:3:restore",
                                                     "netsplit:9:restore"))])
           for t0 in (0.3, 1.1, 2.6)] + [rec.ChaosTimeline()]
    fs = fd.run_fleet(32, tls)
    seqs = fd.run_sequential(32, tls)
    for k in range(4):
        assert fs.cluster(k).diff(seqs[k]) == [], k
    # each netsplit lane: two OSDs marked down, auto-outed and up again,
    # each lane on its own epochs
    assert (fs.eff_down.sum(0)[:3] == 2).all() and (fs.eff_out.sum(0)[:3] == 2).all()
    assert (fs.eff_up.sum(0)[:3] == 2).all()
    assert len({int(np.argmax(fs.eff_down[:, k])) for k in range(3)}) == 3
    assert fs.dirty[:, 3].sum() == 0 and fd.stats["reads"] > 0


def test_flight_recorder_on_leaves_a_per_lane_ring():
    """No longer refused: with the recorder on, a run leaves a per-lane
    ring (``tests/test_torch_flight.py`` holds it to the reference's);
    off, none."""
    _ref_m, m = _maps()
    cfg = Config(env={})
    cfg.set("flight_recorder", "on")
    cfg.set("flight_ring_epochs", 4)
    fd = FleetDriver(m, n_ops=16, config=cfg, device="cpu")
    fd.run_fleet(2, fd.sample(2, "flap"))
    assert fd.flight.ring.shape[:2] == (2, 4) and int(fd.flight.head) == 2
    assert FleetDriver(m, n_ops=16, device="cpu").flight is None


def test_batched_pg_state_reduce_is_per_lane():
    rng = np.random.default_rng(5)
    masks = rng.integers(0, 64, (3, 40)).astype(np.int64)
    alive = rng.integers(3, 7, (3, 40)).astype(np.int32)
    flags = rng.integers(0, 1 << 10, (3, 40)).astype(np.int32)
    hist, aux = pg_state_reduce(torch.from_numpy(masks), torch.from_numpy(alive),
                                torch.from_numpy(flags), 4, 6)
    assert tuple(hist.shape) == (3, N_STATES) and tuple(aux.shape) == (3, 2)
    for i in range(3):
        want = ref_pg_state_step()(jnp.asarray(masks[i].astype(np.uint32)),
                                   jnp.asarray(alive[i]), jnp.asarray(flags[i]), 4, 6)
        np.testing.assert_array_equal(hist[i].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(aux[i].numpy(), np.asarray(want[1]))


# --- Monte Carlo durability -------------------------------------------


class _FakeFleet:
    def __init__(self, hist, counts):
        self.hist = hist
        self.counts = counts


def _clean_fleet(n_epochs=8, n_clusters=4, pg_num=16):
    hist = np.zeros((n_epochs, n_clusters, N_STATES), np.int32)
    hist[:, :, STATE_ACTIVE_CLEAN] = pg_num
    counts = np.zeros((n_epochs, n_clusters, 3), np.int32)
    counts[:, :, 0] = 64  # all ops served
    return hist, counts


def _lossy_fleet():
    from ceph_tpu_torch.obs.pg_states import STATE_DEGRADED, STATE_INACTIVE

    hist, counts = _clean_fleet()
    # cluster 1 drops a PG below k for two epochs -> lost; cluster 2
    # runs degraded-but-readable epochs 2..5 -> ttzd = 4 epochs;
    # cluster 3 blocks half its ops in epoch 0 -> worst availability
    hist[3:5, 1, STATE_INACTIVE] = 1
    hist[3:5, 1, STATE_ACTIVE_CLEAN] = 15
    hist[2:6, 2, STATE_DEGRADED] = 2
    hist[2:6, 2, STATE_ACTIVE_CLEAN] = 14
    counts[0, 3, 0] = 32
    counts[0, 3, 2] = 32
    return hist, counts


def _random_fleet(seed=9, n_epochs=12, n_clusters=24, pg_num=16):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 3, (n_epochs, n_clusters, N_STATES)).astype(np.int32)
    hist[:, :, STATE_ACTIVE_CLEAN] = pg_num - hist.sum(-1) + hist[:, :, STATE_ACTIVE_CLEAN]
    hist[:, ::3, :] = 0
    hist[:, ::3, STATE_ACTIVE_CLEAN] = pg_num
    counts = rng.integers(0, 64, (n_epochs, n_clusters, 3)).astype(np.int32)
    return hist, counts


POINT_FIELDS = ("scenario", "n_clusters", "n_epochs", "mission_s", "survival_fraction",
                "n_lost", "mttdl_s", "mttdl_censored", "availability_mean", "ttzd_mean_s",
                "worst_cluster", "worst_availability", "seed", "n_boot", "codec", "ec_k",
                "ec_m", "placement", "down_out_interval_s")
CI_FIELDS = ("mttdl_ci_lo_s", "mttdl_ci_hi_s", "availability_ci_lo", "availability_ci_hi",
             "ttzd_ci_lo_s", "ttzd_ci_hi_s")


def _both_estimates(hist, counts, seed, n_boot, **kw):
    """The reference's estimate and the port's on the reference's own
    resample indices (its ``jax.random.randint`` draw stands in for the
    port's seeded ``torch.Generator`` draw)."""
    ref = ref_dur.estimate_durability(_FakeFleet(hist, counts), seed=seed, n_boot=n_boot, **kw)
    idx = jax.random.randint(jax.random.PRNGKey(seed), (n_boot, hist.shape[1]), 0, hist.shape[1])
    port = durability.estimate_durability(_FakeFleet(hist, counts), seed=seed, n_boot=n_boot,
                                          indices=torch.from_numpy(np.array(idx)),
                                          device="cpu", **kw)
    return ref, port


def assert_estimates_match(ref, port):
    for f in POINT_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    for f in CI_FIELDS:
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=1e-12, atol=0,
                                   err_msg=f)
    assert port.to_dict().keys() == ref.to_dict().keys()


@pytest.mark.parametrize("make", [_clean_fleet, _lossy_fleet, _random_fleet])
def test_outcome_reduce_matches_reference(make):
    hist, counts = make()
    pg_num = int(hist[0, 0].sum())
    want = ref_dur._outcome_reduce(jnp.asarray(hist), jnp.asarray(counts), pg_num)
    got = durability._outcome_reduce(torch.from_numpy(hist), torch.from_numpy(counts), pg_num)
    for name, g, w in zip(("lost", "avail", "degraded_epochs", "ttzd"), got, want):
        g, w = g.numpy(), np.asarray(w)
        # degraded_epochs by value: the reference's jnp.sum of int32
        # widens to int64 under x64 (as R10's); the port keeps int32
        assert g.dtype == (np.int32 if name == "degraded_epochs" else w.dtype), name
        assert np.array_equal(g, w), name


def test_durability_censored_rule_of_three():
    hist, counts = _clean_fleet()
    ref, port = _both_estimates(hist, counts, 3, 32, dt=0.25, scenario="synthetic")
    assert_estimates_match(ref, port)
    exposure = 4 * 8 * 0.25
    assert port.n_lost == 0 and port.survival_fraction == 1.0 and port.mttdl_censored is True
    assert port.mttdl_s == exposure / durability.RULE_OF_THREE
    assert port.mttdl_ci_lo_s == port.mttdl_ci_hi_s == exposure / durability.RULE_OF_THREE
    assert port.availability_mean == 1.0 and port.ttzd_mean_s == 0.0
    import json

    assert json.loads(json.dumps(port.to_dict())) == ref.to_dict()


def test_durability_detects_loss_and_worst_cluster():
    hist, counts = _lossy_fleet()
    ref, port = _both_estimates(hist, counts, 3, 64, dt=0.25, scenario="synthetic")
    assert_estimates_match(ref, port)
    assert port.n_lost == 1 and port.survival_fraction == 0.75
    assert port.mttdl_censored is False and port.mttdl_s == 4 * 8 * 0.25
    assert 0.0 < port.mttdl_ci_lo_s <= port.mttdl_s <= port.mttdl_ci_hi_s
    assert port.worst_cluster == 3
    assert port.worst_availability == 1.0 - 32 / (8 * 64)
    assert port.ttzd_mean_s == (0 + 2 * 0.25 + 4 * 0.25 + 0) / 4


def test_durability_of_random_and_real_fleets_matches_reference(drivers):
    hist, counts = _random_fleet()
    assert_estimates_match(*_both_estimates(
        hist, counts, 11, 128, dt=0.5, scenario="random", codec="reed-solomon", ec_k=4,
        ec_m=2, placement="crush", down_out_interval_s=600.0))
    _ref_fd, fd = drivers
    fs = fd.run_fleet(EPOCHS, fd.sample(FLEET, "ssd-burst"))
    ref, port = _both_estimates(fs.hist, fs.counts, fd.seed, 32, dt=fd.driver.dt,
                                scenario="ssd-burst")
    assert_estimates_match(ref, port)
    assert port.n_clusters == FLEET and port.mission_s == EPOCHS * fd.driver.dt
    # the seeded torch draw: in range, reproducible, and a full estimate
    idx = durability.bootstrap_indices(3, 16, FLEET, "cpu")
    assert tuple(idx.shape) == (16, FLEET) and 0 <= int(idx.min()) and int(idx.max()) < FLEET
    assert torch.equal(idx, durability.bootstrap_indices(3, 16, FLEET, "cpu"))
    est = durability.estimate_durability(fs, dt=fd.driver.dt, seed=3, n_boot=16, device="cpu")
    assert est == durability.estimate_durability(fs, dt=fd.driver.dt, seed=3, n_boot=16,
                                                 indices=idx, device="cpu")
    assert est.survival_fraction == port.survival_fraction
    assert est.availability_ci_lo <= est.availability_ci_hi
