"""The port's epoch loop vs the reference package's.

The map is built in the reference package (``build_osdmap(64,
pg_num=128, size=6, erasure)``) and carried across as ``encode()``
bytes; each package builds the same chaos scenario on its own map and
runs ``EpochDriver(m, timeline, n_ops=256)`` for 40 epochs (48 for the
netsplit hold), the port on the CPU (``device="cpu"``: peering takes
the plain versions of the CRUSH kernels).

Equal, exactly: the port's superstep and staged series
(``EpochSeries.diff == []``); against the reference, every integer
lane, ``now`` and ``max_rho``.  ``hist`` is compared by value: the
reference's widens to int64 under x64 (ROADMAP §3, R10) and the port's
is its documented int32.  The two float32 ``sums`` are held at
``rtol=1e-6`` (the packages reduce in different orders).  The latency
and queue-depth histograms are exact except ops whose quotient
``v / lat_min`` lies within 4 ulps of a power of two, where the
reference's float32 ``log2`` is not exact (ROADMAP §3, R8): on an epoch
where they differ, the difference must be exactly what the reference's
``bucketize`` makes of those ops' values, recomputed from the port's
state after that epoch, and nothing else.

Also: ``compile_event_tape`` rows and bumps equal to the reference's,
with its refusals; the switch pins the staged path; ``run_epochs``
with snapshots; the tape's rank, chip and crash refusals; the flight
recorder's refusal.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu import recovery as ref_rec
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.recovery.chaos import ChaosEvent as RefEvent, ChaosTimeline as RefTimeline
from ceph_tpu.recovery.failure import parse_spec as ref_parse_spec
from ceph_tpu.recovery.superstep import compile_event_tape as ref_compile_event_tape
from ceph_tpu.workload import histogram as ref_hist
from ceph_tpu_torch import convert
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.recovery.chaos import ChaosEvent, ChaosTimeline
from ceph_tpu_torch.recovery.failure import parse_spec
from ceph_tpu_torch.recovery.superstep import EpochSeries, compile_event_tape
from ceph_tpu_torch.workload import histogram, traffic

ZOO = ("flap", "rack-cascade", "mid-repair-loss", "silent-bitrot", "scrub-storm",
       "flapping-osd")
N_OPS = 256
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


def _maps(n_osd=64, pg_num=128):
    ref = ref_build_osdmap(n_osd, pg_num=pg_num, size=6, pool_kind="erasure")
    return ref, convert.osdmap_from_reference(ref.encode())


def exact_bucket(values, n_buckets=NB, lat_min=LAT_MIN) -> np.ndarray:
    """numpy's exact floor(log2(max(v, lat_min) / lat_min)), clipped."""
    lm = np.float32(lat_min)
    q = np.maximum(np.asarray(values, np.float32), lm) / lm
    _mant, exp = np.frexp(q)
    return np.clip(exp - 1, 0, n_buckets - 1).astype(np.int32)


def near_power_of_two(values, lat_min=LAT_MIN, ulps=4) -> np.ndarray:
    """R8's band: the float32 quotient ``max(v, lat_min) / lat_min``
    lies within ``ulps`` of a power of two."""
    lm = np.float32(lat_min)
    q = np.maximum(np.asarray(values, np.float32), lm) / lm
    frac = q.view(np.int32) & 0x7FFFFF
    return np.minimum(frac, 0x800000 - frac) <= ulps


def _op_values(driver, state, step):
    """Per-op ``(lat, qd, ok)`` of epoch ``step``'s traffic over
    ``state`` (no workload mix: the capacity is the driver's)."""
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


def assert_matches_reference(port: EpochSeries, ref, driver, n_epochs: int):
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
    # the histograms, op by op, on each epoch where they differ: the
    # port's are the exact floor of log2 of its per-op values, and the
    # reference's differ only in R8's band
    states = {}

    def keep(start, _part):
        if start in differ:
            states[start] = driver.final_state

    driver.run_superstep(n_epochs, snapshot_every=1, on_snapshot=keep)
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


@pytest.mark.parametrize("scenario", ZOO)
def test_superstep_equals_staged_and_reference_over_zoo(scenario):
    ref_m, m = _maps()
    ref = ref_rec.EpochDriver(ref_m, ref_rec.build_scenario(scenario, ref_m), n_ops=N_OPS)
    d = rec.EpochDriver(m, rec.build_scenario(scenario, m), n_ops=N_OPS, device="cpu")
    sup = d.run_superstep(40)
    staged = d.run_staged(40)
    assert sup.diff(staged) == []
    np.testing.assert_array_equal(d.tape.t, ref.tape.t)
    assert_matches_reference(sup, ref.run_superstep(40), d, 40)
    # not vacuous: map actions exercise the dirty re-peer; flapping-osd's
    # netsplits stay inside the grace (the map never moves) and
    # silent-bitrot's events are host-store-only and emit no rows
    if scenario == "silent-bitrot":
        assert d.tape.n_bitrot > 0
    elif scenario == "flapping-osd":
        assert len(d.tape) > 0 and sup.dirty.sum() == 0
    else:
        assert sup.dirty.sum() > 0, scenario
    # traffic conservation: served + degraded + blocked == ops issued
    assert (sup.counts.sum(axis=1) == N_OPS).all()


def _netsplit_hold(parse, event, timeline):
    return timeline([
        event(0.3, (parse("netsplit:3"), parse("netsplit:9"))),
        event(8.0, (parse("netsplit:3:restore"), parse("netsplit:9:restore"))),
    ])


def test_superstep_equals_staged_and_reference_netsplit_hold():
    # hold a 2-OSD netsplit past a tightened grace and out interval, so
    # mark-down -> auto-out -> mark-up runs through both paths
    ref_m, m = _maps()
    configs = []
    for cls in (RefConfig, Config):
        cfg = cls(env={})
        cfg.set("osd_heartbeat_grace", 0.5)
        cfg.set("mon_osd_down_out_interval", 2.0)
        configs.append(cfg)
    ref = ref_rec.EpochDriver(ref_m, _netsplit_hold(ref_parse_spec, RefEvent, RefTimeline),
                              n_ops=N_OPS, config=configs[0])
    d = rec.EpochDriver(m, _netsplit_hold(parse_spec, ChaosEvent, ChaosTimeline),
                        n_ops=N_OPS, config=configs[1], device="cpu")
    sup = d.run_superstep(48)
    assert sup.diff(d.run_staged(48)) == []
    assert_matches_reference(sup, ref.run_superstep(48), d, 48)
    assert sup.eff_down.sum() == 2 and sup.eff_out.sum() == 2 and sup.eff_up.sum() == 2
    assert sup.down_total.max() == 2
    # the final state's scalars are the host's view of the run
    st = d.final_state
    assert (int(st.step), float(st.now), int(st.epoch)) == (47, 12.0, int(sup.epoch[-1]))
    assert int(st.tape_cursor) == len(d.tape)


def test_switch_pins_staged_path(monkeypatch):
    _ref_m, m = _maps(32, 64)
    timeline = ChaosTimeline([ChaosEvent(0.3, (parse_spec("osd:3:down_out"),))])
    d = rec.EpochDriver(m, timeline, n_ops=64, device="cpu")
    calls = []
    orig = rec.EpochDriver.run_staged
    monkeypatch.setattr(
        rec.EpochDriver, "run_staged",
        lambda self, *a, **kw: (calls.append("staged"), orig(self, *a, **kw))[1],
    )
    monkeypatch.setenv("CEPH_TPU_EPOCH_SUPERSTEP", "0")
    off = d.run(12)
    assert calls == ["staged"]
    monkeypatch.setenv("CEPH_TPU_EPOCH_SUPERSTEP", "1")
    on = d.run(12)
    assert calls == ["staged"]  # the superstep did not re-enter staged
    assert on.diff(off) == []


def test_run_epochs_with_snapshots():
    ref_m, m = _maps(32, 64)
    timeline = ChaosTimeline([ChaosEvent(0.3, (parse_spec("osd:5"),))])
    seen = []
    series = rec.run_epochs(
        m, timeline, 16, n_ops=64, snapshot_every=4, device="cpu",
        on_snapshot=lambda start, part: seen.append((start, len(part))),
    )
    assert len(series) == 16
    assert seen == [(0, 4), (4, 4), (8, 4), (12, 4)]
    d = rec.EpochDriver(m, timeline, n_ops=64, device="cpu")
    assert series.diff(d.run_superstep(16)) == []
    # the staged path's snapshots split the same way
    staged_seen = []
    staged = d.run_staged(16, snapshot_every=4,
                          on_snapshot=lambda s, p: staged_seen.append((s, len(p))))
    assert staged_seen == seen and staged.diff(series) == []
    ref = ref_rec.run_epochs(ref_m, RefTimeline([RefEvent(0.3, (ref_parse_spec("osd:5"),))]),
                             16, n_ops=64, snapshot_every=4)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(series, f), np.asarray(getattr(ref, f)), f)
    # rows left on the device, and the zero-epoch corner
    state, rows = d.run_superstep(16, pull=False)
    assert rows.packed.shape[0] == 16 and state is d.final_state
    assert EpochSeries.from_device(rows).diff(series) == []
    empty = d.run_superstep(0)
    assert len(empty) == 0 and empty.hist.shape == (0, 7) and empty.sums.dtype == np.float32
    assert len(d.run_staged(0)) == 0
    assert rec.compile_epoch_superstep(d)(16).diff(series) == []


def test_event_tape_matches_reference():
    ref_m, m = _maps(32, 64)
    pairs = [(0.3, ("osd:3:down_out", "slow:7")), (0.8, ("netsplit:5",)),
             (1.1, ("host:host0_1",)), (1.6, ("osd:3:up", "osd:3:in", "bitrot:2.1.8.255")),
             (2.0, ("slow:7:restore", "netsplit:5:restore"))]
    tape = compile_event_tape(ChaosTimeline.from_pairs(pairs), m)
    ref = ref_compile_event_tape(RefTimeline.from_pairs(pairs), ref_m)
    for f in ("t", "kind", "osd", "bump"):
        got, want = getattr(tape, f), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert (tape.n_events, tape.n_bitrot) == (ref.n_events, ref.n_bitrot) == (5, 1)
    # down_out:3 -> DOWN+OUT, slow:7 -> SLOW; netsplit:5 -> NET; only
    # events with map rows bump, once each
    assert tape.bump.tolist().count(1) == 3 and (np.diff(tape.t) >= 0).all()
    t, kind, osd, bump = tape.device("cpu")
    assert torch.equal(kind, torch.from_numpy(tape.kind)) and t.dtype == torch.float64


@pytest.mark.parametrize("specs,match", [
    (("osd:3:down", "osd:3:up"), "conflicting"),
    (("osd:4:out", "osd:4:in"), "conflicting"),
    (("rankstall:1.2",), "rank-scoped"),
    (("chipstall:0.1",), "device-mesh chip"),
    (("crash:4",), "kills the driving process"),
])
def test_event_tape_refusals_match_reference(specs, match):
    ref_m, m = _maps(32, 64)
    with pytest.raises(ValueError, match=match):
        ref_compile_event_tape(RefTimeline.from_pairs([(0.3, specs)]), ref_m)
    with pytest.raises(ValueError, match=match):
        compile_event_tape(ChaosTimeline.from_pairs([(0.3, specs)]), m)


def test_flight_recorder_on_is_not_ported():
    _ref_m, m = _maps(32, 64)
    cfg = Config(env={})
    cfg.set("flight_recorder", "on")
    with pytest.raises(NotImplementedError, match="item 3"):
        rec.EpochDriver(m, ChaosTimeline(), n_ops=16, config=cfg, device="cpu")
    assert not rec.EpochDriver(m, ChaosTimeline(), n_ops=16, device="cpu").flight_on
