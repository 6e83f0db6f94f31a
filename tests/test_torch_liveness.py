"""The port's liveness detector vs the reference package's.

``heartbeat_step`` runs on seeded random lane states (float32 last-ack,
laggy, markdown and down-since lanes, boolean down/suppressed/slow
lanes, int32 reporter counts) and random policy scalars through both
packages: the boolean lanes (down, the out proposals) must be equal,
the float32 lanes equal within ``rtol=1e-6`` (the tolerance: both keep
the lanes in float32, but XLA's CPU ``pow`` and torch's may round
``2 ** markdowns`` apart by an ulp).  ``LivenessDetector`` runs the same
sequence of netsplits, slow OSDs, map syncs, reporter pools, flags and
ticks in both packages and must return the same transitions, detections,
deadlines and ``summary()``.  ``PeeringResult.peer_counts`` is equal
after a host failure.  Everything runs on the CPU (``device="cpu"``).
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu import recovery as ref_rec
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu_torch import convert
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.common.config import Config

RTOL = 1e-6  # float32 lanes; boolean lanes exact


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


def _lanes(seed: int, n: int = 257):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lanes = (
        rng.uniform(0.0, 50.0, n).astype(f32),  # last_ack
        rng.uniform(0.0, 1.0, n).astype(f32),  # laggy
        np.where(rng.random(n) < 0.5, rng.integers(0, 7, n),
                 rng.uniform(0.0, 6.0, n)).astype(f32),  # markdowns
        rng.random(n) < 0.3,  # down
        rng.uniform(0.0, 50.0, n).astype(f32),  # down_since
        rng.random(n) < 0.5,  # suppressed
        rng.random(n) < 0.3,  # slow
        rng.integers(0, 4, n).astype(np.int32),  # reporters
    )
    scalars = (
        float(rng.uniform(50.0, 100.0)),  # now
        float(rng.uniform(1.0, 30.0)),  # grace
        5.0,  # grace_cap
        float(seed % 2),  # adjust
        2,  # min_reporters
        float(rng.uniform(0.0, 20.0)),  # down_out_interval
        0.3,  # laggy_weight
        float(rng.uniform(0.5, 1.0)),  # decay
    )
    return lanes, scalars


@pytest.mark.parametrize("seed", range(6))
def test_heartbeat_step_matches_reference(seed):
    lanes, scalars = _lanes(seed)
    got = rec.heartbeat_step(*(torch.from_numpy(a) for a in lanes), *scalars)
    want = ref_rec.heartbeat_step(*(jnp.asarray(a) for a in lanes), *scalars)
    names = ("last_ack", "laggy", "markdowns", "down", "down_since", "propose_out")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if w.dtype == bool:
            assert g.dtype == bool, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g.dtype == np.float32 == w.dtype, name
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=name)
    assert np.asarray(want[3]).any() and np.asarray(want[5]).any()


def _maps(n_osds=16):
    ref = ref_build_osdmap(n_osds, pg_num=16, size=6, pool_kind="erasure")
    return ref, convert.osdmap_from_reference(ref.encode())


def _detector(port: bool, m, flags):
    R = rec if port else ref_rec
    cfg = Config(env={}) if port else RefConfig(env={})
    cfg.set("osd_heartbeat_grace", 0.5)
    cfg.set("mon_osd_min_down_reporters", 2)
    cfg.set("mon_osd_down_out_interval", 3.0)
    cfg.set("mon_osd_min_in_ratio", 0.8)
    cfg.set("mon_osd_laggy_halflife", 5.0)
    clock = R.VirtualClock()
    kw = {"device": "cpu"} if port else {}
    det = R.LivenessDetector(m.max_osd, clock, config=cfg, flags=flags, osdmap=m, **kw)
    return det, clock


@pytest.mark.parametrize("damped", [True, False], ids=["damped", "flat"])
def test_detector_sequence_matches_reference(damped):
    ref_map, port_map = _maps()
    runs = []
    for port, m in ((False, ref_map), (True, port_map)):
        flags = (rec if port else ref_rec).ClusterFlags()
        det, clock = _detector(port, m, flags)
        det.config.set("mon_osd_adjust_heartbeat_grace", damped)
        R = rec if port else ref_rec
        trace = []
        reporters = np.full(m.max_osd, 3, np.int32)
        reporters[7] = 1  # too few peers to ever be reported
        det.set_reporters(reporters)
        steps = [
            (0.5, [R.parse_spec("netsplit:3"), R.parse_spec("netsplit:7"),
                   R.parse_spec("slow:5")]),
            (0.9, []), (1.2, []), (1.6, [R.parse_spec("netsplit:3:restore")]),
            (2.0, [R.parse_spec("netsplit:3")]), (2.4, []), (3.1, []),
            (3.2, "noout"), (6.0, []), (6.5, "clear"), (7.0, []), (9.8, []),
            (10.0, [R.parse_spec("slow:5:restore"), R.parse_spec("netsplit:3:restore")]),
            (10.5, "up3"), (20.0, []),
        ]
        for t, action in steps:
            clock.advance(t - clock.now())
            if action == "noout":
                flags.set("noout")
            elif action == "clear":
                flags.clear("noout")
            elif action == "up3":
                det.observe_map([3])
            else:
                for spec in action:
                    det.apply(spec)
            specs = [str(s) for s in det.tick()]
            trace.append((specs, det.next_deadline(), det.osds_down, det.osds_laggy,
                          det.laggy_probability(5)))
        runs.append((trace, [(d.osd, d.t_fail, d.t_down) for d in det.detections],
                     det.summary(), [d.latency for d in det.pop_detections()]))
    (ref_trace, ref_dets, ref_sum, ref_pop), (trace, dets, summ, pop) = runs
    for got, want in zip(trace, ref_trace):
        assert got[0] == want[0] and got[2:4] == want[2:4]
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            assert got[1] == pytest.approx(want[1], rel=RTOL)
        assert got[4] == pytest.approx(want[4], rel=RTOL)
    assert dets == ref_dets and summ == ref_sum and pop == ref_pop
    assert summ["downs"] >= 2 and summ["auto_out_events"] >= 1


def test_cluster_flags_match_reference():
    for R in (rec, ref_rec):
        f = R.ClusterFlags("noout", "pause")
        assert f.names() == ("noout", "pause") and "noout" in f and len(f) == 2
        f.clear("pause")
        assert list(f) == ["noout"]
        with pytest.raises(ValueError):
            f.set("nosuchflag")
    assert rec.KNOWN_FLAGS == ref_rec.KNOWN_FLAGS


@pytest.mark.parametrize("spec", ["host:host0_1:down_out", "rack:0:down_out"])
def test_peer_counts_match_reference(spec):
    ref = ref_build_osdmap(64, pg_num=128, size=6, pool_kind="erasure")
    port = convert.osdmap_from_reference(ref.encode())
    ref_prev, port_prev = copy.deepcopy(ref), copy.deepcopy(port)
    ref_rec.inject(ref, spec)
    rec.inject(port, spec)
    want = ref_rec.peer_pool(ref_prev, ref, 1).peer_counts(ref.max_osd)
    got = rec.peer_pool(port_prev, port, 1, device="cpu").peer_counts(port.max_osd)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and got.max() > 0
