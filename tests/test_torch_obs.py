"""The port's observability layer vs the reference package's.

``PGStateClassifier`` (torch ops, SWAR popcount) gives the reference's
histogram and aux counts on seeded random survivor masks, live counts
and flags, including ``n_alive < size``, ``k`` overrides and all seven
states.  Health timelines fed the same peering passes on the same
virtual clock give equal ``series()``, SLO reports, ``status_dict`` and
``render_status``.  The event journal writes, reads back, resumes and
rotates to the same records.  The op tracker's four dumps and an admin
socket's ``perf dump``/``perf schema`` replies (the ``scrub`` and
``recovery`` components) and status trio agree.  All comparisons are
exact; everything runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest

from ceph_tpu.common import admin_socket as ref_asok
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.common.op_tracker import OpTracker as RefOpTracker
from ceph_tpu.obs import (EventJournal as RefJournal, HealthTimeline as RefTimeline,
                          PGStateClassifier as RefClassifier, SLOSpec as RefSLOSpec,
                          evaluate as ref_evaluate, register_admin_hooks as ref_hooks,
                          render_status as ref_render, status_dict as ref_status)
from ceph_tpu.recovery import VirtualClock as RefClock, recovery_counters as ref_recovery_counters
from ceph_tpu.recovery.peering import PeeringResult as RefPeeringResult
from ceph_tpu.recovery.scrub import Scrubber as RefScrubber
from ceph_tpu_torch import obs
from ceph_tpu_torch.common import admin_socket
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.common.op_tracker import OpTracker
from ceph_tpu_torch.obs import pg_states
from ceph_tpu_torch.recovery import VirtualClock, recovery_counters
from ceph_tpu_torch.recovery.peering import (PG_STATE_BACKFILL, PG_STATE_INCONSISTENT,
                                             PG_STATE_REMAPPED, PG_STATE_SCRUBBING,
                                             PeeringResult)
from ceph_tpu_torch.recovery.scrub import Scrubber, apply_bitrot

SIZE = 6
FLAG_BITS = (PG_STATE_BACKFILL, PG_STATE_REMAPPED, PG_STATE_INCONSISTENT, PG_STATE_SCRUBBING)


def _synth(cls, masks, alive, flags, size=SIZE, min_size=4, epoch=2):
    n = len(masks)
    z = np.zeros((n, size), np.int32)
    zp = np.zeros(n, np.int32)
    return cls(pool_id=1, epoch_prev=1, epoch_cur=epoch, size=size, min_size=min_size,
               up=z, up_primary=zp, acting=z, acting_primary=zp, prev_acting=z,
               flags=np.array(flags, np.int32), survivor_mask=np.array(masks, np.uint32),
               n_alive=np.array(alive, np.int32))


def _random_pool(seed, n=300, size=SIZE):
    rng = np.random.default_rng(seed)
    full = (1 << size) - 1
    masks = np.where(rng.random(n) < 0.4, full, rng.integers(0, full + 1, n))
    alive = np.where(rng.random(n) < 0.7, size, rng.integers(0, size + 1, n))
    flags = np.zeros(n, np.int32)
    for bit in FLAG_BITS:
        flags |= np.where(rng.random(n) < 0.15, bit, 0).astype(np.int32)
    return masks.astype(np.uint32), alive.astype(np.int32), flags


def test_popcount32():
    rng = np.random.default_rng(0)
    vals = np.concatenate([[0, 1, 0xFFFFFFFF, 0x80000000, 0x55555555],
                           rng.integers(0, 1 << 32, 1000)]).astype(np.int64)
    import torch

    got = pg_states.popcount32(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, [bin(int(v)).count("1") for v in vals])


@pytest.mark.parametrize("seed,k", [(0, None), (1, None), (2, 3), (3, 5), (4, 1)])
def test_pg_state_classifier_matches_reference(seed, k):
    masks, alive, flags = _random_pool(seed)
    hist, aux = obs.PGStateClassifier(device="cpu")(_synth(PeeringResult, masks, alive, flags), k)
    r_hist, r_aux = RefClassifier()(_synth(RefPeeringResult, masks, alive, flags), k)
    np.testing.assert_array_equal(hist, np.asarray(r_hist))
    np.testing.assert_array_equal(aux, np.asarray(r_aux))
    assert hist.dtype == np.int32 and aux.dtype == np.int32
    assert (hist > 0).all() and hist.sum() == len(masks)  # all seven states
    assert (alive < SIZE).any()


def test_pg_state_classifier_rejects_a_mesh():
    """The mesh seam (once refused) on a world of one: the sharded
    classifier's counts equal the single-device classifier's and the
    reference's on ``make_mesh(1)`` (gloo worlds of 2 and 4:
    tests/test_torch_mesh_paths.py)."""
    from ceph_tpu.parallel.placement import make_mesh as ref_make_mesh
    from ceph_tpu_torch.parallel import make_mesh

    masks, alive, flags = _random_pool(7, n=97)
    mesh = make_mesh(axis="pgs", device="cpu")
    for k in (None, 3):
        hist, aux = obs.PGStateClassifier(mesh)(_synth(PeeringResult, masks, alive, flags), k)
        one = obs.PGStateClassifier(device="cpu")(_synth(PeeringResult, masks, alive, flags), k)
        r_hist, r_aux = RefClassifier(ref_make_mesh(1, axis="pgs"))(
            _synth(RefPeeringResult, masks, alive, flags), k)
        for got in (hist, one[0]):
            np.testing.assert_array_equal(got, np.asarray(r_hist))
        for got in (aux, one[1]):
            np.testing.assert_array_equal(got, np.asarray(r_aux))


def _passes():
    """A seeded sequence of (t, peering arrays, bytes recovered)."""
    out, t, nbytes = [], 0.0, 0
    for i in range(6):
        masks, alive, flags = _random_pool(10 + i, n=64)
        if i == 5:
            masks[:] = (1 << SIZE) - 1
            alive[:] = SIZE
            flags[:] = 0
        t += 0.75 + 0.5 * i
        nbytes += 4096 * i
        out.append((t, masks, alive, flags, nbytes))
    return out


def _timeline(port: bool):
    clock = (VirtualClock if port else RefClock)()
    spec = (obs.SLOSpec if port else RefSLOSpec)(
        max_inactive_seconds=3.0, min_availability_fraction=0.95,
        max_time_to_zero_degraded_s=20.0, min_repair_bandwidth_bps=100.0,
        max_inconsistent_seconds=2.0, max_scrub_age_s=4.0, max_detection_latency_s=1.0)
    kw = {"device": "cpu"} if port else {}
    tl = (obs.HealthTimeline if port else RefTimeline)(
        clock.now, k=4, objects_per_pg=16, sample_status=spec.sample_status, **kw)
    cls = PeeringResult if port else RefPeeringResult
    for i, (t, masks, alive, flags, nbytes) in enumerate(_passes()):
        clock.advance(t - clock.now())
        tl.snapshot(_synth(cls, masks, alive, flags, epoch=2 + i), bytes_recovered=nbytes)
        if i % 2:
            tl.note_scrub()
        if i == 3:
            tl.note_detection(0.75)
    return tl, spec


def test_timeline_status_and_slo_match_reference():
    tl, spec = _timeline(True)
    rtl, rspec = _timeline(False)
    assert tl.series() == rtl.series()
    assert tl.to_dicts() == rtl.to_dicts()
    assert obs.evaluate(tl, spec).to_dict() == ref_evaluate(rtl, rspec).to_dict()
    for f in ("min_availability", "inactive_seconds", "inconsistent_seconds", "max_scrub_age",
              "time_to_zero_degraded", "max_detection_latency"):
        assert getattr(tl, f)() == getattr(rtl, f)(), f
    panels = dict(scrub={"passes": 3, "inconsistencies_found": 2, "verify_retries": 1,
                         "inconsistent_unrecoverable": [5], "time_to_zero_inconsistent_s": 2.5},
                  liveness={"n_osds": 64, "osds_down": 2, "osds_laggy": 1, "flags": ["noout"],
                            "auto_out_events": 1, "flap_damped_events": 0},
                  caches={"schedules": {"hits": 3, "misses": 1, "evictions": 0, "entries": 1}})
    st = obs.status_dict(tl, spec, **panels)
    assert st == ref_status(rtl, rspec, **panels)
    assert obs.render_status(st) == ref_render(st)
    assert obs.status_dict(tl) == ref_status(rtl)
    empty = obs.HealthTimeline(lambda: 0.0, device="cpu")
    assert obs.status_dict(empty) == ref_status(RefTimeline(lambda: 0.0))


def _journal_script(j, clock):
    j.event("chaos.inject", epoch=3, specs=["osd:1"])
    with j.span("recovery.peer", epoch=3):
        clock.advance(0.5)
        j.event("decode.launch", mask=0x3F, n_pgs=4)
        with j.span("scrub.pass", bytes=1024):
            clock.advance(0.25)
    j.event("decode.retry", mask=0x3F, attempt=1)


@pytest.mark.parametrize("max_bytes", [0, 600], ids=["unbounded", "rotating"])
def test_journal_roundtrip_and_resume_match_reference(tmp_path, max_bytes):
    reads = []
    for name, J, C in (("port", obs.EventJournal, VirtualClock), ("ref", RefJournal, RefClock)):
        path = str(tmp_path / f"{name}.jsonl")
        clock = C()
        kw = dict(clock=clock.now, trace_id="t", wall=lambda: 1.0, max_bytes=max_bytes,
                  max_segments=3)
        with J(path, **kw) as j:
            _journal_script(j, clock)
            mem = j.records
        with J(path, **kw) as j:  # resume: the sequence numbers continue
            _journal_script(j, clock)
        reads.append((mem, J.read(path), J.read_rotated(path)))
    (mem, back, rot), (r_mem, r_back, r_rot) = reads
    assert mem == r_mem and back == r_back and rot == r_rot
    seqs = [r["seq"] for r in rot]  # consecutive; rotation drops the oldest
    assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))
    assert (seqs[0] == 0) == (max_bytes == 0) and seqs[-1] == 2 * len(mem) - 1


def _ops(tracker, clock):
    a = tracker.create_op("decode:0x3f")
    clock.advance(0.25)
    a.mark_event("dispatched")
    b = tracker.create_op("decode:0x1f")
    clock.advance(40.0)
    a.mark_event("committed")
    a.finish()
    with tracker.create_op("scrub") as c:
        clock.advance(0.5)
        c.mark_event("read")
    clock.advance(1.0)
    return b


def test_op_tracker_dumps_match_reference():
    dumps = []
    for T, C, cfg in ((OpTracker, VirtualClock, Config), (RefOpTracker, RefClock, RefConfig)):
        clock = C()
        t = T(history_size=2, clock=clock.now, config=cfg(env={}))
        _ops(t, clock)
        dumps.append((t.dump_ops_in_flight(), t.dump_historic_ops(),
                      t.dump_historic_slow_ops(), t.dump_slow_ops_in_flight(), t.num_slow))
    assert dumps[0] == dumps[1]
    assert dumps[0][2]["num_slow_ops_found"] == 1


def _scrub_passes(S, store, kw):
    sc = S(8, 3, **kw)
    read = lambda pg, s: store[pg][s]  # noqa: E731
    sc.build_checksums(read)
    apply_bitrot(store[2][1], 5, 0x11)
    sc.scrub(read)
    sc.scrub(read)


def test_admin_socket_matches_reference(tmp_path):
    recovery_counters(), ref_recovery_counters()  # both components registered
    rng = np.random.default_rng(4)
    base = {pg: rng.integers(0, 256, (3, 32), dtype=np.uint8) for pg in range(8)}
    replies = []
    for name, mod, cfg, S, kw, hooks, tl_of in (
            ("p", admin_socket, Config, Scrubber, {"device": "cpu"}, obs.register_admin_hooks,
             lambda: _timeline(True)),
            ("r", ref_asok, RefConfig, RefScrubber, {}, ref_hooks, lambda: _timeline(False))):
        path = str(tmp_path / f"{name}.asok")
        a = mod.AdminSocket(path, cfg(env={}))
        tl, spec = tl_of()
        hooks(a, tl, spec)
        clock = (VirtualClock if name == "p" else RefClock)()
        tracker = (OpTracker if name == "p" else RefOpTracker)(clock=clock.now, config=cfg(env={}))
        _ops(tracker, clock)
        tracker.register_admin_hooks(a)
        a.start()
        try:
            before = mod.ask(path, "perf dump")["scrub"] if "scrub" in mod.ask(
                path, "perf dump") else None
            _scrub_passes(S, {pg: v.copy() for pg, v in base.items()}, kw)
            after = mod.ask(path, "perf dump")["scrub"]
            delta = {key: (after[key] - (before[key] if before else 0)
                           if not isinstance(after[key], dict)
                           else after[key]["avgcount"] - (before[key]["avgcount"] if before else 0))
                     for key in after}
            schema = mod.ask(path, "perf schema")
            replies.append({
                "scrub_delta": delta,
                "schema": {c: schema[c] for c in ("scrub", "recovery")},
                "status": mod.ask(path, "status"), "health": mod.ask(path, "health"),
                "timeline": mod.ask(path, "timeline"),
                "ops": [mod.ask(path, c) for c in ("dump_ops_in_flight", "dump_historic_ops",
                                                   "dump_historic_slow_ops",
                                                   "dump_slow_ops_in_flight")],
                "config": mod.ask(path, "config show")["osd_heartbeat_grace"],
                "help": mod.ask(path, "help")["commands"],
            })
        finally:
            a.stop()
    port, ref = replies
    assert port["scrub_delta"] == ref["scrub_delta"]
    assert port["scrub_delta"]["scrub_passes"] == 2
    assert port["scrub_delta"]["inconsistencies_found"] == 2
    for key in ("schema", "status", "health", "timeline", "ops", "config"):
        assert port[key] == ref[key], key
    # every hook of the reference's is served, the pipeline's cache dump too
    assert set(port["help"]) == set(ref["help"])
