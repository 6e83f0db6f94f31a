"""The compiled fleet window (``recovery/fleet.py``, ``FleetProgram``) on
the CPU.

The program's body run eagerly (``run_fleet(path="eager")``: each
decision one host read of its predicate, the graph's body on the card)
must equal the host-decided loop (``FleetDriver._run_host``, the CPU's
``run_fleet``) bit for bit: every lane of every cluster, the final
fleet state and, with the recorder on, the per-lane ring; and the
reference's vmapped ``run_fleet`` on the same seeds under the rules of
``tests/test_torch_fleet.py`` (integer lanes exact, ``sums`` at
``rtol=1e-6``, the latency histograms outside R8's band).  A fleet of 3
runs in a pad of 4.  ``checkpointed_fleet`` through the body (a crash
at a boundary, then the resume) equals the uninterrupted host run.  The
run's tables equal the host plan's, and timelines in the same buckets
take the same buffers.

Sizes are ``tests/test_torch_fleet.py``'s map (32 OSDs, 16 PGs) at 16
ops, on one torch thread; the reference's fleet is compiled once, in a
module-scoped fixture.
"""

import copy

import numpy as np
import pytest
import torch

from ceph_tpu.recovery.fleet import FleetDriver as RefFleetDriver
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.recovery import checkpoint as ck
from ceph_tpu_torch.recovery import fleet as fl

import test_torch_fleet as tf
from test_torch_fleet import _maps

FLEET = 3          # lanes, in a pad of 4
EPOCHS = 16
N_OPS = 16
SEED = 7


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _driver(m, flight: bool = False):
    cfg = Config(env={})
    if flight:
        cfg.set("flight_recorder", "on")
        cfg.set("flight_ring_epochs", 8)
    return fl.FleetDriver(m, seed=SEED, n_ops=N_OPS, config=cfg, device="cpu")


@pytest.fixture(scope="module")
def burst():
    """ssd-burst, 3 lanes x 16 epochs: the host-decided run (series,
    final state) and the reference's run of the same timelines."""
    ref_m, m = _maps()
    fd = _driver(m)
    tls = fd.sample(FLEET, "ssd-burst")
    host = fd.run_fleet(EPOCHS, tls)
    ref_fd = RefFleetDriver(ref_m, seed=SEED, n_ops=N_OPS)
    ref = ref_fd.run_fleet(EPOCHS, ref_fd.sample(FLEET, "ssd-burst"))
    return {"m": m, "tls": tls, "host": host, "state": fd.final_state, "ref": ref,
            "stats": dict(fd.stats)}


def test_fleet_body_equals_host_loop_and_reference(burst, monkeypatch):
    """ssd-burst: the body's lanes and final state equal the host-decided
    run's bit for bit, and each lane the reference's; its memo peers and
    reuses as the host loop's does."""
    fd = _driver(burst["m"])
    prog = fd.compile_fleet()
    assert prog is fd.compile_fleet() and not prog.compiled and not prog.flight
    body = fd.run_fleet(EPOCHS, burst["tls"], path="eager")
    assert fd.stats["path"] == "eager" and burst["stats"]["path"] == "host"
    want = {k: burst["stats"][k] for k in ("dirty_lane_epochs", "peered", "peer_reused")}
    assert prog.peer_counts() == want and want["peer_reused"] > 0
    host = burst["host"]
    assert body.n_clusters == FLEET and len(body) == EPOCHS
    for k in range(FLEET):
        assert body.cluster(k).diff(host.cluster(k)) == [], k
    assert ck.diff_states(fd.final_state, burst["state"]) == []
    assert host.dirty.sum() > 0 and fd.stats["reads"] == 0
    # the pad lane ran too (an empty tape) and is cropped
    assert tuple(fd.final_state.epoch.shape) == (4,)
    monkeypatch.setattr(tf, "N_OPS", N_OPS)
    for k in range(FLEET):
        tf.assert_lane_matches_reference(body.cluster(k), burst["ref"].cluster(k), fd.m,
                                         burst["tls"][k], SEED + k)


def test_fleet_body_flight_ring_equals_host_loop(monkeypatch):
    """flap with the recorder on, 2 lanes: lanes, final state and the
    per-lane ring (the lane ladder's rung and peer-cycle lanes included)
    equal the host-decided run's, with the body's memo cut to one slot
    (each new key takes the slot over, a key seen before it is peered
    again)."""
    monkeypatch.setattr(fl.FleetProgram, "MEMO_PER_LANE", 0)
    monkeypatch.setattr(fl.FleetProgram, "MEMO_MIN", 1)
    _ref_m, m = _maps()
    fd = _driver(m, flight=True)
    tls = fd.sample(2, "flap")
    n = 10
    host = fd.run_fleet(n, tls)
    ring, state, host_stats = fd.flight, fd.final_state, dict(fd.stats)
    prog = fd.compile_fleet()
    assert prog.flight
    body = fd.run_fleet(n, tls, path="eager")
    for k in range(2):
        assert body.cluster(k).diff(host.cluster(k)) == [], k
    assert ck.diff_states(fd.final_state, state) == []
    assert int(fd.flight.head) == int(ring.head) == n
    assert torch.equal(fd.flight.ring, ring.ring) and host.dirty.sum() > 0
    assert fd.flight.ring.shape[:2] == (2, 8)
    counts = prog.peer_counts()
    assert prog._carry.memo_key.shape[0] == 1
    assert counts["dirty_lane_epochs"] == int(host.dirty.sum())
    assert counts["peered"] > host_stats["peered"] == 2


def test_fleet_body_chunks_with_snapshots_resume_bit_equal(burst, tmp_path):
    """``checkpointed_fleet`` through the body over the first 8 epochs: a
    crash during the snapshot at epoch 4, then the resume from the
    store, equals the uninterrupted host-decided run lane for lane."""
    n = 8
    fd = _driver(burst["m"])
    want = fd.run_fleet(n, burst["tls"])
    state = fd.final_state
    store = ck.CheckpointStore(str(tmp_path / "fleet"), device="cpu")
    with pytest.raises(ck.SimulatedCrash):
        ck.checkpointed_fleet(fd, n, burst["tls"], store=store, snapshot_every=4,
                              crashes=((4, "during"),), path="eager")
    got = ck.checkpointed_fleet(fd, n, burst["tls"], store=store, snapshot_every=4,
                                path="eager")
    assert fd.stats["path"] == "eager"
    for k in range(FLEET):
        assert got.cluster(k).diff(want.cluster(k)) == [], k
    assert ck.diff_states(fd.final_state, state) == [] and want.dirty.sum() > 0


def test_fleet_tables_follow_the_host_plan_and_buckets():
    """The run's tables are the host plan's (each group's flat indices
    padded by its first, the apply order kept); timelines in the same
    buckets take the same buffers, a longer run new ones; an empty
    window runs nothing."""
    _ref_m, m = _maps()
    fd = _driver(m)
    prog = fd.compile_fleet()
    tls = fd.sample(FLEET, "flap")
    tapes = [rec.compile_event_tape(tl, m) for tl in tls] + [fl._empty_tape()]
    tab = prog._tables(EPOCHS, tapes)
    nows = np.array([fd.driver._now_of(e) for e in range(EPOCHS)])
    plan = fl._tape_plan(tapes, nows, 32)
    assert tab["pads"][:2] == (4, 16)
    assert np.array_equal(tab["bumps"], plan.bumps) and np.array_equal(tab["tdirty"],
                                                                      plan.tape_dirty)
    assert np.array_equal(tab["cursor"], plan.stops)
    assert np.array_equal(tab["g_hi"] - tab["g_lo"], [len(ep) for ep in plan.edits])
    for g, (kind, a, b) in enumerate(g for ep in plan.edits for g in ep):
        assert tab["g_kind"][g] == kind
        assert np.array_equal(tab["g_idx"][g, :b - a], plan.flat[a:b])
        assert (tab["g_idx"][g, b - a:] == plan.flat[a]).all()
    np.testing.assert_array_equal(tab["decay"][:, :EPOCHS + 1],
                                  fd._decay_table(EPOCHS).numpy()[:EPOCHS, :EPOCHS + 1])
    carry = prog._carry_for(tab["pads"])
    assert prog._carry_for(prog._tables(12, tapes[::-1])["pads"]) is carry
    longer = prog._carry_for(prog._tables(40, tapes)["pads"])
    assert longer is not carry and longer.s_pad == 64 and longer.f_pad == 4
    salts = fd._salts(FLEET, 4, None)
    state, rows = prog.run(EPOCHS, tapes, salts, start=5, stop=5)
    assert len(rows) == 0 and tuple(rows.packed.shape) == (0, 4, carry.width)
    assert state is fd._fleet_state(4)
    # a shorter run in the longer run's buffers: its tables fill their heads
    state, rows = prog.run(EPOCHS, tapes, salts, stop=1, compiled=False)
    assert prog._carry_for((4, 16, 16)) is longer and len(rows) == 1
    assert torch.equal(longer.tab["decay"][:EPOCHS, :EPOCHS + 1],
                       fd._decay_table(EPOCHS)[:EPOCHS, :EPOCHS + 1])
    host_state, host_rows = fd._run_host(EPOCHS, tapes, salts, stop=1)
    assert ck.diff_states(state, host_state) == []
    assert torch.equal(rows.packed, host_rows.packed)
