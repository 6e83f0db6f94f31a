"""The port's online EC write path vs the reference's.

The cases of ``tests/test_writepath.py`` on the port (the map and driver
of the reference's own module, ``build_osdmap(32, pg_num=64, size=6,
erasure)``, flap, 64 ops, ``n_sets=8, ways=2, max_writes=32,
full_permille=250``, 8 epochs in chunks of 4, the port on the CPU),
each held against the reference's run on the same inputs:

- K9's plain versions, ``stripe_absorb_plain`` (the reference's loop
  body, one write at a time) and ``stripe_absorb_by_set_plain`` (the
  kernel's order: sets one by one, ticks from the prefix count), against
  the reference's ``stripe_buffer_step`` on every edge batch of
  ``testing/online_edges.py``: buffers, parity and counter rows exact
  (the step consumes its buffer, so each case steps its own clone of the
  warm one);
- phase 2, one K6 launch over every slot's Δdata stacked along the word
  axis, and over the compact Δdata of the touched slots (expanded back
  by ``expand_ddata``), against the reference's vmapped ``_xla_apply``;
- two superstep runs and a staged one of the same driver alike, its cold
  buffer left byte for byte as it was (the runs clone it);
- the codec gate, footprint caching, scan = staged on both series, the
  epoch lanes unchanged by the write stage, a crash at each phase
  resumed with a warm buffer, the scrub of a wrong delta, the admin
  hook.

Epoch series against the reference's follow the epoch-loop tests:
exact but ``sums`` (``rtol=1e-6``), ``hist`` by value (R10) and the
latency histograms outside R8's band (``test_torch_superstep``'s
``assert_matches_reference``); write-path lanes exact.
"""

import copy
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ceph_tpu.ec import gfw as ref_gfw
from ceph_tpu.ec.online import (
    ParityDeltaEngine as RefEngine,
    empty_stripe_buffer as ref_empty_buffer,
    stripe_buffer_step as ref_stripe_buffer_step,
)
from ceph_tpu.ec.schedule import _xla_apply
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.recovery import EpochDriver as RefEpochDriver, build_scenario as ref_scenario
from ceph_tpu.workload import WritepathDriver as RefWritepathDriver
from ceph_tpu_torch import convert
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.common.admin_socket import AdminSocket, ask
from ceph_tpu_torch.ec import gfw, online
from ceph_tpu_torch.ec.kernels import schedule_apply
from ceph_tpu_torch.recovery.checkpoint import (
    CheckpointStore,
    CrashPoint,
    SimulatedCrash,
    diff_states,
)
from ceph_tpu_torch.recovery.scrub import DecodeVerifier, Scrubber
from ceph_tpu_torch.testing import online_edges
from ceph_tpu_torch.workload import WritepathDriver, checkpointed_writepath
from test_torch_superstep import assert_matches_reference

N_EPOCHS = 8
EVERY = 4
CRASH_EPOCH = 3  # not boundary-aligned: the crash fires at epoch 4's boundary
WP = dict(n_sets=8, ways=2, max_writes=32, full_permille=250)
# the K9 cases: liberation k=4 w=7 (the write path's codec for k=4 m=2)
K, W, WORDS = 4, 7, 2
SETS, WAYS = 4, 2
BUF_FIELDS = ("keys", "data", "parity", "dirty", "lru", "tick", "totals")


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


@pytest.fixture(scope="module")
def story():
    """Both packages' write paths over the reference module's driver, and
    each one's uninterrupted run chunked as the checkpointed runs are."""
    ref_m = ref_build_osdmap(32, pg_num=64, size=6, pool_kind="erasure")
    m = convert.osdmap_from_reference(ref_m.encode())
    rd = RefEpochDriver(ref_m, ref_scenario("flap", ref_m), n_ops=64)
    rw = RefWritepathDriver(rd, **WP)
    ref = rw.run_superstep(N_EPOCHS, snapshot_every=EVERY)
    d = rec.EpochDriver(m, rec.build_scenario("flap", m), n_ops=64, device="cpu")
    w = WritepathDriver(d, **WP)
    port = w.run_superstep(N_EPOCHS, snapshot_every=EVERY)
    return {"ref": (rd, rw, ref), "port": (d, w, port),
            "final": (w.final_state, w.final_buf)}


def _assert_buffer_equal(port, ref):
    ref = jax.device_get(ref)
    for f in BUF_FIELDS:
        want = np.asarray(getattr(ref, f))
        got = getattr(port, f).numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.shape == want.shape and np.array_equal(got, want), f


def _ref_batch(batch):
    return (jnp.asarray(batch["keys"]), jnp.asarray(batch["chunks"]),
            jnp.asarray(batch["fulls"]), jnp.asarray(batch["seeds"].view(np.uint32)),
            jnp.asarray(batch["valid"]))


@pytest.fixture(scope="module")
def codec():
    bm = gfw.liberation_bitmatrix(K, W)
    ref_sched = RefEngine(ref_gfw.liberation_bitmatrix(K, W), w=W).full_encoder().schedule
    enc = online.ParityDeltaEngine(bm, w=W, device="cpu").full_encoder()
    return bm, ref_sched, enc


@pytest.fixture(scope="module")
def warm(codec):
    """A warm buffer in both packages: three random batches absorbed."""
    _bm, ref_sched, enc = codec
    rbuf = ref_empty_buffer(SETS, WAYS, K * W, 2 * W, WORDS)
    pbuf = online.empty_stripe_buffer(SETS, WAYS, K * W, 2 * W, WORDS, device="cpu")
    for i in range(3):
        b = online_edges.random_batch(SETS, WAYS, K, 32, seed=100 + i)
        rbuf, _ = ref_stripe_buffer_step(rbuf, jnp.asarray(ref_sched.steps), ref_sched.n_out,
                                         ref_sched.n_bufs, K, W, *_ref_batch(b))
        pbuf, _ = online.stripe_buffer_step(pbuf, enc.table, enc.schedule.n_out, K, W,
                                            *online_edges.to_device(b, "cpu"))
    _assert_buffer_equal(pbuf, rbuf)
    return rbuf, pbuf


@pytest.mark.parametrize("name", online_edges.EDGES)
def test_stripe_absorb_plain_versions_match_reference_on_edges(codec, warm, name):
    _bm, ref_sched, enc = codec
    rbuf, pbuf = warm
    edges = online_edges.edge_batches(SETS, WAYS, K,
                                      resident=online_edges.resident_key(pbuf.keys))
    batch, cold = next((b, c) for n, b, c in edges if n == name)
    if cold:
        rbuf = ref_empty_buffer(SETS, WAYS, K * W, 2 * W, WORDS)
        pbuf = online.empty_stripe_buffer(SETS, WAYS, K * W, 2 * W, WORDS, device="cpu")
    want, want_row = ref_stripe_buffer_step(rbuf, jnp.asarray(ref_sched.steps),
                                            ref_sched.n_out, ref_sched.n_bufs, K, W,
                                            *_ref_batch(batch))
    lanes = online_edges.to_device(batch, "cpu")
    got, row = online.stripe_buffer_step(pbuf.clone(), enc.table, enc.schedule.n_out, K, W,
                                         *lanes)
    _assert_buffer_equal(got, want)
    assert np.array_equal(row.numpy(), np.asarray(want_row))

    def absorb(fn):
        b = pbuf.clone()
        return fn(b.keys, b.data, b.parity, b.dirty, b.lru, b.tick, *lanes, K, W)

    plain = absorb(online.stripe_absorb_plain)
    by_set = absorb(online.stripe_absorb_by_set_plain)
    assert all(torch.equal(a, b) for a, b in zip(plain, by_set))
    assert torch.equal(plain[-1], row)
    *_buf, ddata, slot_of, _row = plain
    owned = slot_of[slot_of >= 0]
    assert len(set(owned.tolist())) == len(owned)
    assert not ddata.view(K * W, len(slot_of), WORDS)[:, slot_of < 0].any()
    if name == "cold_misses":
        assert int(row[online.WP_LANES.index("hits")]) == 0
    if name == "one_set_chain":
        assert int(row[online.WP_LANES.index("evictions")]) >= 4 * WAYS
    if name == "evict_then_hit":
        hits = int(row[online.WP_LANES.index("hits")])
        assert hits >= 1 and int(row[online.WP_LANES.index("evictions")]) >= 1
    if name == "cancelling_pair":
        touched = online.WP_LANES.index("touched_slots")
        assert int(row[online.WP_LANES.index("hits")]) == 2
        assert int(row[touched]) == 0 and int(np.asarray(want_row)[touched]) == 0
        assert len(owned) == 1 and not ddata.any()


@pytest.mark.parametrize("name", online_edges.EDGES)
def test_bound_replay_matches_reference_lookups_on_edges(codec, warm, name):
    """``chip_smoke.absorb_writes``, the host replay of K9's lookups that
    its bound counts work from, against the reference's step on every
    edge batch: the hits, misses and full writes of its row, and each
    replayed slot's final key and tick in the reference's buffer."""
    import chip_smoke as cs

    _bm, ref_sched, _enc = codec
    rbuf, pbuf = warm
    edges = online_edges.edge_batches(SETS, WAYS, K,
                                      resident=online_edges.resident_key(pbuf.keys))
    batch, cold = next((b, c) for n, b, c in edges if n == name)
    if cold:
        rbuf = ref_empty_buffer(SETS, WAYS, K * W, 2 * W, WORDS)
        pbuf = online.empty_stripe_buffer(SETS, WAYS, K * W, 2 * W, WORDS, device="cpu")
    want, want_row = ref_stripe_buffer_step(rbuf, jnp.asarray(ref_sched.steps),
                                            ref_sched.n_out, ref_sched.n_bufs, K, W,
                                            *_ref_batch(batch))
    writes = cs.absorb_writes(pbuf, batch)
    row = dict(zip(online.WP_LANES, np.asarray(want_row).tolist()))
    assert sum(not install for _, install, _, _ in writes) == row["hits"]
    assert sum(install for _, install, _, _ in writes) == row["misses"]
    assert sum(full for _, _, full, _ in writes) == row["full_writes"]
    keys = np.asarray(want.keys).reshape(-1)
    lru = np.asarray(want.lru).reshape(-1)
    tick0 = int(np.asarray(rbuf.tick))
    last = {slot: (key, tick0 + i) for i, ((slot, _, _, _), key) in enumerate(
        zip(writes, batch["keys"][batch["valid"]].tolist()))}
    for slot, (key, tick) in last.items():
        assert int(keys[slot]) == key and int(lru[slot]) == tick


def test_phase2_batched_k6_matches_reference_vmapped_xla_apply(codec):
    _bm, ref_sched, enc = codec
    rng = np.random.default_rng(3)
    n_slots = SETS * WAYS
    dd = rng.integers(0, 1 << 32, (n_slots, K * W, WORDS), dtype=np.uint64).astype(np.uint32)
    dd[1] = 0  # an untouched slot
    want = jax.vmap(lambda x: _xla_apply(jnp.asarray(ref_sched.steps), x, ref_sched.n_out,
                                         ref_sched.n_bufs))(jnp.asarray(dd))
    stacked = torch.from_numpy(np.ascontiguousarray(dd.transpose(1, 0, 2))
                               .reshape(K * W, n_slots * WORDS).view(np.int32))
    got = schedule_apply(enc.table, stacked, enc.schedule.n_out)
    got = got.view(-1, n_slots, WORDS).permute(1, 0, 2).numpy().view(np.uint32)
    assert np.array_equal(got, np.asarray(want))
    assert not got[1].any()


def test_phase2_compact_k6_matches_reference_vmapped_xla_apply(codec):
    """K6 over the compact operand (entries of touched slots only, one
    unowned entry zero) against the reference's vmapped ``_xla_apply``
    of the same Δdata at full width, slot by slot; then the commit
    XORs each owned entry into its slot's parity."""
    _bm, ref_sched, enc = codec
    rng = np.random.default_rng(4)
    n_slots, n = SETS * WAYS, 5
    slot_of = torch.tensor([6, -1, 0, 3, 5], dtype=torch.int32)
    dd = rng.integers(0, 1 << 32, (K * W, n, WORDS), dtype=np.uint64).astype(np.uint32)
    dd[:, 1] = 0
    dd[:, 3] = 0  # an owned entry whose writes cancelled
    compact = torch.from_numpy(dd.reshape(K * W, n * WORDS).view(np.int32))
    full = online.expand_ddata(compact, slot_of, n_slots, WORDS)
    per_slot = full.numpy().view(np.uint32).reshape(K * W, n_slots, WORDS).transpose(1, 0, 2)
    want = np.asarray(jax.vmap(lambda x: _xla_apply(jnp.asarray(ref_sched.steps), x,
                                                    ref_sched.n_out, ref_sched.n_bufs))(
        jnp.asarray(np.ascontiguousarray(per_slot))))
    mw = enc.schedule.n_out
    got = schedule_apply(enc.table, compact, mw)
    assert tuple(got.shape) == (mw, n * WORDS)
    got = got.view(mw, n, WORDS).permute(1, 0, 2).numpy().view(np.uint32)
    for j, slot in enumerate(slot_of.tolist()):
        assert np.array_equal(got[j], want[slot] if slot >= 0 else np.zeros_like(got[j]))
    untouched = sorted(set(range(n_slots)) - set(slot_of.tolist()))
    assert not want[untouched].any()
    parity = torch.from_numpy(rng.integers(0, 1 << 32, (SETS, WAYS, mw, WORDS),
                                           dtype=np.uint64).astype(np.uint32).view(np.int32))
    before = parity.numpy().view(np.uint32).reshape(n_slots, mw, WORDS).copy()
    row = torch.arange(len(online.WP_LANES), dtype=torch.int64)
    totals = torch.ones(len(online.WP_LANES), dtype=torch.int64)
    tick = torch.tensor(5, dtype=torch.int32)
    online.stripe_commit(parity, schedule_apply(enc.table, compact, mw), slot_of, row, totals,
                         tick, torch.tensor(9, dtype=torch.int32))
    assert torch.equal(totals, row + 1) and int(tick) == 9
    assert np.array_equal(parity.numpy().view(np.uint32).reshape(n_slots, mw, WORDS),
                          before ^ want)


def test_runs_leave_the_cold_buffer_as_it_was(story):
    """The step consumes its buffer; every run clones the driver's cold
    one, so two superstep runs and a staged run see the same start."""
    _d, w, (sup, wsup) = story["port"]
    cold = w._init_buf.clone()
    first = w.run_superstep(N_EPOCHS, snapshot_every=EVERY)
    second = w.run_superstep(N_EPOCHS, snapshot_every=EVERY)
    staged = w.run_staged(N_EPOCHS)
    for s, ws in (first, second, staged):
        assert s.diff(sup) == [] and ws.diff(wsup) == []
        assert np.array_equal(ws.lanes, wsup.lanes)
    for f in BUF_FIELDS:
        assert torch.equal(getattr(w._init_buf, f), getattr(cold, f)), f
    assert int((w._init_buf.keys >= 0).sum()) == 0


def test_delta_matches_dense_every_gate_family():
    verdicts = online_edges.bitequal_gate(n_updates=6, seed=20260806, device="cpu")
    assert verdicts == {n: True for n, _b, _w in online_edges.gate_families()}


def test_footprint_programs_cached_per_footprint():
    rng = np.random.default_rng(7)
    eng = online.ParityDeltaEngine(gfw.liberation_bitmatrix(4, 7), w=7, device="cpu")
    ref = RefEngine(ref_gfw.liberation_bitmatrix(4, 7), w=7)
    size = eng.w * eng.packetsize
    data = rng.integers(0, 256, (eng.k, size), dtype=np.uint8)
    parity = eng.encode(data)
    assert np.array_equal(parity, ref.encode(data))
    n_full = len(eng.cache)

    def upd(fp):
        new = rng.integers(0, 256, (len(fp), size), dtype=np.uint8)
        out = eng.apply_delta(parity, fp, data[list(fp)], new)
        assert np.array_equal(out, ref.apply_delta(parity, fp, data[list(fp)], new))
        data[list(fp)] = new
        return out

    parity = upd((0, 2))
    assert len(eng.cache) == n_full + 1
    parity = upd((0, 2))
    assert len(eng.cache) == n_full + 1
    parity = upd((1,))
    assert len(eng.cache) == n_full + 2
    assert np.array_equal(parity, eng.dense_parity(data))


def test_scan_matches_staged_and_reference_both_series(story):
    rd, rw, (rsup, rwsup) = story["ref"]
    d, w, (sup, wsup) = story["port"]
    staged, wstaged = w.run_staged(N_EPOCHS)
    assert sup.diff(staged) == []
    assert wsup.diff(wstaged) == []
    assert np.array_equal(wsup.lanes, np.asarray(rwsup.lanes))
    assert_matches_reference(sup, rsup, d, N_EPOCHS)
    _assert_buffer_equal(w.final_buf, rw.final_buf)
    totals = wsup.totals()
    assert totals["delta_writes"] > 0 and totals["full_writes"] > 0
    assert totals["hits"] > 0 and totals["misses"] > 0


def test_epoch_lanes_unchanged_by_write_stage(story):
    d, _w, (sup, wsup) = story["port"]
    plain = d.run_superstep(N_EPOCHS, snapshot_every=EVERY)
    assert sup.diff(plain) == []
    processed = wsup.lane("delta_writes") + wsup.lane("full_writes")
    assert (processed <= np.asarray(sup.writes)).all()
    assert processed.sum() > 0


@pytest.mark.parametrize("phase", ("before", "during", "after"))
def test_crash_resume_warm_stripe_buffer_bitequal(tmp_path, story, phase):
    d, w, (sup, wsup) = story["port"]
    _rd, _rw, (rsup, rwsup) = story["ref"]
    fstate, fbuf = story["final"]
    store = CheckpointStore(str(tmp_path), device="cpu")
    with pytest.raises(SimulatedCrash) as ei:
        checkpointed_writepath(w, N_EPOCHS, store=store, snapshot_every=EVERY,
                               crashes=(CrashPoint(CRASH_EPOCH, phase),))
    assert (ei.value.epoch, ei.value.phase) == (CRASH_EPOCH, phase)
    store2 = CheckpointStore(str(tmp_path), device="cpu")
    if phase == "after":  # before and during leave no committed snapshot
        meta, (_state, buf), series = store2.load_latest(
            (d._init_state, w._init_buf), with_series=True)
        assert meta["next_epoch"] == EVERY
        assert int((buf.keys >= 0).sum()) > 0
        assert series["wp_lanes"].shape[0] == EVERY
    sup2, wsup2 = checkpointed_writepath(w, N_EPOCHS, store=store2, snapshot_every=EVERY)
    assert sup.diff(sup2) == [] and wsup.diff(wsup2) == []
    assert np.array_equal(wsup2.lanes, np.asarray(rwsup.lanes))
    assert diff_states((w.final_state, w.final_buf), (fstate, fbuf)) == []


def test_scrub_detects_injected_wrong_delta(story):
    _d, w, _series = story["port"]
    _state, buf, _rows, _wrows = w.run_superstep(N_EPOCHS, pull=False)
    bm = w.engine.bitmatrix
    sc = Scrubber(n_pgs=64, n_shards=6, device="cpu")
    sc.note_stripe_writes(buf)
    res = sc.scrub_stripe_buffer(buf, bm)
    assert res.status == "ok"
    assert res.checked_slots > 0 and res.scrubbed_bytes > 0
    keys = buf.keys.numpy()
    si, wi = [int(v[0]) for v in np.nonzero(keys >= 0)]
    parity = buf.parity.clone()
    parity[si, wi, 0, 0] ^= 1
    bad = replace(buf, parity=parity)
    res2 = sc.scrub_stripe_buffer(bad, bm)
    assert res2.status == "inconsistent"
    slot = (si, wi, int(keys[si, wi]))
    assert slot in res2.crc_bad and slot in res2.reencode_bad
    sc.note_stripe_writes(bad)
    res3 = sc.scrub_stripe_buffer(bad, bm)
    assert res3.crc_bad == [] and res3.reencode_bad == [slot]
    assert res3.status == "inconsistent"
    dv = DecodeVerifier(np.zeros((64, 6), np.uint32), codec=None, device="cpu")
    assert dv.verify_stripe_buffer(buf, bm) == set()
    assert dv.verify_stripe_buffer(bad, bm) == {int(keys[si, wi])}


def test_dump_stripe_cache_admin_hook(tmp_path, story):
    _d, w, _series = story["port"]
    rec_ = online.dump_stripe_cache()
    panel = next(b for b in rec_["buffers"] if b["name"] == w.name)
    assert panel["occupied"] > 0 and panel["hits"] > 0
    assert panel["schedule_cache"]["entries"]
    assert "stripe_hits" in rec_["counters"]["ec_writepath"]
    sock = AdminSocket(str(tmp_path / "wp.asok"))
    sock.start()
    try:
        reply = ask(str(tmp_path / "wp.asok"), "dump_stripe_cache")
    finally:
        sock.stop()
    assert json.dumps(reply)
    assert w.name in [b["name"] for b in reply["buffers"]]


def test_stripe_absorb_checks_its_lanes():
    buf = online.empty_stripe_buffer(SETS, WAYS, K * W, 2 * W, WORDS, device="cpu")
    lanes = list(online_edges.to_device(online_edges.random_batch(SETS, WAYS, K, 8, 1), "cpu"))
    lanes[3] = lanes[3].to(torch.int64)  # seeds must be int32 bits
    with pytest.raises(TypeError, match="bseeds"):
        online.stripe_absorb(buf.keys, buf.data, buf.parity, buf.dirty, buf.lru, buf.tick,
                             *lanes, K, W)
    with pytest.raises(ValueError, match="power of two"):
        online.empty_stripe_buffer(6, 2, 4, 2, 1, device="cpu")


# ---- debug_bucket_checks ----------------------------------------------


def test_writepath_batch_bucket_checked_under_debug_bucket_checks(monkeypatch):
    """``debug_bucket_checks`` makes ``WritepathDriver`` assert its batch
    bucket is a power of two (the reference's seam), and a broken bucket
    helper raises there."""
    from ceph_tpu_torch.analysis.runtime_guard import UnbucketedShapeError
    from ceph_tpu_torch.common.config import global_config
    from ceph_tpu_torch.workload import writepath

    m = convert.osdmap_from_reference(
        ref_build_osdmap(32, pg_num=16, size=6, pool_kind="erasure").encode())
    d = rec.EpochDriver(m, rec.ChaosTimeline(), n_ops=64, device="cpu")
    cfg = global_config()
    prev = cfg.get("debug_bucket_checks")
    cfg.set("debug_bucket_checks", True)
    try:
        for cap in (1, 5, 8, 13):
            assert WritepathDriver(d, n_sets=8, ways=2, max_writes=cap).batch_size in (1, 8, 16)
        monkeypatch.setattr(writepath, "_pow2_bucket", lambda n: n)
        with pytest.raises(UnbucketedShapeError, match="writepath batch bucket"):
            WritepathDriver(d, n_sets=8, ways=2, max_writes=13)
    finally:
        cfg.set("debug_bucket_checks", prev)
    WritepathDriver(d, n_sets=8, ways=2, max_writes=13)  # the knob off: no check
