"""The port's durable checkpoints vs the reference's.

The cases of ``tests/test_checkpoint.py`` on the port (the port on the
CPU), at ``build_osdmap(32, pg_num=16, size=6, erasure)``, 16 epochs,
snapshots every 4, 64 ops:

- the store: round trip, a torn newest snapshot and a payload bit flip
  falling back, the manifest's torn tail, the stale tmp sweep, a template
  mismatch counted as torn, the WAL;
- checkpointed superstep, fleet and divergent runs killed before, during
  and after a snapshot write and restored (and flapping-osd, whose
  detector state the restored host view must carry, killed during one),
  and
  one SIGKILL'd ``_crashbox`` child (``"device": "cpu"``): every resumed
  series equal to the reference's uninterrupted run on the same inputs
  (the epoch-loop tests' rules: exact but ``sums`` at ``rtol=1e-6``,
  ``hist`` by value, R10, and the latency histograms outside R8's band),
  every resumed state's lanes byte-equal to the reference's;
- the cross-package restore: a snapshot the port writes restores in the
  reference's ``CheckpointStore`` and the reference's run from it ends
  where its uninterrupted run ends, and the other way round, on a small
  config-7-shaped state (``build_osdmap(64, pg_num=128, size=6,
  erasure)``, flap): state lanes byte-equal, series lanes by value; the
  reference writes ``series.hist`` as int64 (R10), the port reads it back
  as int32.
"""

import copy
import glob
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import jax

from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.recovery import (
    DivergentDriver as RefDivergentDriver,
    EpochDriver as RefEpochDriver,
    FleetDriver as RefFleetDriver,
    build_scenario as ref_scenario,
)
from ceph_tpu.recovery import checkpoint as ref_ck
from ceph_tpu.recovery._crashbox import _timeline as ref_crashbox_timeline
from ceph_tpu_torch import convert
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.core.cluster_state import ClusterState, apply_incremental
from ceph_tpu_torch.obs.journal import EventJournal
from ceph_tpu_torch.osdmap.map import UP, Incremental
from ceph_tpu_torch.recovery._crashbox import _timeline as crashbox_timeline
from ceph_tpu_torch.recovery.checkpoint import (
    CheckpointError,
    CheckpointStore,
    CrashPoint,
    SimulatedCrash,
    WriteAheadLog,
    _read_jsonl_tolerant,
    checkpointed_fleet,
    checkpointed_superstep,
    crash_points,
    diff_states,
    lane_crcs,
    restore_divergent,
    strip_crash_specs,
)
from ceph_tpu_torch.recovery.chaos import ChaosTimeline
from ceph_tpu_torch.recovery.failure import parse_spec
from ceph_tpu_torch.recovery.scrub import crc32c
from ceph_tpu_torch.recovery.superstep import _SERIES_FIELDS
from test_torch_superstep import EXACT, RTOL, assert_matches_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_EPOCHS = 16
EVERY = 4
CRASH_EPOCH = 6  # not boundary-aligned: fires at epoch 8's boundary
N_OPS = 64
PHASES = ("before", "during", "after")
_DIVERGENT_CFG = {"scenario": "flap", "rank_specs": [[0.5, "rankdelay:1.2500"]]}


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


def _ref_lanes(state) -> list:
    return [np.asarray(a) for a in jax.device_get(jax.tree_util.tree_flatten(state)[0])]


def _assert_lanes_equal(port_state, ref_state):
    got, want = convert.state_lanes(port_state), _ref_lanes(ref_state)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), i


_zoo: dict = {}


def _story(scenario):
    """The port driver and the reference's uninterrupted run (and its
    final state) of one scenario, built once."""
    if scenario not in _zoo:
        ref_m, m = _maps()
        rd = RefEpochDriver(ref_m, ref_scenario(scenario, ref_m), n_ops=N_OPS)
        ref = rd.run_superstep(N_EPOCHS, snapshot_every=EVERY)
        d = rec.EpochDriver(m, rec.build_scenario(scenario, m), n_ops=N_OPS, device="cpu")
        _zoo[scenario] = (d, ref, rd.final_state, rd)
    return _zoo[scenario][:3]


# ---- crash specs ------------------------------------------------------


def test_crash_points_strip_and_validation():
    tl = ChaosTimeline.from_pairs([
        (0.5, parse_spec("osd:3")),
        (1.0, parse_spec("crash:8:during")),
        (2.0, parse_spec("crash:4")),
    ])
    cps = crash_points(tl)
    assert [(c.epoch, c.phase, c.action) for c in cps] == [
        (4, "before", "raise"), (8, "during", "raise")]
    assert all(c.action == "sigkill" for c in crash_points(tl, "sigkill"))
    stripped = strip_crash_specs(tl)
    assert not any(s.is_crash for ev in stripped.events() for s in ev.specs)
    assert len(stripped.events()) == 1
    with pytest.raises(ValueError):
        CrashPoint(3, "nope")
    with pytest.raises(ValueError):
        CrashPoint(3, "before", "explode")
    with pytest.raises(SimulatedCrash) as ei:
        CrashPoint(3, "during").fire()
    assert ei.value.epoch == 3 and ei.value.phase == "during" and "epoch 3" in str(ei.value)


# ---- the store ----------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 10000])
def test_lane_crcs_are_crc32c(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    import torch

    got = lane_crcs([torch.from_numpy(data), torch.from_numpy(data[: n // 2])], "cpu")
    assert got == [ref_ck.crc32c(data), ref_ck.crc32c(data[: n // 2])]
    assert got[0] == crc32c(data)


def test_store_roundtrip_state_and_series(tmp_path):
    d, _ref, _fin = _story("flap")
    j = EventJournal()
    store = CheckpointStore(str(tmp_path), journal=j, device="cpu")
    series = {"now": np.arange(3, dtype=np.float32)}
    store.save(d._init_state, meta={"next_epoch": 3}, series=series)
    assert store.bytes_written > 0 and len(store.entries()) == 1
    assert len(j.by_name("checkpoint.write")) == 1
    meta, state, got = store.load_latest(d._init_state, with_series=True)
    assert meta["next_epoch"] == 3
    assert diff_states(state, d._init_state) == []
    assert np.array_equal(got["now"], series["now"])
    assert len(j.by_name("checkpoint.restore")) == 1
    # the reference's store reads the same file
    rmeta, rstate = ref_ck.CheckpointStore(str(tmp_path)).load_latest(_zoo["flap"][3]._init_state)
    assert rmeta == meta
    _assert_lanes_equal(d._init_state, rstate)


def test_store_torn_newest_and_bitflip_fall_back(tmp_path):
    d, _ref, _fin = _story("flap")
    j = EventJournal()
    store = CheckpointStore(str(tmp_path), journal=j, device="cpu")
    store.save(d._init_state, meta={"n": 1})
    store.save(d._init_state, meta={"n": 2})
    newest = store.entries()[-1]["file"]
    blob = open(tmp_path / newest, "rb").read()
    open(tmp_path / newest, "wb").write(blob[: len(blob) // 2])
    out = store.load_latest(d._init_state)
    assert out is not None and out[0]["n"] == 1
    assert len(store.torn) == 1 and store.torn[0].startswith(newest)
    torn = j.by_name("checkpoint.torn")
    assert len(torn) == 1 and torn[0]["attrs"]["file"] == newest
    # one flipped bit deep in the last lane of the other snapshot
    oldest = tmp_path / store.entries()[0]["file"]
    flipped = bytearray(open(oldest, "rb").read())
    flipped[-10] ^= 0x40
    open(oldest, "wb").write(bytes(flipped))
    store2 = CheckpointStore(str(tmp_path), device="cpu")
    assert store2.load_latest(d._init_state) is None
    assert len(store2.torn) == 2 and "CRC mismatch" in store2.torn[1]


def test_store_manifest_chains_and_tolerates_torn_tail(tmp_path):
    d, _ref, _fin = _story("flap")
    store = CheckpointStore(str(tmp_path), device="cpu")
    store.save(d._init_state, meta={"n": 1})
    store.save(d._init_state, meta={"n": 2})
    ents = store.entries()
    assert [e["seq"] for e in ents] == [0, 1] and ents[1]["prev"] == ents[0]["file"]
    with open(store.manifest_path, "a") as fh:
        fh.write('{"seq": 99, "fi')
    store2 = CheckpointStore(str(tmp_path), device="cpu")
    assert [e["seq"] for e in store2.entries()] == [0, 1]
    store2.save(d._init_state, meta={"n": 3})
    assert [e["seq"] for e in store2.entries()] == [0, 1, 2]
    assert store2.load_latest(d._init_state)[0]["n"] == 3


def test_store_sweeps_stale_tmp_and_counts_template_mismatch_torn(tmp_path):
    d, _ref, _fin = _story("flap")
    stale = tmp_path / ".tmp-ckpt-00000007.bin"
    stale.write_bytes(b"half a snapshot")
    store = CheckpointStore(str(tmp_path), device="cpu")
    store.save(d._init_state)
    assert not stale.exists() and not glob.glob(str(tmp_path / ".tmp-*"))
    assert store.load_latest({"x": np.zeros(3)}) is None
    assert store.torn
    # a state of another geometry is damage too, not an exception
    other = rec.EpochDriver(_maps(32, 32)[1], ChaosTimeline(), n_ops=8, device="cpu")
    assert CheckpointStore(str(tmp_path), device="cpu").load_latest(other._init_state) is None


def test_wal_roundtrip_replay_cursor_reset_and_torn_tail(tmp_path):
    _ref_m, m = _maps()
    state = ClusterState.from_osdmap(m, device="cpu")
    incs = [Incremental(epoch=m.epoch + 1, new_state={3: UP, 7: UP}),
            Incremental(epoch=m.epoch + 2, new_weight={5: 0x8000},
                        new_primary_affinity={2: 0})]
    want = state
    for inc in incs:
        want = apply_incremental(want, inc)
    path = str(tmp_path / "wal.jsonl")
    with WriteAheadLog(path) as wal:
        wal.append_incremental(incs[0], t=0.5)
        wal.append_incremental(incs[1], t=1.0)
        wal.append_cursor(step=8, tape_cursor=2, now=2.0)
        assert len(wal.read(path)) == 3
        got = wal.replay(state)
        assert diff_states(got, want) == []
        assert diff_states(wal.replay(got), want) == []
        assert wal.cursor()["step"] == 8
        wal.reset()
        assert wal.read(path) == [] and wal.cursor() is None
        wal.append_cursor(step=4, tape_cursor=1, now=1.0)
    with open(path, "a") as fh:
        fh.write('{"kind": "curs')
    assert [r["step"] for r in WriteAheadLog.read(path)] == [4]
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as fh:
        fh.write('{"kind": "curs\n{"kind": "cursor", "step": 4}\n')
    with pytest.raises(ValueError, match="bad.jsonl:1"):
        _read_jsonl_tolerant(bad)


# ---- checkpointed runs: kill and restore --------------------------------


def test_checkpointed_superstep_matches_reference_and_resumes_complete(tmp_path):
    d, ref, ref_final = _story("flap")
    store = CheckpointStore(str(tmp_path), device="cpu")
    wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
    series = checkpointed_superstep(d, N_EPOCHS, store=store, snapshot_every=EVERY, wal=wal)
    assert_matches_reference(series, ref, d, N_EPOCHS)
    assert len(store.entries()) == N_EPOCHS // EVERY
    assert wal.cursor()["step"] == N_EPOCHS
    _assert_lanes_equal(d.final_state, ref_final)
    again = checkpointed_superstep(d, N_EPOCHS, store=store, snapshot_every=EVERY)
    assert series.diff(again) == [] and len(store.entries()) == N_EPOCHS // EVERY
    assert len(checkpointed_superstep(d, 0, store=CheckpointStore(
        str(tmp_path / "zero"), device="cpu"), snapshot_every=EVERY)) == 0


@pytest.mark.parametrize("scenario,phase", [("flap", p) for p in PHASES]
                         + [("flapping-osd", "during")])
def test_kill_and_restore_bitequal_to_reference(tmp_path, scenario, phase):
    d, ref, ref_final = _story(scenario)
    store = CheckpointStore(str(tmp_path), device="cpu")
    with pytest.raises(SimulatedCrash) as ei:
        checkpointed_superstep(d, N_EPOCHS, store=store, snapshot_every=EVERY,
                               crashes=(CrashPoint(CRASH_EPOCH, phase),))
    assert (ei.value.epoch, ei.value.phase) == (CRASH_EPOCH, phase)
    assert len(store.entries()) == (2 if phase == "after" else 1)
    if phase == "during":
        assert glob.glob(str(tmp_path / ".tmp-*"))
    resumed = CheckpointStore(str(tmp_path), device="cpu")
    out = checkpointed_superstep(d, N_EPOCHS, store=resumed, snapshot_every=EVERY)
    assert_matches_reference(out, ref, d, N_EPOCHS)
    assert len(resumed.entries()) == N_EPOCHS // EVERY
    assert not glob.glob(str(tmp_path / ".tmp-*"))
    _assert_lanes_equal(d.final_state, ref_final)


def _series_by_rules(port, ref, hist_dtype=np.int32):
    """The epoch-loop rules on one lane's series, histograms exact."""
    for f in EXACT + ("lat_hist", "qd_hist"):
        want = np.asarray(getattr(ref, f))
        assert np.array_equal(getattr(port, f), want), f
    assert port.hist.dtype == hist_dtype
    np.testing.assert_array_equal(port.hist, np.asarray(ref.hist))
    np.testing.assert_allclose(port.sums, np.asarray(ref.sums), rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def fleet_story():
    ref_m, m = _maps()
    rfd = RefFleetDriver(ref_m, seed=0, n_ops=N_OPS)
    ref = rfd.run_fleet(N_EPOCHS, rfd.sample(2, "flap"))
    fd = rec.FleetDriver(m, seed=0, n_ops=N_OPS, device="cpu")
    return ref, rfd.final_state, fd, fd.sample(2, "flap")


def test_fleet_kill_and_restore_bitequal(tmp_path, fleet_story):
    ref, ref_final, fd, tls = fleet_story
    with pytest.raises(SimulatedCrash):
        checkpointed_fleet(fd, N_EPOCHS, tls, store=CheckpointStore(str(tmp_path),
                                                                    device="cpu"),
                           snapshot_every=EVERY, crashes=(CrashPoint(CRASH_EPOCH, "during"),))
    assert glob.glob(str(tmp_path / ".tmp-*"))
    fs = checkpointed_fleet(fd, N_EPOCHS, tls, store=CheckpointStore(str(tmp_path),
                                                                     device="cpu"),
                            snapshot_every=EVERY)
    for i in range(len(tls)):
        _series_by_rules(fs.cluster(i), ref.cluster(i))
    _assert_lanes_equal(fd.final_state, ref_final)


def test_fleet_kill_before_then_after_and_restore_bitequal(tmp_path, fleet_story):
    """One store through two kills: before epoch 8's write (nothing past
    epoch 4 committed), then, resumed, after epoch 12's."""
    ref, ref_final, fd, tls = fleet_story
    for phase, epoch in (("before", CRASH_EPOCH), ("after", 12)):
        with pytest.raises(SimulatedCrash):
            checkpointed_fleet(fd, N_EPOCHS, tls, store=CheckpointStore(str(tmp_path),
                                                                        device="cpu"),
                               snapshot_every=EVERY, crashes=(CrashPoint(epoch, phase),))
        assert not glob.glob(str(tmp_path / ".tmp-*"))
    assert CheckpointStore(str(tmp_path), device="cpu").entries()[-1]["seq"] == 2  # 4, 8, 12
    fs = checkpointed_fleet(fd, N_EPOCHS, tls, store=CheckpointStore(str(tmp_path),
                                                                     device="cpu"),
                            snapshot_every=EVERY)
    for i in range(len(tls)):
        _series_by_rules(fs.cluster(i), ref.cluster(i))
    _assert_lanes_equal(fd.final_state, ref_final)


@pytest.fixture(scope="module")
def divergent_story(tmp_path_factory):
    root = tmp_path_factory.mktemp("divergent")
    ref_m, m = _maps()
    rdd = RefDivergentDriver(ref_m, ref_crashbox_timeline(_DIVERGENT_CFG, ref_m), 2, seed=0,
                             n_ops=N_OPS)
    ref_res = rdd.run(N_EPOCHS)

    def driver(n_ranks=2):
        return rec.DivergentDriver(m, crashbox_timeline(_DIVERGENT_CFG, m), n_ranks, seed=0,
                                   n_ops=N_OPS, device="cpu")

    store = CheckpointStore(str(root / "store"), device="cpu")
    with pytest.raises(SimulatedCrash):
        driver().run(N_EPOCHS, store=store, crashes=(CrashPoint(CRASH_EPOCH, "during"),))
    revived = driver()
    res = revived.run(N_EPOCHS, store=store)
    return driver, rdd, ref_res, revived, res, store


def test_divergent_kill_and_restore_bitequal(divergent_story):
    _driver, rdd, ref_res, revived, res, _store = divergent_story
    assert res.converged == ref_res.converged
    assert len(res.rounds) == len(ref_res.rounds)
    assert [r.steps for r in res.rounds] == [r.steps for r in ref_res.rounds]
    assert revived.cur == rdd.cur
    for r, (a, b) in enumerate(zip(res.states, ref_res.states)):
        _assert_lanes_equal(a, b)


def test_divergent_kill_before_then_after_and_restore_bitequal(tmp_path, divergent_story):
    """One store through two kills at reconciliation boundaries: before
    the first boundary's write (nothing committed), then, revived, after
    the second's."""
    driver, _rdd, ref_res, _revived, _res, _store = divergent_story
    for phase, epoch in (("before", CRASH_EPOCH), ("after", 2 * EVERY + 1)):
        with pytest.raises(SimulatedCrash):
            driver().run(N_EPOCHS, store=CheckpointStore(str(tmp_path), device="cpu"),
                         crashes=(CrashPoint(epoch, phase),))
    assert len(CheckpointStore(str(tmp_path), device="cpu").entries()) >= 1
    res = driver().run(N_EPOCHS, store=CheckpointStore(str(tmp_path), device="cpu"))
    assert [r.steps for r in res.rounds] == [r.steps for r in ref_res.rounds]
    for a, b in zip(res.states, ref_res.states):
        _assert_lanes_equal(a, b)


def test_divergent_guards_refuse_drift_and_rank_count(divergent_story):
    driver, _rdd, _ref_res, _revived, _res, store = divergent_story
    newest = store.entries()[-1]["file"]
    path = os.path.join(store.root, newest)
    blob = open(path, "rb").read()
    header, payload = blob.split(b"\n", 1)
    hdr = json.loads(header)
    hdr["meta"]["fingerprints"][0] ^= 1
    open(path, "wb").write(json.dumps(hdr, sort_keys=True).encode() + b"\n" + payload)
    try:
        with pytest.raises(CheckpointError, match="divergent revival"):
            restore_divergent(store, driver())
    finally:
        open(path, "wb").write(blob)
    assert restore_divergent(store, driver(3)) is None


def test_sigkill_crashbox_child_on_the_cpu_resumes_bitequal(tmp_path):
    _d, ref, _fin = _story("flap")
    n = N_EPOCHS // 2  # the child's run: snapshots every 2, killed mid-write at epoch 4's
    cfg = {"mode": "superstep", "store": str(tmp_path / "store"),
           "out": str(tmp_path / "out.npz"), "device": "cpu", "n_osds": 32, "pg_num": 16,
           "size": 6, "pool_kind": "erasure", "scenario": "flap", "n_epochs": n,
           "snapshot_every": 2, "n_ops": N_OPS, "seed": 0,
           "kill": {"epoch": 3, "phase": "during"}}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    def run():
        (tmp_path / "cfg.json").write_text(json.dumps(cfg))
        return subprocess.run([sys.executable, "-m", "ceph_tpu_torch.recovery._crashbox",
                               str(tmp_path / "cfg.json")], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)

    killed = run()
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    assert glob.glob(os.path.join(cfg["store"], ".tmp-*"))
    cfg["kill"] = None
    resumed = run()
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    out = np.load(cfg["out"])
    _series_by_rules(rec.EpochSeries(**{f: out[f] for f in _SERIES_FIELDS}),
                     rec.EpochSeries(**{f: np.asarray(getattr(ref, f))[:n]
                                        for f in _SERIES_FIELDS}))


# ---- across the packages --------------------------------------------------


@pytest.fixture(scope="module")
def config7_small():
    ref_m, m = _maps(64, 128)
    rd = RefEpochDriver(ref_m, ref_scenario("flap", ref_m), n_ops=256)
    ref = rd.run_superstep(8, snapshot_every=4)
    d = rec.EpochDriver(m, rec.build_scenario("flap", m), n_ops=256, device="cpu")
    port = d.run_superstep(8, snapshot_every=4)
    return rd, ref, rd.final_state, d, port, d.final_state


def test_port_snapshot_restores_in_the_reference(tmp_path, config7_small):
    rd, ref, ref_final, d, _port, _pfin = config7_small
    with pytest.raises(SimulatedCrash):
        checkpointed_superstep(d, 8, store=CheckpointStore(str(tmp_path), device="cpu"),
                               snapshot_every=4, crashes=((4, "after"),))
    rstore = ref_ck.CheckpointStore(str(tmp_path))
    meta, rstate, series = rstore.load_latest(rd._init_state, with_series=True)
    assert meta["next_epoch"] == 4 and series["hist"].dtype == np.int32
    out = ref_ck.checkpointed_superstep(rd, 8, store=rstore, snapshot_every=4)
    # the first half is the port's series, the second the reference's
    _series_by_rules(out, ref, hist_dtype=np.int64)
    got = _ref_lanes(rd.final_state)
    for i, (a, b) in enumerate(zip(got, _ref_lanes(ref_final))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), i


def test_reference_snapshot_restores_in_the_port(tmp_path, config7_small):
    rd, ref, ref_final, d, port, port_final = config7_small
    with pytest.raises(ref_ck.SimulatedCrash):
        ref_ck.checkpointed_superstep(rd, 8, store=ref_ck.CheckpointStore(str(tmp_path)),
                                      snapshot_every=4, crashes=((4, "after"),))
    store = CheckpointStore(str(tmp_path), device="cpu")
    meta, state, series = store.load_latest(d._init_state, with_series=True)
    assert meta["next_epoch"] == 4
    assert series["hist"].dtype == np.int64  # R10: the reference's widened hist
    out = checkpointed_superstep(d, 8, store=store, snapshot_every=4)
    assert out.hist.dtype == np.int32
    # the first half's float32 sums are the reference's (another
    # reduction order); the half the port ran after the restore is its own
    assert out.diff(port) in ([], ["sums"])
    np.testing.assert_allclose(out.sums, port.sums, rtol=RTOL, atol=0)
    assert np.array_equal(out.sums[4:], port.sums[4:])
    assert diff_states(d.final_state, port_final) == []
    _assert_lanes_equal(d.final_state, ref_final)


# ---- debug_fsync_audit -------------------------------------------------


@pytest.fixture
def fsync_audit_on():
    from ceph_tpu_torch.common.config import global_config

    cfg = global_config()
    prev = cfg.get("debug_fsync_audit")
    cfg.set("debug_fsync_audit", True)
    yield
    cfg.set("debug_fsync_audit", prev)


def test_save_under_fsync_audit_audits_and_passes(tmp_path, fsync_audit_on, monkeypatch):
    """``debug_fsync_audit`` runs the save under ``FsyncAudit`` and
    verifies the commit chain (the reference's ``save``), no longer
    raising; the audit saw the data fsync before each rename and the
    directory fsync after it."""
    from ceph_tpu_torch.analysis import runtime_guard

    audits = []
    real = runtime_guard.FsyncAudit

    class Recorded(real):
        def verify(self):
            audits.append([k for k, _ in self.events])
            return super().verify()

    monkeypatch.setattr(runtime_guard, "FsyncAudit", Recorded)
    d, _ref, _fin = _story("flap")
    store = CheckpointStore(str(tmp_path), device="cpu")
    path = store.save(d._init_state, meta={"next_epoch": 1},
                      series={"now": np.arange(2, dtype=np.float32)})
    assert path.endswith(".bin") and len(audits) == 1
    kinds = audits[0]
    assert kinds.index("fsync") < kinds.index("replace") < kinds.index("fsync_dir")
    meta, state = store.load_latest(d._init_state)
    assert meta["next_epoch"] == 1 and diff_states(state, d._init_state) == []


def test_save_without_directory_fsync_fails_the_audit(tmp_path, fsync_audit_on, monkeypatch):
    from ceph_tpu_torch.analysis.runtime_guard import FsyncAuditError
    from ceph_tpu_torch.recovery import checkpoint

    monkeypatch.setattr(checkpoint, "_fsync_dir", lambda path: None)
    d, _ref, _fin = _story("flap")
    with pytest.raises(FsyncAuditError, match="no later directory fsync"):
        CheckpointStore(str(tmp_path), device="cpu").save(d._init_state, meta={})
