"""The port's flight recorder and trace export vs the reference's.

The cases of ``tests/test_flight.py`` on the port (on the CPU): the ring
primitive (wrap, un-rotating drain, a pure read, the journal drain), the
knob, the recorder's bit-invisibility for the superstep, the fleet and
the write path (every epoch and write lane equal with it on and off),
the rings themselves equal to the reference's rings on the same runs
(``build_osdmap(32, pg_num=16, size=6, erasure)``, flap and ssd-burst,
a ring of 8 or 16 rows wrapped), the ring resumed bit-equal through a
checkpoint, the dump round trip and tamper checks, the crash guard, the
``status crash`` panel rendered as the reference's CLI renders the same
dump, and the trace export equal to the reference's ``build_trace`` on
the same records and drains.
"""

import copy
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.cli import status as ref_status
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.obs import flight as ref_flight, traceexport as ref_traceexport
from ceph_tpu.recovery import (
    EpochDriver as RefEpochDriver,
    FleetDriver as RefFleetDriver,
    build_scenario as ref_scenario,
)
from ceph_tpu.workload import WritepathDriver as RefWritepathDriver
from ceph_tpu_torch import convert
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.cli import status as status_cli
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.analysis.runtime_guard import RankStalledError
from ceph_tpu_torch.ec.online import WP_LANES
from ceph_tpu_torch.obs import traceexport
from ceph_tpu_torch.obs.flight import (
    FLIGHT_LANES,
    FLIGHT_SCHEMA_VERSION,
    N_FLIGHT_LANES,
    crash_dump_guard,
    drain_flight,
    empty_flight,
    flight_record,
    flight_row,
    journal_drain,
    read_flight_dump,
    resolve_flight_recorder,
    validate_flight_dump,
    write_flight_dump,
)
from ceph_tpu_torch.obs.journal import EventJournal
from ceph_tpu_torch.recovery.checkpoint import (
    CheckpointStore,
    SimulatedCrash,
    checkpointed_superstep,
)
from ceph_tpu_torch.workload import WritepathDriver

N_EPOCHS = 12
RING = 8  # < N_EPOCHS: the wrap path is the common case
WP = dict(n_sets=8, ways=2, max_writes=32, full_permille=250)


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


def _cfg(flight="on", ring=RING, ref=False):
    cfg = (RefConfig if ref else Config)(env={})
    cfg.set("flight_recorder", flight)
    cfg.set("flight_ring_epochs", ring)
    return cfg


def _ring(n=3, ring=4):
    fs = empty_flight(ring, device="cpu")
    for e in range(n):
        fs = flight_record(fs, flight_row(epoch=e, dirty=e % 2, device="cpu"))
    return fs


# ---- the ring primitive ------------------------------------------------


def test_lane_schema_matches_the_reference():
    assert FLIGHT_LANES == ref_flight.FLIGHT_LANES
    assert len(set(FLIGHT_LANES)) == N_FLIGHT_LANES
    assert FLIGHT_SCHEMA_VERSION == ref_flight.FLIGHT_SCHEMA_VERSION
    fs = empty_flight(8, device="cpu")
    assert fs.ring.shape == (8, N_FLIGHT_LANES) and fs.ring.dtype == torch.int64
    assert empty_flight(8, fleet=3, device="cpu").ring.shape == (3, 8, N_FLIGHT_LANES)
    with pytest.raises(ValueError, match="power of two"):
        empty_flight(6, device="cpu")
    row = flight_row(epoch=3, served=7, device="cpu")
    assert row.tolist() == [3 if n == "epoch" else 7 if n == "served" else 0
                            for n in FLIGHT_LANES]
    with pytest.raises(ValueError, match="unknown flight lanes"):
        flight_row(bogus=1, device="cpu")
    block = flight_row(epoch=2, dirty=torch.tensor([1, 0, 1]))
    assert block.shape == (3, N_FLIGHT_LANES)
    assert block[:, FLIGHT_LANES.index("epoch")].tolist() == [2, 2, 2]


def test_record_wraps_and_drain_unrotates_as_the_reference():
    fs = empty_flight(4, device="cpu")
    rfs = ref_flight.empty_flight(4)
    for e in range(6):
        fs = flight_record(fs, flight_row(epoch=e, served=10 * e, device="cpu"))
        rfs = ref_flight.flight_record(rfs, ref_flight.flight_row(epoch=e, served=10 * e))
    d, rd = drain_flight(fs), ref_flight.drain_flight(rfs)
    assert {k: d[k] for k in d if k != "rows"} == {k: rd[k] for k in rd if k != "rows"}
    assert np.array_equal(d["rows"], np.asarray(rd["rows"]))
    assert d["rows"][:, FLIGHT_LANES.index("epoch")].tolist() == [2, 3, 4, 5]
    assert (d["occupancy"], d["drops"]) == (4, 2)
    # a pure read
    again = drain_flight(fs)
    assert int(fs.head) == 6 and np.array_equal(again["rows"], d["rows"])


def test_journal_drain_event_and_empty_ring():
    j = EventJournal()
    assert journal_drain(j, empty_flight(4, device="cpu")) is None
    assert j.by_name("flight.drain") == []
    fs = empty_flight(4, device="cpu")
    for e in range(3):
        fs = flight_record(fs, flight_row(epoch=e, dirty=e % 2, stripe_hits=5, device="cpu"))
    drain = journal_drain(j, fs, source="test")
    assert drain is not None and drain["occupancy"] == 3
    (rec_,) = j.by_name("flight.drain")
    attrs = rec_["attrs"]
    assert (attrs["epoch_first"], attrs["epoch_last"], attrs["occupancy"]) == (0, 2, 3)
    assert attrs["dirty_epochs"] == 1 and attrs["stripe_hits"] == 15
    assert attrs["source"] == "test"


def test_resolve_flight_recorder_modes():
    assert resolve_flight_recorder("on") is True
    assert resolve_flight_recorder("off") is False
    # the port has no bench-decided defaults file: auto is off
    assert resolve_flight_recorder("auto") is False
    with pytest.raises(ValueError, match="on/off/auto"):
        resolve_flight_recorder("maybe")


# ---- the recorder on the epoch loops -----------------------------------


@pytest.fixture(scope="module")
def superstep_pair():
    ref_m, m = _maps()
    rd = RefEpochDriver(ref_m, ref_scenario("flap", ref_m), n_ops=64,
                        config=_cfg(ref=True))
    rd.run_superstep(N_EPOCHS)
    d_off = rec.EpochDriver(m, rec.build_scenario("flap", m), n_ops=64, config=_cfg("off"),
                            device="cpu")
    d_on = rec.EpochDriver(m, rec.build_scenario("flap", m), n_ops=64, config=_cfg("on"),
                           device="cpu")
    j = EventJournal()
    return (rd, d_off, d_on, d_off.run_superstep(N_EPOCHS),
            d_on.run_superstep(N_EPOCHS, snapshot_every=4, journal=j), j)


def test_superstep_flight_is_bit_invisible_and_equals_the_reference_ring(superstep_pair):
    rd, d_off, d_on, s_off, s_on, j = superstep_pair
    assert s_off.diff(s_on) == []
    d, want = d_on.drain_flight(), rd.drain_flight()
    assert d["head"] == want["head"] == N_EPOCHS
    assert np.array_equal(d["rows"], np.asarray(want["rows"]))
    assert d["rows"][:, FLIGHT_LANES.index("epoch")].tolist() == list(range(4, N_EPOCHS))
    dirty = d["rows"][:, FLIGHT_LANES.index("dirty")]
    rung = d["rows"][:, FLIGHT_LANES.index("rung")]
    assert set(dirty.tolist()) == {0, 1} and np.all((rung == -1) == (dirty == 0))
    assert len(j.by_name("flight.drain")) == 3
    assert d_off.flight is None
    with pytest.raises(RuntimeError, match="flight recorder is off"):
        d_off.drain_flight()


def test_fleet_flight_per_lane_rings_bitequal_and_equal_the_reference():
    ref_m, m = _maps()
    rfd = RefFleetDriver(ref_m, seed=0, n_ops=32, config=_cfg(ring=16, ref=True))
    rfd.run_fleet(24, rfd.sample(4, "ssd-burst"))
    fd_off = rec.FleetDriver(m, seed=0, n_ops=32, config=_cfg("off"), device="cpu")
    fd_on = rec.FleetDriver(m, seed=0, n_ops=32, config=_cfg(ring=16), device="cpu")
    tls = fd_off.sample(4, "ssd-burst")
    s_off = fd_off.run_fleet(24, tls)
    j = EventJournal()
    s_on = fd_on.run_fleet(24, tls, journal=j)
    for i in range(len(tls)):
        assert s_off.cluster(i).diff(s_on.cluster(i)) == [], i
    d, want = drain_flight(fd_on.flight), ref_flight.drain_flight(rfd.flight)
    assert d["rows"].shape == (4, 16, N_FLIGHT_LANES) and d["drops"] == 24 - 16
    assert np.array_equal(d["rows"], np.asarray(want["rows"]))
    dirty = d["rows"][:, :, FLIGHT_LANES.index("dirty")]
    assert len({tuple(r) for r in dirty.tolist()}) > 1
    (rec_,) = j.by_name("flight.drain")
    assert rec_["attrs"]["fleet"] == len(tls)


def test_writepath_flight_bitequal_stripe_lanes_and_the_reference_ring():
    ref_m, m = _maps()
    rd = RefEpochDriver(ref_m, ref_scenario("flap", ref_m), n_ops=64,
                        config=_cfg(ring=16, ref=True))
    rw = RefWritepathDriver(rd, **WP)
    rw.run_superstep(N_EPOCHS)
    w_off = WritepathDriver(rec.EpochDriver(m, rec.build_scenario("flap", m), n_ops=64,
                                            config=_cfg("off"), device="cpu"), **WP)
    w_on = WritepathDriver(rec.EpochDriver(m, rec.build_scenario("flap", m), n_ops=64,
                                           config=_cfg(ring=16), device="cpu"), **WP)
    sup_off, wp_off = w_off.run_superstep(N_EPOCHS)
    j = EventJournal()
    sup_on, wp_on = w_on.run_superstep(N_EPOCHS, journal=j)
    assert sup_off.diff(sup_on) == [] and wp_off.diff(wp_on) == []
    d = drain_flight(w_on.flight)
    for lane in ("hits", "misses", "evictions", "delta_words"):
        assert np.array_equal(d["rows"][:, FLIGHT_LANES.index(f"stripe_{lane}")],
                              wp_on.lanes[:, WP_LANES.index(lane)]), lane
    assert int(d["rows"][:, FLIGHT_LANES.index("stripe_hits")].sum()) > 0
    assert np.array_equal(d["rows"], np.asarray(ref_flight.drain_flight(rw.flight)["rows"]))
    assert j.by_name("flight.drain")


def test_checkpoint_kill_restore_flight_ring_bitequal(tmp_path, superstep_pair):
    _rd, _d_off, d, _s_off, ref, _j = superstep_pair
    ref_drain = d.drain_flight()  # the uninterrupted run's ring
    with pytest.raises(SimulatedCrash):
        checkpointed_superstep(d, N_EPOCHS, store=CheckpointStore(
            str(tmp_path / "kill"), device="cpu"), snapshot_every=4, crashes=((8, "after"),))
    out = checkpointed_superstep(d, N_EPOCHS, store=CheckpointStore(
        str(tmp_path / "kill"), device="cpu"), snapshot_every=4)
    assert ref.diff(out) == []
    resumed = d.drain_flight()
    assert resumed["head"] == ref_drain["head"] == N_EPOCHS
    assert np.array_equal(resumed["rows"], ref_drain["rows"])
    # the ring rode the snapshot: the restored one is the epoch-8 ring
    meta, (_state, fs) = CheckpointStore(str(tmp_path / "kill"), device="cpu").load_latest(
        (d._init_state, d._init_flight))
    assert meta["next_epoch"] == N_EPOCHS and int(fs.head) == N_EPOCHS


# ---- crash-dump forensics ----------------------------------------------


def test_write_read_validate_dump_roundtrip(tmp_path):
    fs = _ring()
    path = write_flight_dump(str(tmp_path), fs, reason="RankStalledError",
                             error="rank 1 stalled", state={"chunk": 2})
    assert os.path.basename(path) == "flightdump-RankStalledError-0000.json"
    doc = read_flight_dump(path)
    assert validate_flight_dump(doc) == [] and ref_flight.validate_flight_dump(doc) == []
    assert ref_flight.read_flight_dump(path) == doc
    assert doc["reason"] == "RankStalledError" and doc["state"] == {"chunk": 2}
    assert doc["flight"]["lanes"] == list(FLIGHT_LANES) and len(doc["flight"]["rows"]) == 3
    assert write_flight_dump(str(tmp_path), fs, reason="RankStalledError").endswith(
        "-0001.json")
    assert not glob.glob(str(tmp_path / "*.tmp"))


def test_read_flight_dump_rejects_tampered(tmp_path):
    path = write_flight_dump(str(tmp_path), _ring(), reason="x")
    doc = json.load(open(path))
    doc["kind"] = "not.a.dump"
    open(path, "w").write(json.dumps(doc))
    with pytest.raises(ValueError, match="invalid flight dump"):
        read_flight_dump(path)
    doc["kind"] = "flight.dump"
    doc["flight"]["lanes"] = ["wrong"]
    assert any("lanes" in p for p in validate_flight_dump(doc))
    assert validate_flight_dump(doc) == ref_flight.validate_flight_dump(doc)


def test_crash_dump_guard_typed_failures_only(tmp_path):
    j = EventJournal()
    fs = _ring()
    with pytest.raises(RankStalledError):
        with crash_dump_guard(str(tmp_path), flight=lambda: fs, journal=j,
                              state={"where": "test"}) as g:
            raise RankStalledError("rank 1 stalled")
    assert g.dump_path and os.path.exists(g.dump_path)
    (rec_,) = j.by_name("flight.dump")
    assert rec_["attrs"]["path"] == g.dump_path
    assert rec_["attrs"]["reason"] == "RankStalledError"
    assert read_flight_dump(g.dump_path)["state"] == {"where": "test"}
    before = sorted(os.listdir(tmp_path))
    with pytest.raises(ValueError):
        with crash_dump_guard(str(tmp_path), flight=fs) as g2:
            raise ValueError("not a typed failure")
    assert g2.dump_path is None and sorted(os.listdir(tmp_path)) == before


def test_status_crash_panel_matches_the_reference_cli(tmp_path, capsys):
    jpath = str(tmp_path / "journal.jsonl")
    j = EventJournal(path=jpath)
    fs = _ring(6, ring=4)
    journal_drain(j, fs)
    with pytest.raises(RankStalledError):
        with crash_dump_guard(str(tmp_path), flight=fs, journal=j):
            raise RankStalledError("rank 0")
    j.close()
    found = status_cli.find_crash_dump(journal_path=jpath)
    assert found and found == status_cli.find_crash_dump(root=str(tmp_path))
    assert found == ref_status.find_crash_dump(journal_path=jpath)
    for argv in (["crash", "--dump", found], ["--crash", "--journal-path", jpath],
                 ["crash", "--dump-dir", str(tmp_path), "--json"]):
        assert status_cli.main(argv) == 0
        got = capsys.readouterr().out
        assert ref_status.main(argv) == 0
        assert got == capsys.readouterr().out, argv
    assert "RankStalledError" in got
    doc = read_flight_dump(found)
    (drain_rec,) = j.by_name("flight.drain")
    assert doc["flight"]["rows"][-1][FLIGHT_LANES.index("epoch")] == \
        drain_rec["attrs"]["epoch_last"]
    assert status_cli.main(["crash", "--dump-dir", str(tmp_path / "empty")]) == 1
    assert "no flight dump" in capsys.readouterr().err


# ---- trace export --------------------------------------------------------


def test_trace_export_matches_the_reference(tmp_path, superstep_pair):
    rd, _d_off, d_on, _s_off, _s_on, _j = superstep_pair
    records = [
        {"kind": "span", "name": "epoch.chunk", "t": 0.0, "t_end": 5.0,
         "attrs": {"chunk": 0}},
        {"kind": "event", "name": "flight.drain", "t": 5.0, "attrs": {"occupancy": 5}},
        {"kind": "span", "name": "recovery.group", "t": 1.0, "t_end": 1.5,
         "attrs": {"rank": 1}},
    ]
    drain = d_on.drain_flight()
    out = str(tmp_path / "trace.json")
    doc = traceexport.export_trace(out, records, drain, dt=0.25)
    assert doc == ref_traceexport.build_trace(records, rd.drain_flight(), dt=0.25)
    assert traceexport.validate_trace(doc) == []
    assert traceexport.validate_trace(json.load(open(out))) == []
    flight = [e for e in doc["traceEvents"] if e.get("cat") == "flight"]
    assert len(flight) == RING * len(traceexport._STAGE_LANES)
    assert {e["tid"] for e in flight} == {"peer", "traffic", "scrub"}


def test_trace_export_fleet_ring_one_process_per_lane():
    fs = empty_flight(4, fleet=3, device="cpu")
    rfs = ref_flight.empty_flight(4, fleet=3)
    for e in range(2):
        fs = flight_record(fs, flight_row(epoch=e, dirty=torch.tensor([1, 0, 1])))
        rfs = ref_flight.flight_record(rfs, ref_flight.flight_row(
            epoch=e, dirty=jnp.asarray([1, 0, 1], jnp.int32)))
    doc = traceexport.build_trace((), drain_flight(fs))
    assert doc == ref_traceexport.build_trace((), ref_flight.drain_flight(rfs))
    assert traceexport.validate_trace(doc) == []
    pids = {e["pid"] for e in doc["traceEvents"] if e.get("cat") == "flight"}
    assert pids == {"flight/lane0", "flight/lane1", "flight/lane2"}


def test_trace_selftest_cli(tmp_path, capsys):
    out = str(tmp_path / "trace.json")
    assert traceexport.main(["--selftest", "--out", out]) == 0
    assert json.loads(capsys.readouterr().out.strip())["selftest"] == "ok"
    assert traceexport.main(["--validate", out]) == 0
