"""The port's supervised recovery loop vs the reference package's.

Each named chaos scenario runs twice on the same seeded inputs: through
the reference's ``SupervisedRecovery`` and through the port's on the CPU
(``device="cpu"``: peering, decodes, the scrub's CRCs and the heartbeat
step take their plain versions).  The map is built in the reference
package (``build_osdmap(64, pg_num=64, size=6, erasure)``, 8 hosts a
rack) and carried across as ``encode()`` bytes; the shard store is made
from a seed with numpy and its parity from the reference codec.  Each
run carries an ``EventJournal`` and a ``HealthTimeline`` on the virtual
clock and an ``OpTracker``; the scrub scenarios add a ``Scrubber`` with
``write_shard`` write-back, the liveness scenario a 0.5 s heartbeat
grace.

Equal, exactly: ``summary()`` key for key (it holds no wall-clock
field: ``decode_s`` and ``throttle_wait_s`` are left out of it, and so
out of the comparison), the rebuilt shards byte for byte, the store
after write-back, the journal's records (kind, name, attributes,
virtual times, parent links) in order, ``HealthTimeline.series()``,
``evaluate(...).to_dict()`` and the op tracker's history.
``mid-repair-loss`` also runs under ``recovery_xor_schedule=on`` (an RS
code through the XOR-schedule path, K6's plain version) and ``off`` (a
cauchy_good code through the dense bitmatrix product, K5's), and
``flap`` once more with every group's first launch failing (the retry
path and its seeded backoff jitter).
"""

import copy

import numpy as np
import pytest

from ceph_tpu import recovery as ref_rec
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.common.op_tracker import OpTracker as RefOpTracker
from ceph_tpu.ec import create as ref_create
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.obs import (EventJournal as RefJournal, HealthTimeline as RefTimeline,
                          SLOSpec as RefSLOSpec, evaluate as ref_evaluate)
from ceph_tpu.recovery.planner import _planning_codec as ref_planning_codec
from ceph_tpu.recovery.scrub import Scrubber as RefScrubber
from ceph_tpu_torch import convert
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.common.op_tracker import OpTracker
from ceph_tpu_torch.ec import create
from ceph_tpu_torch.obs import EventJournal, HealthTimeline, SLOSpec, evaluate
from ceph_tpu_torch.workload import TrafficEngine

K, M, CHUNK = 4, 2, 256
N_OSDS, PG_NUM = 64, 64
PROFILES = {
    "rs": {"plugin": "jerasure", "technique": "reed_sol_van", "k": str(K), "m": str(M)},
    "cauchy": {"plugin": "jerasure", "technique": "cauchy_good", "k": str(K), "m": str(M),
               "packetsize": "8"},
}
SLO = dict(max_inactive_seconds=10.0, min_availability_fraction=0.9,
           max_time_to_zero_degraded_s=30.0, min_repair_bandwidth_bps=1.0,
           max_inconsistent_seconds=10.0, max_scrub_age_s=20.0,
           max_detection_latency_s=30.0)
# scenario -> (code, recovery_xor_schedule, scrubber, heartbeat grace,
# first launch of every group fails)
CASES = {
    "flap": ("rs", "auto", False, None, False),
    "flap/retries": ("rs", "auto", False, None, True),
    "rack-cascade": ("rs", "auto", False, None, False),
    "mid-repair-loss": ("rs", "auto", False, None, False),
    "mid-repair-loss/xor-on": ("rs", "on", False, None, False),
    "mid-repair-loss/xor-off": ("cauchy", "off", False, None, False),
    "silent-bitrot": ("rs", "auto", True, None, False),
    "scrub-storm": ("rs", "auto", True, None, False),
    "flapping-osd": ("rs", "auto", False, 0.5, False),
}


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """The reference memoizes its compiled placement and peering programs
    process-wide; put its caches back after this module."""
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


def _store(code: str) -> dict:
    """pg -> [K + M, CHUNK] u8: seeded data, parity by the reference codec."""
    raw, _ = ref_planning_codec(ref_create(PROFILES[code]))
    rng = np.random.default_rng(3)
    out = {}
    for pg in range(PG_NUM):
        data = rng.integers(0, 256, (K, CHUNK), dtype=np.uint8)
        out[pg] = np.vstack([data, np.asarray(raw.encode(data), np.uint8)])
    return out


def _run(port: bool, case: str, cfg_over=None, **sup_kw):
    """One supervised run of ``case`` through either package (config
    overrides in ``cfg_over``, extra ``SupervisedRecovery`` kwargs in
    ``sup_kw``)."""
    code, xor, scrub, grace, faults = CASES[case]
    scenario = case.split("/")[0]
    ref_map = ref_build_osdmap(N_OSDS, pg_num=PG_NUM, size=K + M, pool_kind="erasure")
    m = convert.osdmap_from_reference(ref_map.encode()) if port else ref_map
    m_prev = copy.deepcopy(m)
    R = rec if port else ref_rec
    cfg = Config(env={}) if port else RefConfig(env={})
    cfg.set("recovery_xor_schedule", xor)
    for key, val in (cfg_over or {}).items():
        cfg.set(key, val)
    if grace is not None:
        cfg.set("osd_heartbeat_grace", grace)
        cfg.set("mon_osd_min_down_reporters", 1)
    dev = {"device": "cpu"} if port else {}
    store = _store(code)

    clock = R.VirtualClock()
    journal = (EventJournal if port else RefJournal)(clock=clock.now, trace_id="t",
                                                     wall=lambda: 0.0)
    spec = (SLOSpec if port else RefSLOSpec)(**SLO)
    health = (HealthTimeline if port else RefTimeline)(
        clock.now, k=K, sample_status=spec.sample_status, **dev)
    tracker = (OpTracker if port else RefOpTracker)(clock=clock.now, config=cfg)
    apply_bitrot = R.apply_bitrot
    chaos = R.ChaosEngine(
        m, R.build_scenario(scenario, m, cycles=3), clock=clock, journal=journal,
        corrupt=lambda pg, s, off, mask: apply_bitrot(store[pg][s], off, mask),
        config=cfg, **dev)
    kw = {}
    if faults:
        kw["fault_hook"] = lambda g, attempt: attempt == 0
    if scrub:
        kw["scrubber"] = (rec.Scrubber if port else RefScrubber)(
            PG_NUM, K + M, journal=journal, clock=clock.now, **dev)
        kw["write_shard"] = lambda pg, s, buf: store[pg].__setitem__(s, np.asarray(buf, np.uint8))
    codec = create(PROFILES[code], device="cpu") if port else ref_create(PROFILES[code])
    sup = R.SupervisedRecovery(codec, chaos, config=cfg, seed=7, journal=journal,
                               health=health, op_tracker=tracker, **kw, **sup_kw, **dev)
    res = sup.run(m_prev, 1, lambda pg, s: store[pg][s])
    return {"summary": res.summary(), "res": res, "store": store, "journal": journal.records,
            "series": health.series(), "slo": evaluate(health, spec).to_dict()
            if port else ref_evaluate(health, spec).to_dict(),
            "ops": tracker.dump_historic_ops(), "chaos": chaos}


def _journal_view(records):
    return [(r["kind"], r["name"], r.get("attrs"), r["t"], r.get("t_end"), r["span_id"],
             r["parent_id"]) for r in records]


@pytest.mark.parametrize("case", list(CASES))
def test_supervised_run_matches_reference(case):
    ref, port = _run(False, case), _run(True, case)
    assert port["summary"] == ref["summary"]
    rr, pr = ref["res"], port["res"]
    assert rr.epochs == pr.epochs
    assert sorted(pr.shards) == sorted(rr.shards)
    for pg, shards in rr.shards.items():
        assert sorted(pr.shards[pg]) == sorted(shards)
        for s, chunk in shards.items():
            np.testing.assert_array_equal(pr.shards[pg][s], chunk)
    for pg in range(PG_NUM):
        np.testing.assert_array_equal(port["store"][pg], ref["store"][pg])
    assert pr.final_counts == rr.final_counts
    assert _journal_view(port["journal"]) == _journal_view(ref["journal"])
    assert port["series"] == ref["series"]
    assert port["slo"] == ref["slo"]
    assert port["ops"] == ref["ops"]
    # the scenario really exercised what it names
    s = port["summary"]
    assert s["converged"]
    if case.startswith("mid-repair-loss"):
        assert s["plan_revisions"] >= 1 and s["unrecoverable_pgs"]
    if CASES[case][1] == "on":
        assert s["schedule_launches"] == s["launches"] > 0
    if CASES[case][2]:
        assert s["scrub_passes"] >= 2 and s["inconsistencies_found"] >= 3
    if CASES[case][4]:
        assert s["retries"] == s["launches"] > 0
    if case == "flapping-osd":
        assert port["chaos"].liveness.downs >= 1
        assert port["chaos"].liveness.summary() == ref["chaos"].liveness.summary()


def test_supervised_rejects_multi_device_and_traffic():
    """The multi-device seams (once refused) on a world of one against
    the reference's ``make_mesh(1)``: the supervised loop with a mesh
    (co-scheduling windows, the sharded decode), and with the
    work-stealing dispatcher under a chip fault, report, journal and
    rebuild what the reference does; a chip fault without the
    dispatcher is refused.  Gloo worlds of 2 and 4:
    tests/test_torch_sharded.py, tests/test_torch_dispatch.py."""
    from ceph_tpu.parallel.placement import make_mesh as ref_make_mesh
    from ceph_tpu.recovery.failure import parse_spec as ref_parse_spec
    from ceph_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axis="bytes", device="cpu")
    shard_all = {"recovery_shard_min_bytes": 0}
    runs = [(_run(False, "mid-repair-loss", mesh=ref_make_mesh(1, axis="bytes")),
             _run(True, "mid-repair-loss", mesh=mesh)),
            (_run(False, "flap", shard_all, mesh=ref_make_mesh(1, axis="bytes")),
             _run(True, "flap", shard_all, mesh=mesh))]
    fault = "chipslow:0.4"
    ws = {"recovery_work_stealing": "on", **shard_all}
    ref_ws = _run(False, "flap", ws, mesh=ref_make_mesh(1, axis="bytes"),
                  chip_faults=[ref_parse_spec(fault)])
    port_ws = _run(True, "flap", ws, mesh=mesh, chip_faults=[fault])
    runs.append((ref_ws, port_ws))
    for ref, port in runs:
        assert port["summary"] == ref["summary"]
        assert _journal_view(port["journal"]) == _journal_view(ref["journal"])
        assert port["series"] == ref["series"]
        for pg, shards in ref["res"].shards.items():
            for s_, chunk in shards.items():
                np.testing.assert_array_equal(port["res"].shards[pg][s_], chunk)
    assert runs[0][1]["res"].coscheduled_windows >= 1
    assert runs[1][1]["summary"]["sharded_launches"] > 0
    assert port_ws["summary"]["worksteal_launches"] > 0
    m = convert.osdmap_from_reference(
        ref_build_osdmap(16, pg_num=16, size=K + M, pool_kind="erasure").encode())
    codec = create(PROFILES["rs"], device="cpu")
    chaos = rec.ChaosEngine(m, rec.ChaosTimeline(), device="cpu")
    with pytest.raises(ValueError, match="work-stealing dispatcher"):
        rec.SupervisedRecovery(codec, chaos, device="cpu", chip_faults=["chipstall:0.0"])
    eng = TrafficEngine(chaos.clock.now, 16, 16, K, K + M, K + 1, mesh=mesh, device="cpu")
    assert eng.n_devices == 1 and eng.device == mesh.device
    cfg = Config(env={})
    cfg.set("recovery_work_stealing", "on")
    assert rec.RecoveryExecutor(codec, config=cfg, device="cpu")._dispatcher.n_chips == 1
