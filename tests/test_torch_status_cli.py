"""The port's status CLI (``python -m ceph_tpu_torch.cli.status``) vs the
reference package's.

Demo mode: the same arguments (the reference tests' 64-OSD, 32-PG seeded
flap demo, and again with ``--traffic --ops-per-step 2048``) through
both CLIs, the port's with ``--device cpu``.  ``status`` text, ``health
--json``, ``timeline --json`` and ``journal --json`` must be equal,
except: the ``caches`` panel (both packages' cache counters are
process-wide; its keys are held to the reference's), each traffic
sample's ``ops_per_sec_wall`` (a wall-clock rate) and the journal's wall
times, left out; each traffic sample's ``mean_ms`` within ``rtol=1e-6``
(a float32 sum reduced in another order).  Socket mode: both CLIs against
a daemon of their own package serving equal timelines.  Bench-record
panels: ``fleet`` and ``ranks`` over the same JSON-line files (records of
the fleet and divergent schemas, each with its optional parts present
and absent, among other lines) render equal text and ``--json`` in both
CLIs, and both exit 1 when no record is found; so do ``checkpoint`` and
``writepath`` over records of the schemas ``chip_smoke.py`` prints, and
``writepath --socket`` renders a live ``dump_stripe_cache`` as the
reference's CLI renders the same reply.  With nothing to render, the
commands that once waited for their items exit 1 and say what to pass.
"""

import copy
import json

import numpy as np
import pytest

from ceph_tpu.cli import status as ref_cli
from ceph_tpu.common import admin_socket as ref_asok
from ceph_tpu.obs import EventJournal as RefJournal
from ceph_tpu_torch.cli import status as cli
from ceph_tpu_torch.common import admin_socket
from ceph_tpu_torch.obs import EventJournal

DEMO = ["--num-osd", "64", "--pg-num", "32", "--seed", "1"]
VARIANTS = {"plain": [], "traffic": ["--traffic", "--ops-per-step", "2048"]}
RTOL = 1e-6


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


def _both(capsys, argv):
    """(reference stdout, port stdout) of one command line."""
    assert ref_cli.main(argv) == 0
    ref = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    return ref, capsys.readouterr().out


def _without_caches(text: str) -> list[str]:
    lines = text.splitlines()
    return lines[:lines.index("  caches:")] if "  caches:" in lines else lines


def assert_series_equal(port: list, ref: list) -> None:
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        p, r = dict(p), dict(r)
        pt, rt = p.pop("traffic", None), r.pop("traffic", None)
        assert p == r
        assert (pt is None) == (rt is None)
        if pt is not None:
            pt, rt = dict(pt), dict(rt)
            for d in (pt, rt):
                d.pop("ops_per_sec_wall")
            assert pt.pop("mean_ms") == pytest.approx(rt.pop("mean_ms"), rel=RTOL)
            assert pt == rt


def _journal_view(records):
    return [{k: v for k, v in r.items() if k not in ("wall", "wall_end")} for r in records]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_status_text_matches_reference(capsys, variant):
    ref, port = _both(capsys, ["status"] + DEMO + VARIANTS[variant])
    assert _without_caches(port) == _without_caches(ref)
    assert "cluster:" in port and "health:" in port and "pgs: 32" in port
    assert "SLO_INACTIVE" in port
    assert port.splitlines()[-1].strip().startswith("schedule:")
    if variant == "traffic":
        assert "io:" in port and "client:" in port and "outcomes:" in port


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_health_json_matches_reference(capsys, variant):
    ref, port = _both(capsys, ["health", "--json"] + DEMO + VARIANTS[variant])
    health = json.loads(port)
    assert health == json.loads(ref)
    assert set(health["checks"]) >= {"SLO_INACTIVE", "SLO_AVAILABILITY", "SLO_RECOVERY_TIME"}
    if variant == "traffic":
        assert {"SLO_P99_LATENCY", "SLO_SLOW_OPS"} <= set(health["checks"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_timeline_json_matches_reference(capsys, variant):
    ref, port = _both(capsys, ["timeline", "--json"] + DEMO + VARIANTS[variant])
    series = json.loads(port)["series"]
    assert_series_equal(series, json.loads(ref)["series"])
    assert len(series) >= 3
    assert {"t", "epoch", "health", "pgs", "availability"} <= set(series[0])
    health_seq = [s["health"] for s in series]
    assert variant == "traffic" or (health_seq[0] == health_seq[-1] == "HEALTH_OK"
                                    and "HEALTH_WARN" in health_seq)
    assert all(s.get("traffic") for s in series) == (variant == "traffic")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_journal_json_matches_reference(tmp_path, capsys, variant):
    paths = [str(tmp_path / f"{n}.jsonl") for n in ("ref", "port")]
    assert ref_cli.main(["journal", "--json", "--journal-path", paths[0]]
                        + DEMO + VARIANTS[variant]) == 0
    ref = json.loads(capsys.readouterr().out)["records"]
    assert cli.main(["journal", "--json", "--journal-path", paths[1], "--device", "cpu"]
                    + DEMO + VARIANTS[variant]) == 0
    port = json.loads(capsys.readouterr().out)["records"]
    assert _journal_view(port) == _journal_view(ref)
    names = {r["name"] for r in port}
    assert {"chaos.inject", "decode.launch", "recovery.revise"} <= names
    assert ("traffic.step" in names) == (variant == "traffic")
    # the on-disk journal matches what the command printed
    assert EventJournal.read(paths[1]) == port
    assert RefJournal.read(paths[0]) == ref


def test_timeline_text_and_determinism(capsys):
    argv = ["timeline", "--device", "cpu"] + DEMO + VARIANTS["traffic"]
    assert cli.main(argv) == 0
    first = capsys.readouterr().out
    assert " p99=" in first and "blocked=" in first
    assert cli.main(argv) == 0
    assert capsys.readouterr().out == first
    assert ref_cli.main(argv[:1] + argv[3:]) == 0
    assert capsys.readouterr().out == first


def test_caches_panel_is_the_schedule_cache(capsys):
    """The panel is the reference's: the pipeline cache and the schedule
    cache, each with the reference's counters."""
    assert ref_cli.main(["caches", "--json"] + DEMO) == 0
    ref = json.loads(capsys.readouterr().out)
    assert cli.main(["caches", "--json", "--device", "cpu"] + DEMO) == 0
    reply = json.loads(capsys.readouterr().out)
    assert set(reply) == set(ref) == {"pipeline", "schedule"}
    for name in reply:
        assert set(reply[name]) == set(ref[name]), name
        assert all(isinstance(v, int) and v >= 0 for v in reply[name].values())
    assert set(reply["pipeline"]) == {"entries", "hits", "misses", "evictions"}
    assert cli.main(["caches", "--device", "cpu"] + DEMO) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("pipeline: ") and "entries" in out[0]
    assert out[1].startswith("schedule: ") and "evictions" in out[1]


# the ids the cases had beside fleet (argv0) and ranks (argv1), which
# now render their panels
@pytest.mark.parametrize("argv,item", [
    pytest.param(argv, item, id=f"argv{i}-{item}") for i, (argv, item) in enumerate([
        (["checkpoint"], "item 2d"),
        (["writepath"], "item 3"), (["crash"], "item 3"), (["--crash"], "item 3"),
        (["writepath", "--socket", "/nonexistent.asok"], "item 3"),
    ], start=2)
])
def test_waiting_commands_exit_nonzero_and_name_their_item(tmp_path, capsys, monkeypatch,
                                                           argv, item):
    """The commands once waiting for their items render now; with no
    record, dump or daemon to render they exit 1 and say what to pass,
    as the reference's CLI does."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(argv + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "not ported yet" not in err
    assert ("cannot reach" if "--socket" in argv else "no ") in err


def _daemon_timeline(port: bool):
    """A small timeline with traffic samples, built in either package."""
    from ceph_tpu import obs as ref_obs, recovery as ref_rec, workload as ref_wl
    from ceph_tpu.recovery.peering import PeeringResult as RefPeeringResult
    from ceph_tpu_torch import obs, recovery as rec, workload as wl
    from ceph_tpu_torch.recovery.peering import PeeringResult

    O, R, W = (obs, rec, wl) if port else (ref_obs, ref_rec, ref_wl)
    dev = {"device": "cpu"} if port else {}
    clock = R.VirtualClock()
    spec = O.SLOSpec(max_inactive_seconds=3.0, max_p99_latency_ms=2.0)
    tl = O.HealthTimeline(clock.now, k=4, sample_status=spec.sample_status, **dev)
    eng = W.TrafficEngine(clock.now, 8, 32, 4, 6, 5, ops_per_step=1024,
                          osd_capacity_ops_per_s=2e3, seed=3, **dev)
    z = np.zeros((32, 6), np.int32)
    zp = np.arange(32, dtype=np.int32) % 8
    for i, masks in enumerate(([0b111111] * 32, [0b011111, 0b000111] * 16, [0b111111] * 32)):
        peering = (PeeringResult if port else RefPeeringResult)(
            pool_id=1, epoch_prev=1, epoch_cur=2 + i, size=6, min_size=5, up=z,
            up_primary=zp, acting=z, acting_primary=zp, prev_acting=z,
            flags=np.zeros(32, np.int32), survivor_mask=np.array(masks, np.uint32),
            n_alive=np.full(32, 6 - (i == 1), np.int32))
        tl.snapshot(peering, bytes_recovered=4096 * i, traffic=eng.observe(peering))
        clock.advance(1.0)
    return tl, spec


def test_socket_mode_matches_reference(tmp_path, capsys):
    from ceph_tpu.obs import register_admin_hooks as ref_hooks
    from ceph_tpu_torch.obs import register_admin_hooks

    outs = []
    for name, mod, hooks, main in (("p", admin_socket, register_admin_hooks, cli.main),
                                   ("r", ref_asok, ref_hooks, ref_cli.main)):
        path = str(tmp_path / f"{name}.asok")
        daemon = mod.AdminSocket(path)
        tl, spec = _daemon_timeline(name == "p")
        hooks(daemon, tl, spec)
        daemon.start()
        try:
            got = {}
            for cmd in (["status"], ["health", "--json"], ["timeline", "--json"]):
                assert main(cmd + ["--socket", path]) == 0
                got[cmd[0]] = capsys.readouterr().out
            if name == "p":
                assert main(["caches", "--json", "--socket", path]) == 0
                got["caches"] = json.loads(capsys.readouterr().out)
            # the journal hook is registered only with a journal
            assert main(["journal", "--socket", path]) == 1
            assert "unknown command" in capsys.readouterr().err
        finally:
            daemon.stop()
        outs.append(got)
    port, ref = outs
    assert port["status"] == ref["status"] and "io:" in port["status"]
    assert json.loads(port["health"]) == json.loads(ref["health"])
    assert_series_equal(json.loads(port["timeline"])["series"],
                        json.loads(ref["timeline"])["series"])
    assert set(port["caches"]) == {"pipeline", "schedule"}
    assert cli.main(["status", "--socket", str(tmp_path / "none.asok")]) == 1
    assert "cannot reach" in capsys.readouterr().err


FLEET_RECORD = {
    "metric": "fleet_epoch_rate_per_sec", "status": "ok", "value": 41234,
    "unit": "cluster-epochs/s", "vs_baseline": 12.5, "platform": "gpu",
    "fleet_scenario": "ssd-burst", "fleet_n_clusters": 256, "fleet_n_epochs": 256,
    "fleet_bitequal": True,
    "fleet_scenario_panel": [
        {"scenario": "ssd-steady", "n_clusters": 256, "survival_fraction": 1.0, "n_lost": 0,
         "mttdl_s": 5461.333, "mttdl_ci_lo_s": 5461.333, "mttdl_ci_hi_s": 5461.333,
         "mttdl_censored": True, "availability_mean": 0.999871, "ttzd_mean_s": 3.25,
         "worst_cluster": 17, "worst_availability": 0.99609375},
        {"scenario": "ssd-burst", "n_clusters": 256, "survival_fraction": 0.98828125,
         "n_lost": 3, "mttdl_s": 5461.333, "mttdl_ci_lo_s": 2730.667, "mttdl_ci_hi_s": 32768.0,
         "mttdl_censored": False, "availability_mean": 0.99, "ttzd_mean_s": 60.5,
         "worst_cluster": 200, "worst_availability": 0.875},
    ],
}
FLEET_SWEEP = {"fleet_best_down_out_interval_s": 120.0, "fleet_best_recovery_share": 0.4}
RANKS_RECORD = {
    "metric": "divergent_detect_to_converge_rounds", "value": 2, "unit": "rounds",
    "platform": "gpu", "divergent_scenario": "flap", "divergent_n_ranks": 2,
    "divergent_n_epochs": 48, "divergent_rounds": 7, "divergent_converged": True,
    "divergent_laggy_ranks": [], "divergent_stalled": False,
    "divergent_rank_panel": [{"rank": 0, "step": 48, "epoch": 9, "fingerprint": 123456},
                             {"rank": 1, "step": 48, "epoch": 9, "fingerprint": 123456}],
}
CHECKPOINT_RECORD = {
    "metric": "checkpoint_write_bandwidth_bps", "status": "ok", "value": 812345678,
    "unit": "B/s", "platform": "gpu", "checkpoint_scenario": "flap",
    "checkpoint_n_epochs": 256, "checkpoint_snapshot_every": 16,
    "checkpoint_snapshot_bytes": 1048576, "checkpoint_n_snapshots": 16,
    "checkpoint_write_bandwidth_bps": 812345678.5, "checkpoint_write_s": 0.02,
    "checkpoint_restore_s": 0.75, "checkpoint_load_s": 0.05, "checkpoint_replay_s": 0.7,
    "checkpoint_overhead_fraction": 0.012, "checkpoint_bitequal": True,
    "checkpoint_torn_fallback_ok": True,
    "checkpoint_overhead_panel": [
        {"snapshot_every": 16, "n_snapshots": 16, "run_s": 2.1, "baseline_s": 2.0,
         "overhead_fraction": 0.05},
        {"snapshot_every": 64, "n_snapshots": 4, "run_s": 2.02, "baseline_s": 2.0,
         "overhead_fraction": 0.01}],
}
WRITEPATH_RECORD = {
    "metric": "writepath_encoded_bytes_per_sec", "status": "ok", "value": 1234567890,
    "unit": "B/s", "platform": "gpu", "writepath_scenario": "flap",
    "writepath_n_epochs": 128, "writepath_batch": 256, "writepath_n_sets": 1024,
    "writepath_ways": 4, "writepath_hit_rate": 0.25, "writepath_bitequal": True,
    "writepath_families": "liberation,blaum_roth,liber8tion,cauchy,rs_w8",
    "writepath_stripe_hits": 100, "writepath_stripe_misses": 300,
    "writepath_stripe_evictions": 20, "writepath_delta_bytes": 4096,
    "writepath_full_bytes": 65536, "writepath_schedule_entries": 1,
    "writepath_mix_panel": [
        {"mix": "ssd-steady", "hit_rate": 0.2, "encoded_bytes_per_sec": 1.2e9,
         "delta_bytes": 2048, "full_bytes": 32768, "delta_writes": 10, "full_writes": 5,
         "run_s": 1.5}],
}
RANKS_RETRIES = {"divergent_retries_total": 1, "divergent_backoff_epochs_total": 3,
                 "divergent_laggy_ranks": [1], "divergent_stalled": True,
                 "divergent_converged": False}


def _bench_log(tmp_path, name, *records):
    """A JSON-lines file: a non-record line, then the records, the last
    of each metric the one the panel must pick."""
    path = tmp_path / name
    lines = ["fleet: 256 clusters (a stderr-like line)", json.dumps({"metric": "other"})]
    lines += [json.dumps(r) for r in records]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("command,records", [
    ("fleet", (dict(FLEET_RECORD, value=1), FLEET_RECORD)),
    ("fleet", (dict(FLEET_RECORD, **FLEET_SWEEP, fleet_bitequal=False),)),
    ("ranks", (RANKS_RECORD,)),
    ("ranks", (dict(RANKS_RECORD, value=9), dict(RANKS_RECORD, **RANKS_RETRIES))),
    ("checkpoint", (dict(CHECKPOINT_RECORD, value=1), CHECKPOINT_RECORD)),
    ("checkpoint", (dict(CHECKPOINT_RECORD, checkpoint_overhead_panel=[],
                         checkpoint_bitequal=False),)),
    ("writepath", (WRITEPATH_RECORD,)),
    ("writepath", (dict(WRITEPATH_RECORD, writepath_mix_panel=[], writepath_bitequal=False),)),
])
@pytest.mark.parametrize("as_json", [False, True])
def test_bench_record_panels_match_reference(tmp_path, capsys, command, records, as_json):
    path = _bench_log(tmp_path, "BENCH_log.json", *records)
    argv = [command, "--bench-log", path] + (["--json"] if as_json else [])
    assert ref_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    if as_json:
        assert json.loads(got) == records[-1]
    else:
        assert got.startswith(command + ": ") and len(got.splitlines()) >= 2


@pytest.mark.parametrize("command", ["fleet", "ranks", "checkpoint", "writepath"])
def test_bench_record_panels_without_a_record_exit_1(tmp_path, capsys, monkeypatch, command):
    path = _bench_log(tmp_path, "other.json")
    assert cli.main([command, "--bench-log", path]) == 1
    assert "no " in capsys.readouterr().err
    # the default search reads BENCH*.json in the working directory
    monkeypatch.chdir(tmp_path)
    assert cli.main([command]) == 1
    record = {"fleet": FLEET_RECORD, "ranks": RANKS_RECORD, "checkpoint": CHECKPOINT_RECORD,
              "writepath": WRITEPATH_RECORD}[command]
    _bench_log(tmp_path, "BENCH_r99.json", record)
    assert cli.main([command, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == record


def test_writepath_socket_renders_the_live_stripe_cache(tmp_path, capsys):
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.recovery import ChaosTimeline, EpochDriver
    from ceph_tpu_torch.workload import WritepathDriver

    m = build_osdmap(16, pg_num=16, size=6, pool_kind="erasure")
    w = WritepathDriver(EpochDriver(m, ChaosTimeline(), n_ops=32, device="cpu"), n_sets=4,
                        ways=2, name="cli-probe")
    w.run_superstep(2)
    path = str(tmp_path / "wp.asok")
    daemon = admin_socket.AdminSocket(path)
    daemon.start()
    try:
        reply = admin_socket.ask(path, "dump_stripe_cache")
        assert cli.main(["writepath", "--socket", path]) == 0
        got = capsys.readouterr().out
    finally:
        daemon.stop()
    import io

    want = io.StringIO()
    ref_cli._render("writepath", reply, False, want)
    assert got == want.getvalue() and "cli-probe: " in got
