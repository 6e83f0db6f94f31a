"""Cluster status CLI (the ``ceph -s`` analog).

Two modes::

    # query a live daemon's admin socket (the obs trio registered via
    # ceph_tpu_torch.obs.register_admin_hooks)
    python -m ceph_tpu_torch.cli.status --socket /tmp/ceph-tpu.asok
    python -m ceph_tpu_torch.cli.status --socket /tmp/ceph-tpu.asok health

    # no socket: demo mode — drive a seeded chaos scenario through the
    # supervised executor in-process on --device (cuda by default, which
    # needs a card; --device cpu runs the plain versions) and report its
    # health timeline, SLO verdict, and event journal
    python -m ceph_tpu_torch.cli.status --device cpu
    python -m ceph_tpu_torch.cli.status timeline --scenario flap --json --device cpu
    python -m ceph_tpu_torch.cli.status --traffic --device cpu

Commands: ``status`` (default; the ``ceph -s`` shape), ``health``
(SLO healthchecks), ``timeline`` (the per-epoch PG-state series, with a
client-io column under ``--traffic``), ``journal`` (correlated
span/event records; demo mode only unless the daemon registered a
journal), ``caches`` (the fused placement->peering pipeline cache's and
the EC schedule cache's hit/miss/eviction counters), ``fleet`` (the Monte Carlo durability panel from the latest
``fleet_epoch_rate_per_sec`` record — per-scenario survival fraction,
MTTDL confidence interval, worst-cluster health) and ``ranks`` (the
divergent-rank panel from the latest
``divergent_detect_to_converge_rounds`` record — detection-to-
convergence latency, retries, per-rank final progress).  ``fleet`` and
``ranks`` read JSON lines from ``--bench-log`` files (default:
``BENCH*.json`` in the working directory; ``chip_smoke.py``'s output
holds one line of each), never run a demo, and render a record as the
reference's CLI does.  ``caches`` reports the reference's
``{"pipeline": ..., "schedule": ...}`` panel
(:func:`ceph_tpu_torch.recovery.pipeline.dump_placement_caches`; with
``--socket``, the daemon's ``dump_placement_caches`` hook).

``checkpoint`` (the durable-snapshot panel from the latest
``checkpoint_write_bandwidth_bps`` record: write bandwidth,
restore+replay time, overhead against ``snapshot_every``) and
``writepath`` (the online EC write path's panel from the latest
``writepath_encoded_bytes_per_sec`` record, or live from a daemon's
``dump_stripe_cache`` hook with ``--socket``) read records the same
way.  ``crash`` (also ``--crash``) renders the flight recorder's
post-mortem panel from a ``flightdump-*.json``: an explicit ``--dump``,
a journal's ``flight.dump`` reference (``--journal-path``), or the
newest in ``--dump-dir``.
"""

from __future__ import annotations

import argparse
import json
import sys

COMMANDS = ("status", "health", "timeline", "journal", "caches",
            "fleet", "ranks", "checkpoint", "writepath", "crash")

#: CLI command -> admin-socket prefix (identity unless listed)
_SOCKET_PREFIX = {
    "caches": "dump_placement_caches",
    "writepath": "dump_stripe_cache",
}


def _render(cmd: str, reply: dict, as_json: bool, out) -> None:
    from ..obs.status import render_status

    if as_json:
        print(json.dumps(reply, sort_keys=True), file=out)
        return
    if cmd == "status":
        print(render_status(reply), file=out)
    elif cmd == "health":
        print(reply.get("status", "?"), file=out)
        for name, check in sorted(reply.get("checks", {}).items()):
            print(f"  {name} {check['status']}: {check['detail']}",
                  file=out)
    elif cmd == "caches":
        for name, c in sorted(reply.items()):
            if not isinstance(c, dict):
                continue
            print(
                f"{name}: {c.get('hits', 0)} hits, "
                f"{c.get('misses', 0)} misses, "
                f"{c.get('evictions', 0)} evictions"
                + (f", {c['entries']} entries" if "entries" in c else ""),
                file=out,
            )
    elif cmd == "writepath":
        # live dump_stripe_cache reply: one row per registered buffer
        for b in reply.get("buffers", []):
            print(
                f"{b.get('name', '?')}: "
                f"{b.get('occupied', 0)}/{b.get('n_sets', 0) * b.get('ways', 0)}"
                f" slots ({b.get('dirty_slots', 0)} dirty), "
                f"hit_rate={b.get('hit_rate', 0):.4f} "
                f"({b.get('hits', 0)} hits / {b.get('misses', 0)} misses"
                f" / {b.get('evictions', 0)} evictions), "
                f"delta={b.get('delta_bytes', 0):,}B "
                f"full={b.get('full_bytes', 0):,}B",
                file=out,
            )
    elif cmd == "timeline":
        for s in reply.get("series", []):
            states = " ".join(
                f"{n}={c}" for n, c in s["pgs"].items() if c
            )
            tr = s.get("traffic")
            io = (
                f" p99={tr['p99_ms']:g}ms "
                f"blocked={tr['blocked_fraction']:.4f}"
                if tr else ""
            )
            print(
                f"t={s['t']:g} epoch={s['epoch']} {s['health']} "
                f"avail={s['availability']:.4f} "
                f"degraded_objs={s['degraded_objects']} "
                f"bw={s['repair_bandwidth_bps']:.0f}B/s{io}  {states}",
                file=out,
            )
    else:  # journal
        for r in reply.get("records", []):
            print(json.dumps(r, sort_keys=True), file=out)


def _load_bench_record(metric: str, paths=None) -> dict | None:
    """Latest JSON line with the given ``metric`` from the bench logs.

    ``paths`` defaults to ``BENCH*.json`` in the working directory;
    within them, the last matching line wins (the latest record per
    metric).
    """
    import glob

    if not paths:
        paths = sorted(glob.glob("BENCH*.json"))
    rec = None
    for path in paths:
        try:
            lines = open(path).read().splitlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if d.get("metric") == metric:
                rec = d
    return rec


def load_fleet_record(paths=None) -> dict | None:
    """Latest fleet record (see :func:`_load_bench_record`)."""
    return _load_bench_record("fleet_epoch_rate_per_sec", paths)


def load_divergent_record(paths=None) -> dict | None:
    """Latest divergent-rank record."""
    return _load_bench_record("divergent_detect_to_converge_rounds",
                              paths)


def render_fleet(rec: dict, out) -> None:
    """Text panel for one fleet record: the headline rate plus
    per-scenario survival / MTTDL CI / worst-cluster health."""
    bitequal = rec.get("fleet_bitequal")
    print(
        f"fleet: {rec.get('fleet_n_clusters', '?')} clusters x "
        f"{rec.get('fleet_n_epochs', '?')} epochs "
        f"({rec.get('fleet_scenario', '?')}) on "
        f"{rec.get('platform', '?')}: "
        f"{rec.get('value', 0):,} cluster-epochs/s "
        f"({rec.get('vs_baseline', 0)}x sequential), "
        f"bitequal={'ok' if bitequal else 'FAIL'}",
        file=out,
    )
    if rec.get("fleet_best_down_out_interval_s") is not None:
        print(
            f"  sweep picks: mon_osd_down_out_interval="
            f"{rec['fleet_best_down_out_interval_s']:g}s, "
            f"recovery_share="
            f"{rec.get('fleet_best_recovery_share', 0):g}",
            file=out,
        )
    panel = rec.get("fleet_scenario_panel") or []
    for row in panel:
        ci = (
            f"[{row.get('mttdl_ci_lo_s', 0):.4g}, "
            f"{row.get('mttdl_ci_hi_s', 0):.4g}]"
        )
        cens = " (censored)" if row.get("mttdl_censored") else ""
        print(
            f"  {row.get('scenario', '?'):<12} "
            f"survival={row.get('survival_fraction', 0):.4f} "
            f"mttdl={row.get('mttdl_s', 0):.4g}s {ci}{cens} "
            f"worst=#{row.get('worst_cluster', 0)} "
            f"avail={row.get('worst_availability', 0):.6f}",
            file=out,
        )


def render_ranks(rec: dict, out) -> None:
    """Text panel for one divergent-rank record: detection-to-
    convergence headline plus the per-rank final progress rows."""
    stalled = rec.get("divergent_stalled")
    print(
        f"ranks: {rec.get('divergent_n_ranks', '?')} rank views x "
        f"{rec.get('divergent_n_epochs', '?')} epochs "
        f"({rec.get('divergent_scenario', '?')}) on "
        f"{rec.get('platform', '?')}: detection->convergence "
        f"{rec.get('value', 0):g} rounds over "
        f"{rec.get('divergent_rounds', '?')} total, "
        f"converged={'yes' if rec.get('divergent_converged') else 'NO'}"
        + (", RANK STALLED" if stalled else ""),
        file=out,
    )
    if rec.get("divergent_retries_total") is not None:
        print(
            f"  retries={rec['divergent_retries_total']} "
            f"backoff_epochs={rec.get('divergent_backoff_epochs_total', 0)} "
            f"laggy={rec.get('divergent_laggy_ranks', [])}",
            file=out,
        )
    for row in rec.get("divergent_rank_panel") or []:
        print(
            f"  rank {row.get('rank', '?')}: "
            f"step={row.get('step', 0)} epoch={row.get('epoch', 0)} "
            f"fingerprint={row.get('fingerprint', 0):#x}",
            file=out,
        )


def load_checkpoint_record(paths=None) -> dict | None:
    """Latest ``checkpoint_write_bandwidth_bps`` record (config 9)."""
    return _load_bench_record("checkpoint_write_bandwidth_bps", paths)


def render_checkpoint(rec: dict, out) -> None:
    """Text panel for one config-9 record: write
    bandwidth headline, restore+replay split, and the per-interval
    overhead rows."""
    print(
        f"checkpoint: {rec.get('checkpoint_n_epochs', '?')} epochs "
        f"({rec.get('checkpoint_scenario', '?')}) on "
        f"{rec.get('platform', '?')}: "
        f"{rec.get('value', 0):,.0f} B/s write bandwidth, "
        f"{rec.get('checkpoint_snapshot_bytes', 0):,} B/snapshot",
        file=out,
    )
    if rec.get("checkpoint_restore_s") is not None:
        print(
            f"  restore={rec['checkpoint_restore_s']:.4f}s "
            f"(load {rec.get('checkpoint_load_s', 0):.4f}s + replay "
            f"{rec.get('checkpoint_replay_s', 0):.4f}s), "
            f"bitequal="
            f"{'ok' if rec.get('checkpoint_bitequal') else 'FAIL'}",
            file=out,
        )
    for row in rec.get("checkpoint_overhead_panel") or []:
        print(
            f"  snapshot_every={row.get('snapshot_every', '?'):>4} "
            f"overhead={row.get('overhead_fraction', 0):+.4f} "
            f"({row.get('run_s', 0):.3f}s vs "
            f"{row.get('baseline_s', 0):.3f}s baseline, "
            f"{row.get('n_snapshots', 0)} snapshots)",
            file=out,
        )


def load_writepath_record(paths=None) -> dict | None:
    """Latest ``writepath_encoded_bytes_per_sec`` record (config 10)."""
    return _load_bench_record("writepath_encoded_bytes_per_sec", paths)


def render_writepath(rec: dict, out) -> None:
    """Text panel for one config-10 record: encoded-GB/s
    headline with the bit-equality gate verdict, then per-mix
    stripe-cache hit/miss/evict and parity-delta vs full-stripe byte
    rows."""
    bitequal = rec.get("writepath_bitequal")
    print(
        f"writepath: {rec.get('writepath_n_epochs', '?')} epochs x "
        f"{rec.get('writepath_batch', '?')}-op write batches on "
        f"{rec.get('platform', '?')}: "
        f"{rec.get('value', 0) / 1e9:.4f} GB/s encoded, "
        f"hit_rate={rec.get('writepath_hit_rate', 0):.4f}, "
        f"bitequal={'ok' if bitequal else 'FAIL'} "
        f"({rec.get('writepath_families', '?')})",
        file=out,
    )
    print(
        f"  stripe cache: {rec.get('writepath_stripe_hits', 0):,} hits "
        f"/ {rec.get('writepath_stripe_misses', 0):,} misses "
        f"/ {rec.get('writepath_stripe_evictions', 0):,} evictions, "
        f"delta={rec.get('writepath_delta_bytes', 0):,}B "
        f"full={rec.get('writepath_full_bytes', 0):,}B, "
        f"{rec.get('writepath_schedule_entries', 0)} cached programs",
        file=out,
    )
    for row in rec.get("writepath_mix_panel") or []:
        print(
            f"  {row.get('mix', '?'):<12} "
            f"hit_rate={row.get('hit_rate', 0):.4f} "
            f"encoded={row.get('encoded_bytes_per_sec', 0) / 1e9:.4f}GB/s "
            f"delta={row.get('delta_bytes', 0):,}B "
            f"full={row.get('full_bytes', 0):,}B "
            f"({row.get('delta_writes', 0):,} delta / "
            f"{row.get('full_writes', 0):,} full writes)",
            file=out,
        )


def find_crash_dump(
    dump: str | None = None,
    root: str = ".",
    journal_path: str | None = None,
) -> str | None:
    """Locate the flight dump to render: an explicit path wins; else
    the last ``flight.dump`` reference in the journal (the guard emits
    one per dump); else the newest ``flightdump-*.json`` in ``root``
    (dumps are numbered, so lexical order is creation order)."""
    import glob
    import os

    if dump:
        return dump
    if journal_path and os.path.exists(journal_path):
        from ..obs.journal import EventJournal

        path = None
        for rec in EventJournal.read(journal_path):
            if rec.get("name") == "flight.dump":
                path = rec.get("attrs", {}).get("path")
        if path:
            return path
    hits = sorted(glob.glob(os.path.join(root, "flightdump-*.json")))
    return hits[-1] if hits else None


def render_crash(doc: dict, out, *, tail: int = 8) -> None:
    """The post-mortem panel for one validated flight dump: the typed
    failure, the preserved state snapshot, ring occupancy, and the
    last recorded telemetry rows."""
    print(
        f"crash: {doc.get('reason', '?')}: "
        f"{doc.get('error', '') or '(no message)'}",
        file=out,
    )
    state = doc.get("state") or {}
    if state:
        for key in sorted(state):
            print(f"  state.{key} = {json.dumps(state[key], sort_keys=True)}",
                  file=out)
    fl = doc.get("flight")
    if not fl:
        print("  (no flight ring in dump — recorder was off)", file=out)
        return
    print(
        f"  flight ring: {fl.get('occupancy', 0)}/"
        f"{fl.get('ring_epochs', 0)} rows, head={fl.get('head', 0)}, "
        f"drops={fl.get('drops', 0)}",
        file=out,
    )
    lanes = fl.get("lanes") or []
    rows = fl.get("rows") or []
    show = ("epoch", "dirty", "rung", "dirty_pgs", "served",
            "degraded", "blocked", "down_total", "cycles_peer")
    cols = [(n, lanes.index(n)) for n in show if n in lanes]
    # per-lane (fleet) rings nest one level deeper; render lane 0
    if rows and rows[0] and isinstance(rows[0][0], list):
        rows = rows[0]
    for row in rows[-int(tail):]:
        print(
            "    " + " ".join(f"{n}={row[i]}" for n, i in cols),
            file=out,
        )


#: bench-record command -> (loader, renderer, what to run when none)
_RECORDS = {
    "fleet": (load_fleet_record, render_fleet,
              "no fleet record found (run python3 chip_smoke.py, "
              "bench/config8_fleet.py, or pass --bench-log)"),
    "ranks": (load_divergent_record, render_ranks,
              "no divergent record found (run python3 chip_smoke.py, "
              "bench/config6_recovery.py --divergent, or pass "
              "--bench-log)"),
    "checkpoint": (load_checkpoint_record, render_checkpoint,
                   "no checkpoint record found (run python3 chip_smoke.py, "
                   "bench/config9_checkpoint.py, or pass --bench-log)"),
    "writepath": (load_writepath_record, render_writepath,
                  "no writepath record found (run python3 chip_smoke.py, "
                  "bench/config10_online_ec.py, pass --bench-log, or "
                  "--socket for a live dump_stripe_cache)"),
}


def _demo(args) -> dict:
    """Seeded in-process chaos run on ``args.device`` -> replies for
    every command."""
    import copy

    import numpy as np

    from ..ec.backend import MatrixCodec
    from ..ec.gf import vandermonde_matrix
    from ..models.clusters import build_osdmap
    from ..obs import (
        EventJournal,
        HealthTimeline,
        SLOSpec,
        evaluate,
        status_dict,
    )
    from ..recovery import (
        ChaosEngine,
        SupervisedRecovery,
        VirtualClock,
        build_scenario,
    )

    dev = args.device
    m = build_osdmap(
        args.num_osd,
        pg_num=args.pg_num,
        size=args.ec_k + args.ec_m,
        pool_kind="erasure",
    )
    m_prev = copy.deepcopy(m)
    clock = VirtualClock()
    journal = EventJournal(
        path=args.journal_path,
        clock=clock.now,
        trace_id=f"status-demo-{args.scenario}",
    )
    flags = None
    if args.flag:
        from ..recovery import ClusterFlags

        flags = ClusterFlags(*args.flag)
    chaos = ChaosEngine(
        m, build_scenario(args.scenario, m), clock=clock, journal=journal,
        flags=flags, device=dev,
    )
    scrub_on = args.scrub or args.scenario in (
        "silent-bitrot", "scrub-storm"
    )
    spec = SLOSpec(
        max_inactive_seconds=args.max_inactive_seconds,
        min_availability_fraction=args.min_availability,
        max_time_to_zero_degraded_s=args.max_recovery_seconds,
        max_p99_latency_ms=args.max_p99_ms if args.traffic else None,
        max_slow_op_fraction=(
            args.max_slow_fraction if args.traffic else None
        ),
        max_inconsistent_seconds=(
            args.max_inconsistent_seconds if scrub_on else None
        ),
        max_scrub_age_s=args.max_scrub_age if scrub_on else None,
        max_detection_latency_s=args.max_detection_latency,
    )
    timeline = HealthTimeline(
        clock.now, k=args.ec_k, sample_status=spec.sample_status, device=dev
    )
    traffic = None
    if args.traffic:
        from ..workload import TrafficEngine

        traffic = TrafficEngine(
            clock.now,
            args.num_osd,
            args.pg_num,
            args.ec_k,
            args.ec_k + args.ec_m,
            args.ec_k + 1,
            ops_per_step=args.ops_per_step,
            seed=args.seed,
            journal=journal,
            flags=chaos.flags,
            device=dev,
        )
    codec = MatrixCodec(vandermonde_matrix(args.ec_k, args.ec_m), device=dev)
    rng = np.random.default_rng(args.seed)
    chunks: dict[tuple[int, int], np.ndarray] = {}

    def read_shard(pg: int, s: int) -> np.ndarray:
        key = (int(pg), int(s))
        if key not in chunks:
            chunks[key] = rng.integers(0, 256, 1024, dtype=np.uint8)
        return chunks[key]

    scrubber = None
    write_shard = None
    if scrub_on:
        from ..recovery import Scrubber, apply_bitrot

        # a verified store must be EC-consistent (decode-verify
        # recomputes write-time checksums, so parity has to actually
        # encode the data): materialize every stripe up front instead
        # of lazily minting independent random chunks
        for pg in range(args.pg_num):
            data = rng.integers(
                0, 256, (args.ec_k, 1024), dtype=np.uint8
            )
            parity = np.asarray(codec.encode(data), np.uint8)
            for s in range(args.ec_k):
                chunks[(pg, s)] = data[s].copy()
            for j in range(args.ec_m):
                chunks[(pg, args.ec_k + j)] = parity[j].copy()

        scrubber = Scrubber(
            args.pg_num, args.ec_k + args.ec_m,
            journal=journal, clock=clock.now, device=dev,
        )
        # bitrot events flip real bytes in the demo's host shard store;
        # verified repair writes the decoded chunks back through it
        chaos.corrupt = lambda pg, s, off, mask: apply_bitrot(
            read_shard(pg, s), off, mask
        )

        def write_shard(pg: int, s: int, buf) -> None:
            chunks[(int(pg), int(s))] = np.asarray(buf, np.uint8).copy()

        if traffic is not None:
            # checksum-at-write + degraded-read verification: client
            # writes refresh the scrubber's table, degraded reads
            # CRC-check the surviving shards they serve from
            traffic.scrubber = scrubber
            traffic.read_shard = read_shard

    sup = SupervisedRecovery(
        codec, chaos, seed=args.seed, journal=journal, health=timeline,
        traffic=traffic, scrubber=scrubber, write_shard=write_shard,
        device=dev,
    )
    res = sup.run(m_prev, 1, read_shard)
    journal.close()
    print(
        f"demo {args.scenario}: "
        f"{'converged' if res.converged else 'NOT converged'}, "
        f"{len(timeline)} samples, {len(journal.records)} journal records",
        file=sys.stderr,
    )
    scrub_panel = None
    if scrub_on:
        scrub_panel = {
            "passes": res.scrub_passes,
            "scrubbed_bytes": res.scrubbed_bytes,
            "inconsistencies_found": res.inconsistencies_found,
            "verify_retries": res.verify_retries,
            "inconsistent_unrecoverable": sorted(
                res.inconsistent_unrecoverable
            ),
            "time_to_zero_inconsistent_s": round(
                res.time_to_zero_inconsistent_s, 6
            ),
        }
    liveness_panel = chaos.liveness.summary()
    # compiled-program cache counters (the pipeline and schedule caches
    # are process-global; this is their runtime window)
    from ..recovery.pipeline import dump_placement_caches

    return {
        "status": status_dict(
            timeline, spec, scrub=scrub_panel, liveness=liveness_panel,
            caches=dump_placement_caches(),
        ),
        "health": evaluate(timeline, spec).to_dict(),
        "timeline": {"series": timeline.to_dicts()},
        "journal": {"records": journal.records},
        "caches": dump_placement_caches(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="status")
    p.add_argument("command", nargs="?", default="status",
                   choices=COMMANDS)
    p.add_argument("--socket", metavar="PATH", default=None,
                   help="admin socket of a live daemon; omitted -> "
                        "seeded in-process chaos demo")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="raw JSON reply instead of text rendering")
    # demo-mode knobs
    p.add_argument("--device", default="cuda",
                   help="device of the demo run (cuda or cpu)")
    p.add_argument("--scenario", default="flap",
                   help="chaos scenario for the demo run")
    p.add_argument("--num-osd", type=int, default=64)
    p.add_argument("--pg-num", type=int, default=128)
    p.add_argument("--ec-k", type=int, default=4)
    p.add_argument("--ec-m", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--journal-path", default=None,
                   help="also append demo journal records to this "
                        "JSONL file")
    p.add_argument("--max-inactive-seconds", type=float, default=30.0)
    p.add_argument("--min-availability", type=float, default=0.75)
    p.add_argument("--max-recovery-seconds", type=float, default=30.0)
    p.add_argument("--scrub", action="store_true",
                   help="ride a CRC32C scrubber on the demo run (on by "
                        "default for the bitrot scenarios): checksum "
                        "the store, verify repairs, and render the "
                        "scrub panel")
    p.add_argument("--max-inconsistent-seconds", type=float, default=30.0)
    p.add_argument("--max-scrub-age", type=float, default=60.0)
    p.add_argument("--traffic", action="store_true",
                   help="ride a client-traffic engine on the demo run: "
                        "per-sample latency percentiles, outcome "
                        "fractions, and the client-io panel")
    p.add_argument("--ops-per-step", type=int, default=65536)
    p.add_argument("--max-p99-ms", type=float, default=50.0)
    p.add_argument("--max-slow-fraction", type=float, default=0.02)
    p.add_argument("--flag", action="append", default=[],
                   metavar="NAME",
                   help="raise a cluster flag on the demo run "
                        "(noout/norecover/nobackfill/norebalance/pause; "
                        "repeatable)")
    p.add_argument("--max-detection-latency", type=float, default=None,
                   help="SLO budget on failure-to-mark-down latency "
                        "(virtual seconds); default: check disabled")
    p.add_argument("--bench-log", action="append", default=[],
                   metavar="PATH",
                   help="bench JSONL file(s) for the fleet and ranks "
                        "panels (repeatable; default: BENCH*.json in "
                        "the working directory)")
    p.add_argument("--crash", action="store_true",
                   help="alias for the 'crash' command: render the "
                        "flight-recorder post-mortem panel")
    p.add_argument("--dump", metavar="PATH", default=None,
                   help="explicit flightdump-*.json for the crash "
                        "panel")
    p.add_argument("--dump-dir", metavar="DIR", default=".",
                   help="directory scanned for flightdump-*.json "
                        "(default: working directory)")
    args = p.parse_args(argv)
    out = sys.stdout
    if args.crash:
        args.command = "crash"

    if args.command == "crash":
        from ..obs.flight import read_flight_dump

        path = find_crash_dump(
            args.dump, args.dump_dir, args.journal_path
        )
        if path is None:
            print(
                "status: no flight dump found (pass --dump, "
                "--dump-dir, or --journal-path with a flight.dump "
                "reference)",
                file=sys.stderr,
            )
            return 1
        try:
            doc = read_flight_dump(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"status: cannot read {path}: {e}", file=sys.stderr)
            return 1
        if args.as_json:
            print(json.dumps(doc, sort_keys=True), file=out)
        else:
            print(f"dump: {path}", file=out)
            render_crash(doc, out)
        return 0

    if args.command in _RECORDS and not (args.command == "writepath"
                                         and args.socket is not None):
        load, render, missing = _RECORDS[args.command]
        rec = load(args.bench_log)
        if rec is None:
            print(f"status: {missing}", file=sys.stderr)
            return 1
        if args.as_json:
            print(json.dumps(rec, sort_keys=True), file=out)
        else:
            render(rec, out)
        return 0

    if args.socket is not None:
        from ..common.admin_socket import ask

        try:
            reply = ask(
                args.socket,
                _SOCKET_PREFIX.get(args.command, args.command),
            )
        except OSError as e:
            print(f"status: cannot reach {args.socket}: {e}",
                  file=sys.stderr)
            return 1
        if "error" in reply and len(reply) == 1:
            print(f"status: {reply['error']}", file=sys.stderr)
            return 1
        _render(args.command, reply, args.as_json, out)
        return 0

    replies = _demo(args)
    _render(args.command, replies[args.command], args.as_json, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
