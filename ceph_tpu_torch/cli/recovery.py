"""Recovery CLI: inject failures, peer, plan, and run batched repair.

The ``ceph osd down`` / ``ceph pg dump`` / recovery-status surface for
the failure loop, driving :mod:`ceph_tpu_torch.recovery` end to end on
``--device`` (``cuda`` by default, which needs a card; ``--device cpu``
runs the plain versions)::

    # synthesize a 64-OSD EC cluster, take rack0 down+out, show the
    # peering summary and the pattern-grouped repair plan
    python -m ceph_tpu_torch.cli.recovery --inject rack:0 --plan

    # same but on a saved map, actually running the batched decode
    python -m ceph_tpu_torch.cli.recovery map.bin --inject host:host0_1 --execute

    # drive a continuous failure schedule through the supervised
    # executor: epochs land mid-repair, the plan revises, and the run
    # ends with a structured convergence report (one JSON line)
    python -m ceph_tpu_torch.cli.recovery --chaos mid-repair-loss

    # the same over a mesh (a world of one here; every rank of the
    # world under ``torchrun --nproc-per-node N``), large groups sharded
    # and the work-stealing dispatcher on with one chip slowed
    python -m ceph_tpu_torch.cli.recovery --chaos mid-repair-loss --mesh 0 \\
        --shard-min-bytes 0 --chip-fault chipslow:0.4

With a ``mapfilename`` the map is loaded from the versioned encoding
(``osdmaptool --createsimple`` output); without one a synthetic EC
cluster is built in-process (``--num-osd`` etc.).  ``--mesh N`` runs
over the process group's world (``N`` must be 0 or the world size);
under ``torchrun`` the group forms from its environment, on the card
with NCCL or with ``--device cpu`` on gloo.
"""

from __future__ import annotations

import argparse
import copy
import sys

import numpy as np

from ..osdmap.map import OSDMap


def _load(path: str) -> OSDMap:
    with open(path, "rb") as f:
        return OSDMap.decode(f.read())


def _pick_pool(m: OSDMap, pool_id: int | None) -> int:
    if pool_id is not None:
        return pool_id
    ec = [pid for pid, p in m.pools.items() if p.kind == "erasure"]
    return ec[0] if ec else sorted(m.pools)[0]


def _build_mesh(args, out):
    """``--mesh N`` -> this rank's mesh over the world (None when the
    flag is absent).  Under ``torchrun`` the world is the launched one
    (formed here from its environment); otherwise a world of one."""
    if args.mesh is None:
        return None
    import os

    from ..parallel import make_mesh, multihost

    if "WORLD_SIZE" in os.environ:
        multihost.init(device=args.device)
    try:
        mesh = make_mesh(args.mesh or None, axis="bytes", device=args.device)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}") from None
    print(f"mesh: sharding large pattern groups over {mesh.size} devices", file=out)
    return mesh


def _worksteal_setup(args, cfg):
    """Apply ``--work-stealing``/``--chip-fault`` to the config and
    return the parsed chip-fault specs.  Dies loudly on a non-chip spec
    and on the off+fault contradiction — a fault flag that silently does
    nothing would fake a passing straggler drill."""
    from ..recovery.failure import parse_spec

    chip_faults = [parse_spec(text) for text in args.chip_fault]
    bad = [str(s) for s in chip_faults if not s.is_chip]
    if bad:
        raise SystemExit(
            f"--chip-fault {' '.join(bad)}: not a chip spec "
            "(chipstall:/chipslow:/chipdrop:)"
        )
    ws = args.work_stealing
    if chip_faults and ws == "off":
        raise SystemExit(
            "--chip-fault needs the work-stealing dispatcher; "
            "drop '--work-stealing off'"
        )
    if chip_faults and ws is None:
        ws = "on"  # a requested fault implies the path that consumes it
    if ws is not None:
        cfg.set("recovery_work_stealing", ws)
    return chip_faults


def _codec(args, pool, device):
    from ..ec.registry import create

    return create({
        "plugin": "jerasure",
        "technique": "reed_sol_van",
        "k": str(pool.size - args.ec_m if args.mapfilename else args.ec_k),
        "m": str(args.ec_m),
    }, device=device)


def _chunk_reader(chunk_size: int):
    """``read_shard(pg, s)``: seeded random chunks, made on first read."""
    rng = np.random.default_rng(0)
    chunks: dict[tuple[int, int], np.ndarray] = {}

    def read_shard(pg: int, s: int) -> np.ndarray:
        key = (pg, s)
        if key not in chunks:
            chunks[key] = rng.integers(0, 256, chunk_size, dtype=np.uint8)
        return chunks[key]

    return read_shard


def _run_chaos(args, m, m_prev, pool_id, out) -> int:
    """Drive a named chaos timeline through the supervised executor."""
    import json

    from ..common.config import Config
    from ..recovery import ChaosEngine, SupervisedRecovery, build_scenario

    pool = m.pools[pool_id]
    if pool.kind != "erasure":
        print(f"pool {pool_id} is not erasure-coded; chaos needs an EC pool",
              file=out)
        return 1
    timeline = build_scenario(
        args.chaos, m, start_s=args.chaos_start,
        period_s=args.chaos_period, cycles=args.cycles,
    )
    # chip specs never reach the map engine: split them off the
    # timeline and merge with the --chip-fault flags for the dispatcher
    from ..recovery import ChipLostError
    from ..recovery.dispatch import strip_chip_specs

    timeline, stripped = strip_chip_specs(timeline)
    print(f"chaos {args.chaos}: {len(timeline)} scheduled events", file=out)
    mesh = _build_mesh(args, out)
    device = mesh.device if mesh is not None else args.device
    chaos = ChaosEngine(m, timeline, device=device)
    codec = _codec(args, pool, device)
    cfg = Config()
    if args.max_bytes_per_sec is not None:
        cfg.set("recovery_max_bytes_per_sec", args.max_bytes_per_sec)
    if args.dirty_compaction is not None:
        cfg.set("sparse_dirty_compaction", args.dirty_compaction)
    if args.shard_min_bytes is not None:
        cfg.set("recovery_shard_min_bytes", args.shard_min_bytes)
    chip_faults = list(stripped) + _worksteal_setup(args, cfg)
    sup = SupervisedRecovery(codec, chaos, config=cfg, seed=args.seed, mesh=mesh,
                             chip_faults=chip_faults or None, device=device)
    try:
        res = sup.run(m_prev, pool_id, _chunk_reader(args.chunk_size))
    except ChipLostError as e:
        # typed, never a hang: every chip of this rank was convicted —
        # report which and fail loudly
        print(f"chaos aborted: all chips convicted ({e.chips})", file=out)
        return 1
    for ev in chaos.applied:
        specs = " ".join(str(s) for s in ev.specs)
        print(f"  t={ev.t:g}s epoch {ev.epoch}: {specs}", file=out)
    s = res.summary()
    print(
        f"chaos done: {'converged' if res.converged else 'NOT converged'} "
        f"at t={s['time_to_zero_degraded_s']:g}s, {res.launches} launches "
        f"({res.retries} retries, {res.stale_launches} stale), "
        f"{res.plan_revisions} plan revisions, "
        f"{len(res.completed_pgs)} pgs recovered, "
        f"{len(s['unrecoverable_pgs'])} unrecoverable, "
        f"{len(res.failed_pgs)} failed",
        file=out,
    )
    if res.worksteal_launches:
        idle = ", ".join(f"{f:.2f}" for f in res.idle_fraction_per_chip)
        print(
            f"worksteal: {res.worksteal_launches} launches, "
            f"{res.stolen_subshards} stolen sub-shards, "
            f"{res.hedged_launches} hedged "
            f"({res.hedge_wasted_bytes} wasted bytes), "
            f"{res.chip_convictions} chips convicted, "
            f"idle/chip [{idle}]",
            file=out,
        )
    print(json.dumps({"scenario": args.chaos, "seed": args.seed, **s}),
          file=out)
    return 0 if res.converged else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="recovery")
    p.add_argument("mapfilename", nargs="?",
                   help="versioned OSDMap file; omitted -> synthetic cluster")
    p.add_argument("--num-osd", type=int, default=64,
                   help="synthetic cluster size when no map file is given")
    p.add_argument("--pg-num", type=int, default=128)
    p.add_argument("--ec-k", type=int, default=4)
    p.add_argument("--ec-m", type=int, default=2)
    p.add_argument("--pool", type=int, default=None,
                   help="pool id (default: first erasure pool)")
    p.add_argument("--inject", action="append", metavar="SPEC", default=[],
                   help="failure spec scope:target[:action], repeatable "
                        "(e.g. osd:5, host:host0_1, rack:0:down_out)")
    p.add_argument("--flap", metavar="SPEC",
                   help="flapping sequence instead of a single event")
    p.add_argument("--cycles", type=int, default=3,
                   help="down/up pairs for --flap")
    p.add_argument("--plan", action="store_true",
                   help="peer the epochs and print the pattern-grouped "
                        "repair plan")
    p.add_argument("--execute", action="store_true",
                   help="run the batched repair decode on synthesized "
                        "chunk data (implies --plan)")
    p.add_argument("--chunk-size", type=int, default=4096,
                   help="shard chunk bytes for --execute")
    p.add_argument("--max-bytes-per-sec", type=float, default=None,
                   help="recovery throttle override for --execute")
    p.add_argument("--chaos", metavar="SCENARIO", default=None,
                   help="run a named chaos timeline (flap, rack-cascade, "
                        "mid-repair-loss, ...) through the supervised "
                        "executor and report convergence as one JSON line")
    p.add_argument("--chaos-start", type=float, default=0.25,
                   help="virtual seconds before the first chaos event")
    p.add_argument("--chaos-period", type=float, default=1.0,
                   help="virtual seconds between chaos events")
    p.add_argument("--seed", type=int, default=0,
                   help="retry-jitter seed for --chaos (determinism: same "
                        "seed, same run)")
    p.add_argument("--device", default="cuda",
                   help="device of peering and the decodes (cuda or cpu)")
    p.add_argument("--dirty-compaction", choices=("auto", "on", "off"),
                   default=None,
                   help="dirty-set compaction for the epoch engines "
                        "(sparse_dirty_compaction): peer/classify only "
                        "the gathered dirty PG bucket instead of every "
                        "PG; default 'auto' keeps small demo geometries "
                        "on the dense reference path")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="shard large pattern groups over the world's N ranks "
                        "for --execute/--chaos (0 = every rank; a world of one "
                        "without torchrun); small groups stay on the rank's "
                        "device and are co-scheduled")
    p.add_argument("--shard-min-bytes", type=int, default=None,
                   help="crossover threshold override: smallest group "
                        "operand (bytes) routed to the sharded decode "
                        "(recovery_shard_min_bytes)")
    p.add_argument("--work-stealing", choices=("auto", "on", "off"), default=None,
                   help="work-stealing sub-shard dispatch over the rank's "
                        "chips (recovery_work_stealing; default 'auto': on "
                        "only with more than one CUDA chip)")
    p.add_argument("--chip-fault", action="append", metavar="SPEC", default=[],
                   help="seeded dispatcher chip fault, repeatable "
                        "(chipstall:<chip>[.<launch>], "
                        "chipslow:<chip>.<factor>, chipdrop:<chip>); "
                        "implies --work-stealing on")
    args = p.parse_args(argv)
    out = sys.stdout

    from ..recovery import (
        FLAG_NAMES,
        RecoveryExecutor,
        build_plan,
        flap,
        inject,
        peer_pool,
    )

    if args.mapfilename:
        m = _load(args.mapfilename)
    else:
        from ..models.clusters import build_osdmap

        m = build_osdmap(
            args.num_osd,
            pg_num=args.pg_num,
            size=args.ec_k + args.ec_m,
            pool_kind="erasure",
        )
    pool_id = _pick_pool(m, args.pool)
    m_prev = copy.deepcopy(m)

    if args.chaos:
        return _run_chaos(args, m, m_prev, pool_id, out)

    if not args.inject and not args.flap:
        p.error("nothing to do: give --inject, --flap and/or --chaos")
    for spec in args.inject:
        inc = inject(m, spec)
        print(
            f"inject {spec}: epoch {m.epoch} "
            f"({len(inc.new_state)} state edits, "
            f"{len(inc.new_weight)} weight edits)",
            file=out,
        )
    if args.flap:
        rec = flap(m, args.flap, cycles=args.cycles)
        print(
            f"flap {args.flap}: {args.cycles} cycles over "
            f"{len(rec.incrementals)} epochs, {len(rec.osds)} osds",
            file=out,
        )

    if not (args.plan or args.execute):
        return 0

    peering = peer_pool(m_prev, m, pool_id, device=args.device)
    counts = peering.counts()
    summary = " ".join(
        f"{counts[name]} {name}" for name in FLAG_NAMES.values()
        if name != "clean" and counts[name]
    )
    print(
        f"pool {pool_id}: {counts['total']} pgs: {summary or 'all clean'}",
        file=out,
    )

    pool = m.pools[pool_id]
    if pool.kind != "erasure":
        print(f"pool {pool_id} is not erasure-coded; no repair plan",
              file=out)
        return 0
    codec = _codec(args, pool, args.device)
    plan = build_plan(peering, codec)
    print(
        f"plan: {plan.n_patterns} erasure patterns, {plan.n_pgs} degraded "
        f"pgs, {plan.n_shards} shard rebuilds, "
        f"{len(plan.unrecoverable)} unrecoverable "
        f"-> {plan.n_patterns} decode launches",
        file=out,
    )
    for g in plan.groups:
        print(
            f"  pattern {g.mask:#06x}: missing {list(g.missing)} "
            f"x {g.n_pgs} pgs (read rows {list(g.rows)})",
            file=out,
        )

    if not args.execute:
        return 0

    from ..common.config import Config

    from ..recovery import ChipLostError

    cfg = Config()
    if args.max_bytes_per_sec is not None:
        cfg.set("recovery_max_bytes_per_sec", args.max_bytes_per_sec)
    if args.shard_min_bytes is not None:
        cfg.set("recovery_shard_min_bytes", args.shard_min_bytes)
    chip_faults = _worksteal_setup(args, cfg)
    mesh = _build_mesh(args, out)
    ex = RecoveryExecutor(codec, config=cfg, mesh=mesh, chip_faults=chip_faults or None,
                          dispatch_seed=args.seed, device=args.device)
    try:
        result = ex.run(plan, _chunk_reader(args.chunk_size))
    except ChipLostError as e:
        print(f"execute aborted: all chips convicted ({e.chips})", file=out)
        return 1
    sharded = (
        f" ({result.sharded_launches} mesh-sharded, "
        f"{result.psum_bytes_rebuilt} psum'd bytes)"
        if result.sharded_launches else ""
    )
    if result.worksteal_launches:
        sharded = (
            f" ({result.worksteal_launches} work-stealing, "
            f"{result.stolen_subshards} stolen sub-shards, "
            f"{result.chip_convictions} convicted)"
        )
    print(
        f"execute: {result.launches} launches{sharded}, "
        f"{result.shards_rebuilt} shards / "
        f"{result.bytes_recovered} bytes rebuilt, "
        f"{result.bytes_per_sec / 1e6:.1f} MB/s decode, "
        f"throttle waited {result.throttle_wait_s:.3f}s",
        file=out,
    )
    assert result.launches == plan.n_patterns
    return 0


if __name__ == "__main__":
    sys.exit(main())
