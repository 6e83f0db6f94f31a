"""osdmaptool-parity CLI.

Covers the reference's ``src/tools/osdmaptool.cc`` placement surface:
``--createsimple N``, ``--print``, ``--test-map-pgs`` (whole-map
mapping + distribution statistics, the batch mapping timer),
``--test-map-object``, ``--upmap`` (run the optimizer, write the
resulting commands), ``--upmap-cleanup``, ``--crush-compat`` (weight-set
descent), ``--mark-out``.  Map files
are the framework's versioned JSON OSDMap encoding.  The mapping, the
optimizer and crush-compat run on ``--device`` (``cuda`` by default,
which needs a card; ``--device cpu`` runs the plain versions):

    python -m ceph_tpu_torch.cli.osdmaptool map.json --createsimple 1024 \
        --pg-num 10240
    python -m ceph_tpu_torch.cli.osdmaptool map.json --test-map-pgs
    python -m ceph_tpu_torch.cli.osdmaptool map.json --upmap out.sh \
        --upmap-max 2000
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..osdmap.map import OSDMap, PGId


def load(path: str) -> OSDMap:
    with open(path, "rb") as f:
        return OSDMap.decode(f.read())


def save(m: OSDMap, path: str) -> None:
    with open(path, "wb") as f:
        f.write(m.encode())


def cmd_print(m: OSDMap, out) -> None:
    print(f"epoch {m.epoch}", file=out)
    print(f"max_osd {m.max_osd}", file=out)
    for pid in sorted(m.pools):
        p = m.pools[pid]
        print(
            f"pool {pid} '{p.name}' {p.kind} size {p.size} min_size "
            f"{p.min_size} pg_num {p.pg_num} pgp_num {p.pgp_num} "
            f"crush_rule {p.crush_rule}",
            file=out,
        )
    for osd in range(m.max_osd):
        state = []
        state.append("up" if m.is_up(osd) else "down")
        state.append("out" if m.is_out(osd) else "in")
        w = m.osd_weight[osd] / 0x10000
        print(f"osd.{osd} {' '.join(state)} weight {w:.5f}", file=out)
    for pg, items in sorted(m.pg_upmap_items.items()):
        print(f"pg_upmap_items {pg} {list(map(list, items))}", file=out)


def cmd_test_map_pgs(m: OSDMap, out, pool_id: int | None, device="cuda") -> None:
    from ..osdmap.mapping import OSDMapMapping

    mapping = OSDMapMapping(m, device=device)
    pools = [pool_id] if pool_id is not None else sorted(m.pools)
    for pid in pools:  # warm: compile the pool programs
        mapping.update(pid)
    t0 = time.perf_counter()
    for pid in pools:
        mapping.update(pid)
    dt = time.perf_counter() - t0
    counts = np.zeros(max(m.max_osd, 1), np.int64)
    total_pgs = 0
    for pid in pools:
        counts += mapping.pg_counts_by_osd(pid, acting=False)
        total_pgs += m.pools[pid].pg_num
    print(f"pool {','.join(map(str, pools))} pg_num {total_pgs}", file=out)
    print(f"#osd\tcount", file=out)
    for osd in range(m.max_osd):
        print(f"osd.{osd}\t{counts[osd]}", file=out)
    active = counts[[not m.is_out(o) for o in range(m.max_osd)]]
    if len(active):
        print(f"avg {active.mean():.2f} stddev {active.std():.2f}", file=out)
        print(f"min osd count {active.min()} max osd count {active.max()}", file=out)
    print(f"mapping time {dt * 1e3:.1f} ms ({total_pgs / max(dt, 1e-9):.0f} pg/s)", file=out)


def upmap_commands(inc) -> list[str]:
    """The ``--upmap`` command file's lines for the plan ``inc``: entry
    GC first (the reference emits rm-pg-upmap-items for entries the
    optimizer retires), then the new entries, each list sorted."""
    cmds = [f"ceph osd rm-pg-upmap-items {pg}" for pg in sorted(inc.old_pg_upmap_items)]
    for pg, items in sorted(inc.new_pg_upmap_items.items()):
        pairs = " ".join(f"{f} {t}" for f, t in items)
        cmds.append(f"ceph osd pg-upmap-items {pg} {pairs}")
    return cmds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="osdmaptool")
    p.add_argument("mapfilename")
    p.add_argument("--createsimple", type=int, metavar="NUM_OSD")
    p.add_argument("--pg-num", type=int, default=128)
    p.add_argument("--pool-size", type=int, default=3)
    p.add_argument("--print", dest="do_print", action="store_true")
    p.add_argument("--test-map-pgs", action="store_true")
    p.add_argument("--pool", type=int, default=None)
    p.add_argument("--test-map-object", metavar="NAME")
    p.add_argument("--mark-out", type=int, action="append", metavar="OSD")
    p.add_argument("--upmap", metavar="OUTFILE", help="run the optimizer")
    p.add_argument("--upmap-max", type=int, default=100)
    p.add_argument("--upmap-deviation", type=float, default=1.0)
    p.add_argument("--upmap-pool", action="append", type=int)
    p.add_argument("--upmap-cleanup", action="store_true")
    p.add_argument(
        "--crush-compat", action="store_true",
        help="optimize the compat choose_args weight set instead of upmaps",
    )
    p.add_argument("--save", action="store_true", help="write map changes back")
    p.add_argument("--device", default="cuda",
                   help="device of the mapping, the optimizer and crush-compat "
                        "(cuda or cpu)")
    args = p.parse_args(argv)
    out = sys.stdout

    if args.createsimple:
        from ..models.clusters import build_osdmap

        m = build_osdmap(
            args.createsimple, pg_num=args.pg_num, size=args.pool_size
        )
        save(m, args.mapfilename)
        print(
            f"osdmaptool: writing epoch {m.epoch} to {args.mapfilename}",
            file=sys.stderr,
        )
        return 0

    m = load(args.mapfilename)
    dirty = False
    if args.mark_out:
        for osd in args.mark_out:
            m.mark_out(osd)
        dirty = True
    if args.do_print:
        cmd_print(m, out)
    if args.test_map_pgs:
        cmd_test_map_pgs(m, out, args.pool, args.device)
    if args.test_map_object:
        pool = args.pool if args.pool is not None else sorted(m.pools)[0]
        up, upp, acting, actp = m.map_object(args.test_map_object, pool)
        pg = m.raw_pg_to_pg(m.object_locator_to_pg(args.test_map_object, pool))
        print(
            f" object '{args.test_map_object}' -> {pg} -> up {up} acting {acting}",
            file=out,
        )
    if args.upmap_cleanup:
        removed = len(m.pg_upmap_items) + len(m.pg_upmap)
        m.pg_upmap_items.clear()
        m.pg_upmap.clear()
        print(f"upmap-cleanup: removed {removed} entries", file=out)
        dirty = True
    if args.upmap:
        from ..balancer import calc_pg_upmaps

        inc = calc_pg_upmaps(
            m,
            max_deviation=args.upmap_deviation,
            max_entries=args.upmap_max,
            pools=args.upmap_pool,
            device=args.device,
        )
        cmds = upmap_commands(inc)
        with open(args.upmap, "w") as f:
            f.write("\n".join(cmds) + ("\n" if cmds else ""))
        print(f"upmap: wrote {len(cmds)} commands to {args.upmap}", file=out)
        if cmds:
            m.apply_incremental(inc)
            dirty = True
    if args.crush_compat:
        from ..balancer.module import Balancer

        bal = Balancer(m, mode="crush-compat",
                       max_deviation=args.upmap_deviation, device=args.device)
        before = bal.evaluate(args.upmap_pool)
        changed = bal.tick(args.upmap_pool)  # descends + bumps epoch
        after = bal.evaluate(args.upmap_pool)
        print(
            "crush-compat: "
            f"max deviation {max(before.pool_max_deviation.values(), default=0):.2f}"
            f" -> {max(after.pool_max_deviation.values(), default=0):.2f}"
            f" ({'updated' if changed else 'no change'})",
            file=out,
        )
        dirty = dirty or changed
    if dirty and args.save:
        save(m, args.mapfilename)
        print(f"osdmaptool: writing epoch {m.epoch} to {args.mapfilename}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
