"""crushtool-parity CLI.

Covers the reference's ``src/tools/crushtool.cc`` surface relevant to
placement work: compile (``-c``) / decompile (``-d``), ``--build``
(synthesize a hierarchy from a flat device count), ``--test`` with
``--min-x/--max-x/--num-rep/--rule``, ``--show-mappings``,
``--show-statistics``, ``--show-utilization``, ``--show-bad-mappings``,
and ``--tree``.  Map files are the framework's versioned JSON encoding
(`.json`); text crushmaps use the classic format via the compiler.

The --test engine is the batch engine on ``--device`` (``cuda`` by
default, which needs a card, where the straw2 kernels place the whole x
range; ``--device cpu`` runs the plain versions), with the C++ CPU
reference available via --cpu for differential runs — the reference's
CrushTester loop, vectorized:

    python -m ceph_tpu_torch.cli.crushtool -i map.json --test \
        --show-statistics --max-x 65535
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..crush.compiler import compile_crushmap, decompile_crushmap
from ..crush.map import ALG_IDS, ITEM_NONE, CrushMap


def load_map(path: str) -> CrushMap:
    with open(path, "rb") as f:
        data = f.read()
    if data.lstrip()[:1] == b"{":
        return CrushMap.decode(data)
    return compile_crushmap(data.decode())


def cmd_tree(m: CrushMap, out) -> None:
    def walk(item: int, depth: int) -> None:
        pad = "    " * depth
        if item >= 0:
            print(f"{pad}{m.item_name(item)}", file=out)
            return
        b = m.buckets[item]
        print(
            f"{pad}{m.types[b.type_id]} {b.name} "
            f"(id {b.id}, weight {b.weight / 0x10000:.3f}, "
            f"alg {b.alg})",
            file=out,
        )
        for it in b.items:
            walk(it, depth + 1)

    roots = [bid for bid in m.buckets if m.parent_of(bid) is None]
    for r in sorted(roots, reverse=True):
        walk(r, 0)


def repropagate_weights(m: CrushMap) -> None:
    """Recompute every bucket's recorded child weights bottom-up from
    the leaves (reference CrushWrapper recursive weight update)."""
    child_ids = {i for b in m.buckets.values() for i in b.items}
    for b in list(m.buckets.values()):
        if b.id not in child_ids:
            m.adjust_subtree_weights(b.id)


def check_map(m: CrushMap) -> list:
    """--check parity: structural invariants the reference validates
    (dangling bucket references, id collisions, stale recorded
    weights, rules taking unknown buckets)."""
    problems = []
    for bid, b in m.buckets.items():
        if len(b.items) != len(b.item_weights):
            problems.append(f"bucket {b.name}: items/weights length skew")
        for it, w in zip(b.items, b.item_weights):
            if it >= 0:
                continue
            if it not in m.buckets:
                problems.append(
                    f"bucket {b.name}: dangling child bucket {it}")
                continue
            child_w = sum(m.buckets[it].item_weights)
            if child_w != w:
                problems.append(
                    f"bucket {b.name}: recorded weight for "
                    f"{m.buckets[it].name} is {w}, children sum "
                    f"to {child_w} (run --reweight)")
        seen = set()
        for it in b.items:
            if it in seen:
                problems.append(f"bucket {b.name}: duplicate item {it}")
            seen.add(it)
    placed = [i for b in m.buckets.values() for i in b.items if i >= 0]
    if len(placed) != len(set(placed)):
        problems.append("a device appears in more than one bucket")
    # hierarchy cycles crash every other tool (RecursionError in
    # --tree, no-root no-op in --reweight): iterative DFS over buckets
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {bid: WHITE for bid in m.buckets}
    for start in m.buckets:
        if color[start] != WHITE:
            continue
        stack = [(start, iter(m.buckets[start].items))]
        color[start] = GRAY
        while stack:
            bid, it = stack[-1]
            child = next(it, None)
            if child is None:
                color[bid] = BLACK
                stack.pop()
                continue
            if child >= 0 or child not in m.buckets:
                continue
            if color[child] == GRAY:
                problems.append(
                    f"hierarchy cycle through {m.buckets[child].name}")
                color[child] = BLACK
            elif color[child] == WHITE:
                color[child] = GRAY
                stack.append((child, iter(m.buckets[child].items)))

    from ..crush.map import OP_TAKE

    for r in m.rules.values():
        for st in r.steps:
            if st.op == OP_TAKE and st.arg1 < 0 and st.arg1 not in m.buckets:
                problems.append(
                    f"rule {r.id} ({r.name}): take of unknown bucket "
                    f"{st.arg1}")
    return problems


def weight_overrides(specs, n: int) -> np.ndarray:
    """Full-weight vector with --weight OSD:W overrides applied;
    out-of-range ids are a hard error (matching run_test's historical
    strictness rather than silently ignoring a typo)."""
    w = np.full(max(n, 1), 0x10000, np.uint32)
    for spec in specs or ():
        osd_s, wv = spec.split(":")
        osd = int(osd_s)
        if not 0 <= osd < len(w):
            raise SystemExit(f"--weight {spec}: osd {osd} out of range")
        w[osd] = int(round(float(wv) * 0x10000))
    return w


def run_test(m: CrushMap, args, out) -> int:
    from ..crush.engine import run_batch

    if args.rule is not None and args.rule not in m.rules:
        print(f"rule {args.rule} not in map (rules: "
              f"{sorted(m.rules)})", file=sys.stderr)
        return 1
    rules = (
        [m.rules[args.rule]]
        if args.rule is not None
        else sorted(m.rules.values(), key=lambda r: r.id)
    )
    if not rules:
        print("map has no rules (--build maps need a rule added "
              "via the text compiler)", file=sys.stderr)
        return 1
    dense = m.to_dense()
    xs = np.arange(args.min_x, args.max_x + 1, dtype=np.uint32)
    weights = weight_overrides(args.weight, dense.max_devices)
    rc = 0
    for rule in rules:
        for num_rep in range(args.min_rep, args.max_rep + 1):
            if args.cpu or args.show_choose_tries:
                from ..testing import cppref

                steps = [(s.op, s.arg1, s.arg2) for s in rule.steps]
                if args.show_choose_tries:
                    cppref.reset_retry_stats()
                results, lens = cppref.do_rule_batch(
                    dense, steps, xs, weights, num_rep
                )
            else:
                results, lens = run_batch(dense, rule, xs, weights, num_rep,
                                          device=args.device)
                # torchlint: disable=J003  # the CLI prints the rule's mappings: one read a rule
                results = results.cpu().numpy()
                # torchlint: disable=J003  # the rule's result lengths, read with its mappings
                lens = lens.cpu().numpy()
            if args.show_mappings:
                for x, row, ln in zip(xs, results, lens):
                    osds = [int(o) for o in row[:ln] if o != ITEM_NONE]
                    print(
                        f"CRUSH rule {rule.id} x {x} {osds}", file=out
                    )
            bad = int((lens < num_rep).sum())
            if args.show_statistics or args.show_bad_mappings:
                print(
                    f"rule {rule.id} ({rule.name}) num_rep {num_rep} "
                    f"result size == {num_rep}:\t"
                    f"{int((lens == num_rep).sum())}/{len(xs)}",
                    file=out,
                )
                if bad and args.show_bad_mappings:
                    for x, ln in zip(xs, lens):
                        if ln < num_rep:
                            print(
                                f"bad mapping rule {rule.id} x {x} "
                                f"num_rep {num_rep} result size {ln}",
                                file=out,
                            )
            if args.show_utilization:
                flat = results[results != ITEM_NONE]
                counts = np.bincount(flat, minlength=len(weights))
                expected = len(xs) * num_rep / max((weights > 0).sum(), 1)
                for osd in np.nonzero(counts)[0]:
                    print(
                        f"  device {osd}:\t\tstored : {counts[osd]}\t "
                        f"expected : {expected:.2f}",
                        file=out,
                    )
            if args.show_choose_tries:
                # reference CrushTester --show-choose-tries: histogram
                # of retries needed per placement slot
                from ..testing import cppref

                hist = cppref.retry_histogram()
                # reference format: "tries: count" per bucket (indep
                # rules: counts are failure-normalized, i.e. one less
                # than upstream's rounds-run — see cppref.retry_stats)
                for tries_n in np.nonzero(hist)[0]:
                    print(f" {tries_n}:  {int(hist[tries_n])}", file=out)
            if bad:
                rc = 1 if args.show_bad_mappings else rc
    return rc


def build_hierarchy_from_args(args) -> CrushMap:
    """--build parity: crushtool --build --num_osds N layer1 type1 size1 ..."""
    from ..models.clusters import W1

    m = CrushMap()
    layers = [
        (args.layers[i], args.layers[i + 1], int(args.layers[i + 2]))
        for i in range(0, len(args.layers), 3)
    ]
    for tid, (name, _alg, _size) in enumerate(layers, start=1):
        m.add_type(tid, name)
    for o in range(args.num_osds):
        m.add_device(o)
    # bottom-up grouping; groups are consecutive slices, so weights
    # zip by the same slice (no per-item index scans)
    current = list(range(args.num_osds))
    weights = [W1] * len(current)
    for tname, algname, size in layers:
        alg = ALG_IDS.get(algname, 5)
        next_items: list[int] = []
        next_weights: list[int] = []
        step = size if size > 0 else len(current)
        for gi, lo in enumerate(range(0, len(current), step)):
            b = m.add_bucket(f"{tname}{gi}", tname, alg=alg)
            for item, w in zip(current[lo : lo + step], weights[lo : lo + step]):
                m.insert_item(b.id, item, w)
            next_items.append(b.id)
            next_weights.append(sum(m.buckets[b.id].item_weights))
        current = next_items
        weights = next_weights
    return m


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="crushtool")
    p.add_argument("-i", "--infn", help="input map file (json or text)")
    p.add_argument("-o", "--outfn", help="output file")
    p.add_argument("-c", "--compile", dest="compilefn", help="compile text crushmap")
    p.add_argument("-d", "--decompile", dest="decompilefn", help="decompile map")
    p.add_argument("--build", action="store_true")
    p.add_argument("--num_osds", type=int, default=0)
    p.add_argument("layers", nargs="*", help="--build: name alg size triples")
    p.add_argument("--test", action="store_true")
    p.add_argument("--tree", action="store_true")
    p.add_argument("--rule", type=int, default=None)
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1023)
    p.add_argument("--num-rep", type=int, default=None)
    p.add_argument("--min-rep", type=int, default=3)
    p.add_argument("--max-rep", type=int, default=3)
    p.add_argument("--show-mappings", action="store_true")
    p.add_argument("--show-statistics", action="store_true")
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--show-bad-mappings", action="store_true")
    p.add_argument("--show-choose-tries", action="store_true",
                   help="histogram of retries per placement slot "
                        "(runs on the C++ tier, which tracks the "
                        "retry ladder)")
    p.add_argument("--weight", action="append", metavar="OSD:W")
    p.add_argument("--compare", metavar="MAPFILE",
                   help="report mappings that differ vs another map")
    p.add_argument("--reweight", action="store_true",
                   help="recompute bucket weights bottom-up (needs -o)")
    p.add_argument("--check", action="store_true",
                   help="validate map invariants; nonzero exit on problems")
    for knob in ("choose-total-tries", "choose-local-tries",
                 "choose-local-fallback-tries", "chooseleaf-descend-once",
                 "chooseleaf-vary-r", "chooseleaf-stable"):
        p.add_argument(f"--set-{knob}", type=int, default=None,
                       metavar="N", help=f"set the {knob} tunable (needs -o)")
    p.add_argument("--tunables-profile", choices=[
        "legacy", "argonaut", "bobtail", "firefly", "hammer", "jewel",
        "optimal", "default"], default=None,
        help="apply a named tunables profile (needs -o)")
    p.add_argument("--cpu", action="store_true", help="use the C++ CPU reference")
    p.add_argument("--device", default="cuda",
                   help="device of the --test engine without --cpu (cuda or cpu)")
    # map mutation (reference crushtool --add-item/--remove-item/
    # --reweight-item; weights are decimal, 1.0 = 0x10000)
    p.add_argument("--add-item", nargs=3, metavar=("ID", "WEIGHT", "NAME"),
                   help="add device ID with WEIGHT as NAME (needs --loc)")
    p.add_argument("--loc", nargs=2, action="append",
                   metavar=("TYPE", "NAME"), default=None,
                   help="bucket location for --add-item")
    p.add_argument("--remove-item", metavar="NAME",
                   help="remove a device by name from every bucket")
    p.add_argument("--reweight-item", nargs=2, metavar=("NAME", "WEIGHT"),
                   help="set a device's weight everywhere it appears")
    args = p.parse_args(argv)
    if args.num_rep is not None:
        args.min_rep = args.max_rep = args.num_rep
    out = sys.stdout

    if args.compilefn:
        with open(args.compilefn) as f:
            m = compile_crushmap(f.read())
        dest = args.outfn or args.compilefn + ".json"
        with open(dest, "wb") as f:
            f.write(m.encode())
        print(f"wrote crush map to {dest}", file=sys.stderr)
        return 0
    if args.decompilefn:
        m = load_map(args.decompilefn)
        text = decompile_crushmap(m)
        if args.outfn:
            with open(args.outfn, "w") as f:
                f.write(text)
        else:
            out.write(text)
        return 0
    if args.build:
        if not args.num_osds or len(args.layers) % 3:
            p.error("--build requires --num_osds and name/alg/size triples")
        m = build_hierarchy_from_args(args)
        dest = args.outfn or "crushmap.json"
        with open(dest, "wb") as f:
            f.write(m.encode())
        print(f"wrote crush map to {dest}", file=sys.stderr)
        return 0
    if not args.infn:
        p.error("need -i/--infn (or -c/-d/--build)")
    if (args.add_item or args.remove_item or args.reweight_item
            or args.reweight) and not args.outfn:
        # reference crushtool refuses to mutate without an explicit
        # output file; never silently clobber the -i input map
        p.error("mutation flags (--add-item/--remove-item/"
                "--reweight-item/--reweight) require -o OUTFN")
    m = load_map(args.infn)

    def _device_id(name: str) -> int:
        for osd, nm in m.device_names.items():
            if nm == name:
                return osd
        p.error(f"unknown device {name!r}")


    mutated = False
    if args.add_item:
        osd_s, weight, name = args.add_item
        osd, w = int(osd_s), int(float(weight) * 0x10000)
        if osd < 0:
            p.error("--add-item id must be a device id (>= 0)")
        if not args.loc:
            p.error("--add-item needs at least one --loc TYPE NAME")
        type_ids = {tname: tid for tid, tname in m.types.items()}
        # the reference parses --loc pairs into a map keyed by type
        # (later pair for the same type wins), then inserts at the
        # innermost (lowest type id) location
        locmap: dict[int, "object"] = {}
        for tname, bname in args.loc:
            if tname not in type_ids:
                p.error(f"unknown type {tname!r}")
            try:
                bucket = m.bucket_by_name(bname)
            except (KeyError, ValueError):
                p.error(f"unknown bucket {bname!r}")
            if m.types[bucket.type_id] != tname:
                p.error(f"bucket {bname!r} is not a {tname}")
            locmap[type_ids[tname]] = bucket
        bucket = locmap[min(locmap)]
        if osd in m.device_names and m.device_names[osd] != name:
            p.error(f"device id {osd} already exists as "
                    f"{m.device_names[osd]!r}")
        # reference crushtool: "specified item already exists" — a
        # device may live in at most one bucket
        for b in m.buckets.values():
            if osd in b.items:
                p.error(f"device {osd} already in bucket {b.name!r}")
        m.add_device(osd, name)
        m.insert_item(bucket.id, osd, w)
        mutated = True
    if args.remove_item:
        osd = _device_id(args.remove_item)
        for b in list(m.buckets.values()):
            if osd in b.items:
                m.remove_item(b.id, osd)
        m.device_names.pop(osd, None)  # reference removes the device too
        mutated = True
    if args.reweight_item:
        name, weight = args.reweight_item
        osd, w = _device_id(name), int(float(weight) * 0x10000)
        for b in m.buckets.values():
            if osd in b.items:
                m.adjust_item_weight(b.id, osd, w)
        mutated = True
    if mutated:
        repropagate_weights(m)
        dest = args.outfn
        with open(dest, "wb") as f:
            f.write(m.encode())
        print(f"wrote crush map to {dest}", file=sys.stderr)
        if not (args.test or args.tree or args.compare or args.check):
            return 0

    knobs = {
        k: getattr(args, f"set_{k}")
        for k in ("choose_total_tries", "choose_local_tries",
                  "choose_local_fallback_tries", "chooseleaf_descend_once",
                  "chooseleaf_vary_r", "chooseleaf_stable")
        if getattr(args, f"set_{k}") is not None
    }
    if knobs or args.tunables_profile:
        from dataclasses import replace

        from ..crush.map import Tunables

        if not args.outfn:
            p.error("tunables flags require -o OUTFN")
        base = (Tunables.profile(args.tunables_profile)
                if args.tunables_profile else m.tunables)
        m.tunables = replace(base, **knobs)
        m._mutated()
        with open(args.outfn, "wb") as f:
            f.write(m.encode())
        print(f"wrote crush map to {args.outfn}", file=sys.stderr)
        if not (args.test or args.tree or args.compare or args.check):
            return 0

    if args.reweight:
        repropagate_weights(m)
        with open(args.outfn, "wb") as f:
            f.write(m.encode())
        print(f"reweighted map written to {args.outfn}", file=sys.stderr)
        if not (args.test or args.tree or args.compare or args.check):
            return 0

    if args.check:
        problems = check_map(m)
        for msg in problems:
            print(f"check: {msg}", file=out)
        if problems:
            return 1
        print("check: map is consistent", file=out)
        if not (args.test or args.tree or args.compare):
            return 0

    if args.compare:
        return run_compare(m, args, out)
    if args.tree:
        cmd_tree(m, out)
        return 0
    if args.test:
        return run_test(m, args, out)
    p.error("nothing to do (--test, --tree, -d ...)")
    return 2


def run_compare(m: CrushMap, args, out) -> int:
    """--compare parity (reference crushtool --compare): map the same x
    range under both maps and report how many inputs moved — the
    standard way to preview a tunables/topology change's data motion."""
    from ..testing import cppref

    other = load_map(args.compare)
    if args.rule is not None and args.rule not in m.rules:
        print(f"rule {args.rule} not in map (rules: {sorted(m.rules)})",
              file=sys.stderr)
        return 1
    xs = np.arange(args.min_x, args.max_x + 1, dtype=np.uint32)
    num_rep = args.max_rep  # --num-rep already folded in by main
    d1, d2 = m.to_dense(), other.to_dense()
    w1 = weight_overrides(args.weight, d1.max_devices)
    w2 = weight_overrides(args.weight, d2.max_devices)
    total = 0
    moved = 0
    for rule in sorted(m.rules.values(), key=lambda r: r.id):
        if args.rule is not None and rule.id != args.rule:
            continue
        if rule.id not in other.rules:
            print(f"rule {rule.id} missing from {args.compare}; skipped",
                  file=sys.stderr)
            continue
        rule2 = other.rules[rule.id]
        s1 = [(s.op, s.arg1, s.arg2) for s in rule.steps]
        s2 = [(s.op, s.arg1, s.arg2) for s in rule2.steps]
        r1, _ = cppref.do_rule_batch(d1, s1, xs, w1, num_rep)
        r2, _ = cppref.do_rule_batch(d2, s2, xs, w2, num_rep)
        diff = int((~(r1 == r2).all(axis=1)).sum())
        total += len(xs)
        moved += diff
        print(f"rule {rule.id} ({rule.name}): {diff}/{len(xs)} mappings "
              f"changed", file=out)
    if not total:
        print("no rules compared (missing from the other map?)",
              file=sys.stderr)
        return 1
    print(f"total: {moved}/{total} ({100.0 * moved / total:.2f}%) "
          f"mappings changed", file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
