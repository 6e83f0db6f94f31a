"""Text crushmap compiler/decompiler.

Parity with the reference's ``src/crush/CrushCompiler.{h,cc}`` (the
boost::spirit grammar in ``src/crush/grammar.h``): the classic text
format with ``tunable``/``device``/``type``/bucket/``rule`` sections
compiles to a :class:`~ceph_tpu_torch.crush.map.CrushMap` and back.  Weights
are decimal in text (1.000) and 16.16 fixed point internally.
"""

from __future__ import annotations

from .map import (
    ALG_IDS,
    ALG_NAMES,
    OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP,
    OP_CHOOSELEAF_FIRSTN,
    OP_CHOOSELEAF_INDEP,
    OP_EMIT,
    OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    OP_SET_CHOOSE_LOCAL_TRIES,
    OP_SET_CHOOSE_TRIES,
    OP_SET_CHOOSELEAF_STABLE,
    OP_SET_CHOOSELEAF_TRIES,
    OP_SET_CHOOSELEAF_VARY_R,
    OP_TAKE,
    CrushMap,
    Rule,
    Step,
    Tunables,
)

TUNABLE_FIELDS = {
    "choose_total_tries": "choose_total_tries",
    "choose_local_tries": "choose_local_tries",
    "choose_local_fallback_tries": "choose_local_fallback_tries",
    "chooseleaf_descend_once": "chooseleaf_descend_once",
    "chooseleaf_vary_r": "chooseleaf_vary_r",
    "chooseleaf_stable": "chooseleaf_stable",
}

SET_OPS = {
    OP_SET_CHOOSE_TRIES: "set_choose_tries",
    OP_SET_CHOOSELEAF_TRIES: "set_chooseleaf_tries",
    OP_SET_CHOOSE_LOCAL_TRIES: "set_choose_local_tries",
    OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES: "set_choose_local_fallback_tries",
    OP_SET_CHOOSELEAF_VARY_R: "set_chooseleaf_vary_r",
    OP_SET_CHOOSELEAF_STABLE: "set_chooseleaf_stable",
}
SET_OPS_BY_NAME = {v: k for k, v in SET_OPS.items()}


class CompileError(ValueError):
    pass


def compile_crushmap(text: str) -> CrushMap:
    """Text -> CrushMap (reference ``CrushCompiler::compile``)."""
    tun: dict[str, int] = {}
    m = CrushMap()
    lines: list[list[str]] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if line:
            lines.append(line.split())

    i = 0
    n = len(lines)
    while i < n:
        tok = lines[i]
        if tok[0] == "tunable":
            if tok[1] not in TUNABLE_FIELDS:
                raise CompileError(f"unknown tunable {tok[1]}")
            tun[TUNABLE_FIELDS[tok[1]]] = int(tok[2])
            i += 1
        elif tok[0] == "device":
            osd = int(tok[1])
            name = tok[2]
            dclass = None
            if len(tok) >= 5 and tok[3] == "class":
                dclass = tok[4]
            m.add_device(osd, name, dclass)
            i += 1
        elif tok[0] == "type":
            m.add_type(int(tok[1]), tok[2])
            i += 1
        elif tok[0] == "rule":
            name = tok[1]
            if tok[-1] != "{":
                raise CompileError(f"rule {name}: expected '{{'")
            i += 1
            rid = None
            kind = "replicated"
            steps: list[Step] = []
            while i < n and lines[i][0] != "}":
                t = lines[i]
                if t[0] in ("id", "ruleset"):
                    rid = int(t[1])
                elif t[0] == "type":
                    kind = t[1]
                elif t[0] in ("min_size", "max_size"):
                    pass  # legacy, ignored (as modern reference does)
                elif t[0] == "step":
                    steps.append(_parse_step(m, t[1:]))
                else:
                    raise CompileError(f"rule {name}: bad line {t}")
                i += 1
            if i >= n:
                raise CompileError(f"rule {name}: unterminated block")
            i += 1  # closing }
            m.add_rule(name, steps, kind=kind, rule_id=rid)
        elif len(tok) >= 2 and tok[-1] == "{":
            # bucket: "<typename> <name> {"
            type_name = tok[0]
            bname = tok[1]
            i += 1
            bid = None
            alg = None
            items: list[tuple[str, int]] = []
            while i < n and lines[i][0] != "}":
                t = lines[i]
                if t[0] == "id":
                    bid = int(t[1])
                elif t[0] == "alg":
                    if t[1] not in ALG_IDS:
                        raise CompileError(f"bucket {bname}: bad alg {t[1]}")
                    alg = ALG_IDS[t[1]]
                elif t[0] == "hash":
                    if int(t[1]) != 0:
                        raise CompileError("only hash 0 (rjenkins1) exists")
                elif t[0] == "item":
                    iname = t[1]
                    weight = 0x10000
                    for j in range(2, len(t) - 1):
                        if t[j] == "weight":
                            weight = int(round(float(t[j + 1]) * 0x10000))
                    items.append((iname, weight))
                elif t[0] == "weight":
                    pass  # bucket combined weight: derived
                else:
                    raise CompileError(f"bucket {bname}: bad line {t}")
                i += 1
            if i >= n:
                raise CompileError(f"bucket {bname}: unterminated block")
            i += 1
            b = m.add_bucket(bname, type_name, alg=alg or 5, bucket_id=bid)
            for iname, w in items:
                m.insert_item(b.id, _item_id(m, iname), w)
        else:
            raise CompileError(f"unparsed line: {' '.join(tok)}")
    if tun:
        m.set_tunables(Tunables(**{**Tunables().__dict__, **tun}))
    return m


def _item_id(m: CrushMap, name: str) -> int:
    for osd, dname in m.device_names.items():
        if dname == name:
            return osd
    if name.startswith("osd."):
        return int(name.split(".", 1)[1])
    return m.bucket_by_name(name).id


def _parse_step(m: CrushMap, t: list[str]) -> Step:
    if t[0] == "take":
        if len(t) >= 4 and t[2] == "class":
            root = m.bucket_by_name(t[1]).id
            return Step(OP_TAKE, m.class_shadow_root(root, t[3]))
        return Step(OP_TAKE, m.bucket_by_name(t[1]).id)
    if t[0] == "emit":
        return Step(OP_EMIT)
    if t[0] in ("choose", "chooseleaf"):
        mode = t[1]  # firstn | indep
        num = int(t[2])
        if t[3] != "type":
            raise CompileError(f"step {t}: expected 'type'")
        type_id = m.type_id(t[4])
        op = {
            ("choose", "firstn"): OP_CHOOSE_FIRSTN,
            ("choose", "indep"): OP_CHOOSE_INDEP,
            ("chooseleaf", "firstn"): OP_CHOOSELEAF_FIRSTN,
            ("chooseleaf", "indep"): OP_CHOOSELEAF_INDEP,
        }[(t[0], mode)]
        return Step(op, num, type_id)
    if t[0] in SET_OPS_BY_NAME:
        return Step(SET_OPS_BY_NAME[t[0]], int(t[1]))
    raise CompileError(f"unknown step {t}")


def decompile_crushmap(m: CrushMap) -> str:
    """CrushMap -> text (reference ``CrushCompiler::decompile``)."""
    out: list[str] = ["# begin crush map"]
    t = m.tunables
    for text_name, field in TUNABLE_FIELDS.items():
        out.append(f"tunable {text_name} {getattr(t, field)}")
    out.append("")
    out.append("# devices")
    for osd in sorted(m.device_names):
        line = f"device {osd} {m.device_names[osd]}"
        if osd in m.device_classes:
            line += f" class {m.device_classes[osd]}"
        out.append(line)
    out.append("")
    out.append("# types")
    for tid in sorted(m.types):
        out.append(f"type {tid} {m.types[tid]}")
    out.append("")
    out.append("# buckets")
    # children before parents (the reference emits leaves first)
    emitted: set[int] = set()

    def emit_bucket(bid: int) -> None:
        if bid in emitted or m.shadow_origin(bid) is not None:
            return  # shadow trees are derived, not authored
        b = m.buckets[bid]
        for item in b.items:
            if item < 0:
                emit_bucket(item)
        emitted.add(bid)
        out.append(f"{m.types[b.type_id]} {b.name} {{")
        out.append(f"\tid {b.id}")
        out.append(f"\talg {ALG_NAMES[b.alg]}")
        out.append("\thash 0\t# rjenkins1")
        for item, w in zip(b.items, b.item_weights):
            # %.5f like the reference's decompiler: 5 decimals resolve
            # every 16.16 step (error x 0x10000 < 0.5, so the parse's
            # round() recovers the exact fixed-point weight; 3 decimals
            # lost up to ~33/65536 per item — found by the round-trip
            # placement fuzz)
            out.append(f"\titem {m.item_name(item)} weight {w / 0x10000:.5f}")
        out.append("}")

    for bid in sorted(m.buckets, reverse=True):
        emit_bucket(bid)
    out.append("")
    out.append("# rules")
    for r in sorted(m.rules.values(), key=lambda r: r.id):
        out.append(f"rule {r.name} {{")
        out.append(f"\tid {r.id}")
        out.append(f"\ttype {r.kind}")
        for s in r.steps:
            out.append("\tstep " + _step_text(m, s))
        out.append("}")
    out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


def _step_text(m: CrushMap, s: Step) -> str:
    if s.op == OP_TAKE:
        origin = m.shadow_origin(s.arg1)
        if origin is not None:
            orig_id, cls = origin
            return f"take {m.buckets[orig_id].name} class {cls}"
        return f"take {m.buckets[s.arg1].name}"
    if s.op == OP_EMIT:
        return "emit"
    names = {
        OP_CHOOSE_FIRSTN: "choose firstn",
        OP_CHOOSE_INDEP: "choose indep",
        OP_CHOOSELEAF_FIRSTN: "chooseleaf firstn",
        OP_CHOOSELEAF_INDEP: "chooseleaf indep",
    }
    if s.op in names:
        return f"{names[s.op]} {s.arg1} type {m.types[s.arg2]}"
    if s.op in SET_OPS:
        return f"{SET_OPS[s.op]} {s.arg1}"
    raise CompileError(f"cannot decompile step op {s.op}")
