"""Chrome-trace / Perfetto export of journal spans + flight rows.

``trace.json`` (the Chrome Trace Event Format — load it in
``ui.perfetto.dev`` or ``chrome://tracing``) built from the two
observability sources on ONE timebase, the VirtualClock:

- **journal spans** become complete ("X") events — ``ts``/``dur``
  from the record's virtual ``t``/``t_end`` (microseconds), one track
  (``tid``) per span name, or per chip/rank when the span's attrs
  carry one (``chip``/``rank``), under the ``journal`` process row.
  Point events become instant ("i") events on the same tracks.
- **drained flight rows** (:func:`ceph_tpu_torch.obs.flight.drain_flight`)
  become per-stage tracks under the ``flight`` process row: each
  epoch contributes one "X" slice per stage (peer / traffic / scrub),
  ``ts`` anchored at the epoch's virtual time and ``dur`` carrying
  the stage's **cycle proxy** (deterministic op-count units rendered
  as microseconds — relative widths are meaningful, absolute wall
  time is not, exactly like the counter discipline that produced
  them).  Slice args carry the forensic lanes: ladder rung, dirty
  fraction, stripe-cache hit rate, outcome counts.

Everything here stays on the virtual clock: the wall lane in journal
records is deliberately ignored.  Host code over journal records and
flight drains, the counterpart of the reference package's
``obs/traceexport.py``.

``python -m ceph_tpu_torch.obs.traceexport --selftest`` builds a
synthetic trace (on the CPU) and validates it against
:func:`validate_trace`.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .flight import FLIGHT_LANES

#: stage track -> (cycle-proxy lane, arg lanes rendered on each slice)
_STAGE_LANES = (
    ("peer", "cycles_peer",
     ("rung", "dirty_pgs", "compact", "heavy", "eff_down", "eff_up",
      "eff_out")),
    ("traffic", "cycles_traffic",
     ("served", "degraded", "blocked", "writes", "deg_reads")),
    ("scrub", "cycles_scrub", ("scrub_due",)),
)


def _us(t: float) -> float:
    """Virtual seconds -> trace microseconds."""
    return round(float(t) * 1e6, 3)


def _span_tid(rec: dict) -> str:
    attrs = rec.get("attrs") or {}
    for key in ("chip", "rank"):
        if key in attrs:
            return f"{key}{attrs[key]}"
    return str(rec.get("name", "?"))


def journal_events(records) -> list[dict]:
    """Journal records -> trace events (spans as "X", points as "i")."""
    out = []
    for rec in records:
        if not isinstance(rec, dict) or "t" not in rec:
            continue
        base = {
            "pid": "journal",
            "tid": _span_tid(rec),
            "name": str(rec.get("name", "?")),
            "cat": str(rec.get("kind", "event")),
            "ts": _us(rec["t"]),
        }
        args = {
            k: v for k, v in (rec.get("attrs") or {}).items()
            if isinstance(v, (int, float, str, bool))
        }
        if rec.get("kind") == "span" and "t_end" in rec:
            dur = max(_us(rec["t_end"]) - _us(rec["t"]), 0.0)
            out.append({**base, "ph": "X", "dur": dur, "args": args})
        else:
            out.append({**base, "ph": "i", "s": "t", "args": args})
    return out


def flight_events(
    drain: dict, *, dt: float = 1.0, t0: float = 0.0, lane=None,
) -> list[dict]:
    """Drained flight rows -> per-stage trace slices.

    ``dt``/``t0`` place epoch ``e`` at virtual time ``t0 + (e+1)*dt``
    (the superstep's ``_now_of`` convention); ``lane`` picks one fleet
    lane out of a per-lane ring (``rows`` with a leading fleet axis)
    and names the process row ``flight/lane<k>``."""
    rows = np.asarray(drain["rows"])
    pid = "flight"
    if rows.ndim == 3:
        k = int(lane or 0)
        rows = rows[k]
        pid = f"flight/lane{k}"
    if rows.size == 0:
        return []
    idx = {name: i for i, name in enumerate(FLIGHT_LANES)}
    out = []
    for row in rows:
        epoch = int(row[idx["epoch"]])
        ts = _us(t0 + (epoch + 1) * dt)
        hits = int(row[idx["stripe_hits"]])
        misses = int(row[idx["stripe_misses"]])
        looked = hits + misses
        common = {
            "epoch": epoch,
            "rung": int(row[idx["rung"]]),
            "dirty_fraction": float(int(row[idx["dirty"]])),
            "hit_rate": (hits / looked) if looked else 0.0,
        }
        for stage, cyc_lane, arg_lanes in _STAGE_LANES:
            dur = float(int(row[idx[cyc_lane]]))
            out.append({
                "pid": pid,
                "tid": stage,
                "name": f"{stage}@e{epoch}",
                "cat": "flight",
                "ph": "X",
                "ts": ts,
                "dur": dur,
                "args": {
                    **common,
                    **{a: int(row[idx[a]]) for a in arg_lanes},
                },
            })
    return out


def build_trace(
    journal_records=(), flight_drain=None, *, dt: float = 1.0,
    t0: float = 0.0,
) -> dict:
    """The full trace document: ``{"traceEvents": [...]}`` sorted by
    timestamp, with per-process metadata rows naming the tracks."""
    events = list(journal_events(journal_records))
    if flight_drain is not None:
        rows = np.asarray(flight_drain["rows"])
        if rows.ndim == 3:
            for k in range(rows.shape[0]):
                events.extend(
                    flight_events(flight_drain, dt=dt, t0=t0, lane=k)
                )
        else:
            events.extend(flight_events(flight_drain, dt=dt, t0=t0))
    events.sort(key=lambda e: (e.get("ts", 0), e.get("pid", ""),
                               e.get("tid", "")))
    meta = [
        {
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "ts": 0, "args": {"name": pid},
        }
        for pid in sorted({e["pid"] for e in events})
    ]
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"timebase": "virtual-clock-us"},
    }


def export_trace(
    path: str, journal_records=(), flight_drain=None, *,
    dt: float = 1.0, t0: float = 0.0,
) -> dict:
    """Build and write ``trace.json``; returns the document."""
    doc = build_trace(journal_records, flight_drain, dt=dt, t0=t0)
    with open(path, "w") as fh:
        json.dump(doc, fh)
        fh.write("\n")
    return doc


def validate_trace(doc) -> list[str]:
    """Minimal Chrome-trace JSON schema check; [] = valid.

    The contract CI pins: a top-level ``traceEvents`` list whose
    entries each carry a phase, a numeric non-negative ``ts``, pid /
    tid / name, and — for complete ("X") events — a numeric
    non-negative ``dur``."""
    problems = []
    if not isinstance(doc, dict):
        return ["trace is not an object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            problems.append(f"{where}: missing ph")
            continue
        for key in ("pid", "tid", "name"):
            if key not in ev:
                problems.append(f"{where}: missing {key}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: bad dur {dur!r}")
    return problems


# ---------------------------------------------------------------------------
# CLI selftest


def _selftest(out_path: str) -> int:
    from .flight import drain_flight, empty_flight, flight_record, flight_row

    fs = empty_flight(8, device="cpu")
    for e in range(5):
        fs = flight_record(fs, flight_row(
            device="cpu",
            epoch=e, dirty=e % 2,
            rung=0 if e % 2 else -1,
            dirty_pgs=3 * (e % 2),
            served=100, degraded=2,
            writes=25,
            cycles_peer=32 * (e % 2),
            cycles_traffic=102,
            cycles_scrub=1,
        ))
    records = [
        {"kind": "span", "name": "epoch.chunk", "t": 0.0,
         "t_end": 5.0, "attrs": {"chunk": 0}},
        {"kind": "event", "name": "flight.drain", "t": 5.0,
         "attrs": {"occupancy": 5}},
    ]
    doc = export_trace(out_path, records, drain_flight(fs), dt=1.0)
    problems = validate_trace(doc)
    reread = json.load(open(out_path))
    problems += validate_trace(reread)
    n_flight = sum(
        1 for e in doc["traceEvents"] if e.get("cat") == "flight"
    )
    if n_flight != 5 * len(_STAGE_LANES):
        problems.append(
            f"expected {5 * len(_STAGE_LANES)} flight slices, "
            f"got {n_flight}"
        )
    if problems:
        print(json.dumps({"selftest": "FAIL", "problems": problems}))
        return 1
    print(json.dumps({
        "selftest": "ok", "path": out_path,
        "n_events": len(doc["traceEvents"]),
    }))
    return 0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="traceexport")
    p.add_argument("--selftest", action="store_true",
                   help="build a synthetic trace and validate it")
    p.add_argument("--journal", default=None,
                   help="journal JSONL to export")
    p.add_argument("--out", default="trace.json")
    p.add_argument("--validate", default=None, metavar="TRACE",
                   help="validate an existing trace.json and exit")
    p.add_argument("--dt", type=float, default=1.0)
    args = p.parse_args(argv)
    if args.validate:
        problems = validate_trace(json.load(open(args.validate)))
        print(json.dumps({
            "valid": not problems, "problems": problems,
        }))
        return 0 if not problems else 1
    if args.selftest:
        return _selftest(args.out)
    if args.journal:
        from .journal import EventJournal

        records = (
            EventJournal.read_rotated(args.journal)
            if os.path.exists(args.journal + ".1")
            else EventJournal.read(args.journal)
        )
        doc = export_trace(args.out, records, dt=args.dt)
        print(json.dumps({
            "path": args.out, "n_events": len(doc["traceEvents"]),
        }))
        return 0
    p.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
