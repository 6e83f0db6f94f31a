"""Process-kill chaos child: run a checkpointed scenario, optionally
SIGKILL ourselves at a seeded point, and (when we survive) dump the
result for bit-equality comparison.

Usage::

    python -m ceph_tpu_torch.recovery._crashbox CONFIG.json

The config is one JSON object::

    {
      "mode": "superstep" | "fleet" | "divergent",
      "store": "<checkpoint dir>",
      "out": "<result .npz path>",
      "device": "cuda" | "cpu",            # default: the card
      "n_osds": 32, "pg_num": 64, "size": 6,
      "pool_kind": "erasure",
      "scenario": "flap",
      "n_epochs": 16, "snapshot_every": 4,
      "n_ops": 64, "seed": 0,
      "kill": {"epoch": 8, "phase": "during"} | null,
      "fleet_n": 3, "lane": 1,            # fleet mode
      "n_ranks": 2,                        # divergent mode
      "rank_specs": [[0.5, "rankdelay:1.2500"]]
    }

With ``kill`` set the run dies by SIGKILL (exit code ``-SIGKILL`` to
the parent) at the configured checkpoint-relative point, ``during``
included (mid-checkpoint-write: a torn tmp file on disk).  Rerun with
the SAME config minus ``kill`` and the run resumes from the store and
writes ``out``: the full series lanes (superstep, one fleet lane) or
the per-rank state lanes and fingerprints (divergent).  The parent
compares those arrays bit for bit against an uninterrupted run."""

from __future__ import annotations

import json
import sys

import numpy as np

from ..convert import state_lanes
from ..models.clusters import build_osdmap
from .chaos import ChaosTimeline, build_scenario
from .checkpoint import (
    CheckpointStore,
    CrashPoint,
    checkpointed_fleet,
    checkpointed_superstep,
)
from .failure import parse_spec
from .superstep import _SERIES_FIELDS, EpochDriver


def _crashes(cfg: dict) -> tuple:
    kill = cfg.get("kill")
    if not kill:
        return ()
    return (CrashPoint(int(kill["epoch"]),
                       str(kill.get("phase", "before")),
                       "sigkill"),)


def _timeline(cfg: dict, m) -> ChaosTimeline:
    tl = build_scenario(cfg.get("scenario", "flap"), m)
    extra = [
        (float(t), parse_spec(spec))
        for t, spec in cfg.get("rank_specs", [])
    ]
    if extra:
        tl = ChaosTimeline.from_pairs(
            [(ev.t, spec) for ev in tl.events() for spec in ev.specs]
            + extra
        )
    return tl


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("usage: _crashbox CONFIG.json", file=sys.stderr)
        return 2
    with open(argv[0]) as fh:
        cfg = json.load(fh)
    device = str(cfg.get("device", "cuda"))
    m = build_osdmap(
        int(cfg.get("n_osds", 32)),
        pg_num=int(cfg.get("pg_num", 64)),
        size=int(cfg.get("size", 6)),
        pool_kind=str(cfg.get("pool_kind", "erasure")),
    )
    store = CheckpointStore(cfg["store"], device=device)
    crashes = _crashes(cfg)
    n_epochs = int(cfg.get("n_epochs", 16))
    every = int(cfg.get("snapshot_every", 4))
    n_ops = int(cfg.get("n_ops", 64))
    seed = int(cfg.get("seed", 0))
    mode = cfg.get("mode", "superstep")
    if mode == "superstep":
        d = EpochDriver(m, _timeline(cfg, m), n_ops=n_ops, seed=seed, device=device)
        series = checkpointed_superstep(
            d, n_epochs, store=store, snapshot_every=every,
            crashes=crashes,
        )
        np.savez(cfg["out"], **{
            f: getattr(series, f) for f in _SERIES_FIELDS
        })
    elif mode == "fleet":
        from .fleet import FleetDriver

        fd = FleetDriver(m, seed=seed, n_ops=n_ops, device=device)
        tls = fd.sample(int(cfg.get("fleet_n", 3)),
                        cfg.get("scenario", "flap"))
        fs = checkpointed_fleet(
            fd, n_epochs, tls, store=store, snapshot_every=every,
            crashes=crashes,
        )
        lane = fs.cluster(int(cfg.get("lane", 0)))
        np.savez(cfg["out"], **{
            f: getattr(lane, f) for f in _SERIES_FIELDS
        })
    elif mode == "divergent":
        from .reconcile import DivergentDriver

        dd = DivergentDriver(
            m, _timeline(cfg, m), int(cfg.get("n_ranks", 2)),
            seed=seed, n_ops=n_ops, device=device,
        )
        res = dd.run(n_epochs, store=store, crashes=crashes)
        out = {
            "fingerprints": np.asarray(
                [r.fingerprints for r in res.rounds[-1:]], np.uint64
            ),
            "cur": np.asarray(dd.cur, np.int64),
            "converged": np.asarray([res.converged]),
        }
        for r, st in enumerate(res.states):
            for i, leaf in enumerate(state_lanes(st)):
                out[f"rank{r}_leaf{i:03d}"] = leaf
        np.savez(cfg["out"], **out)
    else:
        print(f"unknown mode {mode!r}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
