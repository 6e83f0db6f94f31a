"""Launch a small ``torch.distributed`` world of processes, for tests.

:func:`run_world` starts ``size`` processes (``python -m
ceph_tpu_torch.testing.world``), one a rank, joined through a
``file://`` store in a scratch directory.  Each rank sets one intra-op
thread (many test workers share the CPU), forms the group, builds its
:class:`~ceph_tpu_torch.parallel.mesh.Mesh` on ``device``, runs a list
of cases — ``("module:function", kwargs)``, each called as
``function(mesh, **kwargs)`` and returning something picklable — and
writes the results to a file the caller reads back.  The cases and
their inputs travel by pickle, so the caller builds seeded inputs once
and holds every rank's results against its own reference.

Every world has a wall-clock limit: when it expires, every rank still
running is killed and :class:`WorldTimeout` is raised, so a hung
collective can never outlast its test.  The group's own timeout
(``collective_timeout_s``) fails a collective whose peer died first.
A rank that raises writes its traceback instead of results, and
:class:`WorldError` carries it.

The same runner serves ``python -m ceph_tpu_torch.testing.world`` under
``torchrun`` (it reads ``RANK``/``WORLD_SIZE`` then), e.g.
``torchrun --nproc-per-node 2 -m ceph_tpu_torch.testing.world --cases
cases.pkl --out DIR --device cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class WorldTimeout(RuntimeError):
    """A world outlived its wall-clock limit; its ranks were killed."""


class WorldError(RuntimeError):
    """A rank of a world failed; carries the failing ranks' reports."""


def run_world(size: int, cases, workdir: str, *, timeout_s: float = 120.0,
              device: str = "cuda", collective_timeout_s: float = 60.0,
              pythonpath=()) -> list:
    """Run ``cases`` on every rank of a ``size``-process world.

    Returns ``results[rank][i]``, case ``i``'s return value on ``rank``.
    The ranks run on ``device`` (the card unless asked for the CPU:
    NCCL, one card a rank; gloo on ``"cpu"``) and import the port from
    this checkout (and the cases' modules from ``pythonpath`` too).
    Raises :class:`WorldTimeout` (every rank killed) past ``timeout_s``
    and :class:`WorldError` when a rank fails."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    for stale in ["store"] + [f"rank{r}.pkl" for r in range(size)]:
        if os.path.exists(os.path.join(workdir, stale)):
            os.remove(os.path.join(workdir, stale))
    cases_path = os.path.join(workdir, "cases.pkl")
    with open(cases_path, "wb") as f:
        pickle.dump(list(cases), f)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE",
                                                           "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=os.pathsep.join([REPO, *pythonpath]), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(size):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.testing.world",
             "--rank", str(rank), "--size", str(size), "--store", store,
             "--cases", cases_path, "--out", workdir, "--device", device,
             "--collective-timeout", str(collective_timeout_s)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise WorldTimeout(f"a {size}-rank world outlived its {timeout_s:g} s limit; "
                                   "every rank was killed")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    results, failed = [], []
    for rank, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{rank}.pkl")
        payload = None
        if os.path.exists(path):
            with open(path, "rb") as f:
                payload = pickle.load(f)
        if p.returncode != 0 or payload is None or "error" in payload:
            with open(os.path.join(workdir, f"rank{rank}.log")) as f:
                tail = f.read()[-4000:]
            err = payload.get("error") if payload else None
            failed.append(f"rank {rank} (exit {p.returncode}): {err or tail}")
        else:
            results.append(payload["results"])
    if failed:
        raise WorldError("\n".join(failed))
    return results


def _resolve(spec: str):
    module, name = spec.split(":")
    return getattr(importlib.import_module(module), name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="world")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--store", default=None, help="file:// store path (default: env://)")
    p.add_argument("--cases", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--collective-timeout", type=float, default=60.0)
    args = p.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from datetime import timedelta

    from ceph_tpu_torch.parallel import multihost
    from ceph_tpu_torch.parallel.mesh import make_mesh

    rank = args.rank if args.rank is not None else int(os.environ["RANK"])
    out = os.path.join(args.out, f"rank{rank}.pkl")
    try:
        multihost.init(f"file://{args.store}" if args.store else None,
                       world_size=args.size, rank=rank, device=args.device,
                       timeout=timedelta(seconds=args.collective_timeout))
        mesh = make_mesh(device=args.device)
        with open(args.cases, "rb") as f:
            cases = pickle.load(f)
        results = [_resolve(spec)(mesh, **kwargs) for spec, kwargs in cases]
        payload = {"results": results}
        code = 0
    except BaseException:  # a rank reports its failure, then exits non-zero
        payload = {"error": traceback.format_exc()}
        code = 1
    with open(out + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(out + ".tmp", out)
    if code == 0:
        multihost.shutdown()
    return code


if __name__ == "__main__":
    sys.exit(main())
