"""Erasure-code benchmark CLI.

Parity with the reference's ``ceph_erasure_code_benchmark``
(``src/test/erasure-code/ceph_erasure_code_benchmark.cc``): encode or
decode workloads per (plugin, technique, k, m, packetsize, size,
iterations), reporting seconds and throughput.

    python -m ceph_tpu_torch.cli.ec_bench --plugin jerasure \
        --workload encode --size 1048576 --iterations 10 \
        --parameter k=8 --parameter m=3

The codec runs on ``--device`` (``cuda`` by default, which needs a card;
``--device cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ec_bench")
    p.add_argument("--plugin", "-p", default="jerasure")
    p.add_argument("--workload", "-w", choices=["encode", "decode"], default="encode")
    p.add_argument("--size", "-s", type=int, default=1 << 20, help="object bytes")
    p.add_argument("--iterations", "-i", type=int, default=10)
    p.add_argument("--erasures", "-e", type=int, default=1)
    p.add_argument(
        "--parameter", "-P", action="append", default=[], metavar="K=V"
    )
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--device", default="cuda", help="device of the codec (cuda or cpu)")
    args = p.parse_args(argv)

    from ..ec import ErasureCodeError, create

    profile = {"plugin": args.plugin}
    for kv in args.parameter:
        k, v = kv.split("=", 1)
        profile[k] = v
    try:
        ec = create(profile, device=args.device)
    except ErasureCodeError as e:
        print(f"ec_bench: {e}", file=sys.stderr)
        return 1
    n = ec.get_chunk_count()
    rng = np.random.default_rng(0)
    obj = rng.integers(0, 256, args.size, dtype=np.uint8)

    encoded = ec.encode(set(range(n)), obj)  # warm (compile)
    chunk_size = len(encoded[0])

    if args.workload == "encode":
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            ec.encode(set(range(n)), obj)
        dt = time.perf_counter() - t0
        total = args.size * args.iterations
    else:
        erased = list(range(args.erasures))
        avail = {i: encoded[i] for i in range(n) if i not in erased}
        ec.decode(set(erased), avail, chunk_size)  # warm
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            ec.decode(set(erased), avail, chunk_size)
        dt = time.perf_counter() - t0
        total = args.size * args.iterations
    if args.verbose:
        print(
            f"plugin={args.plugin} profile={profile} chunk_size={chunk_size}",
            file=sys.stderr,
        )
    print(f"{dt:.6f}\t{total / dt / (1 << 20):.2f} MB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
