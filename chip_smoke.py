"""Drive ceph_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. build: compile the CUDA kernels from ``ceph_tpu_torch/csrc/`` with
   nvcc (sm_90a, one nvcc per source, all at once) and print the build
   seconds, the card, every kernel's registers and spills, and each
   straw2 kernel's instructions per draw in the SASS, split by pipe
   (ALU, FMA, memory, other);
2. kernels: hold K1 (negdraw), K2 (level_choose) and K3 (descend_fused)
   against their plain PyTorch versions on the card, bit for bit, at the
   slice's shapes (1M lanes, build_simple(1024) tables), time both, and
   give each its pipe floor; then K1 and K3 on their edges (fanout 1, 5,
   33, zero weights mid-row, weights 1 and 0xFFFFFFFF, rows off a
   16-byte boundary, 4099 rows, K3's global-memory tables and
   ``empty_is_hard`` both ways), bit for bit;
3. ec_kernels: the same for K4 (matrix_encode: k=8 m=3 and k=4 m=2 over
   32 MiB chunks), K5 (bitmatrix_encode: cauchy_good k=8 m=3 w=8,
   packetsize 2048, over the same, and that code's 64-row decoder with
   data chunks 0 and 1 lost) and K7 (byte_lut: one CLAY repair
   transform, 32 MiB, and the CLAY encode's, 64 MiB; beside the
   ``torch.take`` call), plus each kernel's edge shapes (ragged
   lengths, K4 at (4, 2, 4100), (5, 1, 131), its global-memory tables
   (k=128 m=8), empty data and data 1 byte past a 16-byte boundary, K5
   at w = 6, 7 and 32, its 64- and 128-row decoders, 256 input rows,
   packets of 3, 8 and 48 bytes, data 1 and 4 bytes past a 16-byte
   boundary, K7 at 16 n + 3 bytes, 7 bytes and unaligned), bit for bit;
   K4-K7 carry ptxas's registers and spills;
4. crush: ``make_batch_runner`` on build_simple(1024)'s replicated rule
   (3 replicas), 1M objects, in each mode; bit-equal across them and to
   the C++ reference tier on a 50k sample; placements/s for each (timed
   in turns, median of 6 calls each), and a torch.profiler
   breakdown of one call each; two rules whose choose step has an
   effective numrep <= 0 place nothing, equal to the C++ tier, in
   ``descend`` mode (run before the path's launch counts start);
5. osdmap: ``OSDMapMapping.update`` on build_osdmap(1024, pg_num=32768)
   with upmap items, a full pg_upmap, pg_temp, primary affinity and one
   OSD down; a sample of PGs must equal the scalar pipeline;
5a. general: the general engine (``crush/interp.py``) on 1M objects of
   (a) a uniform 1024-OSD hierarchy (32 racks, 8 hosts, 4 OSDs) under
   its replicated rule and (b) the same shape with straw2 root and racks
   over uniform hosts, 32 OSDs out, under a replicated and an EC rule
   (6 slots): the router's tier, host syncs and K1 launches per call
   (K1 > 0 on (b)), placements/s with the compacted-straggler rounds it
   runs at this size and with masked ones (:func:`masked_rounds`; in
   turns, median of 6 each; equal results), 65,536 placements each way
   equal to the C++ tier;
5b. rebalance: BASELINE config 5, ``parallel/placement.py::
   sharded_rebalance_sim`` on build_simple(10000, 8 OSDs a host, 16
   hosts a rack) with 100 OSDs out: 12 launches of 8 chunks of 2^20
   objects (100,663,296): placements/s, moved fraction beside the
   ideal 3.0%, K3 launches, host syncs and peak memory; 65,536 objects
   at the start of the first and of the last launch placed and counted
   as the C++ tier does;
6. ec_encode: jerasure reed_sol_van k=8 m=3 (BASELINE's headline) and
   k=4 m=2 (BASELINE config 2) with a 4 KiB stripe unit, and
   cauchy_good k=8 m=3 packetsize 2048 (K5; a 64 KiB stripe unit, its
   alignment), on a batch of 64 objects of 4 MiB (256 MiB of data per
   call): data GB/s device-resident (``encode_async``) and through
   ``stripe.encode_object`` for one 4 MiB object (host copies
   included); parity equal to the C++ tier on 4 MiB of columns
   (``cppref.bitmatrix_encode`` for the packet layout);
7. ec_decode: the three codes with m chunks erased (data chunks first),
   decoded through ``ec.decode`` and device-resident; bit-equal to the
   data; GB/s;
8. ec_plugins: the 15 profiles of ``nonregression.ec_cases`` built on
   the card reproduce every ``"ec"`` digest of
   ``tests/golden/archive.json``; a CLAY k=4 m=2 (d=5) repair of one
   chunk of a 64 MiB object, bit-equal to the lost chunk; an LRC
   k=4 m=2 l=3 decode of one lost chunk;
9. schedule_kernel: K6 (schedule_apply) against its plain version at
   the main shape (the repair schedule of cauchy_good k=8 m=3 w=8
   p=2048 with chunks {0, 8} lost, over [8, 32 MiB]), timed beside K5
   on the same repair, and on its edges (a w = 32 schedule on the
   global-memory path, NW = 1,000,003 and 100, words 4 bytes past a
   16-byte boundary, packet sizes 3 and 5, the bit-plane layout at S =
   131, S = 0), bit for bit, with the program's op, level, group and
   work-slot counts and its launch shape;
9a. scrub_kernel: K8 (crc32c_rows, ``csrc/scrub.cu``) against its plain
   version at a scrub pass of the supervised store (8192 x 11 rows of 32
   KiB: a warp a row) and at one decode-verify group (32 rows of 32 KiB:
   a block a row), each timed with its bound and its cut (lanes a row,
   segment bytes), with ptxas's registers, spills and shared memory and
   the fold loop's instructions a byte by pipe (``testing/sass.py``), and
   on its edges (SCRUB_EDGES: L = 0, below 16, one below, at and above
   each timed shape's segment and twice it, rows 1-15 bytes past a
   16-byte boundary across segments, one row of 64 MiB held against the
   plain version on its 32 KiB pieces combined on the host, more rows
   than one grid covers, the check value 0xE3069283), bit for bit;
10. recovery: ``recover_pool`` for ``rack:0:down_out`` on
   build_osdmap(1024, pg_num=8192, size=11, erasure) with 32 KiB
   chunks, for jerasure reed_sol_van k=8 m=3 under ``auto`` (K4) and
   ``recovery_xor_schedule=on`` (K6, bit-plane) and cauchy_good k=8
   m=3 p=2048 under ``auto`` (K6, packet): every rebuilt shard equals
   the stored one, one launch per pattern, the peering equals a numpy
   classification; timed (median of 3) and profiled;
10a. supervised: ``SupervisedRecovery`` on the same map and RS k=8 m=3
   with every shard of the pool stored (32 KiB each): mid-repair-loss,
   scrub-storm (a ``Scrubber`` riding the loop, ``write_shard`` writing
   repairs back) and flapping-osd (0.5 s heartbeat grace), each with an
   EventJournal, a HealthTimeline graded by an SLO and an OpTracker on
   the virtual clock, each counted from 0 (launches, host syncs by
   torch's sync-debug warnings, wall seconds) and gated (converged,
   every rebuilt shard equal to the store, the unrecoverable PGs exactly
   those left below k, every corruption found and a clean closing scrub,
   a detection); the [rows, L] of every K8 launch of the three passes
   (min, median, max, count by shape);
   then config 6's traffic pass (``traffic``: mid-repair-loss with a
   ``TrafficEngine`` of 65,536 ops a step riding every health sample,
   then a 40x overload over 10 one-second steps on the converged map)
   and its scrub pass (``scrub_qos``: scrub-storm with a ``Scrubber``, an
   engine of 16,384 ops a step and its integrity loop), each run without
   and with config 6's mclock arbiter (the scrub pass's with three
   classes), each pass counted from 0 and gated (both runs converged,
   rebuilt bytes and the same unrecoverable PGs in both, rebuilt shards
   equal to the store, every
   sample's ops accounted for; the arbiter's lower recovery-phase p99,
   client grants of 64 bytes an op, recovery grants covering the bytes
   rebuilt, OK -> WARN -> OK across the overload; the scrub gates, the
   client p99 under scrub load within its SLO, the integrity loop's
   checksummed writes and verified degraded reads), and one ``observe``
   measured alone (kernel launches, host syncs, CUDA-event ms);
   scrub-storm, flapping-osd and the traffic pass at 128 PGs on the card
   and the CPU with equal ``summary()`` (the traffic pass: equal samples
   and histograms, ``mean_ms`` within ``TRAFFIC_REPLAY_RTOL``);
10b. epoch: the epoch loop (``recovery/superstep.py::EpochDriver``) at
   BASELINE config 7 (build_osdmap(1024, pg_num=8192, size=6, erasure),
   two slow OSDs, 64 ops a step): 1024 superstep epochs in chunks of 256
   and 128 staged epochs, epochs/s and host syncs an epoch each (at most
   one on a quiet superstep epoch, the chunk copies apart); a
   rack-cascade walk on the same map with compaction auto and off, each
   through both paths (the four series bit-equal, K3 launched, the rungs
   taken); the staged series over one chunk equal to the superstep's;
   launches an epoch by piece (tape, liveness, peering, traffic, scrub,
   row) from torch.profiler spans over 8 config-7 epochs and the walk's
   first three dirty epochs, host ms an epoch by piece and the two paths'
   rates in turns over 128 config-7 epochs each; the walk at 64 OSDs and
   128 PGs equal on the card and the CPU, every lane;
11. balancer: BASELINE config 3 — five bulk remaps of
   build_osdmap(1024, pg_num=10240), one reweight toggled before each
   (PG mappings/s); the upmap balancer (max_deviation 1.0, 2000
   entries a plan) on build_skewed_osdmap(1024, pg_num=10240) until a
   plan is empty, per plan its entries, seconds, rounds, launches, the
   device scorer's ms by CUDA events and the remaps' seconds; the
   final table's SHA-256 equal to the reference's
   (``testing/golden.py``), converged, the first plan equal to each
   scorer's (device and numpy, both timed), a profiled first
   ``optimize()``; one crush-compat
   tick, not worse; each map's mapping against the scalar pipeline on
   256 PGs;
12. cli: crushtool ``--test --show-statistics --show-mappings`` over
   65536 x on build_simple(1024) on the card, equal to ``--cpu``;
   osdmaptool ``--createsimple 1024 --pg-num 10240``,
   ``--test-map-pgs`` and ``--upmap`` (2000 entries), whose command
   file must hold ``calc_pg_upmaps``'s plan for the saved map (the
   file's text is held to the reference's in ``tests/test_torch_cli.py``);
   ec_bench for reed_sol_van and cauchy_good (packetsize 2048) k=8 m=3,
   and one object of its size encoded on the card equal to the CPU's.

Then the launch counts of each main path (phases 4-5: placement; 5a:
general; 5b: rebalance; 6-8: EC; 10: recovery; 10a: supervised,
traffic and scrub_qos; 10b: epoch; 11: balancer; 12: cli, each from 0),
each phase's wall seconds, the kernels
line (each kernel's
launches summed over the paths; every kernel must launch on its paths,
K1 on the general path, K3 on the rebalance path, K6 on the recovery
path, K3, K4 and K8 on the supervised and scrub_qos paths, K3 and K4
on the traffic path, K3 on the epoch and balancer paths),
the card's name and power limit, and
the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
REPLICAS = 3
OBJECTS = 1 << 20

# Instructions of one straw2 draw as nvcc compiled the port's first
# csrc/straw2.cu for sm_90a, counted in its K1's SASS: the hash's 5 mixes
# at 3 instructions a line, then crush_ln, the 64x64 high multiply and
# its corrections.  K1-K3's bound_ms divides it by the issue rate and
# stays the kernels' fixed yardstick; the build phase splits each
# kernel's draw as compiled now by pipe (ceph_tpu_torch/testing/sass.py),
# and the kernels phase gives each its pipe floor from that split.
OPS_PER_DRAW = 197
ISSUE_LANES_PER_SM = 128  # 4 schedulers x one 32-lane warp instruction a clock
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)

MIB = 1 << 20
EC_OBJECTS = 64                # objects per encode call
EC_OBJECT_BYTES = 4 * MIB      # RBD/RGW default object size
EC_STRIPE_UNIT = 4096          # Ceph's default EC stripe unit (chunk per stripe)
# name -> (profile, stripe unit); cauchy_good (K5) aligns a stripe to
# k*w*packetsize*4 bytes, so its chunk per stripe is 64 KiB
EC_CODES = {
    "rs_8_3": ({"plugin": "jerasure", "technique": "reed_sol_van", "k": "8", "m": "3"},
               EC_STRIPE_UNIT),
    "rs_4_2": ({"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2"},
               EC_STRIPE_UNIT),
    "cauchy_8_3": ({"plugin": "jerasure", "technique": "cauchy_good", "k": "8", "m": "3",
                    "packetsize": "2048"}, 64 * 1024),
}
# nonregression.ec_cases' profiles and object, restated (tests/golden/archive.json "ec")
GOLDEN_EC = {
    "jerasure_rs_4_2": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2"},
    "jerasure_rs_8_3": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8", "m": "3"},
    "jerasure_r6_4_2": {"plugin": "jerasure", "technique": "reed_sol_r6_op", "k": "4", "m": "2"},
    "jerasure_cauchy_4_2_p8": {"plugin": "jerasure", "technique": "cauchy_good", "k": "4",
                               "m": "2", "packetsize": "8"},
    "lrc_4_2_3": {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
    "shec_4_3_2": {"plugin": "shec", "k": "4", "m": "3", "c": "2"},
    "clay_4_2": {"plugin": "clay", "k": "4", "m": "2"},
    "clay_4_3_d5": {"plugin": "clay", "k": "4", "m": "3", "d": "5"},
    "clay_4_3_d4": {"plugin": "clay", "k": "4", "m": "3", "d": "4"},
    "jerasure_liberation_4_2_w7": {"plugin": "jerasure", "technique": "liberation", "k": "4",
                                   "m": "2", "w": "7", "packetsize": "8"},
    "jerasure_blaum_roth_4_2_w6": {"plugin": "jerasure", "technique": "blaum_roth", "k": "4",
                                   "m": "2", "w": "6", "packetsize": "8"},
    "jerasure_liber8tion_4_2": {"plugin": "jerasure", "technique": "liber8tion", "k": "4",
                                "m": "2", "packetsize": "8"},
    "jerasure_rs_4_2_w16": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
                            "m": "2", "w": "16"},
    "jerasure_rs_4_2_w32": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
                            "m": "2", "w": "32"},
    "jerasure_cauchy_4_2_w16_p8": {"plugin": "jerasure", "technique": "cauchy_good", "k": "4",
                                   "m": "2", "w": "16", "packetsize": "8"},
}


# phase recovery: a 1024-OSD EC pool and one rack (8 hosts, 32 OSDs) lost
RECOVERY_OSDS = 1024
RECOVERY_PGS = 8192            # Ceph's PG calculator: ~100 PGs per OSD at size 11
RECOVERY_FAILURE = "rack:0:down_out"
RECOVERY_CHUNK = 32 * 1024     # a PG's share cut to one 256 KiB object (k=8)
RECOVERY_CODES = {
    "rs_8_3_auto": ({"plugin": "jerasure", "technique": "reed_sol_van", "k": "8", "m": "3"},
                    "auto"),
    "rs_8_3_on": ({"plugin": "jerasure", "technique": "reed_sol_van", "k": "8", "m": "3"}, "on"),
    "cauchy_good_8_3_auto": ({"plugin": "jerasure", "technique": "cauchy_good", "k": "8",
                              "m": "3", "packetsize": "2048"}, "auto"),
}

# phase balancer: BASELINE config 3, the mgr balancer's upmap optimizer on
# a 10k-PG pool of a 1024-OSD map, to convergence
BALANCER_OSDS = 1024
BALANCER_PGS = 10240
BALANCER_MAX_DEVIATION = 1.0
BALANCER_MAX_OPTIMIZATIONS = 2000
BALANCER_REMAPS = 5            # bulk remaps, each after one reweight toggle
SCALAR_SAMPLE = 256            # PGs held against the scalar pipeline


#: wall seconds from the end of the previous phase's line to the end of each
#: phase's own (build: from the start of main)
PHASE_WALLS: dict = {}
T_START = time.perf_counter()
_LAST_EMIT = [T_START]


def emit(obj) -> None:
    if "phase" in obj:
        now = time.perf_counter()
        PHASE_WALLS[obj["phase"]] = now - _LAST_EMIT[0]
        _LAST_EMIT[0] = now
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def int32_ops_per_s() -> float:
    """The card's peak rate for 32-bit integer operations: SMs x 128
    lanes x max SM clock, the instruction issue limit.  It is the
    67 TFLOP/s float32 rate of the H100 data sheet with one FMA counted
    as one operation; integer adds, logic and multiply-adds issue no
    faster (half of them, on Hopper, only through the float pipes)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * ISSUE_LANES_PER_SM * mhz * 1e6


def bound_ms(nbytes: float, ops: float, int_rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_name(mangled: str) -> str:
    """``gf_matrix_kernel<1>`` from ``_ZN<len><namespace><len>gf_matrix_kernelILb1EE...``:
    the last nested name, with its integer and bool template arguments."""
    pos, name = 3, mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group(0)
        name = mangled[pos + len(n):pos + len(n) + int(n)]
        pos += len(n) + int(n)
    args = re.match(r"I((?:L[bi]\d+E)+)E", mangled[pos:])
    if args:
        name += "<" + ",".join(re.findall(r"L[bi](\d+)E", args.group(1))) + ">"
    return name


def ptxas_report(lib: str) -> dict:
    """Registers and spill bytes of every kernel in ``lib``, from the
    ptxas report the build kept."""
    from ceph_tpu_torch import _cuda

    out, name = {}, None
    with open(os.path.join(_cuda.BUILD_DIR, f"{lib}.ptxas.txt")) as f:
        for ln in f:
            if "Compiling entry function" in ln:
                name = kernel_name(ln.split("'")[1])
            elif name and "spill stores" in ln:
                st, ld = re.findall(r"(\d+) bytes spill", ln)
                out.setdefault(name, {}).update(spill_stores=int(st), spill_loads=int(ld))
            elif name and "Used" in ln and "registers" in ln:
                out.setdefault(name, {})["registers"] = int(
                    re.search(r"Used (\d+) registers", ln).group(1))
                smem = re.search(r"(\d+) bytes smem", ln)
                out[name]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def time_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, int]:
    """(bit-equal, max abs error) of two integer tensors."""
    equal = got.dtype == want.dtype and got.shape == want.shape and bool(torch.equal(got, want))
    if got.shape != want.shape or got.numel() == 0:
        return equal, 0 if equal else -1
    return equal, int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def kernel_record(name: str, replaces: str, kernel, plain, nbytes: int, ops: int,
                  int_rate: float, library=None) -> dict:
    """Run ``kernel`` and ``plain`` on the same card inputs, compare them
    bit for bit, time both (and ``library``, one PyTorch call of the
    same function, where there is one), and bound the kernel by bytes
    and operations."""
    got, want = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    checks = [compare(a, b) for a, b in zip(got, want)]
    bms, by = bound_ms(nbytes, ops, int_rate)
    return {"name": name, "replaces": replaces, "bit_equal": all(c[0] for c in checks),
            "max_abs_err": max(c[1] for c in checks), "ms": time_ms(kernel),
            "plain_ms": time_ms(plain, 3), "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "ops": ops,
            "library_ms": time_ms(library) if library is not None else None}


def pipe_floor_ms(draws: int, split: dict, int_rate: float) -> float:
    """The floor of a draw-bound kernel's integer pipes: its draws times
    the larger of its ALU and FMA instructions per draw (its SASS split)
    over SMs x 64 lanes x max SM clock (each pipe's rate on sm_90, half
    ``int_rate``)."""
    return draws * max(split["alu"], split["fma"]) / (int_rate / 2) * 1e3


def phase_kernels(n: int, int_rate: float, dev, splits: dict) -> dict:
    """K1-K3 vs their plain versions at the main path's shapes: n lanes
    on build_simple(1024)'s descent tables (root 1x32, racks 32x8,
    hosts 256x4), each with its pipe floor from ``splits`` (the build's
    per-draw SASS split); then K1 and K3 on their edges
    (``testing/straw2_edges.py``), compared only."""
    from ceph_tpu_torch.core import straw2
    from ceph_tpu_torch.crush import interp_batch
    from ceph_tpu_torch.models.clusters import build_simple
    from ceph_tpu_torch.testing import straw2_edges

    dense = build_simple(1024).to_dense()
    stop = interp_batch._stop_buckets(dense, [0], 3)
    pack, _ = interp_batch.build_pack(dense, [0], 3, {b: i for i, b in enumerate(stop)}, dev)
    leaf, _ = interp_batch.build_pack(dense, stop, 0, {}, dev)
    table_bytes = pack.ids.numel() * 20 + pack.size.numel() * 4

    g = torch.Generator(device="cpu").manual_seed(SEED)
    rnd = lambda lo, hi: torch.randint(lo, hi, (n,), generator=g, dtype=torch.int64)
    x = rnd(0, 1 << 32).to(torch.int32).to(dev)  # wraps to the u32 bit pattern
    r = rnd(0, 8).to(torch.int32).to(dev)
    lidx = torch.zeros(n, dtype=torch.int32, device=dev)  # every lane at the root
    active = torch.ones(n, dtype=torch.bool, device=dev)

    # K1 at the draw mode's widest level: the root row for every lane, [n, 32]
    rows = [t.index_select(0, lidx.to(torch.int64)) for t in pack.level(0)[:3]]
    k1 = kernel_record("negdraw", "ceph_tpu/core/pallas_straw2.py:273",
                       lambda: straw2.negdraw(x, r, *rows),
                       lambda: straw2.negdraw_plain(x, r, *rows),
                       n * 8 + rows[0].numel() * (4 + 4 + 8 + 8),
                       int((rows[1] != 0).sum()) * OPS_PER_DRAW, int_rate)
    k1["pipe_floor_ms"] = pipe_floor_ms(rows[0].numel(), splits["straw2_negdraw_kernel"],
                                        int_rate)
    # K2 at the same level: row fetch, draws and argmin in one launch
    fanout = pack.meta[0][1]
    k2 = kernel_record("level_choose", "ceph_tpu/core/pallas_straw2.py:384",
                       lambda: straw2.level_choose(x, r, lidx, pack, 0),
                       lambda: straw2.level_choose_plain(x, r, lidx, pack, 0),
                       n * (3 * 4 + 4 * 4) + table_bytes, n * fanout * OPS_PER_DRAW, int_rate)
    k2["pipe_floor_ms"] = pipe_floor_ms(n * fanout, splits["straw2_level_kernel"], int_rate)
    # K3: the rule's descent root -> rack -> host for every lane
    draws = count_descend_draws(x, r, lidx, active, pack, 3, 1024)
    k3 = kernel_record("descend", "ceph_tpu/core/pallas_straw2.py:603",
                       lambda: straw2.descend_fused(x, r, lidx, active, pack, 3, False, 1024),
                       lambda: straw2.descend_plain(x, r, lidx, active, pack, 3, False, 1024),
                       n * (3 * 4 + 1 + 2 * 4 + 2) + table_bytes, draws * OPS_PER_DRAW,
                       int_rate)
    k3["pipe_floor_ms"] = pipe_floor_ms(draws, splits["straw2_descend_kernel"], int_rate)
    # and the leaf descent host -> osd from the hosts the lanes reached
    item, ok, hard, nl = straw2.descend_fused(x, r, lidx, active, pack, 3, False, 1024)
    k3["bit_equal"] = k3["bit_equal"] and all(
        bool(torch.equal(a, b)) for a, b in zip(
            straw2.descend_fused(x, r, nl, ok, leaf, 0, False, 1024),
            straw2.descend_plain(x, r, nl, ok, leaf, 0, False, 1024)))
    edges = []
    for label, args in straw2_edges.negdraw_edges(dev):
        equal, err = compare(straw2.negdraw(*args), straw2.negdraw_plain(*args))
        edges.append({"case": label, "bit_equal": equal, "max_abs_err": err})
    for label, args in straw2_edges.descend_edges(dev):
        checks = [compare(a, b) for a, b in zip(straw2.descend_fused(*args),
                                                straw2.descend_plain(*args))]
        edges.append({"case": label, "bit_equal": all(c[0] for c in checks),
                      "max_abs_err": max(c[1] for c in checks)})
    torch.cuda.synchronize()
    return {"results": [k1, k2, k3], "edges": edges}


def count_descend_draws(x, r, lidx0, active, tb, target_type, max_devices) -> int:
    """Draws the descent of these inputs needs: for each lane, the live
    slots of every row it visits before it is done (the level loop of
    straw2.descend_levels replayed on the plain version)."""
    from ceph_tpu_torch.core import straw2

    draws = 0
    done = ~active
    lidx = lidx0
    for lv in range(tb.n_levels):
        li = torch.where(done, torch.zeros_like(lidx), lidx)
        chosen, ctype, nlidx, size = straw2.level_choose_plain(x, r, li, tb, lv)
        draws += int(size.clamp(1, tb.meta[lv][1])[~done].sum())
        is_bucket = chosen < 0
        reached = (ctype == target_type) if target_type != 0 else ~is_bucket
        bad = ((~is_bucket & ~reached) | (~is_bucket & (chosen >= max_devices))
               | (is_bucket & (ctype == straw2.CTYPE_DANGLING)))
        # hard or soft, a lane stops on an empty row or a bad child
        new_done = done | (size == 0) | bad | reached
        lidx = torch.where(new_done, lidx, nlidx.to(lidx.dtype))
        done = new_done
    return draws


def card_bytes(shape, seed: int, dev) -> torch.Tensor:
    """Random u8 tensor made on the card from a seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)


def phase_ec_kernels(int_rate: float, dev) -> dict:
    """K4, K5 and K7 vs their plain versions at the main path's shapes,
    timed, and on their edge shapes, compared only."""
    from ceph_tpu_torch.ec import gf, gf_kernels, gfw, kernels

    S = EC_OBJECTS * EC_OBJECT_BYTES // 8  # one chunk stream of the k=8 batch
    results, edges = [], []
    for k, m in ((8, 3), (4, 2)):
        M = gf.vandermonde_matrix(k, m)
        tables, nibbles = gf_kernels.mul_tables(M, dev), gf_kernels.nibble_tables(M, dev)
        data = card_bytes((k, S), SEED + k, dev)
        rec = kernel_record(
            "matrix_encode", "ceph_tpu/ec/pallas_gf.py:162",
            lambda: gf_kernels.matrix_encode(tables, data, nibbles),
            lambda: gf_kernels.matrix_encode_plain(tables, data),
            (k + m) * S + m * k * 32, m * k * S + m * (k - 1) * S // 4, int_rate)
        rec["shape"] = f"k={k} m={m} S={S}"
        results.append(rec)
        del data
    bits = gf.matrix_to_bitmatrix(gf.cauchy_good_matrix(8, 3))
    bm = kernels.Bitmatrix(bits, 8, dev)
    data = card_bytes((8, S), SEED + 5, dev)
    rec = kernel_record(
        "bitmatrix_encode", "ceph_tpu/ec/pallas_kernels.py:94",
        lambda: kernels.bitmatrix_encode(bm, data, 2048),
        lambda: kernels.bitmatrix_encode_plain(bm, data, 2048),
        (8 + 3) * S + bm.prog.numel() * 4, int(bits.sum()) * (S // 8 // 4), int_rate)
    rec["shape"] = f"cauchy_good k=8 m=3 w=8 p=2048 S={S}"
    results.append(rec)
    # the decoder of the same code with data chunks 0 and 1 lost, as
    # MatrixCodec builds it: 64 rows, 48 of them copies
    gen = np.vstack([np.eye(8, dtype=np.uint8), gf.cauchy_good_matrix(8, 3)])
    dec_bits = gf.matrix_to_bitmatrix(gf.invert_matrix(gen[2:10]))
    dm = kernels.Bitmatrix(dec_bits, 8, dev)
    rec = kernel_record(
        "bitmatrix_encode", "ceph_tpu/ec/pallas_kernels.py:94",
        lambda: kernels.bitmatrix_encode(dm, data, 2048),
        lambda: kernels.bitmatrix_encode_plain(dm, data, 2048),
        (8 + 8) * S + dm.prog.numel() * 4, int(dec_bits.sum()) * (S // 8 // 4), int_rate)
    rec["shape"] = f"cauchy_good k=8 m=3 decoder, chunks (0, 1) lost, 64 rows, p=2048 S={S}"
    results.append(rec)
    del data
    table = torch.from_numpy(gf.mul_table()[gf.gf_inv(1 ^ gf.gf_mul(2, 2))].copy()).to(dev)
    for label, shape in (("CLAY k=4 m=2 repair transform", (4, 4, 2 * MIB)),
                         ("CLAY k=4 m=2 encode transform", (4, 8, 2 * MIB))):
        x = card_bytes(shape, SEED + 7, dev)
        n = x.numel()
        rec = kernel_record(
            "byte_lut", "ceph_tpu/ec/pallas_gf.py:94",
            lambda: gf_kernels.byte_lut(x, table),
            lambda: gf_kernels.byte_lut_plain(x, table), 2 * n + 256, n, int_rate,
            library=lambda: torch.take(table, x.long()))
        rec["shape"] = f"{label} {list(shape)} ({n} bytes)"
        results.append(rec)
        del x

    def edge(label, got, want):
        equal, err = compare(got, want)
        edges.append({"case": label, "bit_equal": equal, "max_abs_err": err})

    for k, m, size in ((8, 3, 1_000_003), (4, 2, 4100), (5, 1, 131), (128, 8, 1 << 20),
                       (3, 2, 0), (8, 3, -4099)):
        M = gf.vandermonde_matrix(k, m)
        tables, nibbles = gf_kernels.mul_tables(M, dev), gf_kernels.nibble_tables(M, dev)
        data = card_bytes((k, abs(size)), SEED + abs(size), dev)
        label = f"matrix_encode k={k} m={m} S={abs(size)}"
        if size < 0:  # data 1 byte past a 16-byte boundary
            data = card_bytes((k * -size + 1,), SEED, dev)[1:].view(k, -size)
            label += " unaligned data"
        path = "shared" if gf_kernels.tables_staged(m, k) else "global"
        edge(f"{label} tables={path}", gf_kernels.matrix_encode(tables, data, nibbles),
             gf_kernels.matrix_encode_plain(tables, data))
    rs32 = gfw.matrix_to_bitmatrix(gfw.vandermonde_matrix(4, 2, 32), 32)
    gen = np.vstack([np.eye(128, dtype=np.uint8), rs32])
    dec32 = gf.invert_bitmatrix(np.vstack([gen[r * 32:(r + 1) * 32] for r in (1, 3, 4, 5)]))
    cauchy = gf.matrix_to_bitmatrix(gf.cauchy_good_matrix(8, 3))
    w8 = gfw.matrix_to_bitmatrix(gfw.vandermonde_matrix(8, 3, 32), 32)
    # (label, bitmatrix, w, p, data offset past a 16-byte boundary)
    for label, bits, w, p, off in (
            ("liberation k=4 w=7 p=8", gfw.liberation_bitmatrix(4, 7), 7, 8, 0),
            ("liberation k=4 w=7 p=48 (tiles end mid-packet)", gfw.liberation_bitmatrix(4, 7),
             7, 48, 0),
            ("blaum_roth k=4 w=6 p=8", gfw.blaum_roth_bitmatrix(4, 6), 6, 8, 0),
            ("reed_sol_van k=4 m=2 w=32 p=4", rs32, 32, 4, 0),
            ("reed_sol_van k=8 m=3 w=32 p=16 (256 input rows: global)", w8, 32, 16, 0),
            ("w=32 decoder (128 rows) p=4", dec32, 32, 4, 0),
            ("w=32 decoder (128 rows) p=16 (staged)", dec32, 32, 16, 0),
            ("cauchy_good k=8 m=3 w=8 p=3", cauchy, 8, 3, 0),
            ("cauchy_good decoder (64 rows) p=3", dec_bits, 8, 3, 0),
            ("cauchy_good k=8 m=3 w=8 p=2048, data 1 byte past", cauchy, 8, 2048, 1),
            ("cauchy_good k=8 m=3 w=8 p=2048, data 4 bytes past", cauchy, 8, 2048, 4)):
        op = kernels.Bitmatrix(bits, w, dev)
        k, size = bits.shape[1] // w, w * p * 4099
        data = card_bytes((k * size + off,), SEED + w + p, dev)[off:].view(k, size)
        edge(f"bitmatrix_encode {label}", kernels.bitmatrix_encode(op, data, p),
             kernels.bitmatrix_encode_plain(op, data, p))
    for n, off in ((64 * MIB + 3, 0), (7, 0), (16 * 4099 + 3, 1), (16 * 4099 + 3, 4)):
        x = card_bytes((n + off,), SEED + 3, dev)[off:]
        edge(f"byte_lut n={n}" + (f", {off} bytes past a 16-byte boundary" if off else ""),
             gf_kernels.byte_lut(x, table), gf_kernels.byte_lut_plain(x, table))
    torch.cuda.synchronize()
    return {"phase": "ec_kernels", "results": results, "edges": edges}


def repair_bitmatrix(gen_bits: np.ndarray, w: int, k: int, size: int, missing) -> np.ndarray:
    """The planner's repair bitmatrix: the lost chunks' generator rows
    times the inverse of the first k survivors'."""
    from ceph_tpu_torch.ec import gf

    rows = [s for s in range(size) if s not in missing][:k]
    sub = np.vstack([gen_bits[r * w:(r + 1) * w] for r in rows])
    need = np.vstack([gen_bits[s * w:(s + 1) * w] for s in missing])
    return gf.bitmatrix_multiply(need, gf.invert_bitmatrix(sub))


def phase_schedule_kernel(int_rate: float, dev) -> dict:
    """K6 vs its plain version at the main path's shape, timed beside K5
    on the same repair, and on its edges, compared only."""
    from ceph_tpu_torch.ec import gf, gfw, kernels, schedule

    S = EC_OBJECTS * EC_OBJECT_BYTES // 8
    gen = np.vstack([np.eye(64, dtype=np.uint8),
                     gf.matrix_to_bitmatrix(gf.cauchy_good_matrix(8, 3))])
    repair = repair_bitmatrix(gen, 8, 8, 11, (0, 8))
    sched = schedule.compile_schedule(repair)
    table = kernels.StepTable(sched.steps, sched.n_bufs, dev, sched.n_in, sched.n_out)
    prog = table.program(sched.n_in, sched.n_out)
    data = card_bytes((8, S), SEED + 6, dev)
    words = schedule.pack_packet_rows_dev(data, 8, 2048)
    nw = words.shape[1]
    apply = lambda w_: kernels.schedule_apply(table, w_, sched.n_out)
    rec = kernel_record(
        "schedule_apply", "ceph_tpu/ec/pallas_kernels.py:178", lambda: apply(words),
        lambda: kernels.schedule_apply_plain(table, words, sched.n_out),
        (sched.n_in + sched.n_out) * nw * 4, sched.n_steps * nw, int_rate)
    # K5 on the same repair, from the [8, S] chunks: the same bytes out
    bm = kernels.Bitmatrix(repair, 8, dev)
    k5_out = kernels.bitmatrix_encode(bm, data, 2048)
    k6_bytes = schedule.unpack_packet_rows_dev(apply(words), 2, 8, 2048, S)
    rec.update(shape=f"cauchy_good k=8 m=3 w=8 p=2048 lost (0, 8) S={S} NW={nw}",
               n_steps=sched.n_steps, n_bufs=sched.n_bufs, n_in=sched.n_in, n_out=sched.n_out,
               xor_count=sched.xor_count, naive_xor_count=sched.naive_xor_count,
               **program_counts(prog),
               k5_same_repair_ms=time_ms(lambda: kernels.bitmatrix_encode(bm, data, 2048)),
               k5_equal=bool(torch.equal(k5_out, k6_bytes)))
    del data, words, k5_out, k6_bytes
    edges = []

    def edge(label, table_, sched_, w_, encoder=None, host_data=None):
        got = kernels.schedule_apply(table_, w_, sched_.n_out)
        want = kernels.schedule_apply_plain(table_, w_, sched_.n_out)
        equal, err = compare(got, want)
        e = {"case": label, "n_steps": sched_.n_steps, "n_bufs": sched_.n_bufs,
             **program_counts(table_.program(w_.shape[0], sched_.n_out)),
             "words": list(w_.shape), "bit_equal": equal, "max_abs_err": err}
        if encoder is not None:  # the encoder's bytes against the numpy host path
            pack = (schedule.pack_bitplanes(host_data) if encoder.layout == "bitplane"
                    else schedule.pack_packet_rows(host_data, 8, encoder.packetsize))
            out = sched_.execute_host(pack)
            size = host_data.shape[1]
            host = (schedule.unpack_bitplanes(out, encoder.n_chunks_out, size)
                    if encoder.layout == "bitplane" else
                    schedule.unpack_packet_rows(out, encoder.n_chunks_out, 8, encoder.packetsize,
                                                size))
            e["bytes_equal_host"] = bool(np.array_equal(encoder.encode(host_data), host))
            e["bit_equal"] = e["bit_equal"] and e["bytes_equal_host"]
        edges.append(e)

    rng = np.random.default_rng(SEED)
    w32 = gfw.matrix_to_bitmatrix(gfw.vandermonde_matrix(8, 3, 32), 32)
    gen32 = np.vstack([np.eye(256, dtype=np.uint8), w32])
    big = schedule.compile_schedule(repair_bitmatrix(gen32, 32, 8, 11, (0, 8)))
    big_words = torch.from_numpy(rng.integers(0, 2**32, (big.n_in, 40_003), dtype=np.uint32)
                                 .view(np.int32)).to(dev)
    edge("w=32 reed_sol_van k=8 m=3 lost (0, 8): global-memory path",
         kernels.StepTable(big.steps, big.n_bufs, dev), big, big_words)
    ragged = torch.from_numpy(rng.integers(0, 2**32, (sched.n_in, 1_000_003), dtype=np.uint32)
                              .view(np.int32)).to(dev)
    edge("main schedule, NW = 1,000,003", table, sched, ragged)
    edge("main schedule, NW = 100 (below one tile)", table, sched, ragged[:, :100].contiguous())
    sliced = torch.from_numpy(rng.integers(0, 2**32, sched.n_in * 4096 + 1, dtype=np.uint32)
                              .view(np.int32)).to(dev)[1:].view(sched.n_in, 4096)
    edge("main schedule, words 4 bytes past a 16-byte boundary", table, sched, sliced)
    for p in (3, 5):
        enc = schedule.XorScheduleEncoder(repair, "packet", 8, p, device=dev)
        host_data = rng.integers(0, 256, (8, 8 * p * 4099), dtype=np.uint8)
        edge(f"packet layout p={p}", enc.table, enc.schedule,
             schedule.pack_packet_rows_dev(torch.from_numpy(host_data).to(dev), 8, p),
             enc, host_data)
    rs = np.vstack([np.eye(8, dtype=np.uint8), gf.vandermonde_matrix(8, 3)])
    rows = [s for s in range(11) if s not in (0, 8)][:8]
    enc = schedule.XorScheduleEncoder(
        gf.matrix_to_bitmatrix(gf.matrix_encode(rs[[0, 8]], gf.invert_matrix(rs[rows]))),
        "bitplane", device=dev)
    host_data = rng.integers(0, 256, (8, 131), dtype=np.uint8)
    edge("bitplane layout S=131", enc.table, enc.schedule,
         schedule.pack_bitplanes_dev(torch.from_numpy(host_data).to(dev)), enc, host_data)
    before = kernels.LAUNCHES["schedule_apply"]
    edge("S = 0", table, sched, torch.empty((sched.n_in, 0), dtype=torch.int32, device=dev))
    if kernels.LAUNCHES["schedule_apply"] != before:
        raise AssertionError("schedule_apply launched on an empty word range")
    torch.cuda.synchronize()
    return {"phase": "schedule_kernel", "results": [rec], "edges": edges}


def program_counts(prog) -> dict:
    """K6's program for a table: ops, read-after-write levels, groups,
    work slots after reuse by liveness, and the launch shape."""
    from ceph_tpu_torch.ec import kernels

    threads, stages = kernels.schedule_config(prog)
    return {"program_ops": prog.n_ops, "program_levels": prog.n_levels,
            "program_terms": prog.n_terms, "program_groups": len(prog.groups),
            "work_slots": prog.n_work,
            "path": "shared" if threads else "global", "threads": threads, "stages": stages}


def numpy_classify(prev: np.ndarray, up: np.ndarray, acting: np.ndarray, min_size: int):
    """The peering classifier restated in numpy: (flags, survivor_mask)."""
    from ceph_tpu_torch.crush.map import ITEM_NONE
    from ceph_tpu_torch.recovery import peering as P

    size = acting.shape[1]
    alive = acting != ITEM_NONE
    surv = alive & (acting == prev)
    n_alive = alive.sum(1)
    backfill = ((up != ITEM_NONE) & ~(up[:, :, None] == prev[:, None, :]).any(2)).any(1)
    flags = (np.where((up != acting).any(1), P.PG_STATE_REMAPPED, 0)
             | np.where(surv.sum(1) < size, P.PG_STATE_DEGRADED, 0)
             | np.where(n_alive < size, P.PG_STATE_UNDERSIZED, 0)
             | np.where(backfill, P.PG_STATE_BACKFILL, 0)
             | np.where(n_alive < min_size, P.PG_STATE_INACTIVE, 0))
    flags = np.where(flags == 0, P.PG_STATE_CLEAN, flags).astype(np.int32)
    mask = (surv.astype(np.uint64) << np.arange(size, dtype=np.uint64)).sum(1).astype(np.uint32)
    return flags, mask


def recovery_store(codec, pgs: np.ndarray, dev):
    """Seeded data for the degraded PGs, with parity from one batched
    encode on the card; returns ``read_shard(pg, s)`` over one host
    array ``[k + m, n_pgs * chunk]``."""
    k = codec.get_data_chunk_count()
    data = card_bytes((k, len(pgs) * RECOVERY_CHUNK), SEED + 11, dev)
    full = torch.cat([data, codec.codec.encode_async(data)]).cpu().numpy()
    col = {int(pg): i * RECOVERY_CHUNK for i, pg in enumerate(pgs)}
    return full, lambda pg, s: full[s, col[pg]:col[pg] + RECOVERY_CHUNK]


def phase_recovery(dev, launch_counts, reset_launches, n_osds: int = RECOVERY_OSDS,
                   pg_num: int = RECOVERY_PGS) -> dict:
    """``recover_pool`` after a rack failure, for each code of
    RECOVERY_CODES.  ``reset_launches()`` sets the kernels' counters to
    0 just before each code's ``recover_pool`` calls and
    ``launch_counts()`` reads them just after, so the path's counts
    leave out the store's encode and the peering checks."""
    import copy

    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.ec import create
    from ceph_tpu_torch.models.clusters import build_osdmap

    cur = build_osdmap(n_osds, pg_num=pg_num, size=11, pool_kind="erasure")
    prev = copy.deepcopy(cur)
    inc = rec.inject(cur, RECOVERY_FAILURE)
    peered = rec.peer_pool(prev, cur, 1, device=dev)
    flags, mask = numpy_classify(peered.prev_acting, peered.up, peered.acting, peered.min_size)
    if not (np.array_equal(peered.flags, flags) and np.array_equal(peered.survivor_mask, mask)):
        raise AssertionError("peering differs from the numpy classification")
    degraded = peered.pgs_with(rec.PG_STATE_DEGRADED)
    out = {"phase": "recovery", "osds": n_osds, "pgs": pg_num, "failure": RECOVERY_FAILURE,
           "osds_failed": len(inc.new_state), "chunk_bytes": RECOVERY_CHUNK,
           "degraded_pgs": len(degraded), "counts": peered.counts(), "codes": {}}
    pc = rec.recovery_counters()
    path_counts: dict[str, int] = {}
    for name, (profile, mode) in RECOVERY_CODES.items():
        codec = create(profile, device=dev)
        full, read_shard = recovery_store(codec, degraded, dev)
        cfg = Config(env={})
        cfg.set("recovery_xor_schedule", mode)
        call = lambda: rec.recover_pool(prev, cur, 1, codec, read_shard, config=cfg, device=dev)
        before = pc.dump()["recovery"]
        reset_launches()
        runs, secs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            runs.append(call())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        after = pc.dump()["recovery"]
        prof = profile_call(call)
        for kname, v in launch_counts().items():
            path_counts[kname] = path_counts.get(kname, 0) + v
        peering, plan, result = runs[0]
        if not np.array_equal(peering.survivor_mask, peered.survivor_mask):
            raise AssertionError(f"{name}: recover_pool peered differently")
        bit_groups = sum(1 for g in plan.groups if g.repair_matrix is None or mode == "on")
        for _, plan_i, res in runs:
            if res.launches != plan_i.n_patterns or res.schedule_launches != bit_groups:
                raise AssertionError(f"{name}: {res.launches} launches for {plan_i.n_patterns} "
                                     f"patterns, {res.schedule_launches} schedules")
            for g in plan_i.groups:
                for pg in g.pgs:
                    for s in g.missing:
                        if not np.array_equal(res.shards[int(pg)][s], read_shard(int(pg), s)):
                            raise AssertionError(f"{name}: pg {pg} shard {s} rebuilt wrong")
        avg = lambda key: ((after[key]["sum"] - before[key]["sum"])
                           / max(after[key]["avgcount"] - before[key]["avgcount"], 1))
        wall = float(np.median(secs))
        out["codes"][name] = {
            "profile": profile, "mode": mode, "patterns": plan.n_patterns,
            "degraded_pgs": plan.n_pgs, "unrecoverable_pgs": int(len(plan.unrecoverable)),
            "missing_histogram": {str(n): sum(g.n_pgs for g in plan.groups if len(g.missing) == n)
                                  for n in sorted({len(g.missing) for g in plan.groups})},
            "launches": result.launches, "schedule_launches": result.schedule_launches,
            "table_launches": result.launches - result.schedule_launches,
            "bytes_read": plan.bytes_to_read(RECOVERY_CHUNK),
            "bytes_rebuilt": result.bytes_recovered, "shards_rebuilt": result.shards_rebuilt,
            "l_peering_s": avg("l_peering"), "l_plan_s": avg("l_plan"),
            "decode_s": float(np.median([r[2].decode_s for r in runs])),
            "recover_pool_s": wall, "all_recover_pool_s": secs,
            "rebuilt_GBps": result.bytes_recovered / wall / 1e9,
            "profile_recover_pool": prof,
        }
        del full, runs
    out["launches"] = path_counts
    return out


VERIFY_ROWS = 32                # one decode-verify group of host0_0's loss
SCRUB_EDGES = [  # (rows, L, bytes the first row starts past a 16-byte boundary)
    (5, 0, 0), (7, 1, 0), (9, 3, 0), (33, 15, 0), (33, 16, 0), (33, 17, 0), (257, 4097, 0),
    (64, 4096, 1), (31, 4101, 3), (1, 32768, 0), (1, 9, 0),
    # the scrub pass's cut (1 KiB segments) at rows that need no more lanes
    (67584, 1023, 0), (67584, 1024, 0), (67584, 1025, 0), (67584, 2048, 0),
    (2112, 32767, 0), (2112, 32769, 0), (2112, 40960, 0),  # the last: five staged steps
    # the decode-verify cut (a block a row, 64-byte segments)
    (VERIFY_ROWS, 63, 0), (VERIFY_ROWS, 64, 0), (VERIFY_ROWS, 65, 0), (VERIFY_ROWS, 128, 0),
    (VERIFY_ROWS, 32767, 0), (VERIFY_ROWS, 32769, 0), (VERIFY_ROWS, 65536, 0),
    # rows 1-15 bytes past a boundary, 4101 bytes across 512 segments of 16
    *[(VERIFY_ROWS, 4101, off) for off in range(1, 16)],
    (1, 64 * MIB, 0),               # 512 segments of 128 KiB, nine tree levels
    ((1 << 20) * 128 + 5, 1, 0),    # more rows than one grid of K8 covers
]
LONG_ROW = 32768                # rows over 1 MiB are held in pieces of this, combined on the host
SUPERVISED_PASSES = ("mid-repair-loss", "scrub-storm", "flapping-osd")
SUPERVISED_GRACE = 0.5          # heartbeat grace of flapping-osd (the scenario's 0.75 s drops)
SUPERVISED_SEED = 7             # retry-jitter seed
SUPERVISED_SMALL = (128, 128, 1024)  # OSDs, PGs, chunk of the card-vs-CPU replay
#: the scenarios replayed at SUPERVISED_SMALL (mid-repair-loss rides the
#: traffic replay)
SUPERVISED_REPLAY = ("scrub-storm", "flapping-osd")
# config 6's foreground-traffic pass (bench/config6_recovery.py:390-404)
TRAFFIC_SCENARIO = "mid-repair-loss"
TRAFFIC_OPS = 65536
TRAFFIC_OP_BYTES = 64
TRAFFIC_SERVICE_MS = 0.5
TRAFFIC_OSD_CAP_OPS = 6000.0
TRAFFIC_REC_CAP_BPS = 4e6       # repair bandwidth that saturates the fabric
TRAFFIC_ARBITER_CAP_BPS = 8e6
TRAFFIC_SLOW_MS = 10.0
TRAFFIC_SEED = 6
OVERLOAD_FACTOR = 40.0
OVERLOAD_START_S, OVERLOAD_END_S = 3.0, 6.0  # after convergence
POST_STEPS = 10                 # 1 s pure-traffic steps after convergence
TRAFFIC_SLO = {"max_p99_latency_ms": 8.0, "max_slow_op_fraction": 0.02}
# config 6's scrub pass (:573-580, :650-718): the three-class arbiter
SCRUB_QOS_SCENARIO = "scrub-storm"
SCRUB_OPS = 16384
SCRUB_SLO = {"max_inconsistent_seconds": 60.0, "max_scrub_age_s": 120.0,
             "max_p99_latency_ms": 20.0}
TRAFFIC_SMALL_OPS = 4096        # ops a step of the card-vs-CPU traffic replay
# the replay's mean_ms: a float32 sum of 4,096 latencies reduced in
# another order on the card (a tree of about 12 levels, float32 eps 1.2e-7)
TRAFFIC_REPLAY_RTOL = 1e-5


def crc_rows_plain_long(x: torch.Tensor) -> torch.Tensor:
    """The plain K8 of rows too long for its byte loop: each row's
    LONG_ROW-byte pieces (the last one shorter) through
    ``crc_rows_plain`` at once, combined on the host by
    ``crc32c_combine`` (both held to the reference on the CPU)."""
    from ceph_tpu_torch.recovery import scrub

    n, L = x.shape
    whole = L - L % LONG_ROW
    pieces = scrub.crc_rows_plain(x[:, :whole].reshape(-1, LONG_ROW)).view(n, -1).tolist()
    tail = scrub.crc_rows_plain(x[:, whole:]).tolist()
    crcs = []
    for row, last in zip(pieces, tail):
        crc = row[0]
        for c in row[1:]:
            crc = scrub.crc32c_combine(crc, c, LONG_ROW)
        crcs.append(scrub.crc32c_combine(crc, last, L - whole))
    return torch.tensor(crcs, dtype=torch.int64, device=x.device)


def phase_scrub_kernel(int_rate: float, dev, n_pgs: int = RECOVERY_PGS,
                       chunk: int = RECOVERY_CHUNK, edges=SCRUB_EDGES) -> dict:
    """K8 (the scrub's CRC32C of rows) vs its plain version, bit for bit:
    at the supervised store's shape (n_pgs x 11 rows of ``chunk`` bytes:
    a scrub pass) and at one decode-verify group (VERIFY_ROWS rows),
    timed, each with its cut (``scrub.crc_segments``), and on ``edges``
    and the check value, compared only."""
    from ceph_tpu_torch.recovery import scrub

    results = []
    for rows, label in ((n_pgs * 11, f"a scrub pass of {n_pgs} PGs x 11 shards"),
                        (VERIFY_ROWS, "one decode-verify group")):
        data = card_bytes((rows, chunk), SEED + 12, dev)
        rec = kernel_record("crc32c_rows", "ceph_tpu/recovery/scrub.py:120",
                            lambda: scrub.crc_rows(data), lambda: scrub.crc_rows_plain(data),
                            rows * chunk + rows * 8, rows * chunk, int_rate)
        log_w, seg = scrub.crc_segments(rows, chunk)
        rec.update(shape=f"[{rows}, {chunk}] u8 ({label})", lanes_a_row=1 << log_w,
                   segment_bytes=seg,
                   bound_note="bytes read at HBM rate; ops = one table lookup a byte")
        results.append(rec)
        del data
    out_edges = []
    for n, length, offset in edges:
        g = torch.Generator(device=dev).manual_seed(SEED + n + length)
        flat = torch.randint(0, 256, (n * length + offset,), generator=g, device=dev,
                             dtype=torch.uint8)
        x = flat[offset:].view(n, length)
        plain = crc_rows_plain_long if length > MIB else scrub.crc_rows_plain
        equal, err = compare(scrub.crc_rows(x), plain(x))
        log_w, seg = scrub.crc_segments(n, length)
        out_edges.append({"case": f"{n} rows x {length} bytes, +{offset}", "bit_equal": equal,
                          "max_abs_err": err, "lanes_a_row": 1 << log_w, "segment_bytes": seg})
        del flat, x
    check = torch.tensor(list(b"123456789"), dtype=torch.uint8, device=dev)[None, :]
    out_edges.append({"case": "check value crc32c('123456789') = 0xE3069283",
                      "bit_equal": int(scrub.crc_rows(check)[0]) == 0xE3069283,
                      "max_abs_err": 0})
    torch.cuda.synchronize()
    return {"phase": "scrub_kernel", "results": results, "edges": out_edges}


@contextlib.contextmanager
def k8_launch_shapes(shapes: list):
    """Append the ``(rows, L)`` of every K8 launch in a block to
    ``shapes``: the scrub module's callers look ``crc_rows`` up when they
    call it, so it is wrapped for the block (the wrapper's count is
    untouched)."""
    from ceph_tpu_torch.recovery import scrub

    inner = scrub.crc_rows

    def recording(data):
        if data.is_cuda and data.dim() == 2 and data.shape[0]:
            shapes.append(tuple(data.shape))
        return inner(data)

    scrub.crc_rows = recording
    try:
        yield
    finally:
        scrub.crc_rows = inner


def shape_summary(shapes: list) -> dict:
    """Min, median and max of the rows and of L over K8 launches, and the
    launches of each shape."""
    out: dict = {"launches": len(shapes), "by_shape": {}}
    for i, key in ((0, "rows"), (1, "L")):
        v = [s[i] for s in shapes] or [0]
        out[key] = {"min": min(v), "median": float(np.median(v)), "max": max(v)}
    for s in shapes:
        out["by_shape"][f"[{s[0]}, {s[1]}]"] = out["by_shape"].get(f"[{s[0]}, {s[1]}]", 0) + 1
    return out


@contextlib.contextmanager
def count_syncs(out: dict):
    """Count the host syncs of a block: torch's sync-debug mode warns on
    every synchronizing CUDA call (a copy to the host, ``.item()``,
    ``nonzero``), and the warnings are counted into ``out["host_syncs"]``."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["host_syncs"] = sum(1 for w in seen if "synchroniz" in str(w.message))


def supervised_store(codec, pg_num: int, chunk: int, dev):
    """Every shard of every PG: seeded data made on the card, parity from
    one batched encode there, brought to one host array ``[k + m,
    pg_num * chunk]``; returns it with ``read_shard``/``write_shard``."""
    k = codec.get_data_chunk_count()
    data = card_bytes((k, pg_num * chunk), SEED + 13, dev)
    full = torch.cat([data, codec.codec.encode_async(data)]).cpu().numpy()
    del data

    def cols(pg):
        return slice(pg * chunk, (pg + 1) * chunk)

    def write(pg, s, buf):
        full[s, cols(pg)] = buf

    return full, (lambda pg, s: full[s, cols(pg)]), write


def supervised_run(scenario: str, m, codec, read_shard, write_shard, dev, n_pgs: int,
                   scrub: bool = False):
    """One pass of SupervisedRecovery under ``scenario`` on a deepcopy of
    ``m``, with an EventJournal, a HealthTimeline graded by an SLO and
    an OpTracker on the virtual clock (and a Scrubber riding the loop
    when ``scrub``).  Returns (result, chaos, journal, timeline, spec,
    scrubber)."""
    import copy

    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.common.op_tracker import OpTracker
    from ceph_tpu_torch.obs import EventJournal, HealthTimeline, SLOSpec

    cur, prev = copy.deepcopy(m), m
    cfg = Config(env={})
    cfg.set("osd_heartbeat_grace", SUPERVISED_GRACE)
    clock = rec.VirtualClock()
    journal = EventJournal(clock=clock.now, trace_id=f"chip-{scenario}")
    spec = SLOSpec(max_inactive_seconds=10.0, min_availability_fraction=0.99,
                   max_time_to_zero_degraded_s=60.0, max_inconsistent_seconds=10.0)
    health = HealthTimeline(clock.now, k=codec.get_data_chunk_count(),
                            sample_status=spec.sample_status, device=dev)

    def corrupt(pg, s, off, mask):
        rec.apply_bitrot(read_shard(pg, s), off, mask)

    chaos = rec.ChaosEngine(cur, rec.build_scenario(scenario, cur), clock=clock,
                            journal=journal, corrupt=corrupt, config=cfg, device=dev)
    scrubber = (rec.Scrubber(n_pgs, cur.pools[1].size, journal=journal, clock=clock.now,
                             device=dev) if scrub else None)
    sup = rec.SupervisedRecovery(codec, chaos, config=cfg, seed=SUPERVISED_SEED,
                                 journal=journal, health=health,
                                 op_tracker=OpTracker(clock=clock.now, config=cfg),
                                 scrubber=scrubber, write_shard=write_shard if scrub else None,
                                 device=dev)
    res = sup.run(prev, 1, read_shard)
    return res, chaos, journal, health, spec, scrubber


def traffic_arbiter(clock, scrub: bool):
    """Config 6's mclock arbiter over TRAFFIC_ARBITER_CAP_BPS: client
    reservation 1/2 and recovery reservation 1/8, then a recovery limit
    of 1/4 (the traffic pass) or a scrub reservation of 1/16 and a scrub
    limit of 1/4 (the scrub pass's three classes)."""
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.workload import MClockArbiter

    cap = TRAFFIC_ARBITER_CAP_BPS
    cfg = Config(env={})
    cfg.set("osd_mclock_client_res_bps", cap / 2)
    cfg.set("osd_mclock_recovery_res_bps", cap / 8)
    if scrub:
        cfg.set("osd_mclock_scrub_res_bps", cap / 16)
        cfg.set("osd_mclock_scrub_lim_bps", cap / 4)
    else:
        cfg.set("osd_mclock_recovery_lim_bps", cap / 4)
    return MClockArbiter.from_config(cap, cfg, clock=clock.now, sleep=clock.sleep)


def traffic_run(scenario: str, m, codec, read_shard, write_shard, dev, n_pgs: int, ops: int,
                arbiter_on: bool, scrub: bool = False, overload: bool = False) -> dict:
    """One pass of config 6's traffic run (``bench/config6_recovery.py::
    _traffic_pass``) or, with ``scrub``, of its scrub run (``_scrub_pass``)
    on a deepcopy of ``m``: a TrafficEngine of ``ops`` ops a step riding
    every health sample of SupervisedRecovery (with config 6's arbiter
    when ``arbiter_on``), an EventJournal and a HealthTimeline graded by
    TRAFFIC_SLO (SCRUB_SLO).  ``scrub`` adds a Scrubber (admitted through
    the arbiter's scrub class) and the engine's integrity loop;
    ``overload`` adds POST_STEPS one-second steps on the converged map
    with a 40x overload inside them.  Records which rotted PGs had their
    checksum row refreshed by the integrity loop while the rot was in the
    store (``refreshed``), each rotted shard's clean bytes, and the
    engine's latency histogram after every sample."""
    import copy

    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.obs import EventJournal, HealthTimeline, SLOSpec, evaluate
    from ceph_tpu_torch.workload import TrafficEngine

    cur, prev = copy.deepcopy(m), m
    clock = rec.VirtualClock()
    journal = EventJournal(clock=clock.now, trace_id=f"chip-traffic-{scenario}")
    spec = SLOSpec(**(SCRUB_SLO if scrub else TRAFFIC_SLO))
    k, size = codec.get_data_chunk_count(), cur.pools[1].size
    health = HealthTimeline(clock.now, k=k, sample_status=spec.sample_status, device=dev)
    arbiter = traffic_arbiter(clock, scrub) if arbiter_on else None
    rotted: set = set()
    refreshed: set = set()
    clean_bytes: dict = {}

    def corrupt(pg, s, off, mask):
        clean_bytes.setdefault((pg, s), np.array(read_shard(pg, s)))
        rotted.add((pg, s))
        rec.apply_bitrot(read_shard(pg, s), off, mask)

    def write_back(pg, s, buf):
        rotted.discard((int(pg), int(s)))
        write_shard(pg, s, buf)

    chaos = rec.ChaosEngine(cur, rec.build_scenario(scenario, cur), clock=clock,
                            journal=journal, corrupt=corrupt, device=dev)
    scrubber = None
    if scrub:
        scrubber = rec.Scrubber(n_pgs, size, arbiter=arbiter, journal=journal,
                                clock=clock.now, device=dev)
        note_write = scrubber.note_write

        def noting(pg, rs):
            if any(p == pg for p, _ in rotted):
                refreshed.add(int(pg))
            note_write(pg, rs)

        scrubber.note_write = noting
    traffic = TrafficEngine(
        clock.now, cur.max_osd, n_pgs, k, size, k + 1, ops_per_step=ops,
        service_ms=TRAFFIC_SERVICE_MS, osd_capacity_ops_per_s=TRAFFIC_OSD_CAP_OPS,
        recovery_capacity_bps=TRAFFIC_REC_CAP_BPS, op_bytes=TRAFFIC_OP_BYTES,
        slow_ms=TRAFFIC_SLOW_MS, seed=TRAFFIC_SEED, arbiter=arbiter, journal=journal,
        scrubber=scrubber, read_shard=read_shard if scrub else None, device=dev)
    hists = []
    observe = traffic.observe

    def observing(*args, **kwargs):
        sample = observe(*args, **kwargs)
        hists.append(traffic._cum_lat_hist.copy())
        return sample

    traffic.observe = observing
    sup = rec.SupervisedRecovery(codec, chaos, config=Config(env={}), seed=0, journal=journal,
                                 health=health, traffic=traffic, arbiter=arbiter,
                                 scrubber=scrubber, write_shard=write_back if scrub else None,
                                 device=dev)
    res = sup.run(prev, 1, read_shard)
    if overload:
        # an induced overload on the converged cluster: the health grade
        # of these samples is traffic's alone (OK -> WARN -> OK)
        clean = rec.peer_pool(chaos.osdmap, chaos.osdmap, 1, device=dev)
        t0 = clock.now()
        traffic.set_overload(t0 + OVERLOAD_START_S, t0 + OVERLOAD_END_S, OVERLOAD_FACTOR)
        for _ in range(POST_STEPS):
            clock.advance(1.0)
            sample = traffic.observe(clean, epoch=chaos.epoch,
                                     bytes_recovered=res.bytes_recovered)
            health.snapshot(clean, epoch=chaos.epoch, bytes_recovered=res.bytes_recovered,
                            traffic=sample)
    return {"res": res, "traffic": traffic, "health": health, "report": evaluate(health, spec),
            "arbiter": arbiter, "chaos": chaos, "journal": journal, "scrubber": scrubber,
            "refreshed": refreshed, "clean_bytes": clean_bytes, "lat_hists": hists}


def observe_probe(peering, n_osds: int, k: int, size: int, dev) -> dict:
    """One ``TrafficEngine.observe`` at TRAFFIC_OPS on ``peering``'s device
    tensors, after a warm-up: its kernel launches and copies and their
    device ms (torch.profiler), its host syncs, and its ms by CUDA events
    and by the host clock (median of 10 each)."""
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.workload import TrafficEngine

    eng = TrafficEngine(lambda: 0.0, n_osds, peering.pg_num, k, size, k + 1,
                        ops_per_step=TRAFFIC_OPS, service_ms=TRAFFIC_SERVICE_MS,
                        osd_capacity_ops_per_s=TRAFFIC_OSD_CAP_OPS, device=dev)
    eng.observe(peering)
    torch.cuda.synchronize()
    out: dict = {}
    with count_syncs(out):
        eng.observe(peering)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.observe(peering)
        torch.cuda.synchronize()
    kernels = copies = 0
    device_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.key.startswith("Memcpy") or e.key.startswith("Memset"):
            copies += e.count
        elif not getattr(e, "is_user_annotation", False):
            kernels += e.count
        device_us += getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.observe(peering)
        walls.append((time.perf_counter() - t0) * 1e3)
    out.update(kernel_launches=kernels, copies=copies, device_ms=device_us / 1e3,
               ms=time_ms(lambda: eng.observe(peering)), wall_ms=float(np.median(walls)),
               ops=TRAFFIC_OPS)
    return out


def traffic_record(runs: dict) -> dict:
    """Config 6's ``traffic_*`` fields (``build_traffic_record``) from the
    no-arbiter and arbiter runs, with the overload steps' health grades."""
    arb, noarb = runs[True], runs[False]

    def recovery_p99(eng) -> float:
        # the pre-overload samples: where QoS policy, not the induced
        # incident, sets the tail
        return max((t.p99_ms for t in eng.samples[:max(len(eng.samples) - POST_STEPS, 0)]),
                   default=0.0)

    s = arb["traffic"].summary()
    report = arb["report"]
    return {
        "traffic_scenario": TRAFFIC_SCENARIO,
        "traffic_ops": s["ops"],
        "traffic_ops_per_sec": s["ops_per_sec_wall"],
        "traffic_p99_ms": round(arb["health"].max_traffic_p99_ms(), 6),
        "traffic_recovery_p99_ms": round(recovery_p99(arb["traffic"]), 6),
        "traffic_recovery_p99_ms_no_arbiter": round(recovery_p99(noarb["traffic"]), 6),
        "traffic_degraded_fraction": s["degraded_fraction"],
        "traffic_blocked_fraction": s["blocked_fraction"],
        "traffic_slow_ops": s["slow_ops"],
        "traffic_slow_fraction": round(s["slow_ops"] / max(s["ops"], 1), 9),
        "traffic_health_status": report.status,
        "traffic_slo_checks": {c.name: c.status for c in report.checks},
        "traffic_time_to_zero_degraded_s": round(arb["res"].time_to_zero_degraded_s, 6),
        "traffic_time_to_zero_degraded_s_no_arbiter": round(
            noarb["res"].time_to_zero_degraded_s, 6),
        "traffic_qos": arb["arbiter"].summary(),
        "traffic_overload_healths": [
            x.health for x in arb["health"].samples if x.traffic is not None][-POST_STEPS:],
    }


def scrub_record(runs: dict) -> dict:
    """Config 6's ``scrub_*`` fields (``build_scrub_record``, less the
    standalone CRC rate: phase ``scrub_kernel`` times K8) from the
    arbiter and no-arbiter runs, with the engine's integrity counters."""
    arb, noarb = runs[True], runs[False]
    res, report = arb["res"], arb["report"]
    s = arb["traffic"].summary()
    return {
        "scrub_scenario": SCRUB_QOS_SCENARIO,
        "scrub_converged": res.converged,
        "scrub_passes": int(res.scrub_passes),
        "scrub_scrubbed_bytes": int(res.scrubbed_bytes),
        "scrub_inconsistencies_found": int(res.inconsistencies_found),
        "scrub_verify_retries": int(res.verify_retries),
        "scrub_unrecoverable": int(len(res.inconsistent_unrecoverable)),
        "scrub_time_to_zero_inconsistent_s": round(res.time_to_zero_inconsistent_s, 6),
        "scrub_time_to_zero_inconsistent_s_no_arbiter": round(
            noarb["res"].time_to_zero_inconsistent_s, 6),
        "scrub_p99_ms": round(arb["health"].max_traffic_p99_ms(), 6),
        "scrub_p99_ms_no_arbiter": round(noarb["health"].max_traffic_p99_ms(), 6),
        "scrub_health_status": report.status,
        "scrub_slo_checks": {c.name: c.status for c in report.checks},
        "scrub_qos": arb["arbiter"].summary(),
        "traffic_ops": s["ops"],
        "traffic_ops_per_sec": s["ops_per_sec_wall"],
        "writes_checksummed": s["writes_checksummed"],
        "degraded_reads_verified": s["degraded_reads_verified"],
        "read_verify_failures": s["read_verify_failures"],
    }


def phase_traffic(dev, launch_counts, reset_launches, m, codec, read_shard, write_shard,
                  pg_num: int) -> dict:
    """Config 6's traffic pass (TRAFFIC_SCENARIO, TRAFFIC_OPS a step, the
    overload after convergence) and its scrub pass (SCRUB_QOS_SCENARIO,
    SCRUB_OPS a step, the three-class arbiter, the integrity loop), each
    without and with the arbiter, on the supervised phase's map and
    store; each pass is one main path, its runs counted from 0 (launches,
    host syncs, wall seconds) and gated after the counts are read.  The
    scrub runs' rot is undone in the store before the next run."""
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.obs import HEALTH_OK, HEALTH_WARN

    k = codec.get_data_chunk_count()
    out = {}
    for name, scenario, ops, scrub in (("traffic", TRAFFIC_SCENARIO, TRAFFIC_OPS, False),
                                       ("scrub_qos", SCRUB_QOS_SCENARIO, SCRUB_OPS, True)):
        path: dict = {}
        runs, info = {}, {"runs": {}}
        gates: dict = {}
        for arb in (False, True):
            run_info: dict = {}
            reset_launches()
            t0 = time.perf_counter()
            with count_syncs(run_info):
                r = traffic_run(scenario, m, codec, read_shard, write_shard, dev, pg_num, ops,
                                arb, scrub=scrub, overload=not scrub)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for kname, v in launch_counts().items():
                path[kname] = path.get(kname, 0) + v
            runs[arb] = r
            res, eng = r["res"], r["traffic"]
            s = res.summary()
            final = rec.peer_pool(m, r["chaos"].osdmap, 1, device=dev)
            surv = final.n_survivors()
            below_k = {int(p) for p in final.pgs_with(rec.PG_STATE_DEGRADED) if surv[p] < k}
            wrong = [(pg, sh) for pg, shards in res.shards.items() for sh, buf in shards.items()
                     if not np.array_equal(buf, read_shard(pg, sh))]
            tag = "arbiter" if arb else "no_arbiter"
            run_info.update(wall_s=wall, samples=len(eng.samples), engine=eng.summary(),
                            bytes_recovered=int(res.bytes_recovered),
                            stale_launches=s["stale_launches"], salvaged_pgs=s["salvaged_pgs"],
                            time_to_zero_degraded_s=res.time_to_zero_degraded_s,
                            unrecoverable_pgs=s["unrecoverable_pgs"], below_k_pgs=sorted(below_k),
                            shards_wrong=len(wrong), slo=r["report"].status)
            gates[f"converged_{tag}"] = bool(res.converged)
            gates[f"shards_equal_store_{tag}"] = not wrong
            gates[f"unrecoverable_is_below_k_{tag}"] = set(s["unrecoverable_pgs"]) == below_k
            gates[f"no_failed_pgs_{tag}"] = not s["failed_pgs"]
            gates[f"every_sample_completes_ops_{tag}"] = all(
                x.completed > 0 and x.served + x.degraded + x.blocked == x.ops
                for x in eng.samples)
            if scrub:
                chaos, journal, scrubber = r["chaos"], r["journal"], r["scrubber"]
                rotted = {c.event.pg for c in chaos.corruptions}
                found = {p for j in journal.by_name("scrub.inconsistent") for p in j["attrs"]["pgs"]}
                after = scrubber.scrub(read_shard).n_inconsistent  # a check pass, after the counts
                run_info.update(corrupted_pgs=sorted(rotted), refreshed_while_rotted=sorted(
                    r["refreshed"]), inconsistent_unrecoverable=sorted(
                    res.inconsistent_unrecoverable), closing_check_inconsistent=after,
                    p99_ms=r["health"].max_traffic_p99_ms())
                gates[f"every_corruption_found_{tag}"] = rotted <= found
                gates[f"scrubbed_clean_{tag}"] = after == 0
                # the integrity loop refreshes a written PG's checksum row
                # from the store's bytes, rot included (the reference's
                # Scrubber.note_write); such a PG ends inconsistent-
                # unrecoverable, and no other one may
                gates[f"inconsistent_unrecoverable_is_refreshed_rot_{tag}"] = (
                    set(res.inconsistent_unrecoverable) == r["refreshed"])
                gates[f"client_p99_within_slo_{tag}"] = (
                    r["health"].max_traffic_p99_ms() <= SCRUB_SLO["max_p99_latency_ms"])
                gates[f"writes_checksummed_{tag}"] = eng.writes_checksummed > 0
                gates[f"degraded_reads_verified_{tag}"] = eng.degraded_reads_verified > 0
                for (pg, sh), clean in r["clean_bytes"].items():  # undo the rot
                    write_shard(pg, sh, clean)
            info["runs"][tag] = run_info
            print(json.dumps({"traffic_pass": name, "arbiter": arb, "wall_s": wall,
                              "host_syncs": run_info["host_syncs"], "samples": len(eng.samples)}),
                  flush=True)
        arb_run, noarb_run = runs[True], runs[False]
        # the two runs need not rebuild the same bytes: where the arbiter
        # slows recovery, an epoch can land on a launch in flight and its
        # salvage commits fewer shards (the reference does the same:
        # tests/test_torch_traffic.py::test_traffic_pass_matches_reference)
        gates["bytes_recovered_in_both"] = (
            arb_run["res"].bytes_recovered > 0 and noarb_run["res"].bytes_recovered > 0)
        gates["same_unrecoverable_pgs"] = (
            arb_run["res"].summary()["unrecoverable_pgs"]
            == noarb_run["res"].summary()["unrecoverable_pgs"])
        if scrub:
            info.update(scrub_record(runs))
            gates["scrub_class_admitted"] = arb_run["arbiter"].granted("scrub") > 0
        else:
            info.update(traffic_record(runs))
            healths = info["traffic_overload_healths"]
            gates["recovery_p99_below_no_arbiter"] = (
                info["traffic_recovery_p99_ms"] < info["traffic_recovery_p99_ms_no_arbiter"])
            gates["client_granted_is_ops_bytes"] = arb_run["arbiter"].granted("client") == (
                TRAFFIC_OP_BYTES * sum(x.ops for x in arb_run["traffic"].samples))
            gates["recovery_granted_covers_bytes"] = (
                arb_run["arbiter"].granted("recovery") >= arb_run["res"].bytes_recovered)
            gates["overload_ok_warn_ok"] = (
                len(healths) == POST_STEPS and healths[0] == HEALTH_OK
                and HEALTH_WARN in healths and healths[-1] == HEALTH_OK)
            peering = rec.peer_pool(m, arb_run["chaos"].osdmap, 1, device=dev)
            info["observe"] = observe_probe(peering, m.max_osd, k, m.pools[1].size, dev)
        info["launches"] = path
        info["gates"] = gates
        out[name] = info
    return out


def traffic_replay(profile: dict, m_small, pgs_small: int, chunk_small: int, dev) -> dict:
    """The traffic pass (with the arbiter and the overload) at the small
    size on the card and on the CPU: the engine's ``summary()`` but the
    wall rate, every sample's fields but the wall rate (``mean_ms`` within
    TRAFFIC_REPLAY_RTOL), its latency histogram after every sample, the
    supervised summary, the health series and the SLO report equal."""
    from ceph_tpu_torch.ec import create

    got = []
    for d in (dev, torch.device("cpu")):
        c = create(profile, device=d)
        _, rd, wr = supervised_store(c, pgs_small, chunk_small, d)
        r = traffic_run(TRAFFIC_SCENARIO, m_small, c, rd, wr, d, pgs_small, TRAFFIC_SMALL_OPS,
                        True, overload=True)
        got.append(r)
    card, cpu = got

    def samples(r):
        return [{key: v for key, v in vars(x).items() if key != "ops_per_sec_wall"}
                for x in r["traffic"].samples]

    def summary(r):
        return {key: v for key, v in r["traffic"].summary().items() if key != "ops_per_sec_wall"}

    sc, sp = samples(card), samples(cpu)
    means = all(np.isclose(a.pop("mean_ms"), b.pop("mean_ms"), rtol=TRAFFIC_REPLAY_RTOL, atol=0)
                for a, b in zip(sc, sp))
    checks = {
        "summary": summary(card) == summary(cpu),
        "samples": len(sc) == len(sp) and sc == sp,
        "mean_ms": len(sc) == len(sp) and means,
        "lat_hists": len(card["lat_hists"]) == len(cpu["lat_hists"]) and all(
            np.array_equal(a, b) for a, b in zip(card["lat_hists"], cpu["lat_hists"])),
        "supervised_summary": card["res"].summary() == cpu["res"].summary(),
        "health_series": card["health"].series() == cpu["health"].series(),
        "slo": card["report"].to_dict() == cpu["report"].to_dict(),
    }
    return {"equal": all(checks.values()), "checks": checks, "card": summary(card),
            "samples": len(sc)}


def phase_supervised(dev, launch_counts, reset_launches, n_osds: int = RECOVERY_OSDS,
                     pg_num: int = RECOVERY_PGS, chunk: int = RECOVERY_CHUNK,
                     small=SUPERVISED_SMALL) -> dict:
    """SupervisedRecovery on the recovery phase's map and code (RS k=8
    m=3, one ``chunk`` a PG shard), three passes in SUPERVISED_PASSES,
    each counted from 0 (its launches, host syncs and wall seconds), with
    its gates; then config 6's traffic and scrub passes, and the
    SUPERVISED_REPLAY scenarios and the traffic pass at the ``small``
    size on the card and on the CPU, whose summaries must be equal
    (those runs are checks: outside the counts)."""
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.crush import interp_batch
    from ceph_tpu_torch.ec import create
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.obs import evaluate

    profile = RECOVERY_CODES["rs_8_3_auto"][0]
    m = build_osdmap(n_osds, pg_num=pg_num, size=11, pool_kind="erasure")
    codec = create(profile, device=dev)
    k = codec.get_data_chunk_count()
    full, read_shard, write_shard = supervised_store(codec, pg_num, chunk, dev)
    out = {"phase": "supervised", "osds": n_osds, "pgs": pg_num, "chunk_bytes": chunk,
           "store_bytes": int(full.nbytes), "profile": profile, "passes": {}}
    path: dict[str, int] = {}
    k8_shapes: list = []
    for scenario in SUPERVISED_PASSES:
        scrub = scenario == "scrub-storm"
        info: dict = {}
        syncs = interp_batch.HOST_SYNCS
        reset_launches()
        t0 = time.perf_counter()
        with count_syncs(info), k8_launch_shapes(k8_shapes):
            res, chaos, journal, health, spec, scrubber = supervised_run(
                scenario, m, codec, read_shard, write_shard, dev, pg_num, scrub)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        crush_syncs = interp_batch.HOST_SYNCS - syncs
        for kname, v in launches.items():
            path[kname] = path.get(kname, 0) + v
        s = res.summary()
        final = rec.peer_pool(m, chaos.osdmap, 1, device=dev)
        surv = final.n_survivors()
        below_k = {int(p) for p in final.pgs_with(rec.PG_STATE_DEGRADED) if surv[p] < k}
        wrong = [(pg, sh) for pg, shards in res.shards.items() for sh, buf in shards.items()
                 if not np.array_equal(buf, read_shard(pg, sh))]
        info.update(
            wall_s=wall, launches=launches, crush_host_syncs=crush_syncs,
            summary={key: s[key] for key in (
                "converged", "launches", "retries", "stale_launches", "salvaged_pgs",
                "plan_revisions", "time_to_zero_degraded_s", "epochs_observed",
                "completed_pgs", "schedule_launches", "bytes_recovered", "scrub_passes",
                "scrubbed_bytes", "inconsistencies_found", "verify_retries",
                "time_to_zero_inconsistent_s")},
            unrecoverable_pgs=s["unrecoverable_pgs"], below_k_pgs=sorted(below_k),
            failed_pgs=s["failed_pgs"], shards_checked=sum(len(v) for v in res.shards.values()),
            shards_wrong=len(wrong), slo=evaluate(health, spec).to_dict()["status"],
            health_samples=len(health), journal_records=len(journal.records))
        gates = {"converged": s["converged"], "shards_equal_store": not wrong,
                 "unrecoverable_is_below_k": set(s["unrecoverable_pgs"]) == below_k,
                 "no_failed_pgs": not s["failed_pgs"]}
        if scrub:
            rotted = {c.event.pg for c in chaos.corruptions}
            found = {p for r in journal.by_name("scrub.inconsistent") for p in r["attrs"]["pgs"]}
            after = scrubber.scrub(read_shard).n_inconsistent  # a check pass, after the counts
            info.update(corruptions=len(chaos.corruptions), corrupted_pgs=len(rotted),
                        found_pgs=len(found & rotted), closing_check_inconsistent=after,
                        scrub_GBps=s["scrubbed_bytes"] / wall / 1e9)
            gates.update(every_corruption_found=rotted <= found, scrubbed_clean=after == 0,
                         none_inconsistent_unrecoverable=not s["inconsistent_unrecoverable_pgs"])
        if scenario == "flapping-osd":
            det = chaos.liveness.summary()
            info.update(liveness=det, detector_epochs=[r["attrs"]["epoch"] for r in
                                                       journal.by_name("chaos.detected")])
            gates["detected"] = det["downs"] >= 1
        info["gates"] = gates
        out["passes"][scenario] = info
        print(json.dumps({"supervised_pass": scenario, "wall_s": wall,
                          "host_syncs": info["host_syncs"], "gates": gates}), flush=True)
    out["launches"] = path
    out["k8_launch_shapes"] = shape_summary(k8_shapes)
    out.update(phase_traffic(dev, launch_counts, reset_launches, m, codec, read_shard,
                             write_shard, pg_num))
    del full
    # the same seeded runs at a small size on the card and on the CPU
    n_small, pgs_small, chunk_small = small
    m_small = build_osdmap(n_small, pg_num=pgs_small, size=11, pool_kind="erasure")
    replay = {}
    for scenario in SUPERVISED_REPLAY:
        sums = []
        t0 = time.perf_counter()
        for d in (dev, torch.device("cpu")):
            c = create(profile, device=d)
            _, rd, wr = supervised_store(c, pgs_small, chunk_small, d)
            sums.append(supervised_run(scenario, m_small, c, rd, wr, d, pgs_small,
                                       scenario == "scrub-storm")[0].summary())
        replay[scenario] = {"equal": sums[0] == sums[1], "card": sums[0],
                            "check_wall_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    replay["traffic"] = traffic_replay(profile, m_small, pgs_small, chunk_small, dev)
    replay["traffic"]["check_wall_s"] = time.perf_counter() - t0
    out["card_equals_cpu"] = replay
    return out

EPOCH_OSDS = 1024               # BASELINE config 7's acceptance geometry
EPOCH_PGS = 8192
EPOCH_OPS = 64                  # ops a traffic step (config 7's)
EPOCH_EPOCHS = 1024             # superstep epochs timed, after a warm-up chunk
EPOCH_CHUNK = 256               # epochs a chunk (a snapshot, one copy back)
EPOCH_STAGED = 128              # staged epochs timed, after EPOCH_STAGED_WARM
EPOCH_STAGED_WARM = 8
EPOCH_PROFILED = 8              # config 7 epochs under torch.profiler for the split
EPOCH_TURN = 128                # epochs a run of the in-turns rates and the host split
EPOCH_WALK = "rack-cascade"     # the dirty walk's zoo scenario
EPOCH_SMALL = (64, 128)         # OSDs, PGs of the card-vs-CPU replay
EPOCH_SMALL_OPS = 256
#: the epoch body's pieces, each a span for the launch split
EPOCH_PIECES = {"tape": ("_tape_apply",), "liveness": ("_live",),
                "peering": ("_peer_hist", "_peer_hist_compact"),
                "traffic": ("_traffic_apply",), "scrub": ("_scrub_due",), "row": ("_row",)}


def series_head(series, n: int):
    """The first ``n`` epochs of an EpochSeries."""
    import dataclasses

    return type(series)(**{f.name: getattr(series, f.name)[:n]
                           for f in dataclasses.fields(series)})


@contextlib.contextmanager
def pieces_wrapped(driver, wrap):
    """Each piece method of ``driver`` (EPOCH_PIECES) replaced, on the
    instance, by ``wrap(piece, method)`` for the block."""
    for piece, methods in EPOCH_PIECES.items():
        for meth in methods:
            setattr(driver, meth, wrap(piece, getattr(driver, meth)))
    try:
        yield
    finally:
        for methods in EPOCH_PIECES.values():
            for meth in methods:
                delattr(driver, meth)


def piece_host_ms(driver, run, n_epochs: int) -> dict:
    """Host milliseconds an epoch in each piece of ``run()`` (host clock,
    no profiler; a piece called inside itself is timed once)."""
    acc = {p: 0.0 for p in EPOCH_PIECES}
    active: set = set()

    def timed(piece, fn):
        def call(*a, **kw):
            if piece in active:
                return fn(*a, **kw)
            active.add(piece)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[piece] += time.perf_counter() - t0
                active.discard(piece)
        return call

    with pieces_wrapped(driver, timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    return {"by_piece": {p: v / n_epochs * 1e3 for p, v in acc.items()},
            "epoch_ms": total / n_epochs * 1e3, "epochs": n_epochs}


def piece_launches(driver, run) -> dict:
    """Kernel launches, copies and memsets of ``run()`` split by the epoch
    body's pieces (EPOCH_PIECES): each piece of ``driver`` runs inside a
    ``torch.profiler.record_function`` span, and every runtime launch call
    the profiler saw is given to the innermost span around it.  Also the
    device's busy share of the run."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def spanned(name, fn):
        def call(*a, **kw):
            with record_function("epoch:" + name):
                return fn(*a, **kw)
        return call

    with pieces_wrapped(driver, spanned):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end, e.name[len("epoch:"):])
                   for e in events if e.name.startswith("epoch:"))
    calls = []
    for e in events:
        kind = ("kernels" if "LaunchKernel" in e.name else
                "copies" if e.name.startswith("cudaMemcpy") else
                "memsets" if e.name.startswith("cudaMemset") else None)
        if kind is not None and e.device_type == torch.autograd.DeviceType.CPU:
            calls.append((e.time_range.start, kind))
    split = {p: {"kernels": 0, "copies": 0, "memsets": 0} for p in (*EPOCH_PIECES, "other")}
    # one sweep in time order: the open spans form a stack (a dense
    # re-peer nests inside the compacted one), its top the innermost
    stack: list = []
    nxt = 0
    for t, kind in sorted(calls):
        while nxt < len(spans) and spans[nxt][0] <= t:
            stack.append(spans[nxt])
            nxt += 1
        stack = [sp for sp in stack if sp[1] >= t]
        split[stack[-1][2] if stack else "other"][kind] += 1
    device_us = sum(
        getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("epoch:"))
    return {"split": split, "wall_ms": wall_ms, "device_ms": device_us / 1e3,
            "device_busy": device_us / 1e3 / wall_ms if wall_ms else None}


def phase_epoch(dev, launch_counts, reset_launches, n_osds: int = EPOCH_OSDS,
                pg_num: int = EPOCH_PGS, epochs: int = EPOCH_EPOCHS, chunk: int = EPOCH_CHUNK,
                staged: int = EPOCH_STAGED, small=EPOCH_SMALL) -> dict:
    """The epoch loop (``recovery/superstep.py``): (a) BASELINE config 7 as
    ``bench/config7_epoch_loop.py`` runs it — ``build_osdmap(n_osds,
    pg_num, size=6, erasure)``, ``slow:5`` and ``slow:17`` at t=0.1,
    EPOCH_OPS ops a step; ``epochs`` superstep epochs in chunks of
    ``chunk`` after a warm-up chunk, ``staged`` staged epochs after
    EPOCH_STAGED_WARM: epochs/s, host syncs an epoch; (b) a dirty walk
    (EPOCH_WALK over enough epochs that every event lands) with
    compaction ``auto`` and ``off``, each through both paths; these runs
    are the path's launch counts.  Then the checks, outside the counts:
    the staged series over one chunk equal to the superstep's; the
    launches an epoch by piece (torch.profiler) over EPOCH_PROFILED
    config-7 epochs and over the auto walk; the walk at ``small`` size on
    the card and on the CPU, every lane equal."""
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.recovery.failure import parse_spec

    m = build_osdmap(n_osds, pg_num=pg_num, size=6, pool_kind="erasure")

    def config7():
        return rec.ChaosTimeline([rec.ChaosEvent(0.1, (parse_spec("slow:5"),
                                                       parse_spec("slow:17")))])

    out: dict = {"phase": "epoch", "osds": n_osds, "pgs": pg_num, "size": 6,
                 "n_ops": EPOCH_OPS, "chunk": chunk}
    path: dict[str, int] = {}

    def add(counts):
        for kname, v in counts.items():
            path[kname] = path.get(kname, 0) + v

    def timed(run, n: int) -> tuple:
        info: dict = {}
        with count_syncs(info):
            t0 = time.perf_counter()
            series = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        info.update(epochs=n, wall_s=wall, epochs_per_s=n / wall,
                    host_syncs_per_epoch=info["host_syncs"] / n,
                    dirty_epochs=int(series.dirty.sum()))
        return series, info

    walls: dict[str, float] = {}
    t_last = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        walls[name] = now - t_last[0]
        t_last[0] = now

    # (a) config 7
    t0 = time.perf_counter()
    driver = rec.EpochDriver(m, config7(), n_ops=EPOCH_OPS, device=dev)
    build_s = time.perf_counter() - t0
    reset_launches()
    driver.run_superstep(chunk, snapshot_every=chunk)
    torch.cuda.synchronize()
    sup, sup_info = timed(lambda: driver.run_superstep(epochs, snapshot_every=chunk), epochs)
    pulls = -(-epochs // chunk)
    # the chunk pulls are a chunk's, not an epoch's: one copy back each
    sup_info.update(chunk_pulls=pulls,
                    host_syncs_per_epoch_less_pulls=(sup_info["host_syncs"] - pulls) / epochs)
    driver.run_staged(EPOCH_STAGED_WARM)
    torch.cuda.synchronize()
    stg, stg_info = timed(lambda: driver.run_staged(staged), staged)
    add(launch_counts())
    out["config7"] = {"build_s": build_s, "superstep": sup_info, "staged": stg_info,
                      "ratio": sup_info["epochs_per_s"] / stg_info["epochs_per_s"]}
    lap("config7")

    # (b) the dirty walk, compaction auto and off, each through both paths
    tape = rec.compile_event_tape(rec.build_scenario(EPOCH_WALK, m), m)
    n_walk = int(np.ceil(float(tape.t.max()) / driver.dt)) + 8
    walks, walk_info, rungs, drivers = {}, {}, {}, {}
    for mode in ("auto", "off"):
        cfg = Config(env={})
        cfg.set("sparse_dirty_compaction", mode)
        d = rec.EpochDriver(m, rec.build_scenario(EPOCH_WALK, m), n_ops=EPOCH_OPS, config=cfg,
                            device=dev)
        for how in ("superstep", "staged"):
            reset_launches()
            series, info = timed(lambda: getattr(d, "run_" + how)(n_walk), n_walk)
            info["launches"] = launch_counts()
            add(info["launches"])
            walks[(mode, how)] = series
            walk_info[f"{mode}/{how}"] = info
        rungs[mode] = {"compaction_enabled": d.compaction_enabled, "ladder": d._dirty_ladder,
                       "rungs_taken": d.rungs_taken}
        drivers[mode] = d
    ref = walks[("off", "staged")]
    diffs = {f"{mode}/{how}": s.diff(ref) for (mode, how), s in walks.items()}
    walk_k3 = sum(i["launches"].get("descend", 0) for i in walk_info.values())
    out["walk"] = {"scenario": EPOCH_WALK, "epochs": n_walk, "tape_rows": len(tape),
                   "dirty_epochs": int(ref.dirty.sum()),
                   "dirty_at": np.nonzero(ref.dirty)[0].tolist(), "runs": walk_info,
                   "ladder": rungs, "diffs": diffs, "k3_launches": walk_k3}
    out["launches"] = path
    lap("walk")

    # the checks, outside the counts
    one_chunk = driver.run_staged(chunk).diff(series_head(sup, chunk))
    out["config7"]["staged_vs_superstep_one_chunk"] = one_chunk
    lap("staged_check")
    out["launch_split_config7"] = piece_launches(
        driver, lambda: driver.run_superstep(EPOCH_PROFILED))
    out["launch_split_config7"]["epochs"] = EPOCH_PROFILED
    out["host_ms_config7"] = piece_host_ms(driver, lambda: driver.run_superstep(EPOCH_TURN),
                                           EPOCH_TURN)
    # the two paths in turns, to read the rate's spread
    turns = []
    for how in ("superstep", "staged", "staged", "superstep"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(driver, "run_" + how)(EPOCH_TURN)
        torch.cuda.synchronize()
        turns.append([how, EPOCH_TURN / (time.perf_counter() - t0)])
    out["config7"]["epochs_per_s_in_turns"] = turns
    # the auto walk's first epochs, through its third dirty one
    d = drivers["auto"]
    n_prof = int(np.nonzero(ref.dirty)[0][:3][-1]) + 1
    out["launch_split_walk"] = piece_launches(d, lambda: d.run_superstep(n_prof))
    out["launch_split_walk"].update(epochs=n_prof, dirty_epochs=int(ref.dirty[:n_prof].sum()))
    lap("profiles")

    n_small, pgs_small = small
    m_small = build_osdmap(n_small, pg_num=pgs_small, size=6, pool_kind="erasure")
    small_runs = [rec.EpochDriver(m_small, rec.build_scenario(EPOCH_WALK, m_small),
                                  n_ops=EPOCH_SMALL_OPS, device=d_).run_superstep(n_walk)
                  for d_ in (dev, torch.device("cpu"))]
    out["card_equals_cpu"] = {"osds": n_small, "pgs": pgs_small, "epochs": n_walk,
                              "dirty_epochs": int(small_runs[1].dirty.sum()),
                              "diff": small_runs[0].diff(small_runs[1])}
    lap("card_equals_cpu")
    out["walls_s"] = walls
    quiet = sup_info["dirty_epochs"] == 0
    out["gates"] = {
        "config7_quiet": quiet,
        "config7_one_sync_a_quiet_epoch": quiet and sup_info["host_syncs_per_epoch_less_pulls"] <= 1,
        "config7_staged_equals_superstep": one_chunk == [],
        "walk_four_series_equal": all(v == [] for v in diffs.values()),
        "walk_dirty": int(ref.dirty.sum()) > 0,
        "walk_k3_launched": walk_k3 > 0,
        "walk_compacted": rungs["auto"]["compaction_enabled"],
        "card_equals_cpu": out["card_equals_cpu"]["diff"] == []
        and out["card_equals_cpu"]["dirty_epochs"] > 0,
    }
    return out


def ec_batch(name: str, dev):
    """A codec on the card and one encode call's data: EC_OBJECTS objects
    of EC_OBJECT_BYTES striped with EC_STRIPE_UNIT-byte chunks, as the
    k shard streams ``[k, EC_OBJECTS * EC_OBJECT_BYTES / k]`` (byte-local
    codes encode the concatenated streams as the objects one by one)."""
    from ceph_tpu_torch.ec import create

    profile, unit = EC_CODES[name]
    ec = create(profile, device=dev)
    k = ec.get_data_chunk_count()
    if ec.get_chunk_size(k * unit) != unit:
        raise AssertionError(f"{name}: a {k * unit}-byte stripe is not {k} chunks")
    data = card_bytes((k, EC_OBJECTS * EC_OBJECT_BYTES // k), SEED + k, dev)
    return ec, data, unit


def host_seconds(fn, reps: int) -> list[float]:
    """Host-clock seconds of ``fn`` followed by a device synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def phase_ec_encode(dev, batches: dict) -> dict:
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.testing import cppref

    out = {}
    for name in EC_CODES:
        ec, data, unit = ec_batch(name, dev)
        k, m = ec.get_data_chunk_count(), ec.get_coding_chunk_count()
        parity = ec.codec.encode_async(data)
        cols = -(-4 * MIB // k)  # >= 4 MiB of data columns against the C++ tier
        sample = data[:, :cols].cpu().numpy()
        if hasattr(ec.codec, "bitmatrix"):  # the packet layout (K5)
            want = cppref.bitmatrix_encode(ec.codec.bitmatrix, sample, ec.codec.packetsize)
        else:
            want = cppref.matrix_encode(ec.codec.matrix, sample)
        if not np.array_equal(parity[:, :cols].cpu().numpy(), want):
            raise AssertionError(f"{name}: parity differs from the C++ tier")
        ms = time_ms(lambda: ec.codec.encode_async(data))
        obj = np.random.default_rng(SEED).integers(0, 256, EC_OBJECT_BYTES, dtype=np.uint8)
        sw = k * unit
        iface = host_seconds(lambda: stripe.encode_object(ec, obj, sw), 10)
        sinfo, shards = stripe.encode_object(ec, obj, sw)
        if stripe.decode_object(ec, sinfo, shards, len(obj), failed=set(range(m))) != obj.tobytes():
            raise AssertionError(f"{name}: encode_object / decode_object round trip failed")
        batches[name] = (ec, data, parity)
        out[name] = {
            "k": k, "m": m, "chunk_bytes": data.shape[1], "data_bytes": data.numel(),
            "cpp_sample_bytes": k * cols,
            "device_ms": ms, "device_GBps": data.numel() / ms / 1e6,
            "object_bytes": EC_OBJECT_BYTES, "stripe_width": sw,
            "encode_object_s": float(np.median(iface)), "all_encode_object_s": iface,
            "encode_object_GBps": EC_OBJECT_BYTES / float(np.median(iface)) / 1e9,
            "profile_device": profile_call(lambda: ec.codec.encode_async(data)),
            "profile_encode_object": profile_call(lambda: stripe.encode_object(ec, obj, sw)),
        }
    return {"phase": "ec_encode", "objects": EC_OBJECTS, "codes": out}


def phase_ec_decode(dev, batches: dict) -> dict:
    out = {}
    for name, (ec, data, parity) in batches.items():
        k, m = ec.get_data_chunk_count(), ec.get_coding_chunk_count()
        lost = set(range(m))  # data chunks first
        rows = {i: data[i] for i in range(k)} | {k + j: parity[j] for j in range(m)}
        avail_dev = {i: t for i, t in rows.items() if i not in lost}
        got = ec.codec.decode_async(avail_dev, lost)
        if not all(torch.equal(got[i], data[i]) for i in lost):
            raise AssertionError(f"{name}: device-resident decode differs from the data")
        ms = time_ms(lambda: ec.codec.decode_async(avail_dev, lost), 5)
        avail = {i: t.cpu().numpy() for i, t in avail_dev.items()}
        size = data.shape[1]
        secs = host_seconds(lambda: ec.decode(lost, avail, size), 3)
        dec = ec.decode(lost, avail, size)
        for i in lost:
            if not np.array_equal(dec[i], data[i].cpu().numpy()):
                raise AssertionError(f"{name}: decode of chunk {i} differs from the data")
        out[name] = {"lost": sorted(lost), "data_bytes": data.numel(),
                     "device_ms": ms, "device_GBps": data.numel() / ms / 1e6,
                     "decode_s": float(np.median(secs)), "all_decode_s": secs,
                     "decode_GBps": data.numel() / float(np.median(secs)) / 1e9}
    return {"phase": "ec_decode", "codes": out}


def phase_ec_plugins(dev) -> dict:
    import hashlib

    from ceph_tpu_torch.ec import create

    with open(os.path.join(HERE, "tests", "golden", "archive.json")) as f:
        golden = json.load(f)["ec"]
    obj = np.random.default_rng(0xCE9).integers(0, 256, 40_000, dtype=np.uint8)
    bad = []
    for name, profile in GOLDEN_EC.items():
        ec = create(profile, device=dev)
        enc = ec.encode(set(range(ec.get_chunk_count())), obj)
        got = {str(i): hashlib.sha256(np.ascontiguousarray(enc[i]).tobytes()).hexdigest()
               for i in sorted(enc)}
        if got != golden[name]["chunks_sha256"] or len(enc[0]) != golden[name]["chunk_size"]:
            bad.append(name)
    if bad:
        raise AssertionError(f"EC digests differ from tests/golden/archive.json: {bad}")

    # CLAY k=4 m=2 (d=5): repair chunk 0 of a 64 MiB object from 5 helpers
    clay = create(GOLDEN_EC["clay_4_2"], device=dev)
    big = np.random.default_rng(SEED).integers(0, 256, 64 * MIB, dtype=np.uint8)
    t0 = time.perf_counter()
    enc = clay.encode(set(range(clay.get_chunk_count())), big)
    encode_s = time.perf_counter() - t0
    lost = 0
    helpers, planes = clay.minimum_to_decode_subchunks(lost, set(range(1, 6)))
    sub = len(enc[0]) // clay.get_sub_chunk_count()
    helper_subchunks = {i: {int(z): enc[i][z * sub:(z + 1) * sub] for z in planes}
                        for i in helpers}
    if not np.array_equal(clay.repair(lost, helper_subchunks), enc[lost]):
        raise AssertionError("CLAY repair differs from the lost chunk")
    secs = host_seconds(lambda: clay.repair(lost, helper_subchunks), 3)
    read = sum(len(v) for h in helper_subchunks.values() for v in h.values())

    # LRC k=4 m=2 l=3: one lost data chunk, repaired from its local group
    lrc = create(GOLDEN_EC["lrc_4_2_3"], device=dev)
    lenc = lrc.encode(set(range(lrc.get_chunk_count())), big[:4 * MIB])
    gone = lrc.chunk_mapping[0]
    avail = {i: c for i, c in lenc.items() if i != gone}
    t0 = time.perf_counter()
    dec = lrc.decode({gone}, avail, len(lenc[0]))
    lrc_s = time.perf_counter() - t0
    if not np.array_equal(dec[gone], lenc[gone]):
        raise AssertionError("LRC decode differs from the lost chunk")
    return {"phase": "ec_plugins", "golden_profiles": len(GOLDEN_EC), "golden_ok": True,
            "clay": {"object_bytes": big.size, "chunk_bytes": len(enc[0]), "encode_s": encode_s,
                     "lost": lost, "helpers": sorted(helpers), "helper_bytes_read": read,
                     "repair_s": float(np.median(secs)), "all_repair_s": secs,
                     "repair_GBps": len(enc[0]) / float(np.median(secs)) / 1e9,
                     "profile_repair": profile_call(lambda: clay.repair(lost, helper_subchunks))},
            "lrc": {"chunk_bytes": len(lenc[0]), "lost": gone,
                    "read": sorted(lrc.minimum_to_decode({gone}, set(avail))), "decode_s": lrc_s}}


def profile_call(fn) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler),
    and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        # a record_function span shows on the device timeline too; it is
        # no device work of its own
        span = getattr(e, "is_user_annotation", False) or e.key.startswith("recovery:")
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA and not span:
            rows.append({"kernel": e.key[:80], "ms": us / 1e3, "count": e.count})
    rows.sort(key=lambda r: -r["ms"])
    device_ms = sum(r["ms"] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_busy": device_ms / wall_ms,
            "top": rows[:10]}


@contextlib.contextmanager
def masked_rounds():
    """Run the general engine's retry rounds masked over the whole batch,
    whatever its size: the comparison for its compacted-straggler rounds,
    which it runs from ``interp.COMPACT_MIN_BATCH`` lanes up."""
    from ceph_tpu_torch.crush import interp

    keep = interp.COMPACT_MIN_BATCH
    interp.COMPACT_MIN_BATCH = 1 << 62
    try:
        yield
    finally:
        interp.COMPACT_MIN_BATCH = keep


def masked(fn):
    """``fn`` with its retry rounds masked (:func:`masked_rounds`)."""
    def run():
        with masked_rounds():
            return fn()
    return run


def in_turns(runners: dict, reps: int) -> dict:
    """Host seconds of ``reps`` calls of each runner, in turns, the order
    reversed every other turn (A B, B A, ...), so that drift on the host
    hits them alike."""
    labels = list(runners)
    times = {label: [] for label in labels}
    for i in range(reps):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            t0 = time.perf_counter()
            runners[label]()
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    return times


def phase_crush(n: int, dev, modes) -> dict:
    """Every mode of the fast engine on config 1."""
    from ceph_tpu_torch.core import straw2
    from ceph_tpu_torch.crush import interp_batch
    from ceph_tpu_torch.crush.engine import make_batch_runner
    from ceph_tpu_torch.models.clusters import build_simple
    from ceph_tpu_torch.testing import cppref

    m = build_simple(1024)
    rule = m.rule_by_name("replicated_rule")
    dense = m.to_dense()
    w = np.full(dense.max_devices, 0x10000, np.uint32)
    xs = torch.arange(n, dtype=torch.int64, device=dev)
    labels = list(modes)
    out, first, runners = {}, None, {}
    for label in labels:
        crush_arg, fn = make_batch_runner(dense, rule, REPLICAS, mode=label, device=dev)
        runners[label] = lambda fn=fn, crush_arg=crush_arg: fn(crush_arg, w, xs)
        before = dict(straw2.LAUNCHES)
        syncs = interp_batch.HOST_SYNCS
        res, lens = runners[label]()
        torch.cuda.synchronize()
        out[label] = {"launches": {k: straw2.LAUNCHES[k] - before[k] for k in before},
                      "host_syncs": interp_batch.HOST_SYNCS - syncs}
        if first is None:
            first = (res, lens)
        elif not (torch.equal(res, first[0]) and torch.equal(lens, first[1])):
            raise AssertionError(f"{label} disagrees with mode {labels[0]}")
    times = in_turns(runners, 6)
    for label in labels:
        sec = float(np.median(times[label]))
        out[label].update(placements_per_s=n / sec, seconds=sec, all_seconds=times[label],
                          profile=profile_call(runners[label]))
    res, lens = first
    placed = res[:, :REPLICAS].to(torch.int64)
    if (res.shape != (n, REPLICAS) or not bool((lens == REPLICAS).all())
            or bool(((placed < 0) | (placed >= dense.max_devices)).any())
            or bool((placed.sort(dim=1).values.diff(dim=1) == 0).any())):
        raise AssertionError("placements are not 3 distinct in-range OSDs per object")
    k = min(n, 50_000)
    steps = [(s.op, s.arg1, s.arg2) for s in rule.steps]
    rr, ll = cppref.do_rule_batch(dense, steps, np.arange(k, dtype=np.uint32), w, REPLICAS)
    if not (np.array_equal(first[0][:k].cpu().numpy(), rr)
            and np.array_equal(first[1][:k].cpu().numpy(), ll)):
        raise AssertionError("device placements differ from the C++ tier")
    return {"phase": "crush", "objects": n, "modes": out, "cpp_sample": k}


def emptying_rule_edges(dev, n: int = 4096) -> list[dict]:
    """A choose step whose effective numrep (arg1 + result_max) is <= 0
    empties the working vector, so the emit writes nothing
    (``mapper.c``, the C++ tier): on ``build_flat(4)`` take, choose
    firstn -1 type 0, emit, result_max 1; and on ``build_simple(16)``
    take, choose firstn 2 host, choose firstn -3 osd, emit, result_max
    3.  Each runs in ``descend`` mode on the card against the C++ tier."""
    from ceph_tpu_torch.crush.engine import make_batch_runner
    from ceph_tpu_torch.crush.map import OP_CHOOSE_FIRSTN, OP_EMIT, OP_TAKE, Step
    from ceph_tpu_torch.models.clusters import build_flat, build_simple
    from ceph_tpu_torch.testing import cppref

    flat, simple = build_flat(4), build_simple(16)
    host = simple.type_id("host")
    cases = {
        "flat(4): choose firstn -1 type 0, result_max 1": (flat, [
            Step(OP_TAKE, flat.bucket_by_name("default").id), Step(OP_CHOOSE_FIRSTN, -1, 0),
            Step(OP_EMIT)], 1),
        "simple(16): choose firstn 2 host, choose firstn -3 osd, result_max 3": (simple, [
            Step(OP_TAKE, simple.bucket_by_name("default").id), Step(OP_CHOOSE_FIRSTN, 2, host),
            Step(OP_CHOOSE_FIRSTN, -3, 0), Step(OP_EMIT)], 3),
    }
    xs = np.arange(n, dtype=np.uint32)
    out = []
    for label, (m, steps, rm) in cases.items():
        rule = m.add_rule(f"emptying_{len(out)}", steps)
        dense = m.to_dense()
        w = np.full(dense.max_devices, 0x10000, np.uint32)
        crush_arg, fn = make_batch_runner(dense, rule, rm, mode="descend", device=dev)
        res, lens = fn(crush_arg, w, xs)
        cres, clens = cppref.do_rule_batch(dense, [(s.op, s.arg1, s.arg2) for s in steps], xs,
                                           w, rm)
        out.append({"case": label, "mode": "descend", "xs": n,
                    "max_len": int(lens.max()), "cpp_max_len": int(clens.max()),
                    "equal_cpp": bool(np.array_equal(res.cpu().numpy(), cres)
                                      and np.array_equal(lens.cpu().numpy(), clens))})
    return out


def phase_osdmap(dev) -> dict:
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.osdmap import OSDMapMapping, PGId

    rng = np.random.default_rng(SEED)
    m = build_osdmap(1024, pg_num=32768)
    pg_num = 32768
    # upmap items that move a replica the PG really has
    moved = [int(v) for v in rng.choice(pg_num, 64, replace=False)]
    for ps, raw in m.pg_to_raw_osds_batch(1, moved).items():
        to = int(rng.integers(1024))
        if to not in raw:
            m.pg_upmap_items[PGId(1, ps)] = ((raw[0], to),)
    m.pg_upmap[PGId(1, 5)] = (1, 100, 200)
    m.pg_temp[PGId(1, 7)] = (3, 300, 600)
    m.primary_temp[PGId(1, 9)] = 42
    for o in rng.choice(1024, 32, replace=False):
        m.osd_primary_affinity[int(o)] = int(rng.integers(0, 0x10000))
    m.mark_down(17)
    t0 = time.perf_counter()
    mp = OSDMapMapping(m, device=dev)
    mp.update()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp.update()
    again = time.perf_counter() - t0
    special = [5, 7, 9] + [pg.ps for pg in m.pg_upmap_items][:16]
    sample = sorted(set(special) | set(int(v) for v in rng.choice(pg_num, 300, replace=False)))
    for ps in sample:
        pg = PGId(1, ps)
        if mp.get(pg) != m.pg_to_up_acting_osds(pg):
            raise AssertionError(f"pg {pg}: {mp.get(pg)} != {m.pg_to_up_acting_osds(pg)}")
    up = mp._results[1][0]
    if up.shape != (pg_num, 3) or (up[up != 0x7FFFFFFF] >= 1024).any():
        raise AssertionError("mapping has the wrong shape or an out-of-range OSD")
    return {"phase": "osdmap", "pgs": pg_num, "sample_checked": len(sample),
            "first_update_s": first, "update_s": again, "pgs_per_s": pg_num / again}


def mixed_hierarchy(racks: int, hosts: int, osds: int):
    """straw2 root and racks over uniform hosts of ``osds`` OSDs each (the
    shape of build_hierarchy([("rack", racks), ("host", hosts)], osds)),
    with its replicated rule (chooseleaf firstn host) and an EC rule
    (set_chooseleaf_tries 5, chooseleaf indep 0 type host)."""
    from ceph_tpu_torch.crush.map import ALG_STRAW2, ALG_UNIFORM, CrushMap

    m = CrushMap()
    for tid, name in ((1, "root"), (2, "rack"), (3, "host")):
        m.add_type(tid, name)
    root = m.add_bucket("default", "root", alg=ALG_STRAW2)
    osd = 0
    for r in range(racks):
        rack = m.add_bucket(f"rack{r}", "rack", alg=ALG_STRAW2)
        for h in range(hosts):
            host = m.add_bucket(f"host{r}_{h}", "host", alg=ALG_UNIFORM)
            for _ in range(osds):
                m.insert_item(host.id, osd, 0x10000)
                osd += 1
            m.insert_item(rack.id, host.id, osds * 0x10000)
        m.insert_item(root.id, rack.id, hosts * osds * 0x10000)
    m.make_replicated_rule("replicated_rule", "default", "host")
    m.make_erasure_rule("ec_rule", "default", "host")
    return m


def phase_general(dev, counts, reset, n: int = OBJECTS) -> dict:
    """The general engine on the card: (a) a uniform 1024-OSD hierarchy
    (32 racks of 8 hosts of 4 OSDs) under its replicated rule; (b) the
    same shape with straw2 root and racks over uniform hosts, 32 OSDs
    reweighted to 0, under a replicated and an EC rule (6 slots).  Each:
    the router's tier, host syncs and K1 launches of one call, n objects
    timed with compacted retry rounds (the default at this size) and
    masked ones in turns (median of 6 each, host clock; the two results
    equal), a profile of one call each way, and 65,536 placements
    (compacted, the threshold) and the same masked equal to the C++
    tier.  Returns the path's launch counts (one call of each map)."""
    from ceph_tpu_torch.crush import interp, interp_batch
    from ceph_tpu_torch.crush.engine import make_batch_runner, runner_signature
    from ceph_tpu_torch.crush.map import ALG_UNIFORM
    from ceph_tpu_torch.models.clusters import build_hierarchy
    from ceph_tpu_torch.testing import cppref

    uniform = build_hierarchy([("rack", 32), ("host", 8)], osds_per_leaf=4, alg=ALG_UNIFORM)
    mixed = mixed_hierarchy(32, 8, 4)
    out_w = np.full(1024, 0x10000, np.uint32)
    out_w[np.random.default_rng(SEED).choice(1024, 32, replace=False)] = 0
    cases = {
        "a_uniform_replicated": (uniform, "replicated_rule", REPLICAS,
                                 np.full(1024, 0x10000, np.uint32)),
        "b_mixed_replicated": (mixed, "replicated_rule", REPLICAS, out_w),
        "b_mixed_ec": (mixed, "ec_rule", 6, out_w),
    }
    xs = torch.arange(n, dtype=torch.int64, device=dev)
    out, runs = {}, {}
    for label, (m, rule_name, rm, w) in cases.items():
        dense, rule = m.to_dense(), m.rule_by_name(rule_name)
        tier = runner_signature(dense, rule, rm)[0]
        if tier != "general":
            raise AssertionError(f"{label}: routed to the {tier} tier")
        crush_arg, fn = make_batch_runner(dense, rule, rm, device=dev)
        runs[label] = (dense, rule, rm, w, fn, crush_arg)
    reset()
    results = {}
    for label, (dense, rule, rm, w, fn, crush_arg) in runs.items():
        before, syncs = counts()["negdraw"], interp_batch.HOST_SYNCS
        results[label] = fn(crush_arg, w, xs)
        torch.cuda.synchronize()
        out[label] = {"rule": rule.name, "result_max": rm,
                      "k1_launches_per_call": counts()["negdraw"] - before,
                      "host_syncs_per_call": interp_batch.HOST_SYNCS - syncs,
                      "out_osds": int((w == 0).sum())}
    launches = counts()
    steps_of = lambda rule: [(s.op, s.arg1, s.arg2) for s in rule.steps]
    k = interp.COMPACT_MIN_BATCH
    for label, (dense, rule, rm, w, fn, crush_arg) in runs.items():
        run = lambda fn=fn, ca=crush_arg, w=w: fn(ca, w, xs)
        syncs = interp_batch.HOST_SYNCS
        with masked_rounds():
            res_m, lens_m = run()
        out[label]["masked_host_syncs_per_call"] = interp_batch.HOST_SYNCS - syncs
        res, lens = results[label]
        if not (torch.equal(res, res_m) and torch.equal(lens, lens_m)):
            raise AssertionError(f"{label}: compacted and masked rounds differ")
        times = in_turns({"compacted": run, "masked": masked(run)}, 6)
        for way, secs in times.items():
            sec = float(np.median(secs))
            out[label][way] = {"seconds": sec, "all_seconds": secs, "placements_per_s": n / sec}
        out[label]["placements_per_s"] = out[label]["compacted"]["placements_per_s"]
        out[label]["profile"] = profile_call(run)
        out[label]["masked"]["profile"] = profile_call(masked(run))
        sample = np.arange(k, dtype=np.uint32)
        rr, ll = cppref.do_rule_batch(dense, steps_of(rule), sample, w, rm)
        for way, call in (("compacted", lambda: fn(crush_arg, w, sample)),
                          ("masked", masked(lambda: fn(crush_arg, w, sample)))):
            sres, slens = call()
            if not (np.array_equal(sres.cpu().numpy(), rr)
                    and np.array_equal(slens.cpu().numpy(), ll)):
                raise AssertionError(f"{label}: the general engine ({way}) differs from C++")
        if res.shape != (n, rm) or not np.array_equal(res[:k].cpu().numpy(), rr):
            raise AssertionError(f"{label}: the 1M-object run differs from the C++ tier")
        out[label].update(cpp_sample=k, equal_cpp=True,
                          none_slots=int((res == 0x7FFFFFFF).sum()))
        if label.startswith("b_") and out[label]["k1_launches_per_call"] <= 0:
            raise AssertionError(f"{label}: the straw2 levels never launched K1")
    return {"phase": "general", "objects": n, "tier": "general", "maps": out,
            "launches": launches}


# BASELINE config 5: a failure-driven rebalance of 100M objects on a
# 10k-OSD straw2 map (bench/config5_rebalance_sim.py's configuration)
REBALANCE_OSDS = 10_000
REBALANCE_FAILED = 100          # 1% of the OSDs out
REBALANCE_CHUNK = 1 << 20
REBALANCE_CHUNKS_PER_LAUNCH = 8
REBALANCE_LAUNCHES = 12         # 12 x 8 x 2^20 = 100,663,296 objects >= 100M
REBALANCE_SAMPLE = 65_536


def phase_rebalance(dev, counts, reset) -> dict:
    """Config 5 at its own size: build_simple(10000, 8 OSDs a host, 16
    hosts a rack), 3 replicas, 100 OSDs out; 12 launches of 8 chunks of
    2^20 objects (every object of 100M placed): placements/s (2 x objects
    / seconds), the moved count and fraction beside the ideal 3.0%, K3
    launches, host syncs and peak memory; a profile of one launch (after
    the counts).  Gate: 65,536 objects at the start of the first launch
    and of the last are placed as the C++ tier places them, before and
    after, and their moved count is the C++ tier's."""
    from ceph_tpu_torch.crush import interp_batch
    from ceph_tpu_torch.crush.engine import make_batch_runner
    from ceph_tpu_torch.models.clusters import build_simple
    from ceph_tpu_torch.parallel.placement import sharded_rebalance_sim
    from ceph_tpu_torch.testing import cppref

    m = build_simple(REBALANCE_OSDS, osds_per_host=8, hosts_per_rack=16)
    rule = m.rule_by_name("replicated_rule")
    dense = m.to_dense()
    w_before = np.full(dense.max_devices, 0x10000, np.uint32)
    w_after = w_before.copy()
    failed = np.random.default_rng(0).choice(REBALANCE_OSDS, REBALANCE_FAILED, replace=False)
    w_after[failed] = 0
    per_launch = REBALANCE_CHUNK * REBALANCE_CHUNKS_PER_LAUNCH
    objects = per_launch * REBALANCE_LAUNCHES
    ideal = REBALANCE_FAILED * REPLICAS / REBALANCE_OSDS
    step = sharded_rebalance_sim(dense, rule, REPLICAS, REBALANCE_CHUNK,
                                 REBALANCE_CHUNKS_PER_LAUNCH, dev)
    reset()
    syncs = interp_batch.HOST_SYNCS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    moved = int(sum(step(w_before, w_after, i * per_launch) for i in range(REBALANCE_LAUNCHES)))
    sec = time.perf_counter() - t0
    launches = counts()
    out = {"seconds": sec, "placements_per_s": 2 * objects / sec, "moved": moved,
           "moved_fraction": moved / objects, "k3_launches": launches["descend"],
           "host_syncs": interp_batch.HOST_SYNCS - syncs,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "profile_one_launch": profile_call(lambda: step(w_before, w_after, 0))}
    steps = [(s.op, s.arg1, s.arg2) for s in rule.steps]
    crush_arg, fn = make_batch_runner(dense, rule, REPLICAS, device=dev)
    sample_sim = sharded_rebalance_sim(dense, rule, REPLICAS, REBALANCE_SAMPLE, 1, dev)
    samples = []
    for start in (0, (REBALANCE_LAUNCHES - 1) * per_launch):
        xs = np.arange(start, start + REBALANCE_SAMPLE, dtype=np.uint32)
        cpp = [cppref.do_rule_batch(dense, steps, xs, w, REPLICAS) for w in (w_before, w_after)]
        card = [fn(crush_arg, w, xs) for w in (w_before, w_after)]
        equal = all(np.array_equal(c[0].cpu().numpy(), p[0]) and
                    np.array_equal(c[1].cpu().numpy(), p[1]) for c, p in zip(card, cpp))
        cpp_moved = int((cpp[0][0] != cpp[1][0]).any(axis=1).sum())
        sim_moved = int(sample_sim(w_before, w_after, start))
        samples.append({"start": start, "objects": REBALANCE_SAMPLE, "equal_cpp": equal,
                        "moved": sim_moved, "cpp_moved": cpp_moved})
        if not equal or sim_moved != cpp_moved:
            raise AssertionError(f"rebalance sample at {start} differs from the C++ tier")
    return {"phase": "rebalance", "osds": REBALANCE_OSDS, "failed_osds": REBALANCE_FAILED,
            "objects": objects, "launches_of_the_sim": REBALANCE_LAUNCHES,
            "chunk": REBALANCE_CHUNK, "chunks_per_launch": REBALANCE_CHUNKS_PER_LAUNCH,
            "devices": 1, "ideal_moved_fraction": ideal, **out, "samples": samples,
            "launches": launches}


def scalar_sample(m, mp, rng, pool_id: int = 1) -> int:
    """Hold ``SCALAR_SAMPLE`` PGs of the mapping ``mp`` against the scalar
    pipeline (``pg_to_up_acting_osds``, CRUSH on the C++ tier)."""
    from ceph_tpu_torch.osdmap import PGId

    pg_num = m.pools[pool_id].pg_num
    for ps in sorted(int(v) for v in rng.choice(pg_num, SCALAR_SAMPLE, replace=False)):
        pg = PGId(pool_id, ps)
        if mp.get(pg) != m.pg_to_up_acting_osds(pg):
            raise AssertionError(f"pg {pg}: {mp.get(pg)} != {m.pg_to_up_acting_osds(pg)}")
    return SCALAR_SAMPLE


def plan_rows(inc) -> tuple[list, list]:
    return (sorted((pg.pool, pg.ps, tuple(v)) for pg, v in inc.new_pg_upmap_items.items()),
            sorted((pg.pool, pg.ps) for pg in inc.old_pg_upmap_items))


def scorer_plan(start, scorer: str, dev) -> tuple:
    """The first plan of ``calc_pg_upmaps`` with ``scorer`` on a copy of
    ``start`` whose mapping is already built on ``dev``, and its times:
    the call's seconds and each scorer call's ms on the host's clock
    (the device scorer's call ends with its copy back, so the clock
    holds its device work)."""
    import copy

    from ceph_tpu_torch.balancer import calc_pg_upmaps, upmap
    from ceph_tpu_torch.osdmap import OSDMapMapping

    m = copy.deepcopy(start)
    mp = OSDMapMapping(m, device=dev)
    mp.update()
    fn_name = {"device": "_score_candidate_moves_device",
               "numpy": "_score_candidate_moves_np"}[scorer]
    inner = getattr(upmap, fn_name)
    calls_ms: list[float] = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        calls_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(upmap, fn_name, timed)
    try:
        t0 = time.perf_counter()
        plan = calc_pg_upmaps(m, max_deviation=BALANCER_MAX_DEVIATION,
                              max_entries=BALANCER_MAX_OPTIMIZATIONS, mapping=mp,
                              scorer=scorer)
        secs = time.perf_counter() - t0
    finally:
        setattr(upmap, fn_name, inner)
    return plan, {"seconds": secs, "scorer_ms": float(sum(calls_ms)), "scorer_calls_ms": calls_ms}


def phase_balancer(dev, launch_counts, reset_launches, n_osds: int = BALANCER_OSDS,
                   pg_num: int = BALANCER_PGS, golden_sha: str | None = None) -> dict:
    """BASELINE config 3 on the card: (a) bulk remaps of
    ``build_osdmap(n_osds, pg_num)``, one reweight toggled before each,
    as PG mappings/s; (b) the upmap balancer on
    ``build_skewed_osdmap(n_osds, pg_num)`` (``optimize`` + ``execute``
    until a plan is empty), its table's SHA-256 against
    ``golden_sha`` (default: the stored config-3 digest), converged, its
    first plan equal to the first plan of each scorer, timed side by
    side (``scorer_plan``), its mapping equal to the scalar pipeline; (c) one crush-compat tick on a fresh skewed map,
    not worse, equal to the C++ tier under the new weight set.  The
    launch counts cover (a), (b)'s loop and (c), not the checks."""
    import copy

    from ceph_tpu_torch.balancer import Balancer, upmap
    from ceph_tpu_torch.models.clusters import build_osdmap, build_skewed_osdmap
    from ceph_tpu_torch.osdmap import OSDMapMapping
    from ceph_tpu_torch.testing import golden

    rng = np.random.default_rng(SEED + 3)
    path_counts: dict[str, int] = {}

    def tally() -> None:
        for kname, v in launch_counts().items():
            path_counts[kname] = path_counts.get(kname, 0) + v

    # (a) bulk remap
    m = build_osdmap(n_osds, pg_num=pg_num)
    reset_launches()
    t0 = time.perf_counter()
    mp = OSDMapMapping(m, device=dev)
    mp.update()
    first_s = time.perf_counter() - t0
    secs = []
    for i in range(BALANCER_REMAPS):
        m.osd_weight[i] = 0xFFFF if m.osd_weight[i] == 0x10000 else 0x10000
        t0 = time.perf_counter()
        mp.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    tally()
    rates = [pg_num / s for s in secs]
    remap = {"pgs": pg_num, "first_update_s": first_s, "update_s": secs,
             "pg_mappings_per_s": float(np.median(rates)),
             "pg_mappings_per_s_low_high": [min(rates), max(rates)],
             "sample_checked": scalar_sample(m, mp, rng)}
    del m, mp

    # (b) the optimizer loop, the device scorer timed by CUDA events
    ms = build_skewed_osdmap(n_osds, pg_num=pg_num)
    start = copy.deepcopy(ms)
    score_ms: list[float] = []
    admissible: list[int] = []
    remap_s: list[float] = []
    inner = upmap._score_candidate_moves_device

    def timed_scorer(*args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(*args, **kwargs)
        b.record()
        b.synchronize()
        score_ms.append(a.elapsed_time(b))
        admissible.append(len(out[0]))
        return out

    bal = Balancer(ms, max_deviation=BALANCER_MAX_DEVIATION,
                   max_optimizations=BALANCER_MAX_OPTIMIZATIONS, device=dev)
    update = bal.mapping.update

    def timed_update(*args, **kwargs):
        t0 = time.perf_counter()
        update(*args, **kwargs)
        remap_s.append(time.perf_counter() - t0)

    dev_before = max(bal.evaluate().pool_max_deviation.values())
    plans, first_plan = [], None
    upmap._score_candidate_moves_device = timed_scorer
    bal.mapping.update = timed_update
    reset_launches()
    try:
        t_loop = time.perf_counter()
        for _ in range(32):
            score_ms.clear()
            admissible.clear()
            remap_s.clear()
            t0 = time.perf_counter()
            plan = bal.optimize()
            sec = time.perf_counter() - t0
            st = upmap.LAST_RUN_STATS
            first_plan = first_plan or plan
            plans.append({"new": len(plan.new_pg_upmap_items),
                          "removed": len(plan.old_pg_upmap_items), "seconds": sec,
                          **st.as_dict(), "scorer_device_ms": float(sum(score_ms)),
                          "scorer_calls_ms": list(score_ms), "admissible": list(admissible),
                          "remaps": len(remap_s), "remap_s": float(sum(remap_s)),
                          "host_rest_s": sec - float(sum(remap_s)) - float(sum(score_ms)) / 1e3})
            if not bal.execute(plan):
                break
        loop_s = time.perf_counter() - t_loop
    finally:
        upmap._score_candidate_moves_device = inner
        del bal.mapping.update
    tally()
    ev = bal.evaluate()
    final_dev = max(ev.pool_max_deviation.values())
    sha = golden.upmap_table_sha256(ms.pg_upmap_items)
    want_sha = golden_sha or golden.CONFIG3_UPMAP_SHA256
    if sha != want_sha:
        raise AssertionError(f"config-3 upmap table {sha} != {want_sha}")
    if final_dev > BALANCER_MAX_DEVIATION:
        raise AssertionError(f"balancer did not converge: max deviation {final_dev}")
    scorers = {name: scorer_plan(start, name, dev) for name in upmap.SCORERS}
    for name, (plan, _) in scorers.items():
        if plan_rows(plan) != plan_rows(first_plan):
            raise AssertionError(f"the {name} scorer's first plan differs from the loop's")
    bal.mapping.update()
    optimizer = {
        "osds": n_osds, "pgs": pg_num, "max_deviation_before": dev_before,
        "plans": plans, "loop_s": loop_s, "max_deviation_after": final_dev,
        "converged": True, "epoch": ms.epoch, "upmap_pgs": len(ms.pg_upmap_items),
        "upmap_pairs": sum(len(v) for v in ms.pg_upmap_items.values()),
        "table_sha256": sha, "numpy_plan_equal": True,
        "first_plan_by_scorer": {name: t for name, (_, t) in scorers.items()},
        "sample_checked": scalar_sample(ms, bal.mapping, rng),
    }
    prof_map = copy.deepcopy(start)
    prof_bal = Balancer(prof_map, max_deviation=BALANCER_MAX_DEVIATION,
                        max_optimizations=BALANCER_MAX_OPTIMIZATIONS, device=dev)
    prof_plans = []
    optimizer["profile_first_optimize"] = profile_call(
        lambda: prof_plans.append(prof_bal.optimize()))
    if plan_rows(prof_plans[0]) != plan_rows(first_plan):
        raise AssertionError("the profiled first optimize() gave another plan")
    del ms, start, bal, prof_map, prof_bal

    # (c) crush-compat: one tick on a fresh skewed map
    mc = build_skewed_osdmap(n_osds, pg_num=pg_num)
    cbal = Balancer(mc, mode="crush-compat", max_deviation=BALANCER_MAX_DEVIATION, device=dev)
    before = max(cbal.evaluate().pool_max_deviation.values())
    version = mc.crush.version
    reset_launches()
    t0 = time.perf_counter()
    changed = cbal.tick()
    tick_s = time.perf_counter() - t0
    tally()
    after = max(cbal.evaluate().pool_max_deviation.values())
    if after > before:
        raise AssertionError(f"crush-compat made the deviation worse: {before} -> {after}")
    cbal.mapping.update()
    compat = {"tick_s": tick_s, "changed": changed, "max_deviation_before": before,
              "max_deviation_after": after, "crush_versions": mc.crush.version - version,
              "sample_checked": scalar_sample(mc, cbal.mapping, rng)}
    return {"phase": "balancer", "bulk_remap": remap, "optimizer": optimizer,
            "crush_compat": compat, "launches": path_counts}


def run_cli(main_fn, argv) -> tuple[int, str, float]:
    """(exit code, standard output, seconds) of one CLI ``main(argv)``."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def phase_cli(dev, launch_counts, reset_launches, work_dir: str,
              n_osds: int = BALANCER_OSDS, pg_num: int = BALANCER_PGS,
              max_x: int = 65535, ec_size: int = 16 * MIB) -> dict:
    """The harnesses through their ``main()`` on the card: crushtool
    ``--test`` on build_simple(n_osds) equal to ``--cpu``; osdmaptool
    ``--createsimple``, ``--test-map-pgs`` and ``--upmap``, whose command
    file must hold ``calc_pg_upmaps``'s plan for the same saved map (the
    gate checks the plan; the file's text is held to the reference's in
    ``tests/test_torch_cli.py``); ec_bench for reed_sol_van and
    cauchy_good k=8 m=3, then one ``ec_size`` object encoded on the card
    equal to the CPU's encode.  The launch counts cover the CLIs' runs,
    not the checks (``--cpu``, the plan, the encodes)."""
    from ceph_tpu_torch.balancer import calc_pg_upmaps
    from ceph_tpu_torch.cli import crushtool, ec_bench, osdmaptool
    from ceph_tpu_torch.ec import create
    from ceph_tpu_torch.models.clusters import build_simple

    path_counts: dict[str, int] = {}

    def tally() -> None:
        for kname, v in launch_counts().items():
            path_counts[kname] = path_counts.get(kname, 0) + v

    crush_path = os.path.join(work_dir, "simple.json")
    with open(crush_path, "wb") as f:
        f.write(build_simple(n_osds).encode())
    argv = ["-i", crush_path, "--test", "--show-statistics", "--show-mappings",
            "--max-x", str(max_x)]
    on_dev = ["--device", dev.type]
    reset_launches()
    rc, card_out, card_s = run_cli(crushtool.main, argv + on_dev)
    tally()
    rc_cpu, cpu_out, cpu_s = run_cli(crushtool.main, argv + ["--cpu"])
    if rc or rc_cpu or card_out != cpu_out or card_out.count("\n") != max_x + 2:
        raise AssertionError("crushtool --test on the card differs from --cpu")
    out = {"phase": "cli", "crushtool": {
        "map": f"build_simple({n_osds})", "xs": max_x + 1, "card_s": card_s, "cpu_s": cpu_s,
        "statistics": [ln for ln in card_out.splitlines() if ln.startswith("rule ")],
        "equal_cpu": True}}

    map_path = os.path.join(work_dir, "osdmap.json")
    cmd_path = os.path.join(work_dir, "upmap.sh")
    reset_launches()
    rc, _, create_s = run_cli(osdmaptool.main, [map_path, "--createsimple", str(n_osds),
                                                "--pg-num", str(pg_num)])
    rc2, test_out, test_s = run_cli(osdmaptool.main, [map_path, "--test-map-pgs"] + on_dev)
    rc3, upmap_out, upmap_s = run_cli(osdmaptool.main, [map_path, "--upmap", cmd_path,
                                                        "--upmap-max", "2000"] + on_dev)
    tally()
    with open(cmd_path) as f:
        written = f.read()
    plan = calc_pg_upmaps(osdmaptool.load(map_path), max_deviation=1.0, max_entries=2000,
                          device=dev)
    want = "".join(ln + "\n" for ln in osdmaptool.upmap_commands(plan))
    if rc or rc2 or rc3 or written != want or not written:
        raise AssertionError("osdmaptool --upmap's command file is not calc_pg_upmaps's plan")
    out["osdmaptool"] = {
        "osds": n_osds, "pgs": pg_num, "createsimple_s": create_s, "test_map_pgs_s": test_s,
        "test_map_pgs": [ln for ln in test_out.splitlines()
                         if ln.startswith(("avg", "min", "mapping time"))],
        "upmap_s": upmap_s, "upmap": upmap_out.strip(), "commands": written.count("\n"),
        "rm_commands": written.count("rm-pg-upmap-items"), "file_equal_plan": True}

    out["ec_bench"] = {}
    obj = np.random.default_rng(SEED + 4).integers(0, 256, ec_size, dtype=np.uint8)
    for name, params in (("reed_sol_van_8_3", ["technique=reed_sol_van"]),
                         ("cauchy_good_8_3_p2048", ["technique=cauchy_good", "packetsize=2048"])):
        kvs = ["k=8", "m=3"] + params
        profile = {"plugin": "jerasure", **dict(kv.split("=") for kv in kvs)}
        args = ["--plugin", "jerasure", "--size", str(ec_size), "--iterations", "10"] + on_dev
        args += [a for kv in kvs for a in ("--parameter", kv)]
        reset_launches()
        rc, line, _ = run_cli(ec_bench.main, args)
        tally()
        fields = line.strip().split("\t")
        if rc or len(fields) != 2 or not fields[1].endswith(" MB/s"):
            raise AssertionError(f"ec_bench {name} printed {line!r}")
        want_chunks, got_chunks = (create(profile, device=d).encode(set(range(11)), obj)
                                   for d in ("cpu", dev))
        chunk = len(got_chunks[0])
        if sorted(got_chunks) != sorted(want_chunks) or any(
                not np.array_equal(got_chunks[i], want_chunks[i]) for i in want_chunks):
            raise AssertionError(f"ec_bench {name}: the card's encode differs from the CPU's")
        out["ec_bench"][name] = {"size": ec_size, "line": line.strip(), "chunk_bytes": chunk,
                                 "encode_equal_cpu": True}
    out["launches"] = path_counts
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ceph_tpu_torch import _cuda
    from ceph_tpu_torch.core import straw2
    from ceph_tpu_torch.crush import interp_batch
    from ceph_tpu_torch.ec import gf_kernels, kernels as ec_kernels
    from ceph_tpu_torch.recovery import scrub as scrub_mod

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    built = _cuda.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {lib: ptxas_report(lib) for lib in _cuda.SIGNATURES}
    from ceph_tpu_torch.testing import sass

    splits = sass.straw2_splits(
        sass.cuobjdump_sass(os.path.join(_cuda.BUILD_DIR, "libstraw2.so")))
    emit({"phase": "build", "seconds": seconds, "nvcc_seconds": built, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda, "ptxas": ptxas,
          "ops_per_draw": OPS_PER_DRAW, "draw_split_sass": splits})

    int_rate = int32_ops_per_s()
    straw2_phase = phase_kernels(OBJECTS, int_rate, dev, splits)
    kernels = straw2_phase["results"]
    for k in kernels:
        k["ptxas"] = {n: v for n, v in ptxas["straw2"].items()
                      if n.startswith("straw2_" + k["name"].split("_")[0])}
    emit({"phase": "kernels", "lanes": OBJECTS, "int32_ops_per_s": int_rate, **straw2_phase})
    bad = [k["name"] for k in kernels if not k["bit_equal"]]
    bad += [e["case"] for e in straw2_phase["edges"] if not e["bit_equal"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    ec = phase_ec_kernels(int_rate, dev)
    prefixes = {"matrix_encode": "gf_matrix", "bitmatrix_encode": "gf2_bitmatrix",
                "byte_lut": "byte_lut"}
    for r in ec["results"]:
        r["ptxas"] = {k: v for k, v in ptxas["ec"].items() if k.startswith(prefixes[r["name"]])}
    emit(ec)
    bad = [r["name"] for r in ec["results"] if not r["bit_equal"]]
    bad += [e["case"] for e in ec["edges"] if not e["bit_equal"]]
    if bad:
        raise AssertionError(f"EC kernels disagree with their plain versions: {bad}")

    sched = phase_schedule_kernel(int_rate, dev)
    sched["results"][0]["ptxas"] = {k: v for k, v in ptxas["ec"].items()
                                    if k.startswith("xor_program")}
    emit(sched)
    bad = [r["name"] for r in sched["results"] if not (r["bit_equal"] and r["k5_equal"])]
    bad += [e["case"] for e in sched["edges"] if not e["bit_equal"]]
    if bad:
        raise AssertionError(f"K6 disagrees with its plain version: {bad}")
    scrub_phase = phase_scrub_kernel(int_rate, dev)
    fold_split = sass.crc_split(sass.cuobjdump_sass(os.path.join(_cuda.BUILD_DIR,
                                                                 "libscrub.so")))
    for r in scrub_phase["results"]:
        # dynamic shared memory: csrc/scrub.cu's kSmemBytes (T0..T3 one copy a
        # bank, 128 KiB; the staged lines, 72 KiB)
        r["ptxas"] = {k: dict(v, dynamic_smem_bytes=204800) for k, v in ptxas["scrub"].items()}
        r["fold_split_sass"] = fold_split
    emit(scrub_phase)
    bad = [r["name"] for r in scrub_phase["results"] if not r["bit_equal"]]
    bad += [e["case"] for e in scrub_phase["edges"] if not e["bit_equal"]]
    if bad:
        raise AssertionError(f"K8 disagrees with its plain version: {bad}")

    def counts() -> dict:
        return {**straw2.LAUNCHES, **gf_kernels.LAUNCHES, **ec_kernels.LAUNCHES,
                **scrub_mod.LAUNCHES}

    def reset() -> None:
        straw2.reset_launches()
        gf_kernels.reset_launches()
        ec_kernels.reset_launches()
        scrub_mod.reset_launches()

    # each main path from 0: placement (raw CRUSH in every mode, then the
    # OSDMap), EC (encode, decode, the plugins), recovery
    paths = {}
    # the crush phase's edges run before the counts start: their launches
    # are checks, not the main path's
    edges = emptying_rule_edges(dev)
    bad = [e["case"] for e in edges if not e["equal_cpp"]]
    if bad:
        raise AssertionError(f"rules that empty the working vector differ from the C++ tier: {bad}")
    reset()
    emit({**phase_crush(OBJECTS, dev, interp_batch.MODES), "edges": edges})
    emit(phase_osdmap(dev))
    paths["placement"] = counts()
    general = phase_general(dev, counts, reset)
    emit(general)
    paths["general"] = general["launches"]
    rebalance = phase_rebalance(dev, counts, reset)
    emit(rebalance)
    paths["rebalance"] = rebalance["launches"]
    reset()
    batches = {}
    emit(phase_ec_encode(dev, batches))
    emit(phase_ec_decode(dev, batches))
    batches.clear()
    emit(phase_ec_plugins(dev))
    paths["ec"] = counts()
    recovery = phase_recovery(dev, counts, reset)
    emit(recovery)
    paths["recovery"] = recovery["launches"]
    supervised = phase_supervised(dev, counts, reset)
    emit(supervised)
    paths["supervised"] = supervised["launches"]
    paths["traffic"] = supervised["traffic"]["launches"]
    paths["scrub_qos"] = supervised["scrub_qos"]["launches"]
    bad = [(p, g) for p, info in supervised["passes"].items()
           for g, ok in info["gates"].items() if not ok]
    bad += [(p, g) for p in ("traffic", "scrub_qos")
            for g, ok in supervised[p]["gates"].items() if not ok]
    bad += [(s_, "card_equals_cpu") for s_, r in supervised["card_equals_cpu"].items()
            if not r["equal"]]
    if bad:
        raise AssertionError(f"supervised recovery failed its gates: {bad}")
    epoch = phase_epoch(dev, counts, reset)
    emit(epoch)
    paths["epoch"] = epoch["launches"]
    bad = [g for g, ok in epoch["gates"].items() if not ok]
    if bad:
        raise AssertionError(f"the epoch loop failed its gates: {bad}")
    balancer = phase_balancer(dev, counts, reset)
    emit(balancer)
    paths["balancer"] = balancer["launches"]
    import tempfile

    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as work_dir:
        cli = phase_cli(dev, counts, reset, work_dir)
    emit(cli)
    paths["cli"] = cli["launches"]
    emit({"launches_by_path": paths})
    print(json.dumps({"phase_walls_s": PHASE_WALLS,
                      "total_s": time.perf_counter() - T_START}), flush=True)
    need = {"placement": ("negdraw", "level_choose", "descend"),
            "general": ("negdraw",), "rebalance": ("descend",),
            "ec": ("matrix_encode", "bitmatrix_encode", "byte_lut"),
            "recovery": ("descend", "matrix_encode", "schedule_apply"),
            "supervised": ("descend", "matrix_encode", "crc32c_rows"),
            "traffic": ("descend", "matrix_encode"),
            "scrub_qos": ("descend", "matrix_encode", "crc32c_rows"),
            "epoch": ("descend",),
            "balancer": ("descend",),
            "cli": ("descend", "matrix_encode", "bitmatrix_encode")}
    missing = [(p, k) for p, ks in need.items() for k in ks if paths[p].get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"a kernel of a main path never launched: {missing}")
    launches = {k: sum(p.get(k, 0) for p in paths.values()) for k in counts()}

    # one record per kernel: K4 at k=8 m=3, K7 over the CLAY encode's 64 MiB
    main_ec = [r for r in ec["results"] if r["name"] != "matrix_encode" or "k=8" in r["shape"]]
    main_ec = [r for r in main_ec if r["name"] != "byte_lut" or "encode" in r["shape"]]
    main_ec = [r for r in main_ec if r["name"] != "bitmatrix_encode" or "decoder" not in r["shape"]]
    main_ec += sched["results"]
    records = [dict(k, source="ceph_tpu_torch/csrc/straw2.cu") for k in kernels]
    records += [dict(r, source="ceph_tpu_torch/csrc/ec.cu") for r in main_ec]
    # K8 at the scrub pass, with its decode-verify shape beside it
    scrub_pass, verify = scrub_phase["results"]
    records.append(dict(scrub_pass, source="ceph_tpu_torch/csrc/scrub.cu", at_verify_shape={
        key: verify[key] for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}))
    emit({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[k["name"]],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": k["library_ms"],
         "pipe_floor_ms": k.get("pipe_floor_ms"),
         **({"at_verify_shape": k["at_verify_shape"]} if "at_verify_shape" in k else {})}
        for k in records]})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
