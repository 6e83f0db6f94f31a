"""Drive ceph_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. build: compile the CUDA kernels from ``ceph_tpu_torch/csrc/`` with
   nvcc (sm_90a) and print the build seconds and the card;
2. kernels: hold K1 (negdraw), K2 (level_choose) and K3 (descend_fused)
   against their plain PyTorch versions on the card, bit for bit, at the
   slice's shapes (1M lanes, build_simple(1024) tables), and time both;
3. crush: ``make_batch_runner`` on build_simple(1024)'s replicated rule
   (3 replicas), 1M objects, in each mode; bit-equal across modes and to
   the C++ reference tier on a 50k sample; placements/s per mode (the
   modes timed in turns, median of 5 calls each), and a torch.profiler
   breakdown of one call per mode;
4. osdmap: ``OSDMapMapping.update`` on build_osdmap(1024, pg_num=32768)
   with upmap items, a full pg_upmap, pg_temp, primary affinity and one
   OSD down; a sample of PGs must equal the scalar pipeline.

Then the kernels line (launch counts from phases 3-4, the main path; all
must be > 0), the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
REPLICAS = 3
OBJECTS = 1 << 20

# ~32-bit integer operations of one straw2 draw, counted from the
# source of csrc/straw2.cu: hash32_3 = 3 seed xors + 5 mixes x 9 lines x
# 4 ops (183); crush_ln's shifts, compares, index math, 64-bit multiply
# and adds (~25); 2^48 - ln (2); the 64x64 high multiply (~6), q*w and
# the remainder (~5), three corrections (~18); first-index compare and
# winner select (~6).
OPS_PER_DRAW = 245
ISSUE_LANES_PER_SM = 128  # 4 schedulers x one 32-lane warp instruction a clock
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)


def emit(obj) -> None:
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


def kernel_record(name: str, replaces: str, kernel, plain, nbytes: int, draws: int,
                  int_rate: float) -> dict:
    """Run ``kernel`` and ``plain`` on the same card inputs, compare them
    bit for bit, time both, and bound the kernel."""
    got, want = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    equal = all(a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))
                for a, b in zip(got, want))
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, want))
    bms, by = bound_ms(nbytes, draws * OPS_PER_DRAW, int_rate)
    return {"name": name, "replaces": replaces, "bit_equal": equal, "max_abs_err": err,
            "ms": time_ms(kernel), "plain_ms": time_ms(plain, 3), "bound_ms": bms,
            "bound_by": by, "draws": draws}


def phase_kernels(n: int, int_rate: float, dev) -> list[dict]:
    """K1-K3 vs their plain versions at the main path's shapes: n lanes
    on build_simple(1024)'s descent tables (root 1x32, racks 32x8,
    hosts 256x4)."""
    from ceph_tpu_torch.core import straw2
    from ceph_tpu_torch.crush import interp_batch
    from ceph_tpu_torch.models.clusters import build_simple

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
                       int((rows[1] != 0).sum()), int_rate)
    # K2 at the same level: row fetch, draws and argmin in one launch
    fanout = pack.meta[0][1]
    k2 = kernel_record("level_choose", "ceph_tpu/core/pallas_straw2.py:384",
                       lambda: straw2.level_choose(x, r, lidx, pack, 0),
                       lambda: straw2.level_choose_plain(x, r, lidx, pack, 0),
                       n * (3 * 4 + 4 * 4) + table_bytes, n * fanout, int_rate)
    # K3: the rule's descent root -> rack -> host for every lane
    k3 = kernel_record("descend", "ceph_tpu/core/pallas_straw2.py:603",
                       lambda: straw2.descend_fused(x, r, lidx, active, pack, 3, False, 1024),
                       lambda: straw2.descend_plain(x, r, lidx, active, pack, 3, False, 1024),
                       n * (3 * 4 + 1 + 2 * 4 + 2) + table_bytes,
                       count_descend_draws(x, r, lidx, active, pack, 3, 1024), int_rate)
    # and the leaf descent host -> osd from the hosts the lanes reached
    item, ok, hard, nl = straw2.descend_fused(x, r, lidx, active, pack, 3, False, 1024)
    k3["bit_equal"] = k3["bit_equal"] and all(
        bool(torch.equal(a, b)) for a, b in zip(
            straw2.descend_fused(x, r, nl, ok, leaf, 0, False, 1024),
            straw2.descend_plain(x, r, nl, ok, leaf, 0, False, 1024)))
    return [k1, k2, k3]


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
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"kernel": e.key[:80], "ms": us / 1e3, "count": e.count})
    rows.sort(key=lambda r: -r["ms"])
    device_ms = sum(r["ms"] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_busy": device_ms / wall_ms,
            "top": rows[:10]}


def phase_crush(n: int, dev, modes) -> dict:
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
    out, first, runners = {}, None, {}
    for mode in modes:
        crush_arg, fn = make_batch_runner(dense, rule, REPLICAS, mode=mode, device=dev)
        runners[mode] = lambda fn=fn, crush_arg=crush_arg: fn(crush_arg, w, xs)
        before = dict(straw2.LAUNCHES)
        syncs = interp_batch.HOST_SYNCS
        res, lens = runners[mode]()
        torch.cuda.synchronize()
        out[mode] = {"launches": {k: straw2.LAUNCHES[k] - before[k] for k in before},
                     "host_syncs": interp_batch.HOST_SYNCS - syncs}
        if first is None:
            first = (res, lens)
        elif not (torch.equal(res, first[0]) and torch.equal(lens, first[1])):
            raise AssertionError(f"mode {mode} disagrees with mode {modes[0]}")
    # the modes take turns, so drift on the host hits all of them alike
    times = {mode: [] for mode in modes}
    for _ in range(5):
        for mode in modes:
            t0 = time.perf_counter()
            runners[mode]()
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
    for mode in modes:
        sec = float(np.median(times[mode]))
        out[mode].update(placements_per_s=n / sec, seconds=sec, all_seconds=times[mode],
                         profile=profile_call(runners[mode]))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ceph_tpu_torch import _cuda
    from ceph_tpu_torch.core import straw2
    from ceph_tpu_torch.crush import interp_batch

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    built = _cuda.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": built,
          "card": card, "torch": torch.__version__, "cuda": torch.version.cuda})
    with open(os.path.join(_cuda.BUILD_DIR, "straw2.ptxas.txt")) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]

    int_rate = int32_ops_per_s()
    kernels = phase_kernels(OBJECTS, int_rate, dev)
    emit({"phase": "kernels", "lanes": OBJECTS, "int32_ops_per_s": int_rate,
          "ptxas": ptxas, "results": kernels})
    bad = [k["name"] for k in kernels if not k["bit_equal"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    # the main path: counts from 0, raw CRUSH in every mode, then the OSDMap
    straw2.reset_launches()
    emit(phase_crush(OBJECTS, dev, interp_batch.MODES))
    emit(phase_osdmap(dev))
    launches = dict(straw2.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    emit({"kernels": [
        {"name": k["name"], "route": "cuda", "source": "ceph_tpu_torch/csrc/straw2.cu",
         "replaces": k["replaces"], "launches": launches[k["name"]],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None}
        for k in kernels]})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
