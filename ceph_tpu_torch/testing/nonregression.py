"""Non-regression archives and the hot paths' launch and sync budgets.

The counterpart of the reference package's ``testing/nonregression.py``.

Placements and EC encodings are ABI: the archive
(``tests/golden/archive.json``) pins SHA-256 digests of CRUSH mapping
tables per map shape and of EC chunks per profile, over fixed seeds.
:func:`generate` recomputes them through the port on ``device``;
printed as below, the output is byte-equal to the archive on the CPU and
on the card::

    python -m ceph_tpu_torch.testing.nonregression [--device cpu|cuda]

:func:`launch_budget_cases` pins *how often* the hot paths build, launch
and read back, in place of the reference's ``compile_once_cases``.  Each
scenario runs once warm, then makes the reference's value-only change
and runs a second time inside ``CompileBudget(0)``, a
:class:`~ceph_tpu_torch.analysis.runtime_guard.LaunchCounter` and a
:class:`~ceph_tpu_torch.analysis.runtime_guard.TransferCounter`.  The
second run must stay within :data:`BUDGETS`: no build, at most the
stated calls of each hand-written kernel, at most the stated host reads
(seam calls, counted alike on the CPU and on the card).  On the card
every call must also launch its kernel, and the sync-debug warnings are
reported beside the seam reads.  A CUDA graph capture counts as a build;
a graph replay makes no wrapper call, and the launches it ran count as
replayed launches.  In ``fused_placement`` on the card the second run
is one replay of the fused placement->peering program's graph with no
seam read; in ``epoch_superstep`` and ``compacted_superstep`` one replay
of the compiled epoch superstep's graph a chunk, and in
``online_write_batch`` one replay of the compiled write path's graph
(K9, K6 and K9's commit inside it), each with no seam read and no
sync-debug warning (the reference's zero).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

# ---------------------------------------------------------------- the archive


def _digest(arr) -> str:
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _weighted_flat():
    from ..models.clusters import build_flat

    m = build_flat(7)
    root = m.bucket_by_name("default")
    for i, osd in enumerate(root.items):
        m.adjust_item_weight(root.id, osd, 0x8000 + i * 0x4000)
    return m


def crush_cases(device="cuda") -> dict[str, dict]:
    """The three archived maps, 2048 inputs and 3 replicas each, through
    the batch engine's default mode on ``device``."""
    from .. import resolve_device
    from ..crush.engine import make_batch_runner
    from ..models.clusters import build_flat, build_hierarchy

    dev = resolve_device(device)
    specs = {
        "flat_16": build_flat(16),
        "flat_7_weighted": _weighted_flat(),
        "rack_host_osd": build_hierarchy([("rack", 2), ("host", 4)], 4),
    }
    cases = {}
    for name, m in specs.items():
        rule = m.rule_by_name("replicated_rule")
        dense = m.to_dense()
        xs = torch.arange(2048, dtype=torch.int64, device=dev)
        w = torch.full((dense.max_devices,), 0x10000, dtype=torch.int64, device=dev)
        crush_arg, fn = make_batch_runner(dense, rule, 3, device=dev)
        res, lens = fn(crush_arg, w, xs)
        cases[name] = {
            "mappings_sha256": _digest(res.to(torch.int32)),
            "lens_sha256": _digest(lens.to(torch.int32)),
        }
    return cases


#: the archived EC profiles, over one 40,000-byte object
EC_PROFILES = {
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


def ec_cases(device="cuda") -> dict[str, dict]:
    """Every archived profile's chunks of the seeded object, encoded
    through ``ceph_tpu_torch.ec.create(profile, device=device)``."""
    from ..ec import create

    rng = np.random.default_rng(0xCE9)
    obj = rng.integers(0, 256, 40_000, dtype=np.uint8)
    out = {}
    for name, profile in EC_PROFILES.items():
        ec = create(profile, device=device)
        n = ec.get_chunk_count()
        enc = ec.encode(set(range(n)), obj)
        out[name] = {
            "chunk_size": len(enc[0]),
            "chunks_sha256": {str(i): _digest(enc[i]) for i in sorted(enc)},
        }
    return out


def generate(device="cuda") -> dict:
    return {"version": 1, "crush": crush_cases(device), "ec": ec_cases(device)}


def render(archive: dict) -> str:
    """The archive's text, as ``tests/golden/archive.json`` holds it."""
    return json.dumps(archive, indent=1, sort_keys=True) + "\n"


# ---------------------------------------------------------------- the budgets


@dataclass(frozen=True)
class Budget:
    """What a scenario's second run may spend: kernel calls by kernel
    (a kernel not named may not be called), host reads at the seams,
    and no build.  ``why`` says why a budget is above the reference's
    zero host transfers."""

    calls: dict = field(default_factory=dict)
    host_reads: int = 0
    why: str = ""


_LADDER = ("the retry ladder's one read a round (crush/interp_batch.py `_any`: whether any "
           "lane still retries decides the next round)")
_EPOCH_READ = ("a non-idle epoch's one read after the tick (recovery/superstep.py "
               "`EpochDriver._live`: whether the map moved, any OSD down or laggy; the host keeps "
               "the epoch and the clock)")

#: the second run's budget of each scenario, measured on the CPU (the
#: reference holds every scenario to zero builds, and its scan scenarios
#: to zero host transfers; a kernel call is one launch on the card)
BUDGETS: dict[str, Budget] = {
    "pool_mapping": Budget(
        {"descend": 18}, 17,
        f"9 are {_LADDER}; 8 read the four mapping tables back to the host "
        "(osdmap/mapping.py `update`: `.cpu().numpy()` each, the result)"),
    "pattern_decode": Budget(
        {"matrix_encode": 2}, 4,
        "each of the two pattern groups reads its rebuilt chunks back "
        "(recovery/executor.py `_finalize_group`: `.cpu().numpy()`, the result)"),
    "schedule_decode": Budget(
        {"schedule_apply": 2}, 4,
        "each of the two XOR-schedule groups reads its rebuilt chunks back "
        "(ec/schedule.py `finalize`: `.cpu().numpy()`, the result)"),
    "scrub_pass": Budget(
        {"crc32c_rows": 1}, 5,
        "the pass reads its verdict back: the bad-shard mask, the histogram "
        "(`.cpu().numpy()` each) and the bad count (`int`), recovery/scrub.py `scrub`"),
    "heartbeat_tick": Budget(
        {}, 24,
        "each of the two ticks reads its six lanes back for the host's markdown "
        "bookkeeping (recovery/liveness.py `tick`: `.cpu().numpy()` each)"),
    "fused_placement": Budget(
        {"descend": 36}, 18,
        f"on the CPU the fused program runs eagerly, two epochs' mappings: all are {_LADDER} "
        "(on the card the run is one graph replay: no wrapper call and no read)"),
    "epoch_superstep": Budget(
        {"descend": 170}, 114,
        f"on the CPU the host-decided loop: 100 are {_LADDER}; 14 are {_EPOCH_READ} "
        "(`.cpu().tolist()`, 7 epochs) (on the card the window is one replay of the compiled "
        "superstep's graph: no wrapper call, no read and no sync warning)"),
    "fleet_superstep": Budget(
        {"descend": 272}, 176,
        f"on the CPU the host-decided loop: 172 are {_LADDER}; 4 read the active lanes' flags "
        "and keys once a window (recovery/fleet.py `FleetDriver._live`: `.cpu().numpy()`, "
        "twice) (on the card the run is one replay of the compiled fleet's graph, captured at "
        "the first run in the pad bucket: no wrapper call, no read and no sync warning)"),
    "compacted_superstep": Budget(
        {"descend": 360}, 215,
        f"on the CPU the host-decided loop: 210 are {_LADDER}; 5 are the compaction ladder's "
        "rung read (recovery/superstep.py `_peer_hist_compact`: `int(n_dirty)` picks the rung's "
        "width) (on the card the walk is one replay of the compiled superstep's graph, the rung "
        "a SWITCH node: no wrapper call, no read and no sync warning)"),
    "online_write_batch": Budget(
        {"descend": 170, "schedule_apply": 8, "stripe_absorb": 8, "stripe_commit": 8}, 114,
        f"on the CPU the host-decided loop: 100 are {_LADDER}; 14 are {_EPOCH_READ} (7 epochs) "
        "(on the card the run at the second cap is one replay of the compiled write path's "
        "graph, captured at the first: no wrapper call, no read and no sync warning)"),
    "reconcile_round": Budget(
        {}, 0,
        "on the CPU the host-decided body, its epochs idle (on the card each rank's chunk is "
        "one load of its tape and one replay of the template's tape program: no wrapper call, "
        "no read and no sync warning)"),
    "worksteal_dispatch": Budget({"matrix_encode": 32}, 0),
}


def _check(name: str, seen: dict) -> None:
    b = BUDGETS[name]
    over = {k: v for k, v in seen["calls"].items() if v > b.calls.get(k, 0)}
    if over or seen["host_reads"] > b.host_reads or seen["builds"]:
        raise AssertionError(
            f"{name}: over budget — calls {seen['calls']} (budget {b.calls}), host reads "
            f"{seen['host_reads']} (budget {b.host_reads}), builds {seen['builds']} (budget 0)")


class _Second:
    """The second run's scope: ``CompileBudget(0)``, kernel calls (each
    a launch on the card), seam reads and, on the card, sync-debug
    warnings."""

    def __init__(self, what: str, dev: torch.device):
        from ..analysis.runtime_guard import CompileBudget, LaunchCounter, TransferCounter

        cuda = dev.type == "cuda"
        self.budget = CompileBudget(0, what)
        self.launches = LaunchCounter(check_launches=cuda)
        self.reads = TransferCounter(sync_debug=cuda)
        self.cuda = cuda

    def __enter__(self):
        self.budget.__enter__()
        self.launches.__enter__()
        self.reads.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.reads.__exit__(*exc)
        self.launches.__exit__(*exc)
        self.budget.__exit__(*exc)

    def report(self) -> dict:
        return {"builds": self.budget.n_compiles, "calls": dict(self.launches.calls),
                "launches": dict(self.launches.launches),
                "replayed_launches": dict(self.launches.replays),
                "host_reads": self.reads.host_transfers,
                "reads_by_seam": dict(self.reads.by_seam),
                "sync_warnings": self.reads.sync_warnings}


def launch_budget_cases(device="cuda") -> dict[str, dict]:
    """Run every scenario on ``device``; raise ``AssertionError`` when a
    second run builds, goes over its :data:`BUDGETS` entry, or (on the
    card) calls a kernel without launching it, or when a scenario's own
    equality or bucket assertion fails.  Returns each scenario's second
    run: builds, calls and launches by kernel, seam reads (and by seam)
    and sync-debug warnings."""
    from .. import resolve_device

    dev = resolve_device(device)
    report = {}
    for name, case in _CASES.items():
        seen = case(dev)
        report[name] = seen
        _check(name, seen)
    return report


_CASES: dict = {}


def _case(fn):
    _CASES[fn.__name__.removeprefix("_case_")] = fn
    return fn


@_case
def _case_pool_mapping(dev):
    """OSDMapMapping.update() after a reweight: the balancer's whole-map
    remap loop and config 3's timed region."""
    from ..models.clusters import build_osdmap
    from ..osdmap.mapping import OSDMapMapping

    m = build_osdmap(32, pg_num=16)
    mapping = OSDMapMapping(m, device=dev)
    mapping.update()
    m.osd_weight[0] = 0x8000  # value-only edit: same shapes
    with _Second("pool mapping second update", dev) as s:
        mapping.update()
    return s.report()


def _degraded_peering(k, size, masks, pool_id):
    from ..crush.map import ITEM_NONE
    from ..recovery.peering import PG_STATE_CLEAN, PG_STATE_DEGRADED, PeeringResult

    prev = np.arange(len(masks) * size, dtype=np.int32).reshape(-1, size)
    acting = prev.copy()
    flags = np.full(len(masks), PG_STATE_CLEAN, np.int32)
    mask_arr = np.full(len(masks), (1 << size) - 1, np.uint32)
    for i, mask in enumerate(masks):
        for s in range(size):
            if not (mask >> s) & 1:
                acting[i, s] = ITEM_NONE
        flags[i] = PG_STATE_DEGRADED
        mask_arr[i] = mask
    return PeeringResult(
        pool_id=pool_id, epoch_prev=1, epoch_cur=2, size=size, min_size=k,
        up=acting.copy(), up_primary=acting[:, 0].copy(),
        acting=acting, acting_primary=acting[:, 0].copy(),
        prev_acting=prev, flags=flags, survivor_mask=mask_arr,
        n_alive=(acting != ITEM_NONE).sum(axis=1).astype(np.int32),
    )


def _decode_twice(dev, codec, encode, plan, chunk, k, what):
    from ..recovery import RecoveryExecutor

    def store_for(seed):
        rng = np.random.default_rng(seed)
        out = {}
        for g in plan.groups:
            for pg in g.pgs:
                data = rng.integers(0, 256, (k, chunk), dtype=np.uint8)
                out[int(pg)] = np.vstack([data, encode(data)])
        return out

    ex = RecoveryExecutor(codec, device=dev)
    s1 = store_for(1)
    ex.run(plan, lambda pg, s: s1[pg][s])
    s2 = store_for(2)  # fresh values, identical shapes
    with _Second(what, dev) as s:
        res = ex.run(plan, lambda pg, s_: s2[pg][s_])
    assert res.shards, "the decode rebuilt nothing"
    for pg, shards in res.shards.items():
        for shard, data in shards.items():
            np.testing.assert_array_equal(np.asarray(data), s2[int(pg)][shard])
    return s.report()


@_case
def _case_pattern_decode(dev):
    """RecoveryExecutor.run() on the same plan with fresh chunk data:
    config 6's timed region (K4)."""
    from ..ec.backend import MatrixCodec
    from ..ec.gf import vandermonde_matrix
    from ..recovery import build_plan

    k, m_par, chunk = 4, 2, 128
    peering = _degraded_peering(k, k + m_par, [0b001111, 0b110011], 1)
    codec = MatrixCodec(vandermonde_matrix(k, m_par), device=dev)
    plan = build_plan(peering, codec)
    return _decode_twice(dev, codec, codec.encode, plan, chunk, k,
                         "pattern-grouped decode second run")


@_case
def _case_schedule_decode(dev):
    """The same second run for a bitmatrix-native codec (liberation),
    whose pattern groups run cached XOR schedules (K6)."""
    from ..ec import gfw
    from ..ec.backend import BitmatrixCodec
    from ..recovery import build_plan

    k, m_par, w, packetsize = 4, 2, 7, 8
    codec = BitmatrixCodec(gfw.liberation_bitmatrix(k, w), w, packetsize, device=dev)
    peering = _degraded_peering(k, k + m_par, [0b011110, 0b111100], 2)
    plan = build_plan(peering, codec)
    return _decode_twice(dev, codec, codec.encoder.encode, plan, 2 * w * packetsize, k,
                         "XOR-schedule decode second run")


@_case
def _case_scrub_pass(dev):
    """A second whole-pool CRC32C scrub after a byte of the store rots
    (K8): corruption changes values, never shapes."""
    from ..recovery.scrub import Scrubber, apply_bitrot

    n_pgs, n_shards, chunk = 8, 6, 64
    rng = np.random.default_rng(3)
    store = {(pg, s): rng.integers(0, 256, chunk, dtype=np.uint8)
             for pg in range(n_pgs) for s in range(n_shards)}
    scrubber = Scrubber(n_pgs, n_shards, device=dev)
    scrubber.build_checksums(lambda pg, s: store[(pg, s)])
    scrubber.scrub(lambda pg, s: store[(pg, s)])
    apply_bitrot(store[(3, 1)], 17, 0x40)
    with _Second("scrub second pass", dev) as s:
        sr = scrubber.scrub(lambda pg, s_: store[(pg, s_)])
    assert sr.n_inconsistent == 1, sr.n_inconsistent
    return s.report()


@_case
def _case_heartbeat_tick(dev):
    """The liveness detector's heartbeat update across suppression-mask,
    clock and knob changes."""
    from ..common.config import Config
    from ..recovery.chaos import VirtualClock
    from ..recovery.failure import parse_spec
    from ..recovery.liveness import LivenessDetector

    cfg = Config(env={})
    cfg.set("osd_heartbeat_grace", 1.0)
    cfg.set("mon_osd_min_down_reporters", 1)
    clock = VirtualClock()
    det = LivenessDetector(8, clock, config=cfg, device=dev)
    det.apply(parse_spec("netsplit:5"))
    clock.advance(0.5)
    det.tick()
    det.apply(parse_spec("netsplit:5:restore"))
    clock.advance(0.1)
    det.tick()
    det.apply(parse_spec("netsplit:1"))
    det.apply(parse_spec("netsplit:3"))
    cfg.set("osd_heartbeat_grace", 2.0)
    with _Second("heartbeat tick value-only changes", dev) as s:
        clock.advance(2.5)
        det.tick()
        det.apply(parse_spec("netsplit:1:restore"))
        clock.advance(2.0)
        det.tick()
    assert det.osds_down >= 1, det.summary()
    return s.report()


@_case
def _case_fused_placement(dev):
    """The fused placement->peering program (recovery/pipeline.py) across
    a down-OSD/reweight epoch after a warm one: every changed bit is an
    input of the one program, so the second epoch builds and captures
    nothing; on the card it is one replay of the graph the first call
    captured.  The second epoch's outputs equal the staged pass's."""
    from ..models.clusters import build_osdmap
    from ..osdmap.mapping import build_pool_state
    from ..recovery.peering import PeeringEngine

    m = build_osdmap(32, pg_num=16)
    eng = PeeringEngine(m, 1, device=dev)
    fused = eng._fused
    state_a = build_pool_state(m, m.pools[1], device=dev)
    fused(eng._fused_arg, state_a, state_a, eng._pgs, eng.pool.min_size)
    m.mark_down(3)
    m.osd_weight[5] = 0x8000  # value-only edits: same shapes
    state_b = build_pool_state(m, m.pools[1], device=dev)
    replays = fused.replays
    with _Second("fused placement second epoch", dev) as s:
        out = fused(eng._fused_arg, state_a, state_b, eng._pgs, eng.pool.min_size)
    staged = eng.run_staged(state_a, state_b)
    names = ("up", "up_primary", "acting", "acting_primary", "prev_acting", "flags",
             "survivor_mask", "n_alive")
    for name, got in zip(names, out):
        want = getattr(staged, name)
        assert np.array_equal(got.cpu().numpy().astype(want.dtype), want), name
    return {**s.report(), "pipeline_replays": fused.replays - replays}


def _erasure_map():
    from ..models.clusters import build_osdmap

    return build_osdmap(32, pg_num=16, size=6, pool_kind="erasure")


def _tape():
    from ..recovery.chaos import ChaosEvent, ChaosTimeline
    from ..recovery.failure import parse_spec

    return ChaosTimeline([
        ChaosEvent(0.3, (parse_spec("osd:3:down_out"), parse_spec("slow:7"))),
    ])


@_case
def _case_epoch_superstep(dev):
    """A second same-shape window of the epoch loop, rows kept on the
    device (``pull=False``)."""
    from ..recovery.superstep import EpochDriver

    drv = EpochDriver(_erasure_map(), _tape(), n_ops=64, device=dev)
    drv.run_superstep(8, pull=False)
    with _Second("epoch superstep second window", dev) as s:
        drv.run_superstep(8, pull=False)
    return s.report()


@contextlib.contextmanager
def _bucket_checks_on():
    """Scope with the global ``debug_bucket_checks`` on."""
    from ..common.config import global_config

    cfg = global_config()
    prev = cfg.get("debug_bucket_checks")
    cfg.set("debug_bucket_checks", True)
    try:
        yield
    finally:
        cfg.set("debug_bucket_checks", prev)


@_case
def _case_fleet_superstep(dev):
    """The fleet scan grown from 3 to 4 clusters inside one power-of-two
    pad bucket: fleet size is a value, never a shape."""
    from ..analysis.runtime_guard import assert_bucketed
    from ..core.cluster_state import _pad_to
    from ..recovery.fleet import FleetDriver

    fdrv = FleetDriver(_erasure_map(), seed=3, n_ops=64, device=dev)
    fdrv.run_fleet(8, fdrv.sample(3, "ssd-burst"), pull=False)
    assert _pad_to(3) == _pad_to(4), (_pad_to(3), _pad_to(4))
    assert_bucketed("fleet superstep pad bucket", _pad_to(3), _pad_to(4))
    tls_b = fdrv.sample(4, "ssd-burst")
    with _bucket_checks_on(), _Second("fleet superstep same pad bucket", dev) as s:
        fdrv.run_fleet(8, tls_b, pull=False)
    return s.report()


@_case
def _case_compacted_superstep(dev):
    """The dirty-set compaction ladder: a walk whose dirty-PG set grows
    across every rung, bit-equal to the dense run on the same walk."""
    from ..analysis.runtime_guard import assert_bucketed
    from ..common.config import Config
    from ..models.clusters import build_osdmap
    from ..recovery.chaos import ChaosEvent, ChaosTimeline
    from ..recovery.failure import parse_spec
    from ..recovery.superstep import EpochDriver

    m = build_osdmap(64, pg_num=128, size=6, pool_kind="erasure")
    cfg_c = Config(env={})
    cfg_c.set("sparse_dirty_compaction", "on")
    cfg_c.set("sparse_min_bucket", 4)
    cfg_c.set("debug_bucket_checks", True)
    walk, start, batch, t = [], 0, 1, 0.3
    while start + batch <= 32:
        walk.append(ChaosEvent(t, tuple(parse_spec(f"osd:{i}")
                                        for i in range(start, start + batch))))
        start += batch
        batch *= 2
        t += 0.5
    cdrv = EpochDriver(m, ChaosTimeline(walk), n_ops=64, config=cfg_c, device=dev)
    assert cdrv.compaction_enabled, "ladder empty with compaction on"
    for w in cdrv._dirty_ladder:
        assert_bucketed("compacted superstep ladder rung", w)
    series_c = cdrv.run_superstep(24)
    cfg_d = Config(env={})
    cfg_d.set("sparse_dirty_compaction", "off")
    ddrv = EpochDriver(m, ChaosTimeline(list(walk)), n_ops=64, config=cfg_d, device=dev)
    diff = series_c.diff(ddrv.run_superstep(24))
    assert not diff, f"compacted vs dense diverged: {diff}"
    with _bucket_checks_on(), _Second("compacted superstep dirty-set walk", dev) as s:
        cdrv.run_superstep(24, pull=False)
    return s.report()


@_case
def _case_online_write_batch(dev):
    """The write path with a different write cap inside the same
    power-of-two batch bucket (K9, its commit and K6 each epoch)."""
    from ..analysis.runtime_guard import assert_bucketed
    from ..recovery.superstep import EpochDriver
    from ..workload.writepath import WritepathDriver

    wdrv = WritepathDriver(EpochDriver(_erasure_map(), _tape(), n_ops=64, device=dev),
                           n_sets=8, ways=2, max_writes=8)
    wdrv.run_superstep(8, cap=5, pull=False)
    assert_bucketed("online write batch bucket", wdrv.batch_size)
    assert 7 <= wdrv.batch_size, wdrv.batch_size
    with _bucket_checks_on(), _Second("online write batch same bucket", dev) as s:
        wdrv.run_superstep(8, cap=7, pull=False)
    return s.report()


@_case
def _case_reconcile_round(dev):
    """A divergent two-rank round: a same-length chunk a rank, then the
    stacked merge."""
    from ..recovery.chaos import ChaosEvent, ChaosTimeline
    from ..recovery.failure import parse_spec
    from ..recovery.reconcile import DivergentDriver

    tl = ChaosTimeline([
        ChaosEvent(0.3, (parse_spec("osd:5:down_out"),)),
        ChaosEvent(0.4, (parse_spec("rankdelay:1.40"),)),
    ])
    ddrv = DivergentDriver(_erasure_map(), tl, 2, n_ops=64, device=dev)
    for r in range(2):
        ddrv._advance(r, 8)
    ddrv._merge(ddrv._now_at(8))
    with _Second("reconcile round second chunk", dev) as s:
        for r in range(2):
            ddrv._advance(r, 16)
        ddrv._merge(ddrv._now_at(16))
    return s.report()


@_case
def _case_worksteal_dispatch(dev):
    """The work-stealing dispatcher's drain loop on 8 virtual chips: a
    second job of another width (and sub-shard count) in the same
    power-of-two piece bucket."""
    from ..analysis.runtime_guard import assert_bucketed
    from ..ec.backend import TableEncoder
    from ..ec.gf import matrix_encode, vandermonde_matrix
    from ..recovery.dispatch import WorkStealingDispatcher, _next_pow2

    k, m_par = 4, 2
    wenc = TableEncoder(vandermonde_matrix(k, m_par), dev)
    disp = WorkStealingDispatcher([dev] * 8)
    denom = len(disp.chips) * disp.subshards_per_chip
    w_a, w_b = 3000, 4000
    piece_a = _next_pow2(-(-w_a // denom))
    piece_b = _next_pow2(-(-w_b // denom))
    assert_bucketed("worksteal piece bucket", piece_a, piece_b)
    assert piece_a == piece_b, (piece_a, piece_b)
    rng = np.random.default_rng(11)
    src_a = rng.integers(0, 256, (k, w_a), dtype=np.uint8)
    src_b = rng.integers(0, 256, (k, w_b), dtype=np.uint8)
    job_a = disp.submit(wenc, src_a)
    disp.drain()
    np.testing.assert_array_equal(disp.result(job_a), matrix_encode(wenc.matrix, src_a))
    with _Second("worksteal same piece bucket", dev) as s:
        job_b = disp.submit(wenc, src_b)
        disp.drain()
    np.testing.assert_array_equal(disp.result(job_b), matrix_encode(wenc.matrix, src_b))
    return s.report()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nonregression", description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cpu or cuda (default: the card)")
    args = p.parse_args(argv)
    sys.stdout.write(render(generate(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
