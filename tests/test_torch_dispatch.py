"""The port's work-stealing dispatcher (ROADMAP §1 item 4c) vs the
reference package's.

The dispatcher is host code over a list of chips; the port's chips are
torch devices and may repeat one (8 virtual chips on the CPU here, as
the reference's 8 virtual XLA devices).  On the same seeded operands,
fault specs and seeds, the port's dispatcher takes the reference's
decisions — its ``DispatchStats`` (launches, steals, hedges, drop
retries, convictions, busy times and makespans) equal the reference's
field for field — and its recovered bytes equal the static decode,
over ``tests/test_dispatch.py``'s fault matrix.  The executor and the
supervised loop route through it as the reference's do (their
telemetry equal on 8 virtual chips in a world of one), and gloo worlds
of W = 2 and 4 processes (one chip a rank) recover the static sharded
path's bytes, and raise the typed ``ChipLostError`` on every rank
when every chip stalls — never a hang (the world's wall-clock limit is
the proof).
"""

import copy
from dataclasses import asdict

import numpy as np
import pytest
import torch

from ceph_tpu import recovery as ref_rec
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.ec.backend import MatrixCodec as RefMatrixCodec
from ceph_tpu.ec.backend import TableEncoder as RefTableEncoder
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.obs.journal import EventJournal as RefJournal
from ceph_tpu.parallel.placement import make_mesh as ref_make_mesh
from ceph_tpu.recovery import dispatch as ref_dispatch
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.ec.backend import TableEncoder
from ceph_tpu_torch.obs.journal import EventJournal
from ceph_tpu_torch.parallel import make_mesh
from ceph_tpu_torch.recovery.chaos import ChaosTimeline
from ceph_tpu_torch.recovery.dispatch import (
    ChipFaultSchedule,
    WorkStealingDispatcher,
    _next_pow2,
    strip_chip_specs,
)
from ceph_tpu_torch.recovery.failure import UnknownSpecKeyError, parse_spec
from ceph_tpu_torch.testing import mesh_cases
from ceph_tpu_torch.testing.world import run_world

CPU = torch.device("cpu")
K, M = 4, 2
MASKS = [0b001111, 0b110011, 0b011110]
CASES = "ceph_tpu_torch.testing.mesh_cases"

# tests/test_dispatch.py's failure matrix: (name, specs)
MATRIX = [
    ("queued_drop_retry", ["chipdrop:3"]),
    ("queued_drop_convict", ["chipdrop:0"]),
    ("inflight_stall_hedge", ["chipstall:1.1"]),
    ("inflight_stall_convict", ["chipstall:1.0"]),
    ("inflight_slow_steal", ["chipslow:2.6"]),
    ("precommit_hedge_race", ["chipslow:5.9"]),
    ("combined", ["chipstall:0.0", "chipdrop:5", "chipslow:6.3"]),
    ("healthy", []),
]


def _cfgs(**over):
    out = []
    for cls in (Config, RefConfig):
        cfg = cls(env={})
        for key, val in over.items():
            cfg.set(key, val)
        out.append(cfg)
    return out


def _pair(n=8, specs=(), seed=0, **over):
    """(port dispatcher on n virtual CPU chips, reference on n devices)."""
    import jax

    cfg, ref_cfg = _cfgs(**over)
    faults = ChipFaultSchedule.from_specs(specs, n) if specs else None
    ref_faults = ref_dispatch.ChipFaultSchedule.from_specs(specs, n) if specs else None
    return (WorkStealingDispatcher([CPU] * n, cfg, faults=faults, seed=seed),
            ref_dispatch.WorkStealingDispatcher(list(jax.devices())[:n], ref_cfg,
                                                faults=ref_faults, seed=seed))


def _case(w, seed, k=K, m_par=M):
    mat = ref_gf.vandermonde_matrix(k, m_par)
    src = np.random.default_rng(seed).integers(0, 256, (k, w), dtype=np.uint8)
    return (TableEncoder(mat, CPU), RefTableEncoder(mat), src, ref_gf.matrix_encode(mat, src))


def _stats_equal(got, want):
    a, b = asdict(got), asdict(want)
    assert a == b, (a, b)


def test_pow2_piece_bucketing_is_the_reference():
    assert [_next_pow2(n) for n in (0, 1, 2, 3, 4, 5, 64, 65)] == [
        ref_dispatch._next_pow2(n) for n in (0, 1, 2, 3, 4, 5, 64, 65)]
    disp, ref = _pair()
    for w in (3000, 4000, 3):
        enc, ref_enc, src, _ = _case(w, 0)
        job, rjob = disp.submit(enc, src), ref.submit(ref_enc, src)
        assert [(s.seq, s.start, s.width, s.piece) for s in job.subs] == [
            (s.seq, s.start, s.width, s.piece) for s in rjob.subs]


def test_chip_fault_schedule_and_strip_are_the_reference():
    specs = ["chipstall:2.0", "chipslow:3.4", "chipdrop:1", "chipdrop:5", "chipdrop:5:restore"]
    got = ChipFaultSchedule.from_specs(specs, n_chips=8)
    want = ref_dispatch.ChipFaultSchedule.from_specs(specs, n_chips=8)
    assert (got.stall, got.slow, got.dropped) == (want.stall, want.slow, want.dropped)
    assert got.faulty(2) and got.faulty(1) and not got.faulty(3)
    with pytest.raises(UnknownSpecKeyError, match="outside"):
        ChipFaultSchedule.from_specs(["chipdrop:8"], n_chips=8)
    with pytest.raises(ValueError, match="not a chip-scoped spec"):
        ChipFaultSchedule.from_specs(["osd:3:down"], n_chips=8)
    pairs = [(0.1, "chipstall:0.0"), (0.2, "osd:3:down_out"), (0.3, "chipdrop:5")]
    stripped, chips = strip_chip_specs(ChaosTimeline.from_pairs(pairs))
    r_stripped, r_chips = ref_dispatch.strip_chip_specs(
        ref_rec.ChaosTimeline.from_pairs(pairs))
    assert [str(s) for s in chips] == [str(s) for s in r_chips]
    assert [(e.t, [str(s) for s in e.specs]) for e in stripped.events()] == [
        (e.t, [str(s) for s in e.specs]) for e in r_stripped.events()]


@pytest.mark.parametrize("name,specs", MATRIX, ids=[c[0] for c in MATRIX])
def test_failure_matrix_bit_equal_and_same_decisions(name, specs):
    disp, ref = _pair(specs=specs, seed=3)
    jobs = []
    for i, w in enumerate((6000, 3000, 9000)):
        enc, ref_enc, src, want = _case(w, i + 1)
        jobs.append((disp.submit(enc, src), ref.submit(ref_enc, src), want))
    disp.drain()
    ref.drain()
    for job, rjob, want in jobs:
        np.testing.assert_array_equal(disp.result(job), want)
        np.testing.assert_array_equal(ref.result(rjob), want)
        assert sorted(job.committed) == [s.seq for s in job.subs]
        assert {s: (lc.chip.chip_id, lc.t_start) for s, lc in job.committed.items()} == {
            s: (lc.chip.chip_id, lc.t_start) for s, lc in rjob.committed.items()}
    _stats_equal(disp.stats, ref.stats)
    if any("stall" in s or "drop" in s for s in specs):
        assert disp.stats.static_idle_fraction_per_chip() == [1.0] * 8
        assert max(disp.stats.idle_fraction_per_chip()) < 1.0


def test_all_chips_convicted_raises_typed_error():
    disp, ref = _pair(specs=[f"chipstall:{c}.0" for c in range(8)])
    enc, ref_enc, src, _ = _case(2000, 7)
    job, rjob = disp.submit(enc, src), ref.submit(ref_enc, src)
    with pytest.raises(rec.ChipLostError) as ei:
        disp.result(job)
    with pytest.raises(ref_dispatch.ChipLostError) as ri:
        ref.result(rjob)
    assert ei.value.chips == ri.value.chips == list(range(8))
    assert str(ei.value) == str(ri.value)
    _stats_equal(disp.stats, ref.stats)


def test_convicted_chip_stays_out_and_drops_are_journaled():
    disp, ref = _pair(specs=["chipstall:4.0"])
    for w, seed in ((4000, 7), (2500, 11)):
        enc, ref_enc, src, want = _case(w, seed)
        np.testing.assert_array_equal(disp.result(disp.submit(enc, src)), want)
        ref.result(ref.submit(ref_enc, src))
        _stats_equal(disp.stats, ref.stats)
    assert disp.stats.chip_convictions == 1
    disp, ref = _pair(specs=["chipdrop:2"], recovery_chip_fail_threshold=2)
    disp.journal, ref.journal = EventJournal(), RefJournal()
    enc, ref_enc, src, want = _case(7000, 7)
    np.testing.assert_array_equal(disp.result(disp.submit(enc, src)), want)
    ref.result(ref.submit(ref_enc, src))
    for name in ("dispatch.drop", "dispatch.convict", "dispatch.hedge"):
        assert [e["attrs"] for e in disp.journal.by_name(name)] == [
            e["attrs"] for e in ref.journal.by_name(name)]
    assert len(disp.journal.by_name("dispatch.drop")) == disp.stats.drop_retries == 2


def _ref_plan_store(chunk=97, seed=7):
    codec = RefMatrixCodec(ref_gf.vandermonde_matrix(K, M))
    from ceph_tpu.crush.map import ITEM_NONE
    from ceph_tpu.recovery.peering import PG_STATE_DEGRADED, PeeringResult

    size, n = K + M, len(MASKS)
    prev = np.arange(n * size, dtype=np.int32).reshape(n, size)
    acting = prev.copy()
    mask_arr = np.zeros(n, np.uint32)
    for i, mask in enumerate(MASKS):
        for s in range(size):
            if not (mask >> s) & 1:
                acting[i, s] = ITEM_NONE
        mask_arr[i] = mask
    peering = PeeringResult(
        pool_id=1, epoch_prev=1, epoch_cur=2, size=size, min_size=K, up=acting.copy(),
        up_primary=acting[:, 0].copy(), acting=acting, acting_primary=acting[:, 0].copy(),
        prev_acting=prev, flags=np.full(n, PG_STATE_DEGRADED, np.int32),
        survivor_mask=mask_arr, n_alive=(acting != ITEM_NONE).sum(axis=1).astype(np.int32))
    mat = ref_gf.vandermonde_matrix(K, M)
    store = {}

    def read(pg, s):
        if pg not in store:
            store[pg] = mesh_cases.pg_chunks(pg, mat, chunk, seed)
        return store[pg][s]

    return codec, ref_rec.build_plan(peering, codec), read


@pytest.mark.parametrize("specs", [[], ["chipstall:2.0"], ["chipslow:1.4", "chipdrop:6"]])
def test_executor_worksteal_equals_the_reference_on_eight_chips(specs):
    """A world of one driving 8 virtual chips against the reference's
    8-device mesh: same telemetry; bytes equal the static sharded path
    and the single-device executor."""
    over = {"recovery_shard_min_bytes": 0, "recovery_work_stealing": "on"}
    got = mesh_cases.executor(make_mesh(axis="bytes", device="cpu"), K, M, MASKS, 997, 7, over,
                              chip_faults=specs or None, dispatch_devices=8, dispatch_seed=1)
    static = mesh_cases.executor(make_mesh(axis="bytes", device="cpu"), K, M, MASKS, 997, 7,
                                 {"recovery_shard_min_bytes": 0})
    codec, plan, read = _ref_plan_store(997, 7)
    ex = ref_rec.RecoveryExecutor(codec, config=_cfgs(**over)[1],
                                  mesh=ref_make_mesh(axis="bytes"),
                                  chip_faults=[parse_spec(s) for s in specs] or None,
                                  dispatch_seed=1)
    ref = ex.run(plan, read)
    assert got["worksteal_launches"] == got["launches"] == plan.n_patterns
    assert static["sharded_launches"] == plan.n_patterns
    for field in mesh_cases.EXECUTOR_FIELDS:
        assert got[field] == getattr(ref, field), field
    for pg in ref.shards:
        for s in ref.shards[pg]:
            np.testing.assert_array_equal(got["shards"][int(pg)][int(s)], ref.shards[pg][s])
            np.testing.assert_array_equal(static["shards"][int(pg)][int(s)],
                                          ref.shards[pg][s])
    if specs == ["chipstall:2.0"]:
        assert got["chip_convictions"] >= 1
        assert got["static_idle_fraction_per_chip"] == [1.0] * 8
        assert max(got["idle_fraction_per_chip"]) < 1.0


def test_executor_auto_stays_static_without_cuda_chips():
    cfg = Config(env={})
    cfg.set("recovery_shard_min_bytes", 0)
    codec = mesh_cases.MatrixCodec(ref_gf.vandermonde_matrix(K, M), device="cpu")
    ex = rec.RecoveryExecutor(codec, config=cfg, mesh=make_mesh(axis="bytes", device="cpu"),
                              dispatch_devices=[CPU] * 8, device="cpu")
    assert ex._dispatcher is None
    with pytest.raises(ValueError, match="work-stealing dispatcher"):
        rec.RecoveryExecutor(codec, config=cfg, chip_faults=["chipstall:0.0"], device="cpu")


def test_supervised_worksteal_chip_chaos_end_to_end():
    """SupervisedRecovery with a chip fault stripped off the chaos
    timeline, 8 virtual chips against the reference's 8 devices: the
    same summary, shards and per-chip idle fractions."""
    over = {"recovery_shard_min_bytes": 0, "recovery_work_stealing": "on"}
    m = ref_build_osdmap(64, pg_num=32, size=K + M, pool_kind="erasure")
    got = mesh_cases.supervised(make_mesh(axis="bytes", device="cpu"), m.encode(),
                                "host:host0_1:down_out", [(0.05, "chipstall:3.0")], K, M, 64, 5,
                                over, dispatch_devices=8)
    m_prev = copy.deepcopy(m)
    ref_rec.inject(m, "host:host0_1:down_out")
    tl, chip_specs = ref_dispatch.strip_chip_specs(
        ref_rec.ChaosTimeline.from_pairs([(0.05, "chipstall:3.0")]))
    mat = ref_gf.vandermonde_matrix(K, M)
    store = {}

    def read(pg, s):
        if pg not in store:
            store[pg] = mesh_cases.pg_chunks(pg, mat, 64, 5)
        return store[pg][s]

    sup = ref_rec.SupervisedRecovery(RefMatrixCodec(mat), ref_rec.ChaosEngine(m, tl),
                                     config=_cfgs(**over)[1], mesh=ref_make_mesh(axis="bytes"),
                                     chip_faults=chip_specs, seed=5)
    ref = sup.run(m_prev, 1, read)
    assert ref.converged and ref.chip_convictions >= 1 and ref.worksteal_launches > 0
    assert got["summary"] == ref.summary()
    assert got["idle_fraction_per_chip"] == ref.idle_fraction_per_chip
    assert got["static_idle_fraction_per_chip"] == [1.0] * 8
    for pg in got["completed"]:
        for s, data in got["shards"][pg].items():
            np.testing.assert_array_equal(data, store[pg][s])


def test_finalize_order_key_is_the_reference():
    from types import SimpleNamespace

    fls = [SimpleNamespace(group=SimpleNamespace(mask=mask, pgs=pgs))
           for mask, pgs in [(0b110011, (4, 9)), (0b001111, (7,)), (0b001111, (2, 5)),
                             (0b011110, (1,)), (0b110011, (0, 3))]]
    key, ref_key = rec.SupervisedRecovery._finalize_order, ref_rec.SupervisedRecovery._finalize_order
    assert [key(f) for f in sorted(fls, key=key)] == [ref_key(f) for f in sorted(fls, key=ref_key)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    over = {"recovery_shard_min_bytes": 0, "recovery_work_stealing": "on"}
    out = {}
    for size in (2, 4):
        cases = [
            (f"{CASES}:executor", {"k": K, "m_par": M, "masks": MASKS, "chunk": 997, "seed": 7,
                                   "overrides": over, "chip_faults": ["chipslow:0.4"]}),
            (f"{CASES}:executor", {"k": K, "m_par": M, "masks": MASKS, "chunk": 997, "seed": 7,
                                   "overrides": {"recovery_shard_min_bytes": 0}}),
            (f"{CASES}:stalled_worksteal", {"k": K, "m_par": M, "masks": MASKS[:2]}),
        ]
        out[size] = run_world(size, cases, str(tmp_path_factory.mktemp(f"world{size}")),
                              timeout_s=120.0, device="cpu")
    return out


@pytest.mark.parametrize("size", (2, 4))
def test_worlds_worksteal_bit_equal_and_typed_loss_on_every_rank(worlds, size):
    codec, plan, read = _ref_plan_store(997, 7)
    ref = ref_rec.RecoveryExecutor(codec, config=_cfgs(recovery_shard_min_bytes=0)[1],
                                   mesh=ref_make_mesh(size, axis="bytes")).run(plan, read)
    chips = []
    for rank in range(size):
        ws, static, lost = worlds[size][rank]
        assert ws["worksteal_launches"] == plan.n_patterns and ws["sharded_launches"] == 0
        assert static["sharded_launches"] == plan.n_patterns
        for got in (ws, static):
            for pg in ref.shards:
                for s in ref.shards[pg]:
                    np.testing.assert_array_equal(got["shards"][int(pg)][int(s)],
                                                  ref.shards[pg][s])
        assert lost["error"] == "ChipLostError"
        chips += lost["chips"]
        assert lost["chips"] == [rank]  # each rank convicts its own chip
    assert sorted(chips) == list(range(size))
