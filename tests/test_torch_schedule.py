"""The port's XOR-schedule compiler and K6 vs the reference package's.

``compile_schedule`` must emit the reference's step table exactly (the
same ``steps``, ``n_bufs``, ``xor_count`` and ``naive_xor_count``) on
repair bitmatrices of cauchy_good, liberation, a w=16 expansion and a
bit-plane RS repair, and on random matrices; ``XorScheduleEncoder``
(K6's plain version on the CPU) must rebuild the same bytes as the
reference's in both layouts; the device packing must equal the numpy
host reference; and the schedule cache, its counters, quarantine and
``encoder_for_group`` must behave as the reference's.  Inputs are made
from seeds with numpy.  All comparisons are integer: exact equality.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.ec import gfw as ref_gfw
from ceph_tpu.ec import schedule as ref_schedule
from ceph_tpu_torch.ec import gf, gfw, kernels, schedule
from ceph_tpu_torch.ec.backend import BitmatrixEncoder
from ceph_tpu_torch.recovery.planner import PatternGroup


def _repair_bits(gen_bits, w, k, size, missing):
    """A repair bitmatrix: the missing chunks' generator rows times the
    inverse of the first k survivors' (the planner's algebra)."""
    rows = [s for s in range(size) if s not in missing][:k]
    sub = np.vstack([gen_bits[r * w:(r + 1) * w] for r in rows])
    need = np.vstack([gen_bits[s * w:(s + 1) * w] for s in missing])
    return ref_gf.bitmatrix_multiply(need, ref_gf.invert_bitmatrix(sub))


def _cauchy_repair(missing, k=8, m=3):
    bits = ref_gf.matrix_to_bitmatrix(ref_gf.cauchy_good_matrix(k, m))
    gen = np.vstack([np.eye(k * 8, dtype=np.uint8), bits])
    return _repair_bits(gen, 8, k, k + m, missing)


def _liberation_repair(missing, k=4, w=7):
    gen = np.vstack([np.eye(k * w, dtype=np.uint8), ref_gfw.liberation_bitmatrix(k, w)])
    return _repair_bits(gen, w, k, k + 2, missing)


def _rs_bitplane_repair(missing, k=8, m=3):
    gen = np.vstack([np.eye(k, dtype=np.uint8), ref_gf.vandermonde_matrix(k, m)])
    rows = [s for s in range(k + m) if s not in missing][:k]
    repair = ref_gf.matrix_encode(gen[list(missing)], ref_gf.invert_matrix(gen[rows]))
    return ref_gf.matrix_to_bitmatrix(repair)


BITMATRICES = {
    "cauchy_good_8_3_lost_0_8": lambda: _cauchy_repair((0, 8)),
    "cauchy_good_8_3_lost_1_2_3": lambda: _cauchy_repair((1, 2, 3)),
    "cauchy_good_8_3_lost_5": lambda: _cauchy_repair((5,)),
    "liberation_4_7_coding": lambda: ref_gfw.liberation_bitmatrix(4, 7),
    "liberation_4_7_lost_0_4": lambda: _liberation_repair((0, 4)),
    "liberation_4_7_lost_1_2": lambda: _liberation_repair((1, 2)),
    "rs_w16_expansion": lambda: ref_gfw.matrix_to_bitmatrix(
        ref_gfw.vandermonde_matrix(4, 2, 16), 16),
    "rs_bitplane_8_3_lost_0_8": lambda: _rs_bitplane_repair((0, 8)),
    "rs_bitplane_8_3_lost_2_9_10": lambda: _rs_bitplane_repair((2, 9, 10)),
    "random_seed_0": lambda: (np.random.default_rng(0).random((23, 31)) < 0.45).astype(np.uint8),
    "random_seed_1": lambda: (np.random.default_rng(1).random((7, 40)) < 0.6).astype(np.uint8),
}


@pytest.mark.parametrize("name", list(BITMATRICES))
def test_compile_schedule_matches_reference(name):
    bits = BITMATRICES[name]()
    want = ref_schedule.compile_schedule(bits)
    got = schedule.compile_schedule(bits)
    assert got.steps.dtype == np.int32 and got.steps.shape == want.steps.shape
    np.testing.assert_array_equal(got.steps, want.steps)
    assert (got.n_in, got.n_out, got.n_bufs) == (want.n_in, want.n_out, want.n_bufs)
    assert (got.xor_count, got.naive_xor_count) == (want.xor_count, want.naive_xor_count)
    assert got.reduction_fraction == want.reduction_fraction


def test_compile_schedule_max_derived_matches_reference():
    bits = BITMATRICES["random_seed_0"]()
    for cap in (0, 2, 7):
        got, want = schedule.compile_schedule(bits, cap), ref_schedule.compile_schedule(bits, cap)
        np.testing.assert_array_equal(got.steps, want.steps)
        assert got.n_bufs == want.n_bufs <= bits.shape[0] + bits.shape[1] + cap


# ---- K6: plain version, wrapper on the CPU -------------------------------


def _words(n, nw, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, (n, nw), dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("name", ["cauchy_good_8_3_lost_0_8", "liberation_4_7_lost_0_4",
                                  "random_seed_1"])
def test_schedule_apply_matches_host_interpreter(name):
    sched = schedule.compile_schedule(BITMATRICES[name]())
    words = _words(sched.n_in, 37, 3)
    table = kernels.StepTable(sched.steps, sched.n_bufs, "cpu")
    before = dict(kernels.LAUNCHES)
    got = kernels.schedule_apply(table, torch.from_numpy(words.view(np.int32)), sched.n_out)
    assert got.dtype == torch.int32 and got.shape == (sched.n_out, 37)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), sched.execute_host(words))
    assert kernels.LAUNCHES == before  # the CPU runs the plain version, no launch


def test_schedule_apply_edges():
    steps = np.array([[2, 0], [2, 1], [3, 2], [3, 3]], np.int32)
    table = kernels.StepTable(steps, 4, "cpu")
    words = torch.from_numpy(_words(2, 5, 9).view(np.int32))
    out = kernels.schedule_apply_plain(table, words, 2)
    np.testing.assert_array_equal(out[0].numpy(), (words[0] ^ words[1]).numpy())
    assert not out[1].any()  # buf ^= itself clears the row
    empty = kernels.schedule_apply(table, words[:, :0], 2)
    assert empty.shape == (2, 0)
    assert kernels.StepTable(steps.astype(np.int64), 4, "cpu").steps.dtype == torch.int32
    for bad in (steps.astype(np.float32), steps[:, :1], steps.reshape(-1)):
        with pytest.raises(TypeError):
            kernels.StepTable(bad, 4, "cpu")
    with pytest.raises(TypeError):
        kernels.schedule_apply(table, words.to(torch.uint8), 2)
    with pytest.raises(ValueError):  # n_in + n_out buffers do not fit n_bufs
        kernels.schedule_apply(kernels.StepTable(steps[:2], 3, "cpu"), words, 2)
    for bad in ([[2, 0], [4, 1]], [[2, -1]]):  # a buffer index out of [0, n_bufs)
        with pytest.raises(ValueError):
            kernels.StepTable(np.array(bad, np.int32), 4, "cpu")


@pytest.mark.parametrize("n_in,n_work,n_terms,config", [
    (64, 57, 282, (32, 1)), (8, 10, 40, (128, 1)), (8, 0, 8, (128, 1)), (64, 130, 400, (64, 1)),
    (100, 200, 900, (32, 2)), (150, 200, 900, (32, 1)), (256, 434, 2273, (0, 0)),
    (64, 66, 338, (64, 2))])
def test_schedule_smem_cols(n_in, n_work, n_terms, config):
    """K6's shared-memory path holds every slot (work, zero, 16 output
    slots and one copy of the inputs per stage) of a block's threads x 4
    words in 227 KB, with the program; of the shapes that fit it takes
    the one with the most threads an SM can hold, then two stages, then
    larger blocks; else the global path.  (64, 57, 282) is the main
    repair's program, (256, 434) the w = 32 repair's, (64, 66) the
    bit-plane RS repair's."""
    prog = kernels.XorProgram(terms=np.zeros(n_terms, np.uint32),
                              groups=np.zeros(-(-n_terms // 16), np.uint16), n_in=n_in, n_out=16,
                              n_work=n_work, n_ops=0, n_levels=0)
    assert kernels.schedule_config(prog) == config
    if config[0]:
        smem = kernels.program_smem_bytes(prog, *config)
        assert smem <= kernels.SMEM_BYTES
        resident = kernels.SM_SMEM_BYTES // (smem + kernels.BLOCK_SMEM_RESERVED) * config[0]
        for threads in kernels.SCHEDULE_THREADS:
            for stages in (1, 2):
                other = kernels.program_smem_bytes(prog, threads, stages)
                if other <= kernels.SMEM_BYTES:
                    assert kernels.SM_SMEM_BYTES // (other + 1024) * threads <= resident


# ---- device packing vs the numpy host reference ---------------------------


@pytest.mark.parametrize("p", [2048, 64, 3, 5, 7])
def test_packet_packing_matches_numpy(p):
    w, k = 6, 3
    for size in (3 * w * p, 0):
        data = np.random.default_rng(p).integers(0, 256, (k, size), dtype=np.uint8)
        want = ref_schedule.pack_packet_rows(data, w, p)
        got = schedule.pack_packet_rows_dev(torch.from_numpy(data), w, p)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        back = schedule.unpack_packet_rows_dev(got, k, w, p, size)
        np.testing.assert_array_equal(back.numpy(), data)
        np.testing.assert_array_equal(schedule.unpack_packet_rows(want, k, w, p, size), data)


@pytest.mark.parametrize("size", [4096, 131, 999, 32, 0])
def test_bitplane_packing_matches_numpy(size):
    data = np.random.default_rng(size).integers(0, 256, (3, size), dtype=np.uint8)
    want = ref_schedule.pack_bitplanes(data)
    got = schedule.pack_bitplanes_dev(torch.from_numpy(data))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(schedule.unpack_bitplanes_dev(got, 3, size).numpy(), data)
    np.testing.assert_array_equal(schedule.unpack_bitplanes(want, 3, size), data)


# ---- XorScheduleEncoder vs the reference's --------------------------------


@pytest.mark.parametrize("p", [2048, 64, 3, 5])
def test_packet_encoder_matches_reference(p):
    bits, w = _cauchy_repair((0, 8)), 8
    size = 2 * w * p
    data = np.random.default_rng(p).integers(0, 256, (8, size), dtype=np.uint8)
    ref = ref_schedule.XorScheduleEncoder(bits, layout="packet", w=w, packetsize=p)
    enc = schedule.XorScheduleEncoder(bits, layout="packet", w=w, packetsize=p, device="cpu")
    got = enc.encode(data)
    assert got.shape == (2, size)
    np.testing.assert_array_equal(got, ref.encode(data))
    np.testing.assert_array_equal(enc.table.steps.numpy(), ref.schedule.steps)


@pytest.mark.parametrize("size", [4096, 131])
def test_bitplane_encoder_matches_reference(size):
    bits = _rs_bitplane_repair((0, 8))
    data = np.random.default_rng(size).integers(0, 256, (8, size), dtype=np.uint8)
    ref = ref_schedule.XorScheduleEncoder(bits, layout="bitplane")
    enc = schedule.XorScheduleEncoder(bits, layout="bitplane", device="cpu")
    got = enc.encode(data)
    np.testing.assert_array_equal(got, ref.encode(data))
    # and the byte-wise GF(2^8) product it stands for
    gen = np.vstack([np.eye(8, dtype=np.uint8), gf.vandermonde_matrix(8, 3)])
    rows = [s for s in range(11) if s not in (0, 8)][:8]
    repair = gf.matrix_encode(gen[[0, 8]], gf.invert_matrix(gen[rows]))
    np.testing.assert_array_equal(got, gf.matrix_encode(repair, data))


def test_liberation_encoder_matches_dense_and_reference():
    k, w, p = 4, 7, 8
    bits = gfw.liberation_bitmatrix(k, w)
    data = np.random.default_rng(4).integers(0, 256, (k, 3 * w * p), dtype=np.uint8)
    got = schedule.XorScheduleEncoder(bits, "packet", w, p, device="cpu").encode(data)
    np.testing.assert_array_equal(got, BitmatrixEncoder(bits, p, w, "cpu").encode(data))
    ref = ref_schedule.XorScheduleEncoder(bits, layout="packet", w=w, packetsize=p)
    np.testing.assert_array_equal(got, ref.encode(data))


def test_encoder_rejects_bad_input():
    with pytest.raises(ValueError):
        schedule.XorScheduleEncoder(np.eye(8, dtype=np.uint8), layout="words", device="cpu")
    enc = schedule.XorScheduleEncoder(np.eye(8, dtype=np.uint8), "packet", 8, 4, device="cpu")
    with pytest.raises(ValueError):
        enc.encode_async(np.zeros((1, 33), np.uint8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            schedule.XorScheduleEncoder(np.eye(8, dtype=np.uint8))  # device="cuda"


# ---- cache, counters, quarantine, encoder_for_group -----------------------


def _liberation_group(mask=0b011110):
    """A minimal bit-level pattern group (liberation k=4 w=5 p=8)."""
    k, w, ps = 4, 5, 8
    gen = np.vstack([np.eye(k * w, dtype=np.uint8), gfw.liberation_bitmatrix(k, w)])
    survivors = tuple(s for s in range(k + 2) if (mask >> s) & 1)
    missing = tuple(s for s in range(k + 2) if s not in survivors)
    return PatternGroup(
        mask=mask, survivors=survivors, rows=survivors[:k], missing=missing,
        pgs=np.array([0]), repair_matrix=None,
        repair_bitmatrix=_repair_bits(gen, w, k, k + 2, missing), w=w, packetsize=ps,
    )


def _counters():
    return dict(schedule.schedule_counters().dump()["ec_schedule"])


def test_cache_counts_compiles_and_hits():
    cache = schedule.ScheduleCache(name="port-t1")
    g = _liberation_group()
    before = _counters()
    enc = schedule.encoder_for_group(cache, g, "auto", "cpu")
    assert isinstance(enc, schedule.XorScheduleEncoder) and enc.layout == "packet"
    mid = _counters()
    assert mid["schedules_compiled"] == before["schedules_compiled"] + 1
    assert mid["schedule_xor_count"] == before["schedule_xor_count"] + enc.schedule.xor_count
    assert mid["schedule_xor_naive"] == (before["schedule_xor_naive"]
                                         + enc.schedule.naive_xor_count)
    assert schedule.encoder_for_group(cache, g, "auto", "cpu") is enc
    after = _counters()
    assert after["schedule_cache_hits"] == mid["schedule_cache_hits"] + 1
    assert after["schedules_compiled"] == mid["schedules_compiled"] and len(cache) == 1


def test_cache_lru_bound_evicts_oldest():
    cache = schedule.ScheduleCache(name="port-lru", max_entries=2)
    before = _counters()["schedule_cache_evictions"]
    a, b, c = (_liberation_group(m) for m in (0b011110, 0b111100, 0b110011))
    ea = schedule.encoder_for_group(cache, a, "auto", "cpu")
    schedule.encoder_for_group(cache, b, "auto", "cpu")
    assert schedule.encoder_for_group(cache, a, "auto", "cpu") is ea  # a is now newest
    schedule.encoder_for_group(cache, c, "auto", "cpu")  # evicts b
    assert len(cache) == 2 and _counters()["schedule_cache_evictions"] == before + 1
    keys = {e["key"] for e in cache.dump()["entries"]}
    assert keys == {str(("packet", 0b011110)), str(("packet", 0b110011))}


def test_quarantine_reroutes_to_dense():
    cache = schedule.ScheduleCache(name="port-q")
    g = _liberation_group()
    schedule.encoder_for_group(cache, g, "auto", "cpu")
    before = _counters()["schedules_quarantined"]
    assert cache.quarantine(("packet", g.mask)) is True
    assert cache.quarantine(("packet", g.mask)) is False  # once per key
    assert _counters()["schedules_quarantined"] == before + 1
    enc = schedule.encoder_for_group(cache, g, "auto", "cpu")
    assert isinstance(enc, schedule.DenseBitmatrixAdapter)
    assert cache.dump()["quarantined"] == [str(("packet", g.mask))]


def test_mode_off_builds_dense_adapter_matching_reference():
    g = _liberation_group()
    before = _counters()
    enc = schedule.encoder_for_group(schedule.ScheduleCache(name="port-off"), g, "off", "cpu")
    assert isinstance(enc, schedule.DenseBitmatrixAdapter)
    after = _counters()
    assert after["schedules_compiled"] == before["schedules_compiled"]
    data = np.random.default_rng(8).integers(0, 256, (4, 2 * 5 * 8), dtype=np.uint8)
    got = enc.finalize(enc.encode_async(data), data.shape[1])
    ref = ref_schedule.DenseBitmatrixAdapter(g.repair_bitmatrix, g.w, g.packetsize)
    np.testing.assert_array_equal(got, ref.finalize(ref.encode_async(data), data.shape[1]))
    with pytest.raises(ValueError):
        enc.encode_async(data[:, :7])


def test_mode_on_expands_table_group_to_bitplane():
    repair = gf.vandermonde_matrix(4, 2)[[0]]
    g = PatternGroup(mask=0b011110, survivors=(1, 2, 3, 4), rows=(1, 2, 3, 4), missing=(0,),
                     pgs=np.array([0]), repair_matrix=repair)
    enc = schedule.encoder_for_group(schedule.ScheduleCache(name="port-on"), g, "on", "cpu")
    assert isinstance(enc, schedule.XorScheduleEncoder) and enc.layout == "bitplane"
    data = np.random.default_rng(2).integers(0, 256, (4, 100), dtype=np.uint8)
    np.testing.assert_array_equal(enc.encode(data), gf.matrix_encode(repair, data))


def test_dump_ec_schedules_reports_caches_and_counters():
    cache = schedule.ScheduleCache(name="port-t4")
    schedule.encoder_for_group(cache, _liberation_group(), "auto", "cpu")
    schedule.encoder_for_group(cache, _liberation_group(0b111100), "off", "cpu")
    dump = schedule.dump_ec_schedules()
    mine = [c for c in dump["caches"] if c["name"] == "port-t4"]
    assert len(mine) == 1
    engines = {e["key"]: e for e in mine[0]["entries"]}
    entry = engines[str(("packet", 0b011110))]
    assert entry["engine"] == "schedule" and entry["xor_count"] <= entry["naive_xor_count"]
    assert engines[str(("dense", 0b111100))]["engine"] == "dense"
    assert dump["counters"]["ec_schedule"]["schedules_compiled"] >= 1
