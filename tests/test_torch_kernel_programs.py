"""The host-built operands of K4 and K6 vs the reference package.

K6 runs an :class:`~ceph_tpu_torch.ec.kernels.XorProgram` compiled on
the host from a step table; its plain interpreter
(``kernels.program_apply_plain``, the kernel's group-by-group load and
store order) must equal ``schedule_apply_plain`` and the reference's
``ceph_tpu.ec.schedule._xla_apply`` on the main cauchy repair, a w = 32
repair, a bit-plane RS repair, liberation, 20 random bitmatrices and
hand-made tables.  K4 runs on split nibble tables
(``gf_kernels.nibble_tables``): they must rebuild every product of
``mul_table``, and their plain product must equal the reference's
``gf.matrix_encode``.  Inputs are made from seeds with numpy; all
comparisons are integer: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.ec import gfw as ref_gfw
from ceph_tpu.ec import schedule as ref_schedule
from ceph_tpu_torch.ec import gf, gf_kernels, kernels, schedule


def _repair_bits(gen_bits, w, k, size, missing):
    rows = [s for s in range(size) if s not in missing][:k]
    sub = np.vstack([gen_bits[r * w:(r + 1) * w] for r in rows])
    need = np.vstack([gen_bits[s * w:(s + 1) * w] for s in missing])
    return ref_gf.bitmatrix_multiply(need, ref_gf.invert_bitmatrix(sub))


def _cauchy_repair():
    bits = ref_gf.matrix_to_bitmatrix(ref_gf.cauchy_good_matrix(8, 3))
    return _repair_bits(np.vstack([np.eye(64, dtype=np.uint8), bits]), 8, 8, 11, (0, 8))


def _w32_repair():
    bits = ref_gfw.matrix_to_bitmatrix(ref_gfw.vandermonde_matrix(8, 3, 32), 32)
    return _repair_bits(np.vstack([np.eye(256, dtype=np.uint8), bits]), 32, 8, 11, (0, 8))


def _bitplane_repair():
    gen = np.vstack([np.eye(8, dtype=np.uint8), ref_gf.vandermonde_matrix(8, 3)])
    rows = [s for s in range(11) if s not in (0, 8)][:8]
    repair = ref_gf.matrix_encode(gen[[0, 8]], ref_gf.invert_matrix(gen[rows]))
    return ref_gf.matrix_to_bitmatrix(repair)


def _liberation_repair():
    gen = np.vstack([np.eye(28, dtype=np.uint8), ref_gfw.liberation_bitmatrix(4, 7)])
    return _repair_bits(gen, 7, 4, 6, (0, 4))


def _random(seed):
    rng = np.random.default_rng(seed)
    rows, cols = int(rng.integers(1, 40)), int(rng.integers(1, 48))
    return (rng.random((rows, cols)) < rng.uniform(0.2, 0.8)).astype(np.uint8)


BITMATRICES = {
    "cauchy_good_8_3_lost_0_8": _cauchy_repair,
    "rs_w32_8_3_lost_0_8": _w32_repair,
    "rs_bitplane_8_3_lost_0_8": _bitplane_repair,
    "liberation_4_7_coding": lambda: ref_gfw.liberation_bitmatrix(4, 7),
    "liberation_4_7_lost_0_4": _liberation_repair,
    **{f"random_{s}": (lambda s=s: _random(s)) for s in range(20)},
}

# hand-made step tables (steps, n_bufs, n_in, n_out)
EDGE_TABLES = {
    "self_xor": ([[2, 0], [2, 1], [3, 2], [3, 3]], 4, 2, 2),
    "read_after_output_write": ([[2, 0], [3, 2], [2, 1], [0, 2], [3, 0]], 4, 2, 2),
    "even_count_cancels": ([[2, 0], [2, 1], [2, 0], [3, 1]], 4, 2, 2),
    "no_steps": ([], 3, 1, 2),
    "copy_of_input": ([[1, 0]], 2, 1, 1),
    "output_copies_derived": ([[3, 0], [3, 1], [2, 3], [4, 3], [4, 0]], 5, 2, 2),
    "write_into_input": ([[0, 1], [2, 0], [2, 1], [3, 0]], 4, 2, 2),
    "interrupted_run": ([[2, 0], [3, 1], [2, 1], [3, 2]], 4, 2, 2),
    "dead_derived": ([[4, 0], [4, 1], [2, 0], [3, 1], [3, 0]], 5, 2, 2),
}


def _words(n, nw, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, (n, nw), dtype=np.uint64).astype(
        np.uint32)


def _check_groups(prog: kernels.XorProgram):
    """Every group holds at most GROUP_TERMS terms, every op ends, and
    slots stay in range.  (A group may read a slot that one of its ops
    then writes: its loads come first, so it reads the slot's earlier
    value, whose last read it is; the interpreter tests hold that.)"""
    assert prog.groups.sum() == prog.n_terms
    assert prog.groups.max(initial=0) <= kernels.GROUP_TERMS
    t0 = 0
    for size in prog.groups.tolist():
        for term in prog.terms[t0:t0 + size].tolist():
            src, dst = term & 0xFFFF, term >> 16
            assert src < prog.n_work + prog.n_in
            if dst != kernels.NOT_END and not dst & kernels.TO_OUT:
                assert dst < prog.n_work
        t0 += size
    assert prog.n_terms == 0 or prog.terms[-1] >> 16 != kernels.NOT_END


@pytest.mark.parametrize("name", list(BITMATRICES))
def test_program_matches_plain_and_reference(name):
    sched = schedule.compile_schedule(BITMATRICES[name]())
    table = kernels.StepTable(sched.steps, sched.n_bufs, "cpu", sched.n_in, sched.n_out)
    prog = table.program(sched.n_in, sched.n_out)
    _check_groups(prog)
    assert prog.n_work <= sched.n_bufs - sched.n_in
    words = _words(sched.n_in, 33, len(name))
    got = kernels.program_apply_plain(prog, torch.from_numpy(words.view(np.int32)))
    want = kernels.schedule_apply_plain(table, torch.from_numpy(words.view(np.int32)), sched.n_out)
    assert torch.equal(got, want)
    ref = ref_schedule._xla_apply(jnp.asarray(sched.steps), jnp.asarray(words),
                                  n_out=sched.n_out, n_bufs=sched.n_bufs)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(ref))
    # the padded, offset-addressed form the shared-memory path reads
    threads, stages = kernels.schedule_config(prog)
    for stage in range(stages):
        assert torch.equal(kernels.smem_program_apply_plain(
            prog, torch.from_numpy(words.view(np.int32)), threads, stages, stage), got)


@pytest.mark.parametrize("name", list(EDGE_TABLES))
def test_program_edge_tables(name):
    steps, n_bufs, n_in, n_out = EDGE_TABLES[name]
    steps = np.asarray(steps, np.int32).reshape(-1, 2)
    table = kernels.StepTable(steps, n_bufs, "cpu")
    prog = kernels.compile_program(steps, n_bufs, n_in, n_out)
    _check_groups(prog)
    words = _words(n_in, 7, n_bufs)
    got = kernels.program_apply_plain(prog, torch.from_numpy(words.view(np.int32)))
    assert torch.equal(got, kernels.schedule_apply_plain(table, torch.from_numpy(
        words.view(np.int32)), n_out))
    if not len(steps):  # the reference's interpreter cannot index an empty table
        assert not got.any()
        return
    ref = ref_schedule._xla_apply(jnp.asarray(steps), jnp.asarray(words), n_out=n_out,
                                  n_bufs=n_bufs)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(ref))


def test_program_main_shape_counts():
    """The main repair (282 steps over 171 buffers): one op per derived
    buffer and output, every output stored from its register, groups
    near full, slots reused below the 91 derived buffers."""
    sched = schedule.compile_schedule(_cauchy_repair())
    prog = kernels.compile_program(sched.steps, sched.n_bufs, sched.n_in, sched.n_out)
    assert prog.n_ops == sched.n_bufs - sched.n_in == 107
    assert prog.n_terms == sched.n_steps
    outs = [t >> 16 for t in prog.terms.tolist() if t >> 16 != kernels.NOT_END
            and t >> 16 & kernels.TO_OUT]
    assert sorted(o & kernels.SLOT_LIMIT for o in outs) == list(range(sched.n_out))
    assert prog.n_work < sched.n_bufs - sched.n_in - sched.n_out
    assert len(prog.groups) <= -(-prog.n_terms // kernels.GROUP_TERMS) + prog.n_levels


def test_program_group_size_is_respected():
    sched = schedule.compile_schedule(_cauchy_repair())
    words = torch.from_numpy(_words(sched.n_in, 9, 4).view(np.int32))
    table = kernels.StepTable(sched.steps, sched.n_bufs, "cpu")
    want = kernels.schedule_apply_plain(table, words, sched.n_out)
    for g in (1, 2, 3, 7):  # ops spanning groups carry their register across
        prog = kernels.compile_program(sched.steps, sched.n_bufs, sched.n_in, sched.n_out, g)
        assert prog.groups.max() <= g
        assert torch.equal(kernels.program_apply_plain(prog, words), want)


@pytest.mark.parametrize("threads,stages", [(128, 2), (64, 2), (32, 2), (128, 1), (32, 1)])
def test_smem_terms_layout(threads, stages):
    """The shared-memory form of the main repair's program: per group 16
    source offsets then 16 destination words, groups padded with
    zero-slot reads, byte offsets of whole slots of the block's threads x
    4 words, every output's last op into its output slot, copy s reading
    stage s's inputs; equal to the plain interpreter at every stage."""
    sched = schedule.compile_schedule(_cauchy_repair())
    prog = kernels.compile_program(sched.steps, sched.n_bufs, sched.n_in, sched.n_out)
    terms = prog.smem_terms(threads, stages)
    assert terms.shape == (stages, len(prog.groups), 2, kernels.GROUP_TERMS)
    n_slots, zero, out0, in0 = prog.smem_slots(stages)
    assert (n_slots, zero, out0, in0) == (prog.n_work + 1 + 16 + stages * 64, prog.n_work,
                                          prog.n_work + 1, prog.n_work + 17)
    unit = threads * 16
    pad = np.arange(kernels.GROUP_TERMS)[None, :] >= prog.groups[:, None]
    assert pad.sum() == terms.shape[1] * kernels.GROUP_TERMS - prog.n_terms
    assert (terms[:, :, 0][:, pad] == zero * unit).all()
    assert (terms[:, :, 1][:, pad] == kernels.CONTINUE).all()
    assert (terms[:, :, 0] % unit == 0).all()
    ends = terms[0, :, 1][terms[0, :, 1] != kernels.CONTINUE]
    assert len(ends) == prog.n_ops and (ends % unit == 0).all()
    assert sorted(set(ends // unit) & set(range(out0, out0 + 16))) == list(range(out0, out0 + 16))
    words = torch.from_numpy(_words(64, 6, threads + stages).view(np.int32))
    want = kernels.program_apply_plain(prog, words)
    for stage in range(stages):
        assert torch.equal(kernels.smem_program_apply_plain(prog, words, threads, stages, stage),
                           want)
    assert (kernels.program_smem_bytes(prog, threads, stages)
            == n_slots * unit + stages * len(prog.groups) * 128 + 16)


def test_w32_program_takes_the_global_path():
    """The w = 32 repair's slots do not fit a block: K6 runs it on a
    device-memory scratch, from the flat program."""
    sched = schedule.compile_schedule(_w32_repair())
    prog = kernels.compile_program(sched.steps, sched.n_bufs, sched.n_in, sched.n_out)
    assert kernels.schedule_config(prog) == (0, 0)
    assert kernels.program_smem_bytes(prog, 32, 1) > kernels.SMEM_BYTES
    table = kernels.StepTable(sched.steps, sched.n_bufs, "cpu", sched.n_in, sched.n_out)
    _, config, terms, groups = table._device_program(sched.n_in, sched.n_out)
    assert config == (0, 0) and terms.numel() == prog.n_terms
    assert groups.dtype == torch.int16 and int(groups.sum()) == prog.n_terms


def test_program_rejects_no_inputs():
    with pytest.raises(ValueError):
        kernels.compile_program(np.zeros((0, 2), np.int32), 2, 0, 2)
    # the wrapper needs no program then: every output is zero
    table = kernels.StepTable(np.zeros((0, 2), np.int32), 2, "cpu")
    out = kernels.schedule_apply(table, torch.zeros((0, 5), dtype=torch.int32), 2)
    assert out.shape == (2, 5) and not out.any()


def test_step_table_caches_programs():
    sched = schedule.compile_schedule(_cauchy_repair())
    table = kernels.StepTable(sched.steps, sched.n_bufs, "cpu", sched.n_in, sched.n_out)
    prog = table.program(sched.n_in, sched.n_out)
    assert table.program(sched.n_in, sched.n_out) is prog
    assert table.program(sched.n_in, 1) is not prog
    enc = schedule.XorScheduleEncoder(_cauchy_repair(), "packet", 8, 16, device="cpu")
    assert (enc.schedule.n_in, enc.schedule.n_out) in enc.table._programs


# ---------------------------------------------------------------- K4 nibble tables


def test_nibble_tables_rebuild_mul_table():
    """lo[c][d & 15] ^ hi[c][d >> 4] == mul_table[c][d] for all 65,536
    pairs (c, d)."""
    coeffs = np.arange(256, dtype=np.uint8).reshape(16, 16)
    nib = gf_kernels.nibble_tables(coeffs, "cpu").numpy().reshape(256, 32)
    d = np.arange(256)
    got = nib[:, d & 15] ^ nib[:, 16 + (d >> 4)]
    np.testing.assert_array_equal(got, ref_gf.mul_table())
    np.testing.assert_array_equal(gf_kernels.mul_tables(coeffs, "cpu").numpy().reshape(256, 256),
                                  ref_gf.mul_table())


@pytest.mark.parametrize("k,m,size", [(4, 2, 4096), (8, 3, 1024), (5, 1, 131), (3, 2, 0)])
def test_nibble_product_matches_reference(k, m, size):
    rng = np.random.default_rng(k * 7 + m)
    M = ref_gf.vandermonde_matrix(k, m)
    data = rng.integers(0, 256, (k, size), dtype=np.uint8)
    got = gf_kernels.nibble_product_plain(gf_kernels.nibble_tables(M, "cpu"),
                                          torch.from_numpy(data))
    assert got.dtype == torch.uint8 and got.shape == (m, size)
    np.testing.assert_array_equal(got.numpy(), ref_gf.matrix_encode(M, data))


def test_nibble_product_random_matrix():
    rng = np.random.default_rng(11)
    M = rng.integers(0, 256, (6, 9), dtype=np.uint8)
    data = rng.integers(0, 256, (9, 517), dtype=np.uint8)
    got = gf_kernels.nibble_product_plain(gf_kernels.nibble_tables(M, "cpu"),
                                          torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), ref_gf.matrix_encode(M, data))
    assert torch.equal(got, gf_kernels.matrix_encode(gf_kernels.mul_tables(M, "cpu"),
                                                     torch.from_numpy(data)))


def test_table_encoder_holds_both_operands():
    from ceph_tpu_torch.ec.backend import TableEncoder

    enc = TableEncoder(gf.vandermonde_matrix(4, 2), "cpu")
    assert enc.tables.shape == (2, 4, 256) and enc.nibbles.shape == (2, 4, 32)
    assert torch.equal(enc.nibbles, gf_kernels.nibble_tables(enc.matrix, "cpu"))


# ---------------------------------------------------------------- SASS and ptxas readers


_SASS = """
        Function : _ZN41_GLOBAL__N__b2407e84_9_straw2_cu_6ea3afb419straw2_level_kernelEPKj
        /*0000*/                   LOP3.LUT R15, R6, R4, R17, 0x96, !PT ;
        Function : _ZN41_GLOBAL__N__b2407e84_9_straw2_cu_6ea3afb421straw2_negdraw_kernelILi1EEvPKj
        /*0000*/                   LDG.E.CONSTANT R14, desc[UR8][R14.64] ;
        /*0010*/              @!P0 BRA 0xa0 ;
        /*0020*/                   LOP3.LUT R15, R6, R4, R17, 0x96, !PT ;
        /*0030*/                   IADD3 R15, -R18, R6, -R17 ;
        /*0040*/                   IMAD R5, R17, c[0x0][0x230], R15 ;
        /*0050*/                   FLO.U32 R5, R4 ;
        /*0060*/                   LDS.128 R4, [R6+UR4+-0x800] ;
        /*0070*/                   IMAD.WIDE.U32 R4, R4, R19, RZ ;
        /*0080*/                   STG.E.64 desc[UR8][R6.64], R4 ;
        /*0090*/               @P0 BRA 0x20 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0 ;
        Function : _ZN41_GLOBAL__N__b2407e84_9_straw2_cu_6ea3afb421straw2_negdraw_kernelILi2EEvPKj
        /*0000*/                   SHF.R.U32.HI R4, RZ, 0xd, R5 ;
        /*0010*/                   FLO.U32 R5, R4 ;
        /*0020*/                   IMAD.SHL.U32 R6, R4, 0x100, RZ ;
        /*0030*/                   FLO.U32 R7, R6 ;
        /*0040*/                   S2UR UR6, SR_CgaCtaId ;
        /*0050*/               @P1 BRA 0x0 ;
        /*0060*/                   EXIT ;
"""


def test_sass_draw_count():
    """One draw: the instructions of the kernel's innermost loop that
    holds a FLO (one per draw), over the FLOs in it; the forward branch
    and the self-branch after EXIT are no loops."""
    from ceph_tpu_torch.testing import sass

    split = sass.draw_split(_SASS, "straw2_negdraw_kernelILi1E")
    assert split["total"] == 8 and split["draws_per_loop"] == 1
    assert len(sass.kernel_instructions(_SASS, "straw2_level_kernel")) == 1
    with pytest.raises(ValueError):
        sass.kernel_instructions(_SASS, "no_such_kernel")
    with pytest.raises(ValueError):  # a loop without a FLO holds no draw
        sass.draw_split(_SASS, "straw2_level_kernel")


def test_sass_pipe_split():
    """The per-pipe split of a draw: ALU (LOP3, IADD3, SHF, FLO), FMA
    (IMAD forms), memory (LDS, STG), other (BRA, S2UR); two FLOs in a
    loop make it two draws."""
    from ceph_tpu_torch.testing import sass

    one = sass.draw_split(_SASS, "straw2_negdraw_kernelILi1E")
    assert {p: one[p] for p in sass.PIPES} == {"alu": 3, "fma": 2, "memory": 2, "other": 1}
    two = sass.draw_split(_SASS, "straw2_negdraw_kernelILi2E")
    assert two["draws_per_loop"] == 2
    assert {p: two[p] for p in sass.PIPES} == {"alu": 1.5, "fma": 0.5, "memory": 0, "other": 1}
    assert [sass.pipe(op) for op in ("IMAD.HI.U32", "VIMNMX.U32", "LDS.64", "BSYNC", "SEL")] == \
        ["fma", "alu", "memory", "other", "alu"]
    # straw2_splits takes K1 in its paired form where the SASS has one
    with pytest.raises(ValueError):  # this snippet's K2 has no draw loop
        sass.straw2_splits(_SASS)


def test_ptxas_kernel_names():
    import chip_smoke

    ns = "_ZN37_GLOBAL__N__46697718_5_ec_cu_0b61477a"
    assert chip_smoke.kernel_name(ns + "16gf_matrix_kernelILb1EEEvPKhS2_Phiixi") == \
        "gf_matrix_kernel<1>"
    assert chip_smoke.kernel_name(ns + "20gf2_bitmatrix_kernelILi4ELi16EEEvPKjPKhPhiiiix") == \
        "gf2_bitmatrix_kernel<4,16>"
    assert chip_smoke.kernel_name(ns + "16xor_program_smemEPK5uint4iPKjPjiiiiixi") == \
        "xor_program_smem"
