"""The plain versions of K4, K5 and K7 vs the reference's oracles.

K4 (``gf_kernels.matrix_encode``) against ``ceph_tpu.ec.gf.matrix_encode``
and the C++ tier, with the cases of ``tests/test_pallas_gf.py``; K5
(``kernels.bitmatrix_encode``) against ``gf.bitmatrix_encode`` and the
C++ tier at w = 8 and against the reference's ``BitmatrixEncoder`` at
w in {6, 7, 16, 32} and for square decoder bitmatrices, with the packet
sizes of ``tests/test_ec_pallas.py``, and the kernel's walk over its
compiled row lists (``kernels.bitmatrix_walk_plain``) on both of its
paths against the reference's ``BitmatrixEncoder``; K7 (``gf_kernels.byte_lut``)
against ``mul_table()`` rows indexed in numpy.  On CPU tensors each
wrapper runs its plain version.  All comparisons are integer: exact
equality.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.ec import gfw as ref_gfw
from ceph_tpu.ec.backend import BitmatrixEncoder as RefBitmatrixEncoder
from ceph_tpu_torch.ec import gf_kernels, kernels
from ceph_tpu_torch.testing import cppref


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("k,m,size", [(4, 2, 4096), (8, 3, 1024), (5, 1, 131), (3, 2, 0)])
def test_matrix_encode_matches_gf_and_cpp(k, m, size):
    rng = np.random.default_rng(k * 7 + m)
    M = ref_gf.vandermonde_matrix(k, m)
    data = rng.integers(0, 256, (k, size), dtype=np.uint8)
    got = gf_kernels.matrix_encode(gf_kernels.mul_tables(M, "cpu"), _t(data))
    assert got.dtype == torch.uint8 and got.shape == (m, size)
    np.testing.assert_array_equal(got.numpy(), ref_gf.matrix_encode(M, data))
    np.testing.assert_array_equal(got.numpy(), cppref.matrix_encode(M, data))


def test_matrix_encode_rejects_wrong_row_count():
    M = ref_gf.vandermonde_matrix(4, 2)
    with pytest.raises(ValueError):
        gf_kernels.matrix_encode(gf_kernels.mul_tables(M, "cpu"), torch.zeros(3, 64, dtype=torch.uint8))


@pytest.mark.parametrize("m,k,staged", [(3, 8, True), (8, 128, False), (2, 4, True),
                                         (8, 64, True), (4, 129, False)])
def test_tables_staged_threshold(m, k, staged):
    """K4 keeps k=8 m=3's 768 bytes of nibble tables in shared memory (up
    to 16 KB: k=64 m=8) and reads a k=128 m=8 code's 32 KB from global
    memory."""
    assert gf_kernels.tables_staged(m, k) == staged
    assert staged == (m * k * 32 <= gf_kernels.NIBBLE_SMEM_BYTES)


# ---------------------------------------------------------------- K5


@pytest.mark.parametrize("k,m,p", [(4, 2, 16), (8, 3, 64), (3, 2, 4), (4, 2, 2),
                                   (4, 2, 3), (4, 2, 5), (4, 2, 7)])
def test_bitmatrix_encode_w8_matches_gf_and_cpp(k, m, p):
    rng = np.random.default_rng(k * 11 + m + p)
    bm = ref_gf.matrix_to_bitmatrix(ref_gf.cauchy_matrix(k, m))
    size = 8 * p * 3
    data = rng.integers(0, 256, (k, size), dtype=np.uint8)
    got = kernels.bitmatrix_encode(kernels.Bitmatrix(bm, 8, "cpu"), _t(data), p).numpy()
    np.testing.assert_array_equal(got, ref_gf.bitmatrix_encode(bm, data, p))
    np.testing.assert_array_equal(got, cppref.bitmatrix_encode(bm, data, p))


def _native(name: str) -> tuple[np.ndarray, int]:
    """(bitmatrix, w) of a jerasure code that has one natively."""
    k, m = 4, 2
    if name == "blaum_roth_w6":
        return ref_gfw.blaum_roth_bitmatrix(k, 6), 6
    if name == "liberation_w7":
        return ref_gfw.liberation_bitmatrix(k, 7), 7
    w = int(name.split("_w")[1])
    return ref_gfw.matrix_to_bitmatrix(ref_gfw.vandermonde_matrix(k, m, w), w), w


def _decoder(name: str) -> tuple[np.ndarray, int]:
    """A square decoder bitmatrix: data chunks 0 and 2 lost, rows
    (1, 3, 4, 5) of the bit generator inverted (k*w outputs)."""
    bm, w = _native(name)
    kw = bm.shape[1]
    gen = np.vstack([np.eye(kw, dtype=np.uint8), bm])
    sub = np.vstack([gen[r * w:(r + 1) * w] for r in (1, 3, 4, 5)])
    return ref_gf.invert_bitmatrix(sub), w


@pytest.mark.parametrize("name,p,decoder", [
    ("blaum_roth_w6", 8, False), ("liberation_w7", 8, False), ("liberation_w7", 3, False),
    ("rs_w16", 4, False), ("rs_w32", 4, False), ("rs_w16", 5, False),
    ("liberation_w7", 8, True), ("rs_w32", 4, True),
])
def test_bitmatrix_encode_any_w_matches_reference_encoder(name, p, decoder):
    bm, w = _decoder(name) if decoder else _native(name)
    k = bm.shape[1] // w
    rng = np.random.default_rng(w * 31 + p)
    size = w * p * 5
    data = rng.integers(0, 256, (k, size), dtype=np.uint8)
    got = kernels.bitmatrix_encode(kernels.Bitmatrix(bm, w, "cpu"), _t(data), p).numpy()
    assert got.shape == (bm.shape[0] // w, size)
    want = RefBitmatrixEncoder(bm, p, w).encode(data)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mw,kw", [(8, 32), (16, 32), (24, 32), (64, 32), (256, 32), (24, 64)])
def test_bitmatrix_prog_lists_every_set_entry(mw, kw):
    """K5's operand: every output row once, in one of the 8 row groups,
    with its output chunk and packet and exactly its set input rows in
    order (row and chunk packed as ``s | (s // w) << 16``, padding zero);
    the groups' entries (a row's store counting one) differ by at most
    one row's."""
    rng = np.random.default_rng(mw * 7 + kw)
    bits = rng.integers(0, 2, (mw, kw), dtype=np.uint8)
    bits[3] = 0  # an empty row stores zeros
    bm = kernels.Bitmatrix(bits, 8, "cpu")
    words = bm.prog.numpy().view(np.uint32)
    assert words.size == 4 * bm.prog16 and words[0] == kernels.K5_HEAD
    assert words[kernels.K5_GROUPS] == bm.prog16
    seen, loads = [], [0] * kernels.K5_GROUPS
    for q, i, t, ents in kernels._prog_rows(bm):
        r = i * 8 + t
        s = ents & 0xFFFF
        np.testing.assert_array_equal(s, np.flatnonzero(bits[r]))
        np.testing.assert_array_equal(ents >> 16, s // 8)
        seen.append(r)
        loads[q] += len(ents) + 1
    assert sorted(seen) == list(range(mw))
    assert max(loads) - min(loads) <= int(bits.sum(axis=1).max()) + 1
    quads = words.reshape(-1, 4)
    h = kernels.K5_HEAD
    while h < bm.prog16:  # padding after each row's entries is zero
        n = int(quads[h, 0])
        assert not quads[h + 1:h + 1 + -(-n // 4)].reshape(-1)[n:].any() and quads[h, 3] == 0
        h += 1 + -(-n // 4)


def _walk_case(name: str) -> tuple[np.ndarray, int]:
    if name == "cauchy_good_w8":
        return ref_gf.matrix_to_bitmatrix(ref_gf.cauchy_good_matrix(8, 3)), 8
    if name == "decoder_w32":
        return _decoder("rs_w32")
    return _native(name)


@pytest.mark.parametrize("name,p", [
    ("liberation_w7", 8), ("liberation_w7", 48), ("blaum_roth_w6", 8), ("blaum_roth_w6", 16),
    ("cauchy_good_w8", 2048), ("cauchy_good_w8", 3), ("rs_w32", 4), ("rs_w32", 16),
    ("decoder_w32", 16),
])
def test_bitmatrix_walk_matches_reference_encoder(name, p):
    """K5's walk over its row lists (``bitmatrix_walk_plain``), on the
    kernel's staged path (tiles of 512 columns copied piece by piece,
    stale bytes past the ragged end) where the packets are whole 16-byte
    units and on its global path always, against the reference's
    ``BitmatrixEncoder``; the 128-row w = 32 decoder and p = 48 (tiles
    that end mid-packet) included."""
    bm, w = _walk_case(name)
    k = bm.shape[1] // w
    rng = np.random.default_rng(w * 7 + p)
    groups = 3 if p == 2048 else 37  # at least one ragged tile either way
    data = rng.integers(0, 256, (k, w * p * groups), dtype=np.uint8)
    want = RefBitmatrixEncoder(bm, p, w).encode(data)
    op = kernels.Bitmatrix(bm, w, "cpu")
    for staged in ((False, True) if p % 16 == 0 else (False,)):
        got = kernels.bitmatrix_walk_plain(op, _t(data), p, staged).numpy()
        np.testing.assert_array_equal(got, want)


def test_bitmatrix_walk_staged_needs_whole_units():
    op = kernels.Bitmatrix(ref_gf.matrix_to_bitmatrix(ref_gf.cauchy_matrix(4, 2)), 8, "cpu")
    with pytest.raises(ValueError):
        kernels.bitmatrix_walk_plain(op, torch.zeros(4, 8 * 24, dtype=torch.uint8), 24, True)


def test_bitmatrix_encode_rejects_ragged_chunks():
    bm = kernels.Bitmatrix(ref_gf.matrix_to_bitmatrix(ref_gf.cauchy_matrix(4, 2)), 8, "cpu")
    with pytest.raises(ValueError):
        kernels.bitmatrix_encode(bm, torch.zeros(4, 8 * 16 + 4, dtype=torch.uint8), 16)


# ---------------------------------------------------------------- K7


@pytest.mark.parametrize("shape", [(7,), (3, 1001), (2, 5, 33), (0,)])
def test_byte_lut_matches_mul_table_rows(shape):
    mt = ref_gf.mul_table()
    rng = np.random.default_rng(sum(shape) + 1)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    for c in (1, 2, 0x1D, 255):
        got = gf_kernels.byte_lut(_t(x), _t(mt[c]))
        assert got.shape == shape and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), mt[c][x])


def test_byte_lut_rejects_short_table():
    with pytest.raises(ValueError):
        gf_kernels.byte_lut(torch.zeros(8, dtype=torch.uint8), torch.zeros(128, dtype=torch.uint8))
