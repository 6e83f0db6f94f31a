"""K8's decomposition on the CPU: the CRC32C algebra of
``ceph_tpu_torch.recovery.scrub`` (``x^(8n) mod P``, the zero-byte
operator S_n, ``crc32c_combine``, the byte tables of S_n and the
slicing-by-4 tables) and ``crc_rows_segmented_plain``, the model of how
the kernel cuts a row into segments, folds each from state 0 and
combines them in a tree.

Everything is exact: the combine identity ``crc(A||B) == combine(crc(A),
crc(B), |B|)`` under hypothesis against the host byte chain
``crc32c_rows``; the model against ``crc32c_rows`` and the reference's
device loop ``_crc_rows`` (not at L = 0, where the reference's loop
raises: R7 in ROADMAP §3) at L around each segment length, with several
segment lengths, rows starting past a 16-byte boundary and the cuts
``crc_segments`` picks for the kernel; the check value 0xE3069283.
Rows are made from seeds with numpy.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from ceph_tpu.recovery import scrub as ref_scrub
from ceph_tpu_torch.recovery import scrub

CHECK = b"123456789"
SEGMENTS = (16, 48, 1024)
# L about every segment length above, the scrub's 32 KiB chunk, and 40 KiB
# (five staged steps of a warp a row in the kernel)
LENGTHS = sorted({1, 15, 4097, 32768, 40960} | {s + d for s in SEGMENTS for d in (-1, 0, 1)}
                 | {2 * s for s in SEGMENTS})
# row counts whose cut the kernel takes: one row, a decode-verify group,
# rows that fill the card with a warp a row, a scrub pass, a lane a row
KERNEL_ROWS = (1, 32, 2112, 90112, 67584)


def _register(data: bytes, crc: int = 0) -> int:
    """R(crc, data): the byte chain without conditioning."""
    table = scrub.crc32c_table()
    for b in data:
        crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc


def _host(rows: np.ndarray) -> np.ndarray:
    return scrub.crc32c_rows(rows).astype(np.int64)


def test_check_value_by_every_split():
    assert scrub.crc32c(CHECK) == 0xE3069283
    for i in range(len(CHECK) + 1):
        a, b = CHECK[:i], CHECK[i:]
        assert scrub.crc32c_combine(scrub.crc32c(a), scrub.crc32c(b), len(b)) == 0xE3069283
    x = torch.tensor(list(CHECK), dtype=torch.uint8)[None, :]
    for seg in (1, 2, 4, 16):
        assert int(scrub.crc_rows_segmented_plain(x, seg)[0]) == 0xE3069283


@settings(max_examples=200, deadline=None, database=None)
@given(st.binary(max_size=200), st.binary(max_size=200))
def test_combine_matches_the_byte_chain(a, b):
    whole = np.frombuffer(a + b, np.uint8)[None, :]
    want = int(scrub.crc32c_rows(whole)[0])
    assert scrub.crc32c_combine(scrub.crc32c(a), scrub.crc32c(b), len(b)) == want
    # the same identity on raw registers, and R(c, M) = S_|M|(c) ^ R(0, M)
    assert scrub.crc32c_combine(_register(a), _register(b), len(b)) == _register(a + b)
    c = scrub.crc32c(a)
    assert _register(b, c) == scrub.crc32c_shift(c, len(b)) ^ _register(b)


@settings(max_examples=100, deadline=None, database=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 5000))
def test_shift_is_zero_bytes_and_its_tables_apply_it(c, n):
    assert scrub.crc32c_shift(c, n) == _register(bytes(n), c)
    t = scrub.crc32c_shift_tables(n).astype(np.int64)
    by_tables = int(t[0, c & 0xFF] ^ t[1, (c >> 8) & 0xFF] ^ t[2, (c >> 16) & 0xFF]
                    ^ t[3, c >> 24])
    assert by_tables == scrub.crc32c_shift(c, n)


def test_x8n_powers_compose():
    rng = np.random.default_rng(5)
    for m, n in rng.integers(0, 1 << 26, (20, 2)):
        m, n = int(m), int(n)
        prod = scrub.gf2_multmodp(scrub.crc32c_x8n(m), scrub.crc32c_x8n(n))
        assert prod == scrub.crc32c_x8n(m + n)
    assert scrub.crc32c_x8n(0) == 1 << 31  # x^0


def test_slice_tables_fold_a_word_as_four_bytes():
    t = scrub.crc32c_slice_tables().astype(np.int64)
    np.testing.assert_array_equal(t[0], scrub.crc32c_table())
    rng = np.random.default_rng(6)
    for crc, w in rng.integers(0, 2**32, (50, 2), dtype=np.uint64):
        crc, w = int(crc), int(w)
        c = crc ^ w
        by_slices = int(t[3, c & 0xFF] ^ t[2, (c >> 8) & 0xFF] ^ t[1, (c >> 16) & 0xFF]
                        ^ t[0, c >> 24])
        assert by_slices == _register(w.to_bytes(4, "little"), crc)


@pytest.mark.parametrize("length", [0, 1, 16, 17, 4097, 32768, 64 << 20])
def test_operand_layout_and_init(length):
    log_w, seg = scrub.crc_segments(32, length)
    words, init = scrub.crc_operand(length, log_w, seg)
    assert words.dtype == np.uint32 and words.shape == ((1 + log_w) * 1024,)
    np.testing.assert_array_equal(words[:1024].reshape(4, 256), scrub.crc32c_slice_tables())
    for d in range(log_w):
        np.testing.assert_array_equal(words[(1 + d) * 1024:(2 + d) * 1024].reshape(4, 256),
                                      scrub.crc32c_shift_tables(seg << d))
    # R(0, zeros) = 0, so the CRC of L zero bytes is the init term alone
    assert init == scrub.crc32c_shift(0xFFFFFFFF, length) ^ 0xFFFFFFFF
    if length <= 4097:
        assert init == scrub.crc32c(bytes(length))
    if length == 0:
        assert init == 0  # L = 0 gives 0 (R7)


def test_crc_segments_cuts():
    assert scrub.crc_segments(90112, 32768) == (5, 1024)  # a scrub pass: a warp a row
    assert scrub.crc_segments(32, 32768) == (9, 64)  # a decode-verify group: a block a row
    assert scrub.crc_segments(5, 0) == (0, 16)
    assert scrub.crc_segments((1 << 20) * 128 + 5, 1) == (0, 16)
    assert scrub.crc_segments(1, 64 << 20) == (9, 131072)
    for n in (1, 2, 7, 32, 33, 1000, 2112, 67584, 90112, 1 << 27):
        for length in (0, 1, 15, 16, 17, 100, 1023, 1024, 1025, 4097, 32767, 32768, 32769,
                       1 << 20, 64 << 20):
            log_w, seg = scrub.crc_segments(n, length)
            W = 1 << log_w
            assert 0 <= log_w <= scrub.K8_MAX_LOG_LANES
            assert seg >= 16 and seg % 16 == 0 and seg * W >= length, (n, length)
            # the fewest lanes that hold the row: no lane is left wholly empty
            # by a cut that a smaller W would also hold at seg
            assert W == 1 or seg * (W // 2) < length or seg == 16, (n, length)
            # enough lanes to fill the card, unless a lane is down to 16
            # bytes or a row already has a block
            assert (n * W >= scrub.K8_FILL_LANES or seg == 16
                    or log_w == scrub.K8_MAX_LOG_LANES), (n, length)


@pytest.mark.parametrize("length", LENGTHS)
def test_segmented_model_matches_reference(length):
    rng = np.random.default_rng(length)
    rows = rng.integers(0, 256, (5, length), dtype=np.uint8)
    want = _host(rows)
    dev = np.asarray(ref_scrub._crc_rows(jnp.asarray(rows), jnp.asarray(ref_scrub.crc32c_table())))
    np.testing.assert_array_equal(want, dev.astype(np.int64))
    for offset in (0, 5):  # rows that start past a 16-byte boundary
        flat = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint8), rows.reshape(-1)]))
        x = flat[offset:].view(5, length)
        for seg in SEGMENTS:
            got = scrub.crc_rows_segmented_plain(x, seg)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"seg={seg} +{offset}")
        for n in KERNEL_ROWS:  # the kernel's own cut of n rows of this length
            log_w, seg = scrub.crc_segments(n, length)
            got = scrub.crc_rows_segmented_plain(x, seg, log_w)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"n={n} +{offset}")
    np.testing.assert_array_equal(scrub.crc_rows_plain(torch.from_numpy(rows)).numpy(), want)


def test_segmented_model_at_zero_length_and_bad_cuts():
    x = torch.zeros((3, 0), dtype=torch.uint8)
    assert scrub.crc_rows_segmented_plain(x, 16).tolist() == [0, 0, 0]  # R7: host oracle only
    np.testing.assert_array_equal(_host(np.zeros((3, 0), np.uint8)), [0, 0, 0])
    with pytest.raises(ValueError):
        scrub.crc_rows_segmented_plain(torch.zeros((1, 33), dtype=torch.uint8), 16, 1)
