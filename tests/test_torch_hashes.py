"""ceph_tpu_torch.core.hashes vs the reference package's jnp primitives.

Inputs are made from a seed with numpy and fed to both.  Every
comparison is integer: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.core import hashes as jh
from ceph_tpu_torch.core import hashes as th
from ceph_tpu_torch.core import ref

U32_MAX = 0xFFFFFFFF


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _negdraw_both(x, ids, r, w):
    """(port, reference) negdraws; the reference's u64 max becomes the
    port's int64 max sentinel, the only value where the two differ."""
    magic = jh.magic_reciprocal(w)
    want = np.asarray(jh.straw2_negdraw_magic(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(r), jnp.asarray(w),
        jnp.asarray(magic)))
    want = np.where(want == np.uint64(2**64 - 1), np.uint64(th.NEGDRAW_NONE), want)
    got = th.straw2_negdraw(_t(x), _t(ids), _t(r), _t(w)).numpy()
    return got, want.astype(np.int64)


@pytest.mark.parametrize("fn", ["crush_hash32_2", "crush_hash32_3"])
def test_hashes_random(fn):
    rng = np.random.default_rng(11)
    n_args = 2 if fn.endswith("_2") else 3
    args = [rng.integers(0, 2**32, 4096, dtype=np.uint32) for _ in range(n_args)]
    want = np.asarray(getattr(jh, fn)(*map(jnp.asarray, args)))
    got = getattr(th, fn)(*map(_t, args)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))  # exact


def test_negative_bucket_ids_hash_as_u32():
    ids = np.array([-1, -2, -1000, -(2**31)], np.int32)
    x = np.arange(4, dtype=np.uint32)
    want = np.asarray(jh.crush_hash32_3(jnp.asarray(x), jnp.asarray(ids.view(np.uint32)),
                                        jnp.zeros(4, jnp.uint32)))
    got = th.crush_hash32_3(torch.from_numpy(x.astype(np.int64)),
                            torch.from_numpy(ids), torch.zeros(4, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))  # exact


def test_crush_ln_every_input():
    u = np.arange(0x10000, dtype=np.uint32)
    want = np.asarray(jh.crush_ln(jnp.asarray(u))).astype(np.int64)
    np.testing.assert_array_equal(th.crush_ln(_t(u)).numpy(), want)  # exact


def test_crush_ln_boundary_product():
    """u = 0xffff gives xs = 0x10000, whose product with RH reaches 64
    bits; the split multiply must still give the scalar oracle's value."""
    # the widest product of the table walk is 64 bits: beyond int64
    prods = [x * ref.RH_LH_TBL[((x >> 8) << 1) - 256] for x in range(0x8000, 0x10001)]
    assert max(prods).bit_length() == 64
    u = torch.tensor([0xFFFF, 0x7FFF, 0])  # xs = 0x10000, 0x8000, 0x8000
    assert th.crush_ln(u).tolist() == [ref.crush_ln(0xFFFF), ref.crush_ln(0x7FFF), 0]


def test_negdraw_random():
    rng = np.random.default_rng(42)
    B, F = 1024, 8
    x = rng.integers(0, 2**32, (B, 1), dtype=np.uint32)
    ids = rng.integers(0, 2**31, (B, F), dtype=np.uint32)
    r = rng.integers(0, 64, (B, 1), dtype=np.uint32)
    w = rng.integers(0, 0x200000, (B, F), dtype=np.uint32)
    got, want = _negdraw_both(x, ids, r, w)
    np.testing.assert_array_equal(got, want)  # exact


def test_negdraw_edge_weights():
    B = 512
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**32, (B, 1), dtype=np.uint32)
    ids = rng.integers(0, 2**31, (B, 4), dtype=np.uint32)
    r = rng.integers(0, 50, (B, 1), dtype=np.uint32)
    w = np.tile(np.array([0, 1, U32_MAX, 0x10000], np.uint32), (B, 1))
    got, want = _negdraw_both(x, ids, r, w)
    np.testing.assert_array_equal(got, want)  # exact
    assert (got[:, 0] == th.NEGDRAW_NONE).all()


def test_negdraw_crush_ln_boundary_u_ffff():
    xs = np.array([7250, 88814, 114993], np.uint32)
    for x in xs:  # the inputs really do hit u == 0xffff
        assert (ref.crush_hash32_3(int(x), 12345, 7) & 0xFFFF) == 0xFFFF
    ids = np.full((3, 2), 12345, np.uint32)
    r = np.full((3, 1), 7, np.uint32)
    w = np.array([[0x10000, 1], [U32_MAX, 0x8000], [3, 0x25000]], np.uint32)
    got, want = _negdraw_both(xs[:, None], ids, r, w)
    np.testing.assert_array_equal(got, want)  # exact


def test_negdraw_quotient_exactly_2_pow_48():
    """u == 0 with weight 1: the quotient is exactly 2^48."""
    xs_all = torch.arange(200_000)
    pairs = []
    for item in range(4):
        h = th.crush_hash32_3(xs_all, torch.full_like(xs_all, item), torch.zeros_like(xs_all))
        hits = torch.nonzero((h & 0xFFFF) == 0)[:, 0]
        assert hits.numel(), "u==0 preimage search failed"
        pairs.append((int(hits[0]), item))
    x = np.array([[p[0]] for p in pairs], np.uint32)
    ids = np.array([[p[1], p[1] + 100] for p in pairs], np.uint32)
    r = np.zeros((4, 1), np.uint32)
    w = np.ones((4, 2), np.uint32)
    got, want = _negdraw_both(x, ids, r, w)
    np.testing.assert_array_equal(got, want)  # exact
    assert (got[:, 0] == 1 << 48).all()


def test_negdraw_ragged_batch():
    rng = np.random.default_rng(3)
    B, F = 333, 3
    x = rng.integers(0, 2**32, (B, 1), dtype=np.uint32)
    ids = rng.integers(0, 2**31, (B, F), dtype=np.uint32)
    r = rng.integers(0, 8, (B, 1), dtype=np.uint32)
    w = rng.integers(1, 0x40000, (B, F), dtype=np.uint32)
    got, want = _negdraw_both(x, ids, r, w)
    np.testing.assert_array_equal(got, want)  # exact


def test_magic_reciprocal_matches():
    w = np.array([0, 1, 3, 0x10000, U32_MAX], np.uint32)
    np.testing.assert_array_equal(th.magic_reciprocal(w), jh.magic_reciprocal(w))


@pytest.mark.parametrize("b", [1, 7, 64, 100, 1000])
def test_ceph_stable_mod(b):
    x = np.random.default_rng(b).integers(0, 2**32, 2048, dtype=np.uint32)
    bmask = ref.pg_num_mask(b)
    want = np.asarray(jh.ceph_stable_mod(jnp.asarray(x), np.uint32(b), np.uint32(bmask)))
    got = th.ceph_stable_mod(_t(x), b, bmask).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))  # exact


def test_is_out():
    rng = np.random.default_rng(5)
    n = 4096
    w = rng.choice(np.array([0, 1, 0x4000, 0x8000, 0xFFFF, 0x10000, 0x20000], np.uint32), n)
    item = rng.integers(0, 1024, n, dtype=np.uint32)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    want = np.asarray(jh.is_out(jnp.asarray(w), jnp.asarray(item), jnp.asarray(x)))
    got = th.is_out(_t(w), _t(item), _t(x)).numpy()
    np.testing.assert_array_equal(got, want)  # exact
