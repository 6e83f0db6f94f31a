"""The straw2 kernels' draw arithmetic, modelled in numpy, vs the reference.

``ceph_tpu_torch.core.straw2`` models the forms ``csrc/straw2.cu`` uses
for one draw: the hash with the subtractions of the lines in
``MIX_MASK`` as multiply-adds by 0xFFFFFFFF, the crush_ln walk with its
product in 32-bit halves, and the divide by the magic reciprocal with
one correction.  Each is held exactly against ``ceph_tpu.core.hashes``:
the divide over every ``a = 2^48 - crush_ln(u)`` (all 65,536 ``u``)
times edge and seeded weights, the hash over 1M seeded triples and the
edges 0 and 0xFFFFFFFF.
"""

import os
import re

import numpy as np
import pytest

import jax.numpy as jnp

from ceph_tpu.core import hashes as jh
from ceph_tpu_torch.core import straw2

EDGE_WEIGHTS = [1, 2, 3, 0xFFFF, 0x10000, 0x10001, 2**31, 0xFFFFFFFF]
SEEDED_WEIGHTS = np.random.default_rng(20261017).integers(1, 2**32, 200, dtype=np.uint64)
ALL_U = np.arange(1 << 16, dtype=np.uint32)


def _a_all_u() -> np.ndarray:
    """Every ``2^48 - crush_ln(u)`` the reference can produce."""
    return (np.uint64(1) << np.uint64(48)) - np.asarray(jh.crush_ln(jnp.asarray(ALL_U)))


def _weights(group):
    return [np.uint64(group)] if group != "seeded" else list(SEEDED_WEIGHTS)


@pytest.mark.parametrize("group", EDGE_WEIGHTS + ["seeded"])
def test_kernel_divide_is_floor_over_every_u(group):
    """One correction after the high product is exact for every a the
    draw can meet and any u32 weight: the quotient of the reference's
    ``straw2_negdraw`` (``ln_neg // w``)."""
    a = _a_all_u()
    assert a.max() == 1 << 48 and a.min() == 0  # u = 0 and u = 0xffff
    for w in _weights(group):
        magic = jh.magic_reciprocal(np.array([w]))[0]
        got = straw2.div_magic_model(a, magic, w)
        np.testing.assert_array_equal(got, a // w)  # exact


@pytest.mark.parametrize("group", EDGE_WEIGHTS + ["seeded"])
def test_kernel_divide_matches_div_by_magic(group):
    """The same quotients as the reference's three-correction
    ``div_by_magic`` with the unchanged magic."""
    a = _a_all_u()
    for w in _weights(group):
        magic = jh.magic_reciprocal(np.array([w]))[0]
        want = np.asarray(jh.div_by_magic(jnp.asarray(a), jnp.uint64(magic), jnp.uint64(w)))
        np.testing.assert_array_equal(straw2.div_magic_model(a, magic, w), want)


def test_kernel_divide_needs_its_correction():
    """The high product alone is one short somewhere (so the correction
    is exercised), never two."""
    a = _a_all_u()
    short = 0
    for w in EDGE_WEIGHTS + list(SEEDED_WEIGHTS[:20]):
        q = straw2.umul64hi_model(a, jh.magic_reciprocal(np.array([w]))[0])
        d = a // np.uint64(w) - q
        assert d.max() <= 1
        short += int(d.sum())
    assert short > 0


def test_umul64hi_model_matches_reference_mulhi():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**64, 100_000, dtype=np.uint64)
    b = rng.integers(0, 2**64, 100_000, dtype=np.uint64)
    a[:4] = [0, 1, 2**64 - 1, 2**64 - 1]
    b[:4] = [2**64 - 1, 2**64 - 1, 2**64 - 1, 0]
    np.testing.assert_array_equal(straw2.umul64hi_model(a, b),
                                  np.asarray(jh.mulhi64(jnp.asarray(a), jnp.asarray(b))))


def test_kernel_ln_walk_matches_reference_crush_ln():
    """The crush_ln walk with its product in 32-bit halves, every u."""
    np.testing.assert_array_equal(straw2.ln_neg_model(ALL_U), _a_all_u())


@pytest.mark.parametrize("mask", [straw2.MIX_MASK, 0, 0x1FF], ids=["kernel", "alu", "fma"])
def test_kernel_hash_forms_match_reference(mask):
    """The hash with subtractions as multiply-adds by 0xFFFFFFFF, on 1M
    seeded triples and the edges 0 and 0xFFFFFFFF."""
    rng = np.random.default_rng(mask + 1)
    a, b, c = (rng.integers(0, 2**32, 1 << 20, dtype=np.uint32) for _ in range(3))
    edge = np.array([0, 0xFFFFFFFF], np.uint32)
    ea, eb, ec = (g.reshape(-1) for g in np.meshgrid(edge, edge, edge, indexing="ij"))
    a, b, c = (np.concatenate([t, e]) for t, e in ((a, ea), (b, eb), (c, ec)))
    want = np.asarray(jh.crush_hash32_3(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    np.testing.assert_array_equal(straw2.hash32_3_model(a, b, c, mask), want)


def test_mix_mask_matches_the_kernel_source():
    src = os.path.join(os.path.dirname(straw2.__file__), "..", "csrc", "straw2.cu")
    with open(src) as f:
        m = re.search(r"constexpr unsigned kMixMask = (0x[0-9A-Fa-f]+)u;", f.read())
    assert m and int(m.group(1), 16) == straw2.MIX_MASK


def test_kernel_draw_model_matches_reference_negdraw():
    """The whole modelled draw against ``straw2_negdraw_magic`` and
    ``straw2_negdraw`` on seeded triples, zero and edge weights among
    them."""
    rng = np.random.default_rng(11)
    n = 200_000
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    ids = rng.integers(0, 2**32, n, dtype=np.uint32)
    r = rng.integers(0, 64, n, dtype=np.uint32)
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[::97] = 0
    w[1::89] = np.array(EDGE_WEIGHTS, np.uint32)[rng.integers(0, 8, len(w[1::89]))]
    magic = jh.magic_reciprocal(w)
    got = straw2.draw_model(x, ids, r, w, magic)
    args = [jnp.asarray(t) for t in (x, ids, r, w)]
    np.testing.assert_array_equal(got, np.asarray(jh.straw2_negdraw(*args)))
    np.testing.assert_array_equal(
        got, np.asarray(jh.straw2_negdraw_magic(*args, jnp.asarray(magic))))
