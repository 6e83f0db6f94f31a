"""Plain versions of the straw2 kernels K1-K3 vs the reference package.

K1 (negdraw) is held against ``ceph_tpu.core.hashes`` on gathered
bucket rows; K2 (level_choose) and K3 (descend_fused), and the port's
``interp_batch.descend`` in each mode, against the reference's
``interp_batch.descend`` level loop (its jnp path: kernel mode "0").
Maps are built in the reference package and carried across with
``ceph_tpu_torch.convert``.  On CPU tensors every wrapper runs its plain
version.  All comparisons are integer: exact equality.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from ceph_tpu.core import hashes as jh
from ceph_tpu.crush import interp_batch as jib
from ceph_tpu.models import clusters as jclusters
from ceph_tpu_torch.convert import crushmap_from_reference
from ceph_tpu_torch.core import straw2
from ceph_tpu_torch.crush import interp_batch as tib

B = 512


def _holey_map():
    """Hierarchy with an emptied host (empty-bucket status) and some
    zero and fractional item weights."""
    m = jclusters.build_hierarchy([("rack", 2), ("host", 3)], 3)
    host = m.bucket_by_name("host0_1")
    for osd in list(host.items):
        m.remove_item(host.id, osd)
    other = m.bucket_by_name("host1_0")
    m.adjust_item_weight(other.id, other.items[0], 0)
    m.adjust_item_weight(other.id, other.items[1], 0x8000)
    return m


MAPS = {
    "flat": (lambda: jclusters.build_flat(16), 0),
    "hierarchy": (lambda: jclusters.build_hierarchy([("rack", 3), ("host", 4)], 3), "host"),
    "simple64": (lambda: jclusters.build_simple(64), "host"),
    "holey": (_holey_map, "host"),
}


# (map, leaf): the rule's descent of every map, and the leaf descent
# below it where the rule has one (a flat map's rule picks OSDs directly)
CASES = [(n, False) for n in MAPS] + [(n, True) for n in MAPS if MAPS[n][1] != 0]
CASE_IDS = [f"{n}-{'leaf' if lf else 'rule'}" for n, lf in CASES]


@lru_cache(maxsize=None)
def _case(name: str, leaf: bool):
    """(reference pack, port tables, target_type, max_devices) for the
    rule's descent (``leaf=False``) or the leaf descent below it."""
    build, target = MAPS[name]
    jm = build()
    tm = crushmap_from_reference(jm.to_obj())
    target_type = 0 if target == 0 else jm.type_id(target)
    jd, td = jm.to_dense(), tm.to_dense()
    root = -1 - jm.bucket_by_name("default").id
    if leaf:
        roots = jib._stop_buckets(jd, [root], target_type)
        target_type, consumer = 0, {}
    else:
        roots, consumer = [root], {}
        if target_type:
            stop = jib._stop_buckets(jd, [root], target_type)
            consumer = {b: i for i, b in enumerate(stop)}
    with jib._force_kernel_mode("0"):
        jpack, _ = jib.build_pack(jd, roots, target_type, consumer)
    tpack, _ = tib.build_pack(td, roots, target_type, consumer, "cpu")
    return jpack, tpack, target_type, jd.max_devices


def _inputs(seed: int, nb0: int):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, B, dtype=np.uint32)
    r = rng.integers(0, 50, B, dtype=np.int32)
    lidx = rng.integers(0, nb0, B, dtype=np.int32)
    active = rng.random(B) < 0.8
    return x, r, lidx, active


def _port(x, r, lidx, active):
    return (torch.from_numpy(x.view(np.int32)), torch.from_numpy(r),
            torch.from_numpy(lidx), torch.from_numpy(active))


def _jax_level(table, x, r, lidx):
    """The reference's level body (row fetch, draws, first-index argmin,
    winner's fields) on its jnp path."""
    row = jib.take_rows(table, jnp.asarray(lidx))
    nd = jh.straw2_negdraw_magic(jnp.asarray(x)[:, None], row["ids"],
                                 jnp.asarray(r)[:, None].astype(jnp.uint32),
                                 row["weights"], row["magic"])
    amin = jnp.argmin(nd, axis=1).astype(jnp.int32)
    item = lax.bitcast_convert_type(jib._select_col(row["ids"], amin), jnp.int32)
    return tuple(np.asarray(v) for v in (
        item, jib._select_col(row["ctype"], amin), jib._select_col(row["nlidx"], amin),
        row["size"]))


@pytest.mark.parametrize("name", list(MAPS))
def test_k1_negdraw_plain_vs_hashes(name):
    _, tpack, _, _ = _case(name, False)
    ids, w, mg, _, _ = tpack.level(tpack.n_levels - 1)
    x, r, lidx, _ = _inputs(1, ids.shape[0])
    li = torch.from_numpy(lidx.astype(np.int64))
    ids_r, w_r, mg_r = (t.index_select(0, li) for t in (ids, w, mg))
    tx, tr, _, _ = _port(x, r, lidx, np.ones(B, bool))
    got = straw2.negdraw(tx, tr, ids_r, w_r, mg_r).numpy()
    u32 = lambda t: jnp.asarray(t.numpy().view(np.uint32))
    want = np.asarray(jh.straw2_negdraw_magic(
        jnp.asarray(x)[:, None], u32(ids_r), jnp.asarray(r.view(np.uint32))[:, None],
        u32(w_r), jnp.asarray(mg_r.numpy().view(np.uint64))))
    want = np.where(want == np.uint64(2**64 - 1), np.uint64(straw2.hashes.NEGDRAW_NONE), want)
    np.testing.assert_array_equal(got, want.astype(np.int64))  # exact
    np.testing.assert_array_equal(straw2.negdraw_plain(tx, tr, ids_r, w_r).numpy(), got)


@pytest.mark.parametrize("name,leaf", CASES, ids=CASE_IDS)
def test_k2_level_choose_plain_vs_reference_level(name, leaf):
    jpack, tpack, _, _ = _case(name, leaf)
    assert tpack.signature == tuple((t.nb, t.fanout) for t in jpack.tables)
    for lv, table in enumerate(jpack.tables):
        x, r, lidx, _ = _inputs(10 + lv, table.nb)
        want = _jax_level(table, x, r, lidx)
        tx, tr, tl, _ = _port(x, r, lidx, np.ones(B, bool))
        got = straw2.level_choose(tx, tr, tl, tpack, lv)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int32))  # exact


@pytest.mark.parametrize("name,leaf", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("empty_is_hard", [False, True], ids=["soft", "hard"])
def test_k3_descend_plain_and_modes_vs_reference(name, leaf, empty_is_hard):
    jpack, tpack, target_type, max_devices = _case(name, leaf)
    x, r, lidx, active = _inputs(20, jpack.tables[0].nb)
    with jib._force_kernel_mode("0"):
        want = jib.descend(jpack, jnp.asarray(x), jnp.asarray(lidx), jnp.asarray(r),
                           target_type, empty_is_hard, jnp.asarray(active), max_devices)
    want = [np.asarray(v) for v in want]
    args = _port(x, r, lidx, active)
    got_k3 = straw2.descend_fused(args[0], args[1], args[2], args[3], tpack,
                                  target_type, empty_is_hard, max_devices)
    for g, w in zip(got_k3, want):
        np.testing.assert_array_equal(g.numpy(), w)  # exact
    for mode in tib.MODES:
        got = tib.descend(tpack, args[0], args[2], args[1], target_type, empty_is_hard,
                          args[3], max_devices, mode)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)  # exact


def test_holey_map_reaches_empty_and_zero_weight_paths():
    """The holey map's leaf descent really meets an empty bucket."""
    _, tpack, target_type, max_devices = _case("holey", True)
    x, r, lidx, active = _inputs(30, tpack.meta[0][0])
    sizes = tpack.level(0)[4]
    assert (sizes == 0).any()
    args = _port(x, r, lidx, np.ones(B, bool))
    _, ok, hard, _ = straw2.descend_fused(args[0], args[1], args[2], args[3], tpack,
                                          target_type, True, max_devices)
    assert hard.any() and ok.any()


def test_pack_descend_tables_rejects_wide_fields():
    ids = np.zeros((1, 2), np.uint32)
    with pytest.raises(ValueError):
        straw2.pack_descend_tables(
            [(ids, ids, ids, np.array([[0x10000, 0]], np.uint32), np.ones(1, np.uint32))],
            "cpu")
    with pytest.raises(ValueError):
        straw2.pack_descend_tables([], "cpu")
