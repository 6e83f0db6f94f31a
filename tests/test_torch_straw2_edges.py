"""The K1 and K3 edge inputs (``ceph_tpu_torch.testing.straw2_edges``) on the CPU.

The card holds the kernels against their plain versions on these inputs
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).  Here each case is
checked to be the edge it names, and the plain versions are held on it
against the reference package: K1's draws against
``ceph_tpu.core.hashes.straw2_negdraw_magic``, K3's winners against a
first-index argmin over the modelled kernel draw.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.core import hashes as jh
from ceph_tpu_torch.core import straw2
from ceph_tpu_torch.testing import straw2_edges

K1_CASES = straw2_edges.negdraw_edges("cpu")
K3_CASES = straw2_edges.descend_edges("cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("i", range(len(K1_CASES)), ids=[c[0] for c in K1_CASES])
def test_negdraw_edge_plain_vs_reference(i):
    label, (x, r, ids, w, magic) = K1_CASES[i]
    assert ids.shape[0] == straw2_edges.ROWS and ids.shape[0] % 256
    wn = _u32(w)
    assert (wn == 0).any() and (wn == 1).any()
    if wn.shape[1] > 1:
        assert (wn == 0xFFFFFFFF).any()
    if wn.shape[1] > 2:
        assert ((wn[:, 1:-1] == 0).any(axis=1)).any()  # zero weights mid-row
    sliced = "boundary" in label
    assert (ids.storage_offset() % 4 != 0) == sliced and ids.is_contiguous()
    want = np.asarray(jh.straw2_negdraw_magic(
        jnp.asarray(_u32(x))[:, None], jnp.asarray(_u32(ids)), jnp.asarray(_u32(r))[:, None],
        jnp.asarray(wn), jnp.asarray(magic.numpy().view(np.uint64))))
    want = np.where(want == np.uint64(2**64 - 1), np.uint64(straw2.hashes.NEGDRAW_NONE), want)
    np.testing.assert_array_equal(straw2.negdraw(x, r, ids, w, magic).numpy(),
                                  want.astype(np.int64))  # exact


@pytest.mark.parametrize("i", range(len(K3_CASES)), ids=[c[0] for c in K3_CASES])
def test_descend_edge_plain_vs_modelled_draws(i):
    label, (x, r, lidx, active, tb, target, hard, max_devices) = K3_CASES[i]
    item, ok, hard_out, _ = straw2.descend_fused(x, r, lidx, active, tb, target, hard,
                                                 max_devices)
    ids, w, mg, _, size = (t.numpy() for t in tb.level(0))
    if "global" in label:
        assert tb.ids.numel() * 20 > 227 * 1024  # outgrows a block's shared memory
    else:
        assert (size == 0).any() and tb.n_levels == 1
    li = lidx.numpy()
    nd = straw2.draw_model(_u32(x)[:, None], ids.view(np.uint32)[li], _u32(r)[:, None],
                           w.view(np.uint32)[li], mg.view(np.uint64)[li])
    live = np.arange(ids.shape[1])[None, :] < size[li][:, None]
    nd = np.where(live, nd, np.uint64(2**64 - 1))
    want = ids[li, nd.argmin(axis=1)]
    act = active.numpy()
    np.testing.assert_array_equal(item.numpy()[act], want[act])
    empty = size[li] == 0
    assert (hard_out.numpy()[act & empty] == hard).all()
    assert not ok.numpy()[act & empty].any()
    assert (item.numpy()[~act] == straw2.ITEM_NONE).all()
