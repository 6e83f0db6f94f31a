"""The CUDA kernels on the card (marked ``cuda``; skipped without one).

Each kernel against its plain PyTorch version on the same card inputs,
and the batch runner's three modes against the CPU plain versions, at a
small size, and K2/K3 on tables too large for shared memory.  Run them
on a machine with an H100 and nvcc:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
repo's conftest imports the reference package, which needs jax).  All
comparisons are integer: exact equality.
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.core import straw2
from ceph_tpu_torch.crush import interp_batch
from ceph_tpu_torch.crush.engine import make_batch_runner
from ceph_tpu_torch.models.clusters import build_simple

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _tables(dev):
    dense = build_simple(64).to_dense()
    stop = interp_batch._stop_buckets(dense, [0], 3)
    pack, _ = interp_batch.build_pack(dense, [0], 3, {b: i for i, b in enumerate(stop)}, dev)
    return pack


def _lanes(dev, n=4099):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32)).to(dev)
    r = torch.from_numpy(rng.integers(0, 9, n, dtype=np.int32)).to(dev)
    return x, r


def test_kernels_match_plain_versions(card):
    pack = _tables(card)
    x, r = _lanes(card)
    n = x.shape[0]
    ids, w, mg, _, _ = pack.level(1)
    li = torch.randint(0, ids.shape[0], (n,), device=card)
    rows = [t.index_select(0, li) for t in (ids, w, mg)]
    assert torch.equal(straw2.negdraw(x, r, *rows), straw2.negdraw_plain(x, r, *rows))
    lidx = li.to(torch.int32)
    for a, b in zip(straw2.level_choose(x, r, lidx, pack, 1),
                    straw2.level_choose_plain(x, r, lidx, pack, 1)):
        assert torch.equal(a, b)
    active = torch.rand(n, device=card) < 0.9
    zero = torch.zeros(n, dtype=torch.int32, device=card)
    for a, b in zip(straw2.descend_fused(x, r, zero, active, pack, 3, True, 64),
                    straw2.descend_plain(x, r, zero, active, pack, 3, True, 64)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_osds", [4000, 12000])
def test_large_tables(card, n_osds):
    """Flat roots whose slot table needs the opt-in to more than 48 KB of
    shared memory (4000 OSDs, 80 KB) or exceeds a block's 227 KB (12000
    OSDs, 240 KB: K2 and K3 read their tables from global memory)."""
    from ceph_tpu_torch.models.clusters import build_flat

    dense = build_flat(n_osds).to_dense()
    pack, _ = interp_batch.build_pack(dense, [0], 0, {}, card)
    assert pack.ids.numel() * 20 > 48 * 1024
    x, r = _lanes(card, 2053)
    zero = torch.zeros_like(x)
    for a, b in zip(straw2.level_choose(x, r, zero, pack, 0),
                    straw2.level_choose_plain(x, r, zero, pack, 0)):
        assert torch.equal(a, b)
    active = torch.ones_like(x, dtype=torch.bool)
    for a, b in zip(straw2.descend_fused(x, r, zero, active, pack, 0, False, n_osds),
                    straw2.descend_plain(x, r, zero, active, pack, 0, False, n_osds)):
        assert torch.equal(a, b)


def test_wrappers_refuse_wrong_dtypes(card):
    pack = _tables(card)
    x, r = _lanes(card, 64)
    with pytest.raises(TypeError):
        straw2.level_choose(x.to(torch.int64), r, r, pack, 0)


def _erasure():
    m = build_simple(48)
    m.make_erasure_rule("ec", "default", "host")
    return m, m.rule_by_name("ec"), 6, {2: 0}


def _skewed():
    from ceph_tpu_torch.models.clusters import build_skewed

    m = build_skewed(64)
    return m, m.rule_by_name("replicated_rule"), 3, {3: 0x8000, 7: 0}


SHAPES = {
    "simple": lambda: (build_simple(64), build_simple(64).rule_by_name("replicated_rule"),
                       3, {5: 0}),
    "erasure": _erasure,
    "skewed": _skewed,
}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", interp_batch.MODES)
def test_modes_match_cpu(card, mode, shape):
    m, rule, rm, reweights = SHAPES[shape]()
    dense = m.to_dense()
    w = np.full(dense.max_devices, 0x10000, np.uint32)
    for osd, wt in reweights.items():
        w[osd] = wt
    xs = np.arange(5000, dtype=np.uint32)
    ca, fn = make_batch_runner(dense, rule, rm, mode=mode, device="cpu")
    want = fn(ca, w, xs)
    before = dict(straw2.LAUNCHES)
    ca, fn = make_batch_runner(dense, rule, rm, mode=mode, device=card)
    got = fn(ca, w, xs)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert any(straw2.LAUNCHES[k] > before[k] for k in before)
