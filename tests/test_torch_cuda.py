"""The CUDA kernels on the card (marked ``cuda``; skipped without one).

Each kernel against its plain PyTorch version on the same card inputs,
and the batch runner's three modes against the CPU plain versions, at a
small size, K2/K3 on tables too large for shared memory, K1 and K3 on
their edges (``ceph_tpu_torch/testing/straw2_edges.py``); the EC
kernels K4, K5 and K7 against theirs on edge shapes (ragged lengths,
K4's global-memory table path, K5 at w = 6, 7, 32, its 64- and 128-row
decoders, unaligned packet sizes and data, K7 at 16 n + 3 bytes and
on unaligned data), K6 on its shared-memory paths (two input stages and one) and its
global-memory path, codecs built on
the card against the same on the CPU, a small ``recover_pool`` on the
card against the same on the CPU, the general engine (uniform and mixed
maps, K1 on the straw2 levels) against the CPU and the C++ tier, and
its compacted-straggler retry against its masked rounds and the C++
tier, K8 (the scrub's CRC32C of rows) against its plain version on its
edges (``K8_EDGES``: L = 0 and below 16, about the segment lengths of
the scrub pass's and a decode-verify group's cuts, rows off a 16-byte
boundary across segments, a 64 MiB row checked by 32 KiB pieces
combined on the host, more rows than one grid, the check value), a
small supervised ``scrub-storm`` run on the
card against the same run on the CPU, the foreground-traffic step
(torch ops) on the card against the same call on the CPU, and K9 (the
stripe buffer's write loop) against ``stripe_absorb_plain`` on its edge
batches (``ceph_tpu_torch/testing/online_edges.py``) and a random batch,
each on its own clone of the buffer: buffers, the compact Δdata,
``slot_of`` and counter rows, and K9's commit against
``stripe_commit_plain``; the fused placement->peering program's CUDA
graph (``recovery/pipeline.py``) on both device tiers against the
program run eagerly (and on the CPU), a replay making no wrapper call
and no host read, a capture with a host read raising, and a graph left
in a reference cycle not freed inside another capture; the graphs'
IF and SWITCH nodes nested in WHILE and IF bodies against the same code
run eagerly; the compiled epoch superstep (``recovery/superstep.py``)
on a small config 7 and a compacted walk against the eager body and
``run_staged`` (and the CPU), a second chunk of another length replayed
without a capture, a replay with no call, read or sync warning, and a
capture with a host read in the epoch body raising; the compiled write
path (``workload/writepath.py``) on a small config 10 against the eager
body, the host-decided loop, ``run_staged`` and the CPU (with the
recorder too), one capture over two caps in one bucket, a replay with no
call, read or sync warning, and a capture with a host read in the write
stage raising; the compiled fleet window (``recovery/fleet.py``) against
the eager body, the host-decided loop and the CPU (with the per-lane
ring too), a second fleet in the pad bucket replayed with no capture,
call, read or sync warning, and the tape program
(``recovery/superstep.py``) sharing one capture over two tapes of a row
bucket, equal to its eager body and the host-decided sequential loop.
Run them
on a machine with an H100 and nvcc:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
repo's conftest imports the reference package, which needs jax).  All
comparisons are exact equality, but the traffic step's two float32 sums
(``rtol=1e-5``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ceph_tpu_torch.core import straw2
from ceph_tpu_torch.crush import interp_batch
from ceph_tpu_torch.crush.engine import make_batch_runner
from ceph_tpu_torch.models.clusters import build_simple
from ceph_tpu_torch.testing import online_edges

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


def test_negdraw_edges_match_plain(card):
    """K1 on its edges (``testing/straw2_edges.py``): fanout 1, 2, 5, 33
    and 32 (paired slots), zero weights mid-row, weights 1 and
    0xFFFFFFFF, rows off a 16-byte boundary (slot by slot), 4099 rows."""
    from ceph_tpu_torch.testing import straw2_edges

    for label, args in straw2_edges.negdraw_edges(card):
        before = straw2.LAUNCHES["negdraw"]
        got = straw2.negdraw(*args)
        torch.cuda.synchronize()
        assert straw2.LAUNCHES["negdraw"] == before + 1
        assert torch.equal(got, straw2.negdraw_plain(*args)), label


def test_descend_edges_match_plain(card):
    """K3 on its edges: fanout 1, 5 and 33 with zero weights, short and
    empty rows under ``empty_is_hard`` both ways, and tables that
    outgrow shared memory (the global-memory path)."""
    from ceph_tpu_torch.testing import straw2_edges

    for label, args in straw2_edges.descend_edges(card):
        got = straw2.descend_fused(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, straw2.descend_plain(*args)):
            assert torch.equal(a, b), label


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


# ---------------------------------------------------------------- EC: K4, K5, K7


def _bytes(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)


@pytest.mark.parametrize("k,m,size", [(8, 3, 1 << 16), (4, 2, 4096), (5, 1, 131), (4, 2, 4100),
                                      (128, 8, 4096), (3, 2, 0), (8, 3, 100_003),
                                      (6, 4, "unaligned")])
def test_matrix_encode_matches_plain(card, k, m, size):
    """Shared-memory nibble tables, ragged and non-16-multiple lengths,
    the global-memory table path (k=128 m=8: 32 KB of nibble tables), and
    data that starts 1 byte past a 16-byte boundary."""
    from ceph_tpu_torch.ec import gf, gf_kernels

    M = gf.vandermonde_matrix(k, m)
    tables = gf_kernels.mul_tables(M, card)
    nibbles = gf_kernels.nibble_tables(M, card)
    if size == "unaligned":
        size = 4096
        data = _bytes((k * size + 1,), k + m, card)[1:].view(k, size)
        assert data.data_ptr() % 16
    else:
        data = _bytes((k, size), k + m, card)
    before = gf_kernels.LAUNCHES["matrix_encode"]
    got = gf_kernels.matrix_encode(tables, data, nibbles)
    torch.cuda.synchronize()
    assert torch.equal(got, gf_kernels.matrix_encode_plain(tables, data))
    assert gf_kernels.LAUNCHES["matrix_encode"] == before + (size > 0)
    assert gf_kernels.tables_staged(m, k) == (k * m * 32 <= gf_kernels.NIBBLE_SMEM_BYTES)
    with pytest.raises(ValueError):  # the kernel's operand is the nibble tables
        gf_kernels.matrix_encode(tables, data)


def _bitmatrix(kind):
    from ceph_tpu_torch.ec import gf, gfw

    if kind == "cauchy_w8":
        return gf.matrix_to_bitmatrix(gf.cauchy_good_matrix(8, 3)), 8
    if kind == "blaum_roth_w6":
        return gfw.blaum_roth_bitmatrix(4, 6), 6
    if kind == "liberation_w7":
        return gfw.liberation_bitmatrix(4, 7), 7
    bm = gfw.matrix_to_bitmatrix(gfw.vandermonde_matrix(4, 2, 32), 32)
    if kind == "rs_w32":
        return bm, 32
    if kind == "decoder_w8":  # cauchy_good k=8 m=3, data chunks 0 and 1 lost: 64 rows
        gen = np.vstack([np.eye(64, dtype=np.uint8),
                         gf.matrix_to_bitmatrix(gf.cauchy_good_matrix(8, 3))])
        return gf.invert_bitmatrix(gen[16:80]), 8
    # a w = 32 decoder: 128 output rows
    gen = np.vstack([np.eye(128, dtype=np.uint8), bm])
    sub = np.vstack([gen[r * 32:(r + 1) * 32] for r in (1, 3, 4, 5)])
    return gf.invert_bitmatrix(sub), 32


@pytest.mark.parametrize("kind,p,offset", [
    ("cauchy_w8", 2048, 0), ("cauchy_w8", 3, 0), ("blaum_roth_w6", 8, 0), ("liberation_w7", 8, 0),
    ("liberation_w7", 5, 0), ("liberation_w7", 48, 0), ("rs_w32", 4, 0), ("rs_w32", 16, 0),
    ("decoder_w32", 4, 0), ("decoder_w32", 16, 0), ("decoder_w8", 2048, 0),
    ("cauchy_w8", 2048, 4), ("cauchy_w8", 2048, 1), ("decoder_w8", 16, 1),
])
def test_bitmatrix_encode_matches_plain(card, kind, p, offset):
    """Both paths of K5 (staged: p a multiple of 16 and the data
    16-byte aligned; else the global walk), data ``offset`` bytes past
    a 16-byte boundary."""
    from ceph_tpu_torch.ec import kernels

    bits, w = _bitmatrix(kind)
    bm = kernels.Bitmatrix(bits, w, card)
    k, size = bits.shape[1] // w, w * p * 37
    data = _bytes((k * size + offset,), w + p, card)[offset:].view(k, size)
    got = kernels.bitmatrix_encode(bm, data, p)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.bitmatrix_encode_plain(bm, data, p))


@pytest.mark.parametrize("shape,offset", [((7,), 0), ((3, 1001), 0), ((1 << 20,), 0), ((0,), 0),
                                          ((16 * 4099 + 3,), 0), ((16 * 4099 + 3,), 1),
                                          ((16 * 4099 + 3,), 4)])
def test_byte_lut_matches_plain(card, shape, offset):
    """K7's 16-byte path and its tail, and its edge path on data 1 or 4
    bytes past a 16-byte boundary."""
    from ceph_tpu_torch.ec import gf, gf_kernels

    table = torch.from_numpy(gf.mul_table()[0x8E].copy()).to(card)
    n = int(np.prod(shape))
    x = _bytes((n + offset,), 5, card)[offset:].view(shape)
    got = gf_kernels.byte_lut(x, table)
    torch.cuda.synchronize()
    assert torch.equal(got, gf_kernels.byte_lut_plain(x, table))


@pytest.mark.parametrize("profile", [
    {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8", "m": "3"},
    {"plugin": "jerasure", "technique": "cauchy_good", "k": "4", "m": "2", "packetsize": "8"},
    {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2", "w": "32"},
    {"plugin": "clay", "k": "4", "m": "2"},
    {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
])
def test_codecs_on_the_card_match_cpu(card, profile):
    from ceph_tpu_torch.ec import create

    obj = np.random.default_rng(1).integers(0, 256, 50_000, dtype=np.uint8)
    gpu, cpu = create(profile, device=card), create(profile, device="cpu")
    n = gpu.get_chunk_count()
    got, want = gpu.encode(set(range(n)), obj), cpu.encode(set(range(n)), obj)
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])
    lost = (0, n - 1)
    avail = {i: c for i, c in want.items() if i not in lost}
    dec = gpu.decode(set(lost), avail, len(want[0]))
    for i in lost:
        np.testing.assert_array_equal(dec[i], want[i])


# ---------------------------------------------------------------- K6 and recovery


def _w32_repair(missing=(0, 8)):
    """A w = 32 RS k=8 m=3 repair bitmatrix: its schedule has 935 buffers
    (global-memory path); with (1,) of k=6 m=3, a program whose slots fit
    a 32-thread block with one input stage."""
    from ceph_tpu_torch.ec import gf, gfw

    k, m = (8, 3) if missing == (0, 8) else (6, 3)
    bits = gfw.matrix_to_bitmatrix(gfw.vandermonde_matrix(k, m, 32), 32)
    gen = np.vstack([np.eye(k * 32, dtype=np.uint8), bits])
    rows = [s for s in range(k + m) if s not in missing][:k]
    sub = np.vstack([gen[r * 32:(r + 1) * 32] for r in rows])
    need = np.vstack([gen[s * 32:(s + 1) * 32] for s in missing])
    return gf.bitmatrix_multiply(need, gf.invert_bitmatrix(sub))


def _cauchy_repair():
    from ceph_tpu_torch.ec import gf

    bits = gf.matrix_to_bitmatrix(gf.cauchy_good_matrix(8, 3))
    gen = np.vstack([np.eye(64, dtype=np.uint8), bits])
    rows = [s for s in range(11) if s not in (0, 8)][:8]
    return gf.bitmatrix_multiply(np.vstack([gen[0:8], gen[64:72]]),
                                 gf.invert_bitmatrix(np.vstack([gen[r * 8:(r + 1) * 8]
                                                                for r in rows])))


def _bitplane_repair():
    from ceph_tpu_torch.ec import gf

    rs = np.vstack([np.eye(8, dtype=np.uint8), gf.vandermonde_matrix(8, 3)])
    rows = [s for s in range(11) if s not in (0, 8)][:8]
    return gf.matrix_to_bitmatrix(gf.matrix_encode(rs[[0, 8]], gf.invert_matrix(rs[rows])))


@pytest.mark.parametrize("case,nw", [("cauchy", 4099), ("cauchy", 128), ("w32_shared", 1000),
                                     ("w32_global", 777), ("cauchy", 0), ("cauchy", 100),
                                     ("cauchy", 1001), ("cauchy_sliced", 4096),
                                     ("cauchy", 132 * 256 * 3 + 5), ("bitplane", 5000),
                                     ("w32_global", 40_000)])
def test_schedule_apply_matches_plain(card, case, nw):
    """K6's paths: one input stage (the cauchy repair and the k=6 w = 32
    repair), two stages (the bit-plane RS repair), slots reused by
    liveness, the global path (k=8 w = 32); NW below one tile, not a
    multiple of 4 (4-byte copies), words 4 bytes past a 16-byte boundary
    (a sliced row), and many tiles per block."""
    from ceph_tpu_torch.ec import kernels, schedule

    if case.startswith("cauchy"):
        bm = _cauchy_repair()
    elif case == "bitplane":
        bm = _bitplane_repair()
    else:
        bm = _w32_repair((0, 8) if case == "w32_global" else (1,))
    sched = schedule.compile_schedule(bm)
    table = kernels.StepTable(sched.steps, sched.n_bufs, card, sched.n_in, sched.n_out)
    prog = table.program(sched.n_in, sched.n_out)
    config = kernels.schedule_config(prog)
    assert (config == (0, 0)) == (case == "w32_global")
    assert config[1] == {"bitplane": 2, "w32_global": 0}.get(case, 1)
    assert prog.n_work < sched.n_bufs - sched.n_in - sched.n_out  # slots reused
    rng = np.random.default_rng(nw)
    host = rng.integers(0, 2**32, sched.n_in * nw + 1, dtype=np.uint32).view(np.int32)
    words = torch.from_numpy(host).to(card)
    words = words[1:] if case == "cauchy_sliced" else words[:-1]
    words = words.view(sched.n_in, nw)
    assert (words.data_ptr() % 16 != 0) == (case == "cauchy_sliced")
    before = kernels.LAUNCHES["schedule_apply"]
    got = kernels.schedule_apply(table, words, sched.n_out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["schedule_apply"] == before + (nw > 0)
    assert torch.equal(got, kernels.schedule_apply_plain(table, words, sched.n_out))


@pytest.mark.parametrize("layout,p,size", [("packet", 2048, 2 * 8 * 2048), ("packet", 3, 8 * 3 * 41),
                                           ("packet", 5, 8 * 5 * 7), ("bitplane", 0, 131)])
def test_schedule_encoder_on_the_card_matches_cpu(card, layout, p, size):
    from ceph_tpu_torch.ec import gf, schedule

    bits = gf.matrix_to_bitmatrix(gf.vandermonde_matrix(8, 3)[:2])
    data = np.random.default_rng(size).integers(0, 256, (8, size), dtype=np.uint8)
    kw = dict(layout=layout, w=8, packetsize=p or 64)
    got = schedule.XorScheduleEncoder(bits, device=card, **kw).encode(data)
    want = schedule.XorScheduleEncoder(bits, device="cpu", **kw).encode(data)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("profile,mode", [
    ({"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2"}, "auto"),
    ({"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2"}, "on"),
    ({"plugin": "jerasure", "technique": "cauchy_good", "k": "4", "m": "2", "packetsize": "64"},
     "auto"),
    ({"plugin": "jerasure", "technique": "cauchy_good", "k": "4", "m": "2", "packetsize": "64"},
     "off"),
])
def test_recover_pool_on_the_card_matches_cpu(card, profile, mode):
    import copy

    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.ec import create, kernels
    from ceph_tpu_torch.models.clusters import build_osdmap

    cur = build_osdmap(64, pg_num=128, size=6, pool_kind="erasure")
    prev = copy.deepcopy(cur)
    rec.inject(cur, "rack:0:down_out")
    cfg = Config(env={})
    cfg.set("recovery_xor_schedule", mode)
    cpu_codec = create(profile, device="cpu")
    chunk = 2 * 8 * cpu_codec.codec.packetsize
    rng = np.random.default_rng(5)
    store = {}

    def read_shard(pg, s):
        if pg not in store:
            data = rng.integers(0, 256, (4, chunk), dtype=np.uint8)
            store[pg] = np.vstack([data, cpu_codec.codec.encode(data)])
        return store[pg][s]

    before = dict(kernels.LAUNCHES)
    peering, plan, got = rec.recover_pool(prev, cur, 1, create(profile, device=card), read_shard,
                                          config=cfg, device=card)
    want_peering = rec.peer_pool(prev, cur, 1, device="cpu")
    np.testing.assert_array_equal(peering.survivor_mask, want_peering.survivor_mask)
    np.testing.assert_array_equal(peering.flags, want_peering.flags)
    assert got.launches == plan.n_patterns > 0
    for g in plan.groups:
        for pg in g.pgs:
            for s in g.missing:
                np.testing.assert_array_equal(got.shards[int(pg)][s], store[int(pg)][s])
    bit_level = mode == "on" or "cauchy" in profile.get("technique", "")
    if bit_level and mode != "off":
        assert kernels.LAUNCHES["schedule_apply"] == before["schedule_apply"] + plan.n_patterns


@pytest.mark.parametrize("seed,shrunk", [(0, False), (1, False), (2, True)])
def test_device_scorer_on_the_card_matches_numpy(card, monkeypatch, seed, shrunk):
    """The upmap scorer's float64/int64 broadcasts on the card give the
    numpy scorer's candidate stream, gains bit for bit, order included."""
    from ceph_tpu_torch.balancer import upmap

    if shrunk:
        monkeypatch.setattr(upmap, "MAX_ROWS", 16)
        monkeypatch.setattr(upmap, "MAX_UNDER", 8)
    rng = np.random.default_rng(seed)
    n_osd = 300
    up = np.stack([rng.choice(n_osd, 3, replace=False) for _ in range(4000)]).astype(np.int32)
    up[rng.random(up.shape) < 0.05] = 0x7FFFFFFF
    deviation = rng.integers(-9, 10, n_osd) / 2.0 + rng.integers(0, 3, n_osd) / 3.0
    dom = rng.integers(-1, 40, n_osd).astype(np.int64)
    under = np.nonzero(deviation < 0)[0]
    args = (up, deviation, dom, under, 1.0, n_osd)
    want = upmap._score_candidate_moves_np(*args)
    got = upmap._score_candidate_moves_device(*args, card)
    assert len(want[0]) > 0
    assert np.array_equal(got[0].view(np.int64), want[0].view(np.int64))
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)


def test_calc_pg_upmaps_on_the_card_matches_cpu(card):
    from ceph_tpu_torch.balancer import calc_pg_upmaps, upmap
    from ceph_tpu_torch.models.clusters import build_skewed_osdmap

    plans, stats = [], []
    for dev, scorer in ((card, "device"), ("cpu", "numpy")):
        m = build_skewed_osdmap(256, pg_num=2048)
        before = straw2.LAUNCHES["descend"]
        inc = calc_pg_upmaps(m, max_entries=300, device=dev, scorer=scorer)
        plans.append(sorted((pg.ps, items) for pg, items in inc.new_pg_upmap_items.items()))
        stats.append(upmap.LAST_RUN_STATS)
        if dev is card:
            assert straw2.LAUNCHES["descend"] > before
    assert plans[0] == plans[1] and len(plans[0]) == 300
    assert stats[0].score_launches == stats[1].np_score_calls > 0


def _mixed_map():
    """straw2 root and racks over uniform hosts (4 x 4 x 4 OSDs), with a
    replicated and an EC rule."""
    from ceph_tpu_torch.crush.map import ALG_STRAW2, ALG_UNIFORM, CrushMap

    m = CrushMap()
    for tid, name in ((1, "root"), (2, "rack"), (3, "host")):
        m.add_type(tid, name)
    root = m.add_bucket("default", "root", alg=ALG_STRAW2)
    osd = 0
    for r in range(4):
        rack = m.add_bucket(f"rack{r}", "rack", alg=ALG_STRAW2)
        for h in range(4):
            host = m.add_bucket(f"host{r}_{h}", "host", alg=ALG_UNIFORM)
            for _ in range(4):
                m.insert_item(host.id, osd, 0x10000)
                osd += 1
            m.insert_item(rack.id, host.id, 4 * 0x10000)
        m.insert_item(root.id, rack.id, 16 * 0x10000)
    m.make_replicated_rule("replicated_rule", "default", "host")
    m.make_erasure_rule("ec", "default", "host")
    return m


@pytest.mark.parametrize("rule_name,rm", [("replicated_rule", 3), ("ec", 6)])
@pytest.mark.parametrize("kind", ["uniform", "mixed"])
def test_general_engine_on_the_card_matches_cpu(card, kind, rule_name, rm):
    """The general engine on the card (K1 on its straw2 levels) gives the
    CPU's placements and the C++ tier's."""
    from ceph_tpu_torch.crush import engine, interp
    from ceph_tpu_torch.crush.map import ALG_UNIFORM
    from ceph_tpu_torch.models.clusters import build_hierarchy
    from ceph_tpu_torch.testing import cppref

    if kind == "uniform":
        m = build_hierarchy([("rack", 4), ("host", 4)], 4, alg=ALG_UNIFORM)
        m.make_erasure_rule("ec", "default", "host")
    else:
        m = _mixed_map()
    dense, rule = m.to_dense(), m.rule_by_name(rule_name)
    assert engine.runner_signature(dense, rule, rm)[0] == "general"
    w = np.full(dense.max_devices, 0x10000, np.uint32)
    w[[3, 17, 40]] = 0
    w[9] = 0x8000
    xs = np.random.default_rng(1).integers(0, 2**32, 20_000, dtype=np.uint32)
    before = straw2.LAUNCHES["negdraw"]
    got = interp.batch_do_rule(interp.StaticCrushMap(dense, card), rule, xs, w, rm)
    assert (straw2.LAUNCHES["negdraw"] > before) == (kind == "mixed")
    want = interp.batch_do_rule(interp.StaticCrushMap(dense, "cpu"), rule, xs, w, rm)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    cres, clens = cppref.do_rule_batch(dense, [(s.op, s.arg1, s.arg2) for s in rule.steps],
                                       xs, w, rm)
    assert np.array_equal(got[0].cpu().numpy(), cres)
    assert np.array_equal(got[1].cpu().numpy(), clens)


@pytest.mark.parametrize("rule_name,rm", [("replicated_rule", 3), ("ec", 6)])
def test_compacted_retry_on_the_card_matches_masked_rounds(card, monkeypatch, rule_name, rm):
    """At the compaction threshold on a straw2 map: the general engine's
    compacted rounds on the card equal its masked rounds (the threshold
    raised above the batch) and the C++ tier, as the fast engine's
    masked rounds do in every mode."""
    from ceph_tpu_torch.crush import engine, interp
    from ceph_tpu_torch.models.clusters import build_skewed
    from ceph_tpu_torch.testing import cppref

    m = build_skewed(96, seed=1)
    m.make_erasure_rule("ec", "default", "host")
    dense, rule = m.to_dense(), m.rule_by_name(rule_name)
    w = np.full(dense.max_devices, 0x10000, np.uint32)
    w[[3, 7, 11, 40, 41]] = 0
    B = interp.COMPACT_MIN_BATCH
    xs = np.random.default_rng(2).integers(0, 2**32, B, dtype=np.uint32)
    cres, clens = cppref.do_rule_batch(dense, [(s.op, s.arg1, s.arg2) for s in rule.steps],
                                       xs, w, rm)
    for mode in interp_batch.MODES:
        res, lens = engine.run_batch(dense, rule, xs, w, rm, mode=mode, device=card)
        assert np.array_equal(res.cpu().numpy(), cres), mode
        assert np.array_equal(lens.cpu().numpy(), clens), mode
    smap = interp.StaticCrushMap(dense, card)
    for threshold in (B, B + 1):
        monkeypatch.setattr(interp, "COMPACT_MIN_BATCH", threshold)
        res, lens = interp.batch_do_rule(smap, rule, xs, w, rm)
        assert np.array_equal(res.cpu().numpy(), cres), threshold
        assert np.array_equal(lens.cpu().numpy(), clens), threshold


@pytest.mark.parametrize("rule_name,rm", [("replicated_rule", 3), ("ec", 6)])
def test_general_engine_compacted_retry_on_the_card(card, monkeypatch, rule_name, rm):
    """The general engine's compacted rounds on a mixed map on the card
    equal its masked rounds and the C++ tier at the compaction
    threshold."""
    from ceph_tpu_torch.crush import interp
    from ceph_tpu_torch.testing import cppref

    m = _mixed_map()
    dense, rule = m.to_dense(), m.rule_by_name(rule_name)
    w = np.full(dense.max_devices, 0x10000, np.uint32)
    w[[3, 17, 40]] = 0
    w[9] = 0x8000
    B = interp.COMPACT_MIN_BATCH
    xs = np.random.default_rng(3).integers(0, 2**32, B, dtype=np.uint32)
    cres, clens = cppref.do_rule_batch(dense, [(s.op, s.arg1, s.arg2) for s in rule.steps],
                                       xs, w, rm)
    smap = interp.StaticCrushMap(dense, card)
    for threshold in (B, B + 1):
        monkeypatch.setattr(interp, "COMPACT_MIN_BATCH", threshold)
        res, lens = interp.batch_do_rule(smap, rule, xs, w, rm)
        assert np.array_equal(res.cpu().numpy(), cres), threshold
        assert np.array_equal(lens.cpu().numpy(), clens), threshold


# chip_smoke.SCRUB_EDGES (L = 0 and below 16, about the scrub pass's and
# a decode-verify group's cuts, rows off a 16-byte boundary across
# segments, a 64 MiB row, more rows than one grid) and many rows of 64
K8_EDGES = chip_smoke.SCRUB_EDGES + [(70000, 64, 0)]


@pytest.mark.parametrize("n,length,offset", K8_EDGES)
def test_crc_rows_kernel_matches_plain_version(card, n, length, offset):
    from ceph_tpu_torch.recovery import scrub

    g = torch.Generator(device=card).manual_seed(n * 7919 + length)
    flat = torch.randint(0, 256, (n * length + offset,), generator=g, device=card,
                         dtype=torch.uint8)
    data = flat[offset:].view(n, length)
    before = scrub.LAUNCHES["crc32c_rows"]
    got = scrub.crc_rows(data)
    assert scrub.LAUNCHES["crc32c_rows"] == before + 1
    sample = data[: min(n, 64)]
    plain = chip_smoke.crc_rows_plain_long if length > chip_smoke.MIB else scrub.crc_rows_plain
    assert torch.equal(got[: sample.shape[0]], plain(sample))
    check = torch.tensor(list(b"123456789"), dtype=torch.uint8, device=card)[None, :]
    assert int(scrub.crc_rows(check)[0]) == 0xE3069283


def test_supervised_scrub_storm_on_the_card_matches_cpu(card):
    import copy

    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.ec import create
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.recovery.planner import _planning_codec

    profile = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2"}

    def run(dev):
        m = build_osdmap(64, pg_num=64, size=6, pool_kind="erasure")
        m_prev = copy.deepcopy(m)
        raw, _ = _planning_codec(create(profile, device="cpu"))
        rng = np.random.default_rng(3)
        store = {}
        for pg in range(64):
            data = rng.integers(0, 256, (4, 512), dtype=np.uint8)
            store[pg] = np.vstack([data, raw.encode(data)])
        chaos = rec.ChaosEngine(
            m, rec.build_scenario("scrub-storm", m, cycles=3), device=dev,
            corrupt=lambda pg, s, off, mask: rec.apply_bitrot(store[pg][s], off, mask))
        sup = rec.SupervisedRecovery(
            create(profile, device=dev), chaos, config=Config(env={}), seed=7, device=dev,
            scrubber=rec.Scrubber(64, 6, clock=chaos.clock.now, device=dev),
            write_shard=lambda pg, s, buf: store[pg].__setitem__(s, buf))
        return sup.run(m_prev, 1, lambda pg, s: store[pg][s]).summary(), store

    from ceph_tpu_torch.recovery import scrub

    before = scrub.LAUNCHES["crc32c_rows"]
    got, got_store = run(card)
    assert scrub.LAUNCHES["crc32c_rows"] > before
    want, want_store = run("cpu")
    assert got == want and got["converged"] and got["inconsistencies_found"] >= 8
    for pg in want_store:
        np.testing.assert_array_equal(got_store[pg], want_store[pg])


@pytest.mark.parametrize("k,size,min_size,pg_num,n_osds", [(4, 6, 5, 1000, 96),
                                                           (8, 11, 9, 8192, 1024)])
def test_traffic_step_on_the_card_matches_cpu(card, k, size, min_size, pg_num, n_osds):
    """The traffic step's torch ops on the card against the same call on
    the CPU: counts, histograms (``bucketize`` through ``frexp`` on both),
    ``written``, ``deg_read`` and ``max_rho`` equal; the float32 ``sums``
    within ``rtol=1e-5`` (two reduction orders over 65,536 ops)."""
    from ceph_tpu_torch.workload import traffic

    rng = np.random.default_rng(pg_num)
    mask = np.where(rng.random(pg_num) < 0.5, (1 << size) - 1,
                    rng.integers(0, 1 << size, pg_num)).astype(np.int64)
    host = (torch.from_numpy(mask), torch.from_numpy(rng.integers(0, size + 1, pg_num, dtype=np.int32)),
            torch.from_numpy(rng.integers(-1, n_osds, pg_num, dtype=np.int32)))
    bmask = (1 << max(pg_num - 1, 1).bit_length()) - 1
    scalars = (12345, pg_num, bmask, k, size, min_size, 250, 0.5, 6000.0 / 16, 0.125)
    step = traffic.traffic_step(1 << 16, n_osds)
    got = [t.cpu() for t in step(*(t.to(card) for t in host), *scalars)]
    want = step(*host, *scalars)
    for name, g, w in zip(("counts", "lat_hist", "qd_hist", "sums", "max_rho", "written",
                           "deg_read"), got, want):
        if name == "sums":
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name
    assert int(got[0].sum()) == 1 << 16 and int(got[1].sum()) > 0


@pytest.mark.parametrize("edge", ("random",) + online_edges.EDGES)
def test_stripe_absorb_kernel_matches_plain_version(card, edge):
    """K9 on the card against ``stripe_absorb_plain`` on the same card
    inputs, exact, each on its own clone of the buffer (both update it in
    place): a warm buffer (or a cold one for the cold edge) of 16 sets x
    4 ways, liberation k=4 w=7, 8 words a row."""
    from ceph_tpu_torch.ec import gfw, online

    sets, ways, k, w, words = 16, 4, 4, 7, 8
    buf = online.empty_stripe_buffer(sets, ways, k * w, 2 * w, words, device=card)
    enc = online.ParityDeltaEngine(gfw.liberation_bitmatrix(k, w), w=w,
                                   device=card).full_encoder()
    for i in range(2):
        warm = online_edges.random_batch(sets, ways, k, 128, 50 + i)
        buf, _ = online.stripe_buffer_step(buf, enc.table, enc.schedule.n_out, k, w,
                                           *online_edges.to_device(warm, card))
    edges = {n: (b, c) for n, b, c in online_edges.edge_batches(
        sets, ways, k, resident=online_edges.resident_key(buf.keys))}
    batch, cold = edges.get(edge, (online_edges.random_batch(sets, ways, k, 256, 9), False))
    if cold:
        buf = online.empty_stripe_buffer(sets, ways, k * w, 2 * w, words, device=card)
    lanes = online_edges.to_device(batch, card)

    def absorb(fn):
        b = buf.clone()
        return fn(b.keys, b.data, b.parity, b.dirty, b.lru, b.tick, *lanes, k, w)

    got = absorb(online.stripe_absorb)
    want = absorb(online.stripe_absorb_plain)
    for name, g, p in zip(("keys", "data", "parity", "dirty", "lru", "tick", "ddata",
                           "slot_of", "row"), got, want):
        assert g.dtype == p.dtype and torch.equal(g, p), name
    # the commit on the parity K9 left behind (its installs and full
    # writes zeroed), as the step runs them: each side its own clone
    dpar = online.schedule_apply(enc.table, want[6], enc.schedule.n_out)
    committed = {}
    for name, fn in (("kernel", online.stripe_commit), ("plain", online.stripe_commit_plain)):
        parity, totals, tick = got[2].clone(), buf.totals.clone(), buf.tick.clone()
        fn(parity, dpar, want[7], want[8], totals, tick, want[5])
        committed[name] = (parity, totals, tick)
    for g, p in zip(committed["kernel"], committed["plain"]):
        assert torch.equal(g, p)
    assert int(committed["kernel"][2]) == int(want[5])


def test_transfer_counter_counts_sync_warnings_on_the_card(card):
    """On the card the seam reads and the sync-debug warnings are both
    counted, and the sync-debug mode is put back."""
    from ceph_tpu_torch.analysis.runtime_guard import TransferCounter

    t = torch.arange(1024, device=card)
    with TransferCounter(sync_debug=True) as tc:
        t.sum().item()
        t.cpu()
    assert tc.host_transfers == 2 and tc.sync_warnings >= 2
    assert torch.cuda.get_sync_debug_mode() == 0


def test_launch_counter_sees_every_call_launch_on_the_card(card):
    """Each wrapper call on a CUDA tensor launches its kernel: the
    ``LAUNCHES`` delta equals the ``CALLS`` delta."""
    from ceph_tpu_torch.analysis.runtime_guard import LaunchCounter
    from ceph_tpu_torch.ec import gf_kernels
    from ceph_tpu_torch.recovery import scrub

    with LaunchCounter(check_launches=True) as lc:
        scrub.crc_rows(torch.zeros((4, 64), dtype=torch.uint8, device=card))
        gf_kernels.byte_lut(torch.zeros(64, dtype=torch.uint8, device=card),
                            torch.arange(256, device=card).to(torch.uint8))
    assert lc.calls == lc.launches == {"crc32c_rows": 1, "byte_lut": 1}


# ---------------------------------------------------------------- the fused pipeline's graph

PEER_FIELDS = ("up", "up_primary", "acting", "acting_primary", "prev_acting", "flags",
               "survivor_mask", "n_alive")


def _pipeline_maps(general: bool):
    """(prev, cur) port maps whose ladders retry (an EC pool with out
    OSDs); the general tier's form has uniform hosts."""
    import copy

    from ceph_tpu_torch.crush.map import ALG_UNIFORM
    from ceph_tpu_torch.models.clusters import build_osdmap

    m = build_osdmap(48, pg_num=256, size=6, pool_kind="erasure")
    if general:
        for b in m.crush.buckets.values():
            if m.crush.types[b.type_id] == "host":
                b.alg = ALG_UNIFORM
        m.crush._mutated()
    prev = copy.deepcopy(m)
    for o in (1, 6, 11, 30):
        m.osd_weight[o] = 0
    m.mark_down(17)
    return prev, m


def _pipeline_case(dev, general: bool, cache=None, maps=None):
    """(fused program, crush_arg, state_prev, state_cur, pgs, min_size) of
    :func:`_pipeline_maps` (or ``maps``) through ``cache`` (a new one by
    default)."""
    from ceph_tpu_torch.osdmap.mapping import build_pool_state
    from ceph_tpu_torch.recovery import pipeline

    prev, m = maps or _pipeline_maps(general)
    pool = m.pools[1]
    crush_arg, fn = pipeline.compile_fused_peering(
        m.crush.to_dense(), pool, m.crush.rules[pool.crush_rule],
        cache=pipeline.PipelineCache() if cache is None else cache, device=dev)
    sp = build_pool_state(prev, prev.pools[1], device=dev)
    sc = build_pool_state(m, pool, device=dev)
    return fn, crush_arg, sp, sc, torch.arange(pool.pg_num, device=dev), pool.min_size


@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
def test_pipeline_replay_equals_the_eager_program(card, general, monkeypatch):
    """The captured graph's replay equals the program run eagerly on the
    card and on the CPU, and a second replay with other inputs leaves
    the first result as it was.  The general tier's eager runs compact
    their ladders (a low threshold); its capture does not."""
    from ceph_tpu_torch.crush import interp

    monkeypatch.setattr(interp, "COMPACT_MIN_BATCH", 16)
    fn, crush_arg, sp, sc, pgs, min_size = _pipeline_case(card, general)
    eager = fn.program(crush_arg, sp, sc, pgs, min_size)
    first = fn(crush_arg, sp, sc, pgs, min_size)   # warm-up, capture, replay
    assert fn.captures == 1 and fn.graphs()[0].cond_nodes > 0
    for name, a, b in zip(PEER_FIELDS, first, eager):
        assert torch.equal(a, b), name
    kept = [t.clone() for t in first]
    again = fn(crush_arg, sc, sp, pgs, min_size)    # the epochs swapped: a replay
    assert fn.captures == 1 and fn.replays == 2
    want = fn.program(crush_arg, sc, sp, pgs, min_size)
    for name, a, b, k in zip(PEER_FIELDS, again, want, kept):
        assert torch.equal(a, b), name
    for name, a, k in zip(PEER_FIELDS, first, kept):
        assert torch.equal(a, k), name
    cpu = _pipeline_case(torch.device("cpu"), general)
    for name, a, b in zip(PEER_FIELDS, first, cpu[0](*cpu[1:])):
        assert torch.equal(a.cpu(), b), name


def test_pipeline_replay_makes_no_wrapper_call_and_no_read(card):
    """A replay makes no wrapper call and no read; its launches are
    counted, those its WHILE bodies ran too (more than the sure ones),
    and the capture's calls launched nothing."""
    from ceph_tpu_torch.analysis import runtime_guard

    fn, crush_arg, sp, sc, pgs, min_size = _pipeline_case(card, False)
    with runtime_guard.LaunchCounter(check_launches=True) as first:
        fn(crush_arg, sp, sc, pgs, min_size)
    graph = fn.graphs()[0]
    assert first.captured == graph.launches
    torch.cuda.synchronize()
    with runtime_guard.track(sync_debug=True, check_launches=True) as g:
        fn(crush_arg, sp, sc, pgs, min_size)
        torch.cuda.synchronize()
    lc = g.launch_counter
    assert lc.calls == {} and lc.captured == {}
    assert lc.launches == lc.replays and lc.launches["descend"] > graph.sure["descend"]
    assert g.host_transfers == 0 and g.n_compiles == 0
    assert g.transfer_counter.sync_warnings == 0


@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
def test_pipeline_replays_a_reweighted_map_with_its_own_tables(card, general):
    """A CRUSH reweight keeps the key: its program is the first map's
    graph, replayed with the reweighted tables copied in, and equals the
    reweighted map's eager program and staged pass bit for bit."""
    import copy

    from ceph_tpu_torch.crush.map import ALG_STRAW2
    from ceph_tpu_torch.recovery import pipeline
    from ceph_tpu_torch.recovery.peering import PeeringEngine

    cache = pipeline.PipelineCache()
    prev, m = _pipeline_maps(general)
    fn, arg_a, sp, sc, pgs, min_size = _pipeline_case(card, general, cache, (prev, m))
    first = fn(arg_a, sp, sc, pgs, min_size)
    heavy = copy.deepcopy(m)
    buckets = [b for b in heavy.crush.buckets.values()
               if b.alg == ALG_STRAW2 and len(b.items) > 1]
    for b in buckets[:4]:
        b.item_weights[0] = b.item_weights[0] // 2 + 1
    heavy.crush._mutated()
    fn_b, arg_b, _, sh, _, _ = _pipeline_case(card, general, cache, (prev, heavy))
    assert fn_b is fn and cache.stats()["hits"] == 1
    got = fn(arg_b, sp, sh, pgs, min_size)
    assert fn.captures == 1 and fn.replays == 2
    eager = fn.program(arg_b, sp, sh, pgs, min_size)
    staged = PeeringEngine(heavy, 1, device=card).run_staged(sp, sh)
    for name, a, b in zip(PEER_FIELDS, got, eager):
        assert torch.equal(a, b), name
        want = getattr(staged, name)
        assert np.array_equal(a.cpu().numpy().astype(np.int64), want.astype(np.int64)), name
    assert not all(torch.equal(a, b) for a, b in zip(first, got))  # the weights matter
    back = fn(arg_a, sp, sc, pgs, min_size)  # and the first map's tables come back
    for name, a, b in zip(PEER_FIELDS, back, first):
        assert torch.equal(a, b), name


def test_a_capture_with_a_host_read_raises(card):
    """A host read inside a capture raises (no eager fallback), and the
    card stays usable."""
    from ceph_tpu_torch.core import graphs

    x = torch.arange(8, device=card)
    with pytest.raises(graphs.HostReadInCapture):
        graphs.capture(lambda: bool((x + 1).any()), card)
    with pytest.raises(graphs.HostReadInCapture):
        graphs.capture(lambda: interp_batch._any(x > 3), card)
    assert int(x.sum()) == 28


class _Cycle:
    pass


def test_a_graph_left_in_a_cycle_is_not_freed_inside_another_capture(card):
    """A graph whose last reference is a reference cycle (a driver and its
    program) made garbage while another graph is captured, with the
    collector as eager as it gets: no collection runs inside the capture
    (freeing a graph there aborts the process), and the new graph replays."""
    import gc

    from ceph_tpu_torch.core import graphs

    x = torch.zeros(4, device=card)
    keep = {"old": graphs.capture(lambda: x.add_(100), card)}

    def program():
        c = _Cycle()
        c.me, c.graph = c, keep.pop("old")
        del c
        for _ in range(64):
            x.add_(1)
            [_Cycle() for _ in range(8)]

    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        g = graphs.capture(program, card)
    finally:
        gc.set_threshold(*threshold)
    gc.collect()  # the old graph freed here, outside any capture
    g.replay()
    torch.cuda.synchronize()
    assert x.tolist() == [64.0] * 4


# ---------------------------------------------------------------- the epoch superstep's graph


def _nested(dev, flag: bool, n: int):
    """A WHILE over ``n`` passes inside an IF on ``flag``, each pass an
    IF with an else and a SWITCH (one index past the last: no body):
    ``(acc, program)`` with ``program`` the code (a capture's, or run
    eagerly through the same helpers)."""
    from ceph_tpu_torch.core import graphs

    acc = torch.zeros(4, dtype=torch.int64, device=dev)
    i = torch.zeros((), dtype=torch.int64, device=dev)
    top = torch.tensor(n, device=dev)
    on = torch.tensor(flag, device=dev)

    def passes():
        i.zero_()

        def one():
            graphs.cond((i % 2) == 0, lambda: acc[0:1].add_(i), lambda: acc[1:2].add_(1))
            graphs.switch((i % 4).to(torch.int32), [lambda: acc[2:3].add_(1),
                                                      lambda: acc[3:4].add_(i),
                                                      lambda: acc[2:3].add_(10)])
            i.add_(1)

        graphs.loop(lambda: i < top, one)

    return acc, lambda: graphs.cond(on, passes)


@pytest.mark.parametrize("flag,n", [(True, 7), (False, 7), (True, 0)])
def test_nested_if_and_switch_inside_while_inside_if_give_the_eager_result(card, flag, n):
    from ceph_tpu_torch.core import graphs

    acc_e, eager = _nested(card, flag, n)
    eager()
    acc_g, program = _nested(card, flag, n)
    g = graphs.capture(program, card)
    assert g.cond_nodes == 4 and len(g.bodies) == 7
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(acc_g, acc_e)
    g.replay()  # the state is the buffers': a second replay adds as much again
    assert torch.equal(acc_g, 2 * acc_e)
    graphs.collect()
    g.release()


def _superstep_driver(dev, case: str, flight: bool = False):
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.recovery.failure import parse_spec

    m = build_osdmap(64, pg_num=128, size=6, pool_kind="erasure")
    cfg = Config(env={})
    cfg.set("flight_recorder", "on" if flight else "off")
    if case == "config7":
        tl = rec.ChaosTimeline([rec.ChaosEvent(0.1, (parse_spec("slow:5"),
                                                     parse_spec("slow:17")))])
    else:
        cfg.set("sparse_dirty_compaction", case)
        cfg.set("sparse_min_bucket", 4)
        tl = rec.build_scenario("flap", m)
    return rec.EpochDriver(m, tl, n_ops=64, config=cfg, device=dev)


@pytest.mark.parametrize("case,flight", [("config7", False), ("on", False), ("off", False),
                                         ("on", True)])
def test_superstep_graph_equals_the_eager_body_and_staged(card, case, flight):
    """The chunk's replay equals the body run eagerly on the card,
    ``run_staged`` and the CPU's host-decided superstep, every lane bit
    for bit; the compacted walk takes the same rungs; with the recorder
    on, the rings are equal."""
    from ceph_tpu_torch import recovery as rec

    d = _superstep_driver(card, case, flight)
    n = 40
    graph = d.run_superstep(n, snapshot_every=16)
    rungs, ring = list(d.rungs_taken), d.drain_flight()["rows"] if flight else None
    prog = rec.compile_epoch_superstep(d)
    assert prog.captures == 1 and prog.replays == 3 and prog.graph.cond_nodes >= 4
    eager = prog.run_eager(n, snapshot_every=16)
    assert graph.diff(eager) == [] and list(d.rungs_taken) == rungs
    if flight:
        assert np.array_equal(d.drain_flight()["rows"], ring)
    assert graph.diff(d.run_staged(n)) == []
    cpu = _superstep_driver(torch.device("cpu"), case, flight)
    assert graph.diff(cpu.run_superstep(n)) == [] and cpu.rungs_taken == rungs
    if case != "config7":
        assert graph.dirty.sum() > 0
    if case == "on":
        assert rungs and min(r for r in rungs if r >= 0) < len(d._dirty_ladder)


def test_superstep_second_chunk_of_another_length_replays(card):
    d = _superstep_driver(card, "on")
    d.run_superstep(16)
    prog = d.compile_superstep()
    assert prog.captures == 1
    short = d.run_superstep(7)
    long = d.run_superstep(40)  # past the graph's buffers: several replays
    assert prog.captures == 1 and prog.replays == 1 + 1 + 3
    assert short.diff(d.run_staged(7)) == [] and long.diff(d.run_staged(40)) == []


def test_superstep_replay_makes_no_call_no_read_and_no_sync_warning(card):
    from ceph_tpu_torch.analysis import runtime_guard

    d = _superstep_driver(card, "on")
    d.run_superstep(32, pull=False)
    torch.cuda.synchronize()
    with runtime_guard.track(sync_debug=True, check_launches=True) as g:
        state, rows = d.run_superstep(32, pull=False)
        torch.cuda.synchronize()
    lc = g.launch_counter
    assert lc.calls == {} and lc.captured == {} and g.n_compiles == 0
    assert g.host_transfers == 0 and g.transfer_counter.sync_warnings == 0
    assert lc.launches == lc.replays and lc.launches.get("descend", 0) > 0
    assert rec_series(rows).diff(d.run_staged(32)) == []


def rec_series(rows):
    from ceph_tpu_torch.recovery.superstep import EpochSeries

    return EpochSeries.from_device(rows)


def test_superstep_capture_with_a_host_read_in_the_body_raises(card, monkeypatch):
    """A host read in the epoch body stops the capture with an error: no
    chunk runs eagerly in its place."""
    from ceph_tpu_torch.core import graphs

    d = _superstep_driver(card, "config7")
    core = d._traffic_core

    def reads(state, salt, cap):
        bool(state.pg_hist.any())
        return core(state, salt, cap)

    monkeypatch.setattr(d, "_traffic_core", reads)
    with pytest.raises(graphs.HostReadInCapture):
        d.run_superstep(8)
    assert d.compile_superstep().graph is None


# ---------------------------------------------------------------- the write path's graph


def _writepath_driver(dev, flight: bool = False, compaction: str = "on"):
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.workload import WritepathDriver

    m = build_osdmap(64, pg_num=128, size=6, pool_kind="erasure")
    cfg = Config(env={})
    cfg.set("flight_recorder", "on" if flight else "off")
    cfg.set("sparse_dirty_compaction", compaction)
    cfg.set("sparse_min_bucket", 4)
    d = rec.EpochDriver(m, rec.build_scenario("flap", m), n_ops=64, config=cfg, device=dev)
    return WritepathDriver(d, n_sets=8, ways=2, max_writes=32, full_permille=250)


def _buffers_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in ("keys", "data", "parity", "dirty", "lru", "tick", "totals"))


@pytest.mark.parametrize("flight,compaction", [(False, "on"), (False, "off"), (True, "on")])
def test_writepath_graph_equals_the_eager_body_host_loop_and_staged(card, flight, compaction):
    """A chunk's replay (K3, K9, K6 and K9's commit inside the graph)
    equals the body run eagerly on the card, the host-decided loop,
    ``run_staged`` and the CPU's run, both series and the buffer bit for
    bit; with the recorder on, the rings too."""
    from ceph_tpu_torch.core import graphs

    w = _writepath_driver(card, flight, compaction)
    d = w.driver
    n = 24
    graph, wgraph = w.run_superstep(n, snapshot_every=8)
    buf = w.final_buf
    ring = d.drain_flight()["rows"] if flight else None
    prog = w.compile_writepath_flight() if flight else w.compile_writepath()
    assert prog.captures == 1 and prog.replays == 3 and prog.graph.cond_nodes >= 4
    graphs.collect()  # the bodies' launches, by their pass counters
    launched = prog.graph.launched
    assert all(launched.get(k, 0) > 0 for k in ("stripe_absorb", "schedule_apply",
                                                  "stripe_commit", "descend")), launched
    runs = {"eager": lambda: prog.run_eager(n, snapshot_every=8),
            "host": lambda: w._run_chunks(w._advance_host, d._init_flight, n, snapshot_every=8),
            "staged": lambda: w.run_staged(n)}
    for how, run in runs.items():
        s, ws = run()
        assert graph.diff(s) == [] and wgraph.diff(ws) == [], how
        assert _buffers_equal(buf, w.final_buf), how
        if flight and how != "staged":
            assert np.array_equal(d.drain_flight()["rows"], ring), how
    cpu = _writepath_driver(torch.device("cpu"), flight, compaction)
    s, ws = cpu.run_superstep(n, snapshot_every=8)
    assert graph.diff(s) == [] and wgraph.diff(ws) == [] and _buffers_equal(buf, cpu.final_buf)
    assert graph.dirty.sum() > 0 and wgraph.totals()["full_writes"] > 0


def test_writepath_one_capture_over_two_caps(card):
    """Caps 5 and 7 (one bucket) replay the graph the first run captured,
    each equal to the host-decided run at its cap."""
    w = _writepath_driver(card)
    d = w.driver
    prog = w.compile_writepath()
    for cap in (5, 7):
        s, ws = w.run_superstep(16, cap=cap)
        hs, hws = w._run_chunks(w._advance_host, None, 16, cap=cap)
        assert s.diff(hs) == [] and ws.diff(hws) == [], cap
        assert (ws.lane("delta_writes") + ws.lane("full_writes") <= cap).all()
    assert prog.captures == 1 and prog.replays == 2 and d.compile_superstep().graph is None


def test_writepath_replay_makes_no_call_no_read_and_no_sync_warning(card):
    from ceph_tpu_torch.analysis import runtime_guard

    w = _writepath_driver(card)
    w.run_superstep(16, pull=False)
    torch.cuda.synchronize()
    with runtime_guard.track(sync_debug=True, check_launches=True) as g:
        _state, _buf, rows, wrows = w.run_superstep(16, pull=False, cap=7)
        torch.cuda.synchronize()
    lc = g.launch_counter
    assert lc.calls == {} and lc.captured == {} and g.n_compiles == 0
    assert g.host_transfers == 0 and g.transfer_counter.sync_warnings == 0
    assert lc.launches == lc.replays
    assert all(lc.launches.get(k, 0) >= 16 for k in ("stripe_absorb", "schedule_apply",
                                                       "stripe_commit"))
    s, ws = w.run_staged(16, cap=7)
    assert rec_series(rows).diff(s) == [] and np.array_equal(wrows.cpu().numpy(), ws.lanes)


def test_writepath_capture_with_a_host_read_in_the_write_stage_raises(card, monkeypatch):
    """A host read in the write stage stops the capture with an error: no
    chunk runs eagerly in its place."""
    from ceph_tpu_torch.core import graphs

    w = _writepath_driver(card)
    batch = w._write_batch

    def reads(state, step, cap, **kw):
        bool(state.n_alive.any())
        return batch(state, step, cap, **kw)

    monkeypatch.setattr(w, "_write_batch", reads)
    with pytest.raises(graphs.HostReadInCapture):
        w.run_superstep(8)
    assert w.compile_writepath().graph is None


# ---------------------------------------------------------------- the fleet's window, the tape program


def _fleet_driver(dev, flight: bool = False):
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.models.clusters import build_osdmap

    m = build_osdmap(32, pg_num=16, size=6, pool_kind="erasure")
    cfg = Config(env={})
    cfg.set("flight_recorder", "on" if flight else "off")
    cfg.set("flight_ring_epochs", 16)
    return rec.FleetDriver(m, seed=7, n_ops=32, config=cfg, device=dev)


def _rings_equal(a, b) -> bool:
    return (a is None and b is None) or (torch.equal(a.ring.cpu(), b.ring.cpu())
                                         and int(a.head) == int(b.head))


@pytest.mark.parametrize("flight", [False, True])
def test_fleet_graph_equals_the_eager_body_host_loop_and_cpu(card, flight):
    """A fleet run's replay (K3 inside the dirty lanes' WHILE body)
    equals the body run eagerly on the card, the host-decided loop and
    the CPU's run: every lane, the final state and, with the recorder
    on, the per-lane ring."""
    from ceph_tpu_torch.core import graphs
    from ceph_tpu_torch.recovery.checkpoint import diff_states

    fd = _fleet_driver(card, flight)
    tls = fd.sample(3, "ssd-burst")
    n = 24
    graph = fd.run_fleet(n, tls)
    ring, state = fd.flight, fd.final_state
    prog = fd.compile_fleet()
    g = prog.graph
    assert prog.captures == 1 and prog.replays == 1 and g.cond_nodes >= 5
    assert fd.stats["path"] == "graph"
    graphs.collect()  # the bodies' launches, by their pass counters
    assert g.launched.get("descend", 0) > 0 and graph.dirty.sum() > 0
    counts = prog.peer_counts()
    for how in ("eager", "host"):
        s = fd.run_fleet(n, tls, path=how)
        assert fd.stats["path"] == how
        assert all(graph.cluster(k).diff(s.cluster(k)) == [] for k in range(3)), how
        assert diff_states(state, fd.final_state) == [] and _rings_equal(ring, fd.flight), how
    # the graph's memo peered and reused as the host loop's did
    assert counts == {k: fd.stats[k] for k in counts} and counts["peer_reused"] > 0
    cpu = _fleet_driver(torch.device("cpu"), flight)
    s = cpu.run_fleet(n, tls)
    assert all(graph.cluster(k).diff(s.cluster(k)) == [] for k in range(3))
    assert diff_states(state, cpu.final_state) == [] and _rings_equal(ring, cpu.flight)


def test_fleet_second_fleet_in_the_bucket_replays_without_a_capture(card):
    """3 lanes, then 4 other ones in the same pad bucket: the second run
    replays the first's graph with no wrapper call, read or sync warning,
    and equals the host-decided loop."""
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.analysis import runtime_guard

    fd = _fleet_driver(card)
    fd.run_fleet(8, fd.sample(3, "ssd-burst"), pull=False)
    tls = fd.sample(4, "ssd-burst")
    torch.cuda.synchronize()
    with runtime_guard.track(sync_debug=True, check_launches=True) as g:
        _state, rows = fd.run_fleet(8, tls, pull=False)
        torch.cuda.synchronize()
    lc = g.launch_counter
    assert lc.calls == {} and lc.captured == {} and g.n_compiles == 0
    assert g.host_transfers == 0 and g.transfer_counter.sync_warnings == 0
    assert lc.launches == lc.replays
    prog = fd.compile_fleet()
    assert prog.captures == 1 and prog.replays == 2
    got = rec.FleetSeries.from_device(rows, 4)
    want = fd.run_fleet(8, tls, path="host")
    assert all(got.cluster(k).diff(want.cluster(k)) == [] for k in range(4))


def test_tape_program_second_tape_in_the_bucket_replays_without_a_capture(card):
    """``run_sequential`` through the tape program: two tapes of one row
    bucket share one capture, equal to the body run eagerly and to the
    host-decided sequential loop; a third tape's run reads nothing."""
    from ceph_tpu_torch.analysis import runtime_guard

    fd = _fleet_driver(card)
    tls = fd.sample(3, "flap")
    args = fd._sequential_args(tls)
    seq = fd.run_sequential(16, tls[:2], rows_pad=args[2])
    prog = fd.driver.compile_tape_program()
    assert prog.captures == 1 and prog.replays == 2 and prog.rows_pad == args[2]
    eager = fd.run_sequential(16, tls[:2], rows_pad=args[2], path="eager")
    host = fd.run_sequential(16, tls[:2], rows_pad=args[2], path="host")
    for k in range(2):
        assert seq[k].diff(eager[k]) == [] and seq[k].diff(host[k]) == [], k
    torch.cuda.synchronize()
    with runtime_guard.track(sync_debug=True, check_launches=True) as g:
        prog.load(args[0][2], 11)
        _state, _fs, rows = prog.advance(fd.driver._init_state, fd.driver._init_host.copy(),
                                         0, 16)
        torch.cuda.synchronize()
    lc = g.launch_counter
    assert lc.calls == {} and g.host_transfers == 0 and g.transfer_counter.sync_warnings == 0
    assert lc.launches == lc.replays and prog.captures == 1
