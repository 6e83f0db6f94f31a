"""The port's scrub (K8's plain version, the Scrubber, decode-verify) vs
the reference package's.

Rows and stores are made from seeds with numpy.  CRCs are integers and
every comparison is exact: the check value ``crc32c("123456789") ==
0xE3069283``; ``crc_rows_plain`` against the reference's host
``crc32c_rows`` at L = 0, 1, 3, 17 and 4097, and its device loop
``_crc_rows`` at the same L but 0 (it raises on an empty row: R7 in
ROADMAP §3); the port's ``scrub_step`` against the reference's on
damaged stacks; ``Scrubber.scrub`` after bit rot (whole-pool and
staggered passes) giving the same mask, histogram and count;
``DecodeVerifier.bad_pgs`` naming the same PGs on damaged decode
output; and a miscompiled XOR schedule caught, quarantined once and
re-derived dense, as in the reference.  Everything runs on the CPU
(``device="cpu"``), where K8's wrapper takes its plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.ec import gf as ref_gf, gfw as ref_gfw
from ceph_tpu.ec.backend import (BitmatrixCodec as RefBitmatrixCodec,
                                 MatrixCodec as RefMatrixCodec)
from ceph_tpu.recovery import build_plan as ref_build_plan, scrub as ref_scrub
from ceph_tpu.recovery.peering import PeeringResult as RefPeeringResult
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.crush.map import ITEM_NONE
from ceph_tpu_torch.ec import gf, gfw
from ceph_tpu_torch.ec.backend import BitmatrixCodec, MatrixCodec
from ceph_tpu_torch.ec.kernels import StepTable
from ceph_tpu_torch.ec.schedule import XorScheduleEncoder
from ceph_tpu_torch.obs import EventJournal
from ceph_tpu_torch.recovery import (PG_STATE_CLEAN, PG_STATE_DEGRADED, PeeringResult,
                                     RecoveryExecutor, build_plan, scrub)
from ceph_tpu_torch.recovery.executor import RecoveryResult

LENGTHS = [0, 1, 3, 17, 4097]


def _rows(n, length, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, length), dtype=np.uint8)


def test_check_value():
    data = torch.tensor(list(b"123456789"), dtype=torch.uint8)[None, :]
    assert int(scrub.crc_rows_plain(data)[0]) == 0xE3069283
    assert int(scrub.crc_rows(data)[0]) == 0xE3069283
    assert scrub.crc32c(b"123456789") == 0xE3069283
    np.testing.assert_array_equal(scrub.crc32c_table(), ref_scrub.crc32c_table())


@pytest.mark.parametrize("length", LENGTHS)
def test_crc_rows_plain_matches_reference(length):
    rows = _rows(9, length, seed=length)
    got = scrub.crc_rows(torch.from_numpy(rows))
    assert got.dtype == torch.int64 and got.shape == (9,)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref_scrub.crc32c_rows(rows))
    if length:  # the reference's loop cannot trace an empty row (R7)
        dev = np.asarray(ref_scrub._crc_rows(jnp.asarray(rows),
                                             jnp.asarray(ref_scrub.crc32c_table())))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), dev)
    assert scrub.LAUNCHES["crc32c_rows"] == 0  # the CPU never launches K8


def test_crc_rows_rejects_bad_input():
    with pytest.raises(ValueError):
        scrub.crc_rows(torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        scrub.crc_rows(torch.zeros((2, 4), dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scrub_step_matches_reference(seed):
    n_pgs, n_shards, chunk = 12, 6, 40
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (n_pgs, n_shards, chunk), dtype=np.uint8)
    expected = ref_scrub.crc32c_rows(data.reshape(-1, chunk)).reshape(n_pgs, n_shards)
    for _ in range(7):
        data[rng.integers(n_pgs), rng.integers(n_shards), rng.integers(chunk)] ^= 0x5A
    bad_mask, hist, n_bad = scrub.scrub_step(torch.from_numpy(data),
                                             torch.from_numpy(expected.astype(np.int64)))
    r_mask, r_hist, r_n = ref_scrub.scrub_step()(data, expected, ref_scrub.crc32c_table())
    np.testing.assert_array_equal(bad_mask.numpy().astype(np.uint32), np.asarray(r_mask))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(r_hist))
    assert int(n_bad) == int(r_n) > 0


def _flat_store(n_pgs, n_shards, chunk, seed=0):
    rng = np.random.default_rng(seed)
    return {(pg, s): rng.integers(0, 256, chunk, dtype=np.uint8)
            for pg in range(n_pgs) for s in range(n_shards)}


def _rot(store, events):
    for (pg, s), off, mask in events:
        scrub.apply_bitrot(store[(pg, s)], off, mask)


@pytest.mark.parametrize("staggered", [False, True], ids=["whole", "staggered"])
def test_scrubber_matches_reference(staggered):
    n_pgs, n_shards, chunk = 32, 6, 48
    stores = [_flat_store(n_pgs, n_shards, chunk) for _ in range(2)]
    scrubbers = [scrub.Scrubber(n_pgs, n_shards, device="cpu"),
                 ref_scrub.Scrubber(n_pgs, n_shards)]
    for sc, st in zip(scrubbers, stores):
        sc.build_checksums(lambda pg, s, st=st: st[(pg, s)])
    np.testing.assert_array_equal(scrubbers[0].checksums, scrubbers[1].checksums)
    rng = np.random.default_rng(5)
    for t in (0.0, 0.3, 0.55, 0.9, 1.2, 2.5):
        events = [((int(rng.integers(n_pgs)), int(rng.integers(n_shards))),
                   int(rng.integers(1000)), int(rng.integers(1, 256))) for _ in range(3)]
        results = []
        for sc, st in zip(scrubbers, stores):
            _rot(st, events)
            kw = {"now": t, "period_s": 1.0} if staggered else {}
            results.append(sc.scrub(lambda pg, s, st=st: st[(pg, s)], **kw))
        got, want = results
        np.testing.assert_array_equal(got.inconsistent_mask, want.inconsistent_mask)
        assert got.inconsistent_mask.dtype == np.uint32
        np.testing.assert_array_equal(got.hist, np.asarray(want.hist))
        assert (got.n_inconsistent, got.scrubbed_bytes) == (want.n_inconsistent,
                                                            want.scrubbed_bytes)
        if staggered:
            np.testing.assert_array_equal(got.due, want.due)
        else:
            assert got.due is None and want.due is None
    assert got.n_inconsistent > 0
    # the read-path check and checksum-at-write agree too
    for pg in range(n_pgs):
        reads = [sc.verify_read(pg, lambda p, s, st=st: st[(p, s)], mask=0b101101)
                 for sc, st in zip(scrubbers, stores)]
        assert reads[0] == reads[1]
    for sc, st in zip(scrubbers, stores):
        sc.note_write(3, lambda p, s, st=st: st[(p, s)])
    np.testing.assert_array_equal(scrubbers[0].checksums, scrubbers[1].checksums)


def test_scrubber_rejects_a_mesh_and_needs_checksums():
    """The mesh seam (once refused) on a world of one equals the
    single-device scrubber and the reference's ``make_mesh(1)`` scrub
    (gloo worlds of 2 and 4: tests/test_torch_mesh_paths.py); a scrub
    still needs its checksums first."""
    from ceph_tpu.parallel.placement import make_mesh as ref_make_mesh
    from ceph_tpu.recovery.scrub import Scrubber as RefScrubber
    from ceph_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(11)
    clean = rng.integers(0, 256, (5, 3, 32), dtype=np.uint8)
    rot = clean.copy()
    rot[1, 2, 4] ^= 1
    rot[4, 0, 31] ^= 0x80
    got = []
    for sc in (scrub.Scrubber(5, 3, mesh=make_mesh(axis="pgs", device="cpu")),
               scrub.Scrubber(5, 3, device="cpu"), RefScrubber(5, 3, mesh=ref_make_mesh(1))):
        sc.build_checksums(lambda pg, s: clean[pg, s])
        r = sc.scrub(lambda pg, s: rot[pg, s])
        got.append((r.inconsistent_mask.tolist(), np.asarray(r.hist).tolist(),
                    r.n_inconsistent, np.asarray(sc.checksums).tolist()))
    assert got[0] == got[1] == got[2] and got[0][2] == 2
    with pytest.raises(RuntimeError):
        scrub.Scrubber(4, 2, device="cpu").scrub(lambda pg, s: np.zeros(4, np.uint8))


def _degraded(result_cls, masks, size, k, pool_id=1):
    """One degraded PG per survivor mask."""
    prev = np.arange(len(masks) * size, dtype=np.int32).reshape(-1, size)
    acting = prev.copy()
    flags = np.full(len(masks), PG_STATE_CLEAN, np.int32)
    mask_arr = np.full(len(masks), (1 << size) - 1, np.uint32)
    for i, mask in enumerate(masks):
        for s in range(size):
            if not (mask >> s) & 1:
                acting[i, s] = ITEM_NONE
        flags[i] = PG_STATE_DEGRADED
        mask_arr[i] = mask
    return result_cls(
        pool_id=pool_id, epoch_prev=1, epoch_cur=2, size=size, min_size=k,
        up=acting.copy(), up_primary=acting[:, 0].copy(), acting=acting,
        acting_primary=acting[:, 0].copy(), prev_acting=prev, flags=flags,
        survivor_mask=mask_arr, n_alive=(acting != ITEM_NONE).sum(axis=1).astype(np.int32))


def _matrix_fixture(masks, chunk=64, k=4, m_par=2, seed=1):
    size = k + m_par
    codec = MatrixCodec(gf.vandermonde_matrix(k, m_par), device="cpu")
    ref_codec = RefMatrixCodec(ref_gf.vandermonde_matrix(k, m_par))
    plans = (build_plan(_degraded(PeeringResult, masks, size, k), codec),
             ref_build_plan(_degraded(RefPeeringResult, masks, size, k), ref_codec))
    rng = np.random.default_rng(seed)
    store = {}
    for pg in range(len(masks)):
        data = rng.integers(0, 256, (k, chunk), dtype=np.uint8)
        store[pg] = np.vstack([data, ref_codec.encode(data)])
    checks = ref_scrub.crc32c_rows(np.stack([store[pg] for pg in range(len(masks))])
                                   .reshape(-1, chunk)).reshape(len(masks), size)
    return (codec, ref_codec), plans, store, checks, chunk


@pytest.mark.parametrize("with_codec", [True, False], ids=["parity", "crc_only"])
def test_decode_verifier_matches_reference(with_codec):
    (codec, ref_codec), (plan, ref_plan), store, checks, chunk = _matrix_fixture(
        [0b111100, 0b110011, 0b011110, 0b101101])
    ver = scrub.DecodeVerifier(checks, codec=codec if with_codec else None, device="cpu")
    ref_ver = ref_scrub.DecodeVerifier(checks, codec=ref_codec if with_codec else None)
    read = lambda pg, s: store[pg][s]  # noqa: E731
    rng = np.random.default_rng(9)
    for g, rg in zip(plan.groups, ref_plan.groups):
        assert (g.mask, list(g.missing)) == (rg.mask, list(rg.missing))
        out = np.stack([np.concatenate([store[int(pg)][s] for pg in g.pgs]) for s in g.missing])
        for trial in range(4):
            bad = out.copy()
            if trial:
                bad[rng.integers(len(g.missing)), rng.integers(bad.shape[1])] ^= 0x10
            got = ver.bad_pgs(g, bad, chunk, read_shard=read)
            assert got == ref_ver.bad_pgs(rg, bad, chunk, read_shard=read)
            assert bool(got) == bool(trial)


def test_decode_verifier_parity_recheck_matches_reference():
    """A blessed (corrupted) checksum table passes the CRC; the parity
    re-encode still catches the tampered row, in both packages."""
    (codec, ref_codec), (plan, ref_plan), store, checks, chunk = _matrix_fixture([0b011110])
    (g,), (rg,) = plan.groups, ref_plan.groups
    out = np.stack([np.concatenate([store[int(pg)][s] for pg in g.pgs]) for s in g.missing])
    out[1, 5] ^= 0x20
    checks = checks.copy()
    checks[0, 5] = scrub.crc32c(out[1])
    read = lambda pg, s: store[pg][s]  # noqa: E731
    got = scrub.DecodeVerifier(checks, codec=codec, device="cpu").bad_pgs(
        g, out, chunk, read_shard=read)
    assert got == ref_scrub.DecodeVerifier(checks, codec=ref_codec).bad_pgs(
        rg, out, chunk, read_shard=read) == {0}


def test_miscompiled_schedule_quarantined_then_dense():
    """A deliberately miscompiled XOR schedule (one bogus step) is caught
    by decode-verify, its pattern quarantined and journaled once, and
    the decode re-derived through the dense bitmatrix engine: the same
    outcome as the reference's test of the same name."""
    k, w, packetsize = 4, 7, 8
    size, chunk = k + 2, 2 * w * packetsize
    codec = BitmatrixCodec(gfw.liberation_bitmatrix(k, w), w, packetsize, device="cpu")
    ref_codec = RefBitmatrixCodec(ref_gfw.liberation_bitmatrix(k, w), w, packetsize)
    masks = [0b011110, 0b111100]
    plan = build_plan(_degraded(PeeringResult, masks, size, k, pool_id=2), codec)
    rng = np.random.default_rng(1)
    store = {}
    for pg in range(len(masks)):
        data = rng.integers(0, 256, (k, chunk), dtype=np.uint8)
        store[pg] = np.vstack([data, ref_codec.encoder.encode(data)])
    checks = ref_scrub.crc32c_rows(np.stack([store[pg] for pg in range(len(masks))])
                                   .reshape(-1, chunk)).reshape(len(masks), size)
    cfg = Config(env={})
    ex = RecoveryExecutor(codec, config=cfg, device="cpu")
    ex.verifier = scrub.DecodeVerifier(checks, codec=codec, device="cpu")
    for g in plan.groups:
        enc = XorScheduleEncoder(g.repair_bitmatrix, layout="packet", w=g.w,
                                 packetsize=g.packetsize, device="cpu")
        sched = enc.schedule
        bogus = np.vstack([sched.steps, [[sched.n_in, 0]]]).astype(np.int32)
        enc.table = StepTable(bogus, sched.n_bufs, enc.device, sched.n_in, sched.n_out)
        ex._schedules.get(("packet", g.mask), lambda enc=enc: enc)
    journal = EventJournal()
    read = lambda pg, s: store[pg][s]  # noqa: E731
    inner = RecoveryResult(shards={})
    for g in plan.groups:
        fl = ex._dispatch_group(g, read, inner)
        assert fl.engine == "schedule"
        out, got_chunk = ex._finalize_group(fl, inner)
        ok, bad = ex._verified_commit(g, out, got_chunk, fl.engine, inner, read,
                                      jevent=journal.event)
        assert ok == {int(p) for p in g.pgs} and not bad
    assert inner.verify_retries == len(plan.groups)
    assert [r["attrs"]["mask"] for r in journal.by_name("scrub.schedule_quarantined")] == [
        g.mask for g in plan.groups]
    for pg, shards in inner.shards.items():
        for s, got in shards.items():
            np.testing.assert_array_equal(got, store[pg][s])
    # the quarantine is sticky: a fresh run goes straight to the dense engine
    res = ex.run(plan, read)
    assert res.schedule_launches == 0 and res.verify_retries == 0
    for pg, shards in res.shards.items():
        for s, got in shards.items():
            np.testing.assert_array_equal(got, store[pg][s])
