"""The port's resident ClusterState vs the reference package's.

The map is built in the reference package (``build_osdmap(32,
pg_num=16, size=6, erasure)``) and carried across as ``encode()`` bytes;
the same Incrementals go through the reference's ``apply_incremental``
and the port's on the CPU (``device="cpu"``), and through each
package's host ``OSDMap.apply_incremental`` + ``build_pool_state``.

Equal, exactly: every lane of ``ClusterState.from_osdmap`` (the
survivor mask and checksums as u32 values, carried in int64 by the
port), the four pool lanes the scatter writes and the map epoch after
each delta, the pad widths and sentinels of ``incremental_arrays``,
the refusals of structural deltas and of bad reporter pools, and a
fleet (``stack_states``, ``index_state``, ``apply_incremental_fleet``)
against applying each member's delta in turn.
"""

import copy

import numpy as np
import pytest
import torch

from ceph_tpu.core import cluster_state as ref_cs
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.osdmap.map import Incremental as RefIncremental
from ceph_tpu_torch import convert
from ceph_tpu_torch.core import cluster_state as cs
from ceph_tpu_torch.osdmap.map import EXISTS, UP, Incremental, PGId
from ceph_tpu_torch.osdmap.mapping import build_pool_state

POOL_LANES = ("osd_up", "osd_exists", "osd_weight", "primary_affinity")


def _maps():
    ref = ref_build_osdmap(32, pg_num=16, size=6, pool_kind="erasure")
    return ref, convert.osdmap_from_reference(ref.encode())


def _both(**fields):
    return RefIncremental(**fields), Incremental(**fields)


def _lanes(state) -> dict:
    return {name: np.asarray(getattr(state.pool, name)) for name in POOL_LANES}


def _assert_pool_equal(got: dict, want: dict):
    for lane in POOL_LANES:
        np.testing.assert_array_equal(got[lane].astype(np.int64),
                                      np.asarray(want[lane]).astype(np.int64), err_msg=lane)


def _assert_matches_host(m, state):
    host = build_pool_state(m, m.pools[min(m.pools)], device="cpu")
    _assert_pool_equal(_lanes(state), {n: getattr(host, n).numpy() for n in POOL_LANES})
    assert int(state.epoch) == m.epoch


def test_from_osdmap_matches_reference():
    ref_m, m = _maps()
    rep = np.arange(32, dtype=np.int32) % 5
    ck = np.random.default_rng(0).integers(0, 2**32, (16, 6), dtype=np.uint64).astype(np.uint32)
    ref = ref_cs.ClusterState.from_osdmap(ref_m, now=1.25, reporters=rep, checksums=ck)
    port = cs.ClusterState.from_osdmap(m, now=1.25, reporters=rep, checksums=ck, device="cpu")
    _assert_pool_equal(_lanes(port), {n: getattr(ref.pool, n) for n in POOL_LANES})
    for name in ("last_ack", "laggy", "markdowns", "down", "down_since", "suppressed",
                 "slow", "out", "reporters", "up", "up_primary", "acting",
                 "acting_primary", "flags", "survivor_mask", "n_alive", "pg_hist",
                 "pg_aux", "checksums", "epoch", "now", "last_tick", "tape_cursor", "step"):
        want, got = np.asarray(getattr(ref, name)), getattr(port, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.astype(np.float64), want.astype(np.float64),
                                      err_msg=name)
    assert port.now.dtype == torch.float64 and port.last_ack.dtype == torch.float32
    assert port.epoch.dtype == torch.int32 and port.up.dtype == torch.int32
    assert (port.n_osds, port.pg_num) == (ref.n_osds, ref.pg_num) == (32, 16)


def test_apply_incremental_matches_host_rebuild_and_reference():
    ref_m, m = _maps()
    ref = ref_cs.ClusterState.from_osdmap(ref_m)
    port = cs.ClusterState.from_osdmap(m, device="cpu")
    first = port
    before = {n: t.clone() for n, t in vars(port.pool).items()}
    # the hot-loop delta mix chaos emits: downs, a reweight, an out, an
    # affinity change; then a delta reversing part of it (up via xor)
    for fields in (
        dict(new_state={3: UP, 7: UP}, new_weight={5: 0x8000, 9: 0},
             new_primary_affinity={2: 0x8000}),
        dict(new_state={3: UP}, new_weight={5: 0x10000}),
    ):
        ref_inc, inc = _both(epoch=m.epoch + 1, **fields)
        ref = ref_cs.apply_incremental(ref, ref_inc)
        port = cs.apply_incremental(port, inc)
        ref_m.apply_incremental(ref_inc)
        m.apply_incremental(inc)
        _assert_matches_host(m, port)
        _assert_pool_equal(_lanes(port), {n: getattr(ref.pool, n) for n in POOL_LANES})
        assert int(port.epoch) == int(ref.epoch)
    # the scatter built new tensors: the first state is untouched
    for n, t in before.items():
        assert torch.equal(t, getattr(first.pool, n)), n


def test_apply_incremental_exists_flip_forces_up_false():
    ref_m, m = _maps()
    ref_inc, inc = _both(epoch=m.epoch + 1, new_state={4: EXISTS | UP})
    port = cs.apply_incremental(cs.ClusterState.from_osdmap(m, device="cpu"), inc)
    ref = ref_cs.apply_incremental(ref_cs.ClusterState.from_osdmap(ref_m), ref_inc)
    m.apply_incremental(inc)
    _assert_matches_host(m, port)
    _assert_pool_equal(_lanes(port), {n: getattr(ref.pool, n) for n in POOL_LANES})
    assert not bool(port.pool.osd_up[4]) and not bool(port.pool.osd_exists[4])


def test_structural_incrementals_are_rejected():
    _ref_m, m = _maps()
    state = cs.ClusterState.from_osdmap(m, device="cpu")
    with pytest.raises(ValueError, match="new_max_osd"):
        cs.apply_incremental(state, Incremental(epoch=m.epoch + 1, new_max_osd=64))
    with pytest.raises(ValueError, match="structural"):
        cs.apply_incremental(
            state, Incremental(epoch=m.epoch + 1, new_pg_temp={PGId(1, 0): (1, 2, 3)}))


def test_pad_widths_are_powers_of_two_within_a_bucket():
    assert [cs._pad_to(n) for n in (0, 1, 2, 3, 4, 5, 8, 9)] == [1, 1, 2, 4, 4, 8, 8, 16]
    assert [cs._pad_to(n) for n in range(40)] == [ref_cs._pad_to(n) for n in range(40)]
    # deltas of 3 and 4 rows share the bucket: one shape for both
    arrs3 = cs.incremental_arrays(Incremental(epoch=2, new_state={1: UP, 2: UP, 3: UP}), 32,
                                  device="cpu")
    arrs4 = cs.incremental_arrays(
        Incremental(epoch=2, new_state={1: UP, 2: UP, 3: UP, 4: UP}), 32, device="cpu")
    assert [a.shape for a in arrs3] == [a.shape for a in arrs4] == [(4,)] * 3 + [(1,)] * 4
    ref3 = ref_cs.incremental_arrays(
        RefIncremental(epoch=2, new_state={1: UP, 2: UP, 3: UP}), 32)
    for got, want in zip(arrs3, ref3):
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))
    # pad rows carry the out-of-range index the scatter drops
    assert int(arrs3[0][3]) == 32
    # forced pads (the fleet's shared shape), and a delta past them
    forced = cs.incremental_arrays(Incremental(epoch=2, new_weight={1: 0}), 32, pads=(2, 8, 4),
                                   device="cpu")
    assert [a.shape[0] for a in forced] == [2, 2, 2, 8, 8, 4, 4]
    with pytest.raises(ValueError, match="exceeds forced pad"):
        cs.incremental_arrays(Incremental(epoch=2, new_state={1: UP, 2: UP}), 32,
                              pads=(1, 1, 1), device="cpu")
    # an all-pad delta changes nothing
    _ref_m, m = _maps()
    state = cs.ClusterState.from_osdmap(m, device="cpu")
    same = cs.apply_incremental(state, Incremental(epoch=m.epoch + 1))
    for n in POOL_LANES:
        assert torch.equal(getattr(same.pool, n), getattr(state.pool, n)), n
    with pytest.raises(ValueError, match="not powers of two"):
        cs._check_bucketed("widths", 4, 6)


def test_from_osdmap_reporter_validation():
    _ref_m, m = _maps()
    with pytest.raises(ValueError, match="reporters shape"):
        cs.ClusterState.from_osdmap(m, reporters=np.zeros(7, np.int32), device="cpu")
    st = cs.ClusterState.from_osdmap(m, reporters=np.full(32, 3, np.int32), device="cpu")
    assert (st.reporters.numpy() == 3).all()
    assert st.n_osds == 32 and st.pg_num == 16


def _fleet_deltas(m):
    """One delta a member (the last an empty pad delta), of different
    sizes so the shared pad triple is the largest's bucket."""
    e = m.epoch + 1
    return [
        dict(epoch=e, new_state={1: UP}, new_weight={4: 0}),
        dict(epoch=e, new_state={2: UP, 3: UP, 9: EXISTS | UP},
             new_primary_affinity={5: 0x4000, 6: 0}),
        dict(epoch=e, new_weight={7: 0x8000, 8: 0, 10: 0x2000}),
        dict(epoch=e),
    ]


def test_fleet_matches_each_cluster_in_turn():
    ref_m, m = _maps()
    rng = np.random.default_rng(3)
    members = [cs.ClusterState.from_osdmap(
        m, now=float(i), reporters=rng.integers(0, 9, 32).astype(np.int32), device="cpu")
        for i in range(4)]
    fleet = cs.stack_states(members)
    assert fleet.pool.osd_up.shape == (4, 32) and fleet.now.shape == (4,)
    assert fleet.n_osds == 32 and fleet.pg_num == 16
    for i, s in enumerate(members):
        back = cs.index_state(fleet, i)
        assert torch.equal(back.reporters, s.reporters) and float(back.now) == float(i)
    deltas = _fleet_deltas(m)
    epochs, arrays, pads = cs.fleet_incremental_arrays([Incremental(**d) for d in deltas], 32,
                                                       device="cpu")
    ref_epochs, ref_arrays, ref_pads = ref_cs.fleet_incremental_arrays(
        [RefIncremental(**d) for d in deltas], 32)
    assert pads == ref_pads == (4, 4, 2)
    np.testing.assert_array_equal(epochs.numpy(), np.asarray(ref_epochs))
    for got, want in zip(arrays, ref_arrays):
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))
    out = cs.apply_incremental_fleet(fleet, [Incremental(**d) for d in deltas])
    ref_fleet = ref_cs.apply_incremental_fleet(
        ref_cs.stack_states([ref_cs.ClusterState.from_osdmap(ref_m) for _ in range(4)]),
        [RefIncremental(**d) for d in deltas])
    for i, d in enumerate(deltas):
        one = cs.apply_incremental(members[i], Incremental(**d))
        got = cs.index_state(out, i)
        for n in POOL_LANES:
            assert torch.equal(getattr(got.pool, n), getattr(one.pool, n)), (i, n)
        assert int(got.epoch) == int(one.epoch)
        _assert_pool_equal(_lanes(got), {n: np.asarray(getattr(ref_fleet.pool, n))[i]
                                         for n in POOL_LANES})
        host = copy.deepcopy(m)
        host.apply_incremental(Incremental(**d))
        _assert_matches_host(host, got)
    with pytest.raises(ValueError, match="3 incrementals for a fleet of 4"):
        cs.apply_incremental_fleet(fleet, [Incremental(**d) for d in deltas[:3]])
    with pytest.raises(ValueError, match="checksum tables"):
        cs.stack_states([members[0], cs.ClusterState.from_osdmap(
            m, checksums=np.zeros((16, 6), np.uint32), device="cpu")])
    with pytest.raises(ValueError, match="at least one"):
        cs.stack_states([])


def test_view_delta_counts_what_moved():
    _ref_m, m = _maps()
    a = cs.ClusterState.from_osdmap(m, device="cpu")
    b = cs.apply_incremental(a, Incremental(epoch=m.epoch + 1, new_state={1: UP, 2: UP}))
    d = cs.view_delta(a, b)
    assert (d.epoch_from, d.epoch_to, d.n_up_changed, d.n_pgs_remapped) == (
        m.epoch, m.epoch + 1, 2, 0)
    assert d.to_json()["n_steps"] == 0 and d.n_tape_rows == 0
    with pytest.raises(ValueError, match="geometries differ"):
        cs.view_delta(a, cs.ClusterState.from_osdmap(
            convert.osdmap_from_reference(ref_build_osdmap(
                16, pg_num=16, size=6, pool_kind="erasure").encode()), device="cpu"))
