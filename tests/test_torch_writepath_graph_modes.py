"""The compiled write path (``workload/writepath.py``,
``WritepathProgram``) on the CPU: the flight twin, caps, chunks, the
write batch on the step tables, checkpoints and the body's reads.

The body run eagerly (see ``tests/test_torch_writepath_graph.py``, whose
geometry and helpers these tests share) must equal the reference's scan,
the host-decided loop and ``run_staged`` with the recorder on (the ring
equal to the host loop's, its stripe lanes equal to the write rows) and
at caps 5 and 7 in one bucket (one program); chunks with snapshots split
as the host path's; the write batch from the step table's salt and a cap
tensor equals the host form at every step of the tables;
``checkpointed_writepath`` over the compiled advance, crashed before,
during and after a snapshot, resumes bit-equal to an uninterrupted run;
the body's only host reads are its predicates.
"""

import functools

import numpy as np
import pytest
import torch

from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.analysis import runtime_guard
from ceph_tpu_torch.core import graphs
from ceph_tpu_torch.crush import interp_batch
from ceph_tpu_torch.ec.online import WP_LANES
from ceph_tpu_torch.obs import flight
from ceph_tpu_torch.recovery.checkpoint import (
    CheckpointStore,
    CrashPoint,
    SimulatedCrash,
    diff_states,
)
from ceph_tpu_torch.recovery.superstep import _SALT_STEP
from ceph_tpu_torch.workload import WritepathDriver, checkpointed_writepath

from test_torch_writepath_graph import (  # noqa: F401  (the fixtures)
    EVERY,
    N_EPOCHS,
    N_OPS,
    WP,
    _check,
    _drivers,
    _maps,
    _one_torch_thread,
    _reference_caches_left_as_found,
)


def test_flight_twin_ring_equals_host_loop_and_stripe_lanes_equal_wrows():
    rw, w = _drivers("flap", "auto", flight_on=True)
    prog = w.compile_writepath_flight()
    assert prog.flight and prog is not w.compile_writepath()
    _body, wbody, ring = _check(rw, w)
    assert len(ring) == N_EPOCHS
    for n in ("hits", "misses", "evictions", "delta_words"):
        np.testing.assert_array_equal(ring[:, flight.FLIGHT_LANES.index(f"stripe_{n}")],
                                      wbody.lane(n))
    _rw, off = _drivers("flap", "auto", reference=False)
    with pytest.raises(RuntimeError, match="flight recorder is off"):
        off.compile_writepath_flight()


def test_chunks_with_snapshots_and_rows_left_on_the_device():
    _rw, w = _drivers("flap", "auto", reference=False)
    prog = w.compile_writepath()
    body, wbody = prog.run_eager(10, snapshot_every=3)
    host, whost = w.run_superstep(10, snapshot_every=3)
    assert body.diff(host) == [] and wbody.diff(whost) == []
    state, buf, rows, wrows = prog.run_eager(10, pull=False)
    assert rows.now is None and rows.lanes is not None and len(rows) == 10
    assert rec.EpochSeries.from_device(rows).diff(host) == []
    assert np.array_equal(wrows.numpy(), whost.lanes)
    # a buffer given is consumed; the one returned is the caller's own
    given = w._init_buf.clone()
    _s, out, _r, _w = prog.run_eager(4, pull=False, buf=given)
    assert out.data.data_ptr() != prog._carry.buf.data.data_ptr()
    assert int((w._init_buf.keys >= 0).sum()) == 0


def test_caps_in_one_bucket_each_equal_reference():
    """Caps 5 and 7 run the same program (the cap a buffer of the body),
    each equal to the reference's scan at that cap."""
    rw, w = _drivers("flap", "auto")
    assert w.batch_size == 32
    prog = w.compile_writepath()
    got = {}
    for cap in (5, 7):
        _body, wbody, _ring = _check(rw, w, cap=cap)
        got[cap] = wbody
        assert (wbody.lane("delta_writes") + wbody.lane("full_writes") <= cap).all()
        assert w.compile_writepath() is prog
    assert got[5].diff(got[7]) != []


@pytest.mark.parametrize("mix", [None, "ssd-skew"])
def test_write_batch_on_table_salt_and_cap_tensor_equals_host_form(mix):
    """At every step of the tables the step table's salt is the host's
    ``(salt_base + step * _SALT_STEP) & 0xFFFFFFFF`` (a nonzero seed too),
    and the write batch from it and a cap tensor equals the batch from
    the host step and cap, lane for lane."""
    ref_m, m = _maps()
    d = rec.EpochDriver(m, rec.build_scenario("flap", m), n_ops=N_OPS, mix=mix, seed=11,
                        device="cpu")
    w = WritepathDriver(d, **WP)
    state = d.run_superstep(6, pull=False)[0]  # a state past the events
    host_tab, dev_tab = d._tables(N_EPOCHS)
    assert len(host_tab["salt"]) >= 64
    for step in range(len(host_tab["salt"])):
        assert int(host_tab["salt"][step]) == (d.salt_base + step * _SALT_STEP) & 0xFFFFFFFF
        for cap in (0, 5, w.batch_size, 1000):
            want = w._write_batch(state, step, cap)
            got = w._write_batch(state, None, torch.tensor(cap, dtype=torch.int32),
                                 salt=dev_tab["salt"][step].reshape(()))
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (step, cap)
    assert int(want[4].sum()) > 0


@pytest.fixture(scope="module")
def uninterrupted():
    """A write path and its uninterrupted run: the series and the final
    state and buffer."""
    _rw, w = _drivers("flap", "auto", reference=False)
    series = w.run_superstep(N_EPOCHS, snapshot_every=EVERY)
    return w, series, (w.final_state, w.final_buf)


@pytest.mark.parametrize("phase", ("before", "during", "after"))
def test_checkpointed_compiled_advance_resumes_bitequal(tmp_path, monkeypatch, uninterrupted,
                                                        phase):
    """``checkpointed_writepath`` over the compiled advance (the card's:
    its host view stale after a chunk), killed at a snapshot and resumed
    from the store with a warm buffer, lands where an uninterrupted run
    does."""
    w, (sup, wsup), want = uninterrupted
    prog = w.compile_writepath()
    monkeypatch.setattr(w, "advance", functools.partial(prog._advance_writes, compiled=False))
    with pytest.raises(SimulatedCrash):
        checkpointed_writepath(w, N_EPOCHS, store=CheckpointStore(str(tmp_path), device="cpu"),
                               snapshot_every=EVERY, crashes=(CrashPoint(3, phase),))
    store = CheckpointStore(str(tmp_path), device="cpu")
    if phase == "after":
        meta, (_state, buf), _series = store.load_latest((w.driver._init_state, w._init_buf),
                                                         with_series=True)
        assert meta["next_epoch"] == EVERY and int((buf.keys >= 0).sum()) > 0
    got, wgot = checkpointed_writepath(w, N_EPOCHS, store=store, snapshot_every=EVERY)
    assert sup.diff(got) == [] and wsup.diff(wgot) == []
    assert diff_states((w.final_state, w.final_buf), want) == []


def test_body_reads_only_its_predicates():
    """Under the runtime guard's TransferCounter the eager body's seam
    reads are its decisions' predicates and the CRUSH retry ladder's: the
    write stage reads nothing."""
    _rw, w = _drivers("flap", "auto", flight_on=True, reference=False)
    prog = w.compile_writepath_flight()
    prog(4)  # the tables
    p0, h0 = graphs.PREDICATE_READS, interp_batch.HOST_SYNCS
    with runtime_guard.TransferCounter() as tc:
        prog(N_EPOCHS, pull=False)
    preds = graphs.PREDICATE_READS - p0
    assert tc.host_transfers == preds + interp_batch.HOST_SYNCS - h0
    assert set(tc.by_seam) <= {"__bool__", "__int__"} and preds >= 3 * N_EPOCHS
    assert len(WP_LANES) == prog._carry.wrows.shape[1]
