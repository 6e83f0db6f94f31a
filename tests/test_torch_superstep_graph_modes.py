"""The compiled epoch superstep (``recovery/superstep.py``,
``SuperstepProgram``) on the CPU: compaction auto and off, the flight
recorder, chunks, the host view, the step tables and the decisions.

The body run eagerly (see ``tests/test_torch_superstep_graph.py``) must
equal the reference's ``run_superstep`` and the port's ``run_staged``
with compaction auto and off, and the host path's series, rungs and
flight ring with the recorder on; chunks with snapshots split as the
host path's.  Each step table equals what the host driver computes at
that step (a burst mix among the cases), the body's only host reads
are its decisions' predicates, the conditional-node helpers raise
outside a capture, and a replayed graph counts each body's launches as
often as the body ran.
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.analysis import runtime_guard
from ceph_tpu_torch.core import cluster_state as cs
from ceph_tpu_torch.core import graphs
from ceph_tpu_torch.crush import interp_batch
from ceph_tpu_torch.recovery import superstep

from test_torch_superstep import ZOO, _maps, assert_matches_reference
from test_torch_superstep_graph import EPOCHS, _check, _drivers


@pytest.mark.parametrize("scenario,compaction", [("flap", "auto"), ("mid-repair-loss", "auto"),
                                                 ("flap", "off"), ("mid-repair-loss", "off")])
def test_device_body_equals_reference_auto_and_off(scenario, compaction):
    _check(scenario, compaction)


@pytest.mark.parametrize("scenario,compaction", [("flap", "on"), ("mid-repair-loss", "off")])
def test_device_body_flight_recorder_equals_host_and_reference(scenario, compaction):
    """With the recorder on, the body's series, rungs and ring equal the
    host path's (lanes bit for bit, the probe's extras too) and the
    reference's series."""
    ref, d = _drivers(scenario, compaction, flight=True)
    prog = rec.compile_epoch_superstep(d)
    assert prog.flight and prog is d.compile_superstep_flight()
    body = prog(EPOCHS)
    ring, rungs = d.drain_flight(), list(d.rungs_taken)
    host = d.run_superstep(EPOCHS)
    assert body.diff(host) == [] and d.rungs_taken == rungs
    want = d.drain_flight()
    assert ring["head"] == want["head"] == EPOCHS
    np.testing.assert_array_equal(ring["rows"], want["rows"])
    assert_matches_reference(body, ref.run_superstep(EPOCHS), d, EPOCHS)
    assert d.compile_superstep() is not prog


def test_device_body_chunks_with_snapshots():
    """Chunks with ``on_snapshot`` split as the host path's do, each
    chunk's state the host path's, the rows left on the device when not
    pulled."""
    _ref, d = _drivers("flap", "on")
    prog = d.compile_superstep()
    seen, states = [], []
    body = prog(EPOCHS, snapshot_every=12,
                on_snapshot=lambda s, p: (seen.append((s, len(p))), states.append(d.final_state)))
    assert seen == [(0, 12), (12, 12), (24, 12), (36, 4)]
    host_states = []
    host = d.run_superstep(EPOCHS, snapshot_every=12,
                           on_snapshot=lambda s, p: host_states.append(d.final_state))
    assert body.diff(host) == []
    for a, b in zip(states, host_states):
        for name in superstep._state_names(a):
            assert torch.equal(superstep._get(a, name), superstep._get(b, name)), name
    state, rows = prog(EPOCHS, pull=False)
    assert rows.lanes is not None and rows.now is None and len(rows) == EPOCHS
    assert superstep.EpochSeries.from_device(rows).diff(body) == []


def test_compiled_chunk_leaves_a_stale_host_view():
    """After a compiled chunk the host view keeps the tables' clock and
    cursor; the host-decided step refuses it until it is rebuilt from
    the state, and the rebuilt view is the host path's."""
    _ref, d = _drivers("flap", "on")
    prog = d.compile_superstep()
    host = d._init_host.copy()
    state, _fs, _rows = prog.advance(d._init_state, host, 0, 16)
    want = d._init_host.copy()
    d._advance_host(d._init_state, want, 0, 16)
    assert host.stale and (host.step, host.now, host.cursor) == (want.step, want.now,
                                                                 want.cursor)
    with pytest.raises(RuntimeError, match="stale"):
        d._epoch_step(state, host, 16)
    view = d.host_view(state)
    assert not view.stale and (view.epoch, view.last_tick, view.any_down, view.any_laggy) == (
        want.epoch, want.last_tick, want.any_down, want.any_laggy)
    assert np.array_equal(view.suppressed, want.suppressed)
    assert np.array_equal(view.slow, want.slow)


# ---------------------------------------------------------------- the step tables


def _host_steps(d, n: int) -> dict[str, list]:
    """What the host-decided driver computes at each of ``n`` steps, from
    the pieces that compute it (the tape window, the traffic parameters,
    the scrub window), step by step; nothing else feeds them."""
    got = {k: [] for k in ("now", "stop", "bump", "map", "salt", "cap", "scrub")}
    state, host = d._init_state, d._init_host.copy()
    for step in range(n):
        prev_now, epoch = host.now, host.epoch
        state, map_rows = d._tape_apply(state, host, step)
        salt, cap = d._traffic_params(step, host.now)
        for key, v in (("now", host.now), ("stop", host.cursor), ("bump", host.epoch - epoch),
                       ("map", map_rows), ("salt", int(salt)), ("cap", float(cap)),
                       ("scrub", int(d._scrub_due(prev_now, host.now)[0]))):
            got[key].append(v)
    return got


@pytest.mark.parametrize("scenario,mix", [(s, None) for s in ZOO] + [("flap", "ssd-burst"),
                                                                      ("scrub-storm", "ssd-skew")])
def test_step_tables_equal_the_host_values(scenario, mix):
    _ref_m, m = _maps(32, 64)
    # a short scrub period: the scrub lane moves from window to window
    d = rec.EpochDriver(m, rec.build_scenario(scenario, m), n_ops=16, mix=mix,
                        scrub_period_s=2.0, device="cpu")
    n = 48
    want = _host_steps(d, n)
    tab = d.step_tables(n)
    assert tab["now"].dtype == np.float64 and tab["now32"].dtype == np.float32
    assert tab["now"].tolist() == want["now"]
    assert np.array_equal(tab["now32"], np.asarray(want["now"], np.float32))
    for key in ("stop", "bump", "map", "salt", "scrub"):
        assert tab[key].tolist() == want[key], key
    assert np.array_equal(tab["cap"], np.asarray(want["cap"], np.float32))
    if mix == "ssd-burst":  # the burst moves the capacity
        assert len(set(tab["cap"].tolist())) == 2
    assert (np.diff(tab["scrub"]) != 0).any()
    _host, dev = d._tables(n)
    assert all(len(v) >= n and torch.equal(dev[k][:n], torch.from_numpy(tab[k]))
               for k, v in dev.items())


# ---------------------------------------------------------------- the decisions


@pytest.mark.parametrize("scenario", ["flap", "scrub-storm"])
def test_body_reads_only_its_predicates(scenario):
    """Under the runtime guard's TransferCounter the body's seam reads
    are its decisions' predicates (the eager helpers') and the CRUSH
    retry ladder's (``interp_batch._any``): nothing else."""
    _ref, d = _drivers(scenario, "on", flight=True)
    prog = rec.compile_epoch_superstep(d)
    prog(4)  # the tables
    p0, h0 = graphs.PREDICATE_READS, interp_batch.HOST_SYNCS
    with runtime_guard.TransferCounter() as tc:
        prog(EPOCHS, pull=False)
    preds = graphs.PREDICATE_READS - p0
    assert tc.host_transfers == preds + interp_batch.HOST_SYNCS - h0
    assert set(tc.by_seam) <= {"__bool__", "__int__"} and preds >= 3 * EPOCHS


def test_conditional_node_helpers_raise_outside_a_capture():
    yes = torch.ones((), dtype=torch.bool)
    with pytest.raises(RuntimeError, match="needs a capture"):
        graphs.if_node(yes, lambda: None)
    with pytest.raises(RuntimeError, match="needs a capture"):
        graphs.if_node(yes, lambda: None, lambda: None)
    with pytest.raises(RuntimeError, match="needs a capture"):
        graphs.switch_node(torch.zeros((), dtype=torch.int32), [lambda: None])
    with pytest.raises(RuntimeError, match="needs a capture"):
        with graphs.while_node(lambda: yes):
            pass
    # the eager forms decide on the host
    seen = []
    graphs.cond(yes, lambda: seen.append("then"), lambda: seen.append("else"))
    graphs.cond(~yes, lambda: seen.append("then"), lambda: seen.append("else"))
    for i in (-1, 0, 2, 3):
        graphs.switch(torch.tensor(i, dtype=torch.int32),
                      [lambda i=i, k=k: seen.append((i, k)) for k in range(3)])
    x = torch.tensor(3)
    graphs.loop(lambda: x > 0, lambda: x.sub_(1))
    assert seen == ["then", "else", (0, 0), (2, 2)] and int(x) == 0


class _Replayed:
    def replay(self):
        pass


def test_body_launches_count_by_passes(monkeypatch):
    """A replay counts the launches outside every body at once and each
    body's (an IF's then and else, a SWITCH branch, a WHILE body) as
    often as its pass counter says it ran: a body that never ran counts
    nothing."""
    from ceph_tpu_torch.core import straw2

    monkeypatch.setitem(straw2.LAUNCHES, "descend", straw2.LAUNCHES["descend"])
    monkeypatch.setitem(straw2.REPLAYS, "descend", straw2.REPLAYS["descend"])
    bodies = [{"descend": 2}, {"descend": 5}, {"descend": 1}, {}]  # then, else, branch, while
    passes = torch.zeros(graphs.MAX_BODIES, dtype=torch.int64)
    g = graphs.Graph(_Replayed(), None, None, nodes=9, cond_nodes=3,
                     launches={"descend": 11}, in_bodies={"descend": 8}, bodies=bodies,
                     passes=passes, capture_ms=0.0, pool_bytes=0)
    assert g.sure == {"descend": 3}
    with runtime_guard.LaunchCounter() as lc:
        g.replay()
        passes[:4] = torch.tensor([1, 0, 4, 4])  # what the card's counters would say
        g.replay()
        passes[:4] += torch.tensor([0, 1, 0, 0])
    assert lc.launches == lc.replays == {"descend": 3 + 3 + 2 * 1 + 5 * 1 + 1 * 4}
    assert lc.calls == {} and g.launched == {"descend": 17} and int(passes.sum()) == 0


def test_device_rung_equals_the_host_rung():
    for widths in ((), (4,), (4, 16, 64), (32, 128, 512, 2048)):
        for n in (0, 1, 4, 5, 16, 17, 63, 64, 65, 127, 2048, 2049, 9000):
            got = cs.ladder_rung_device(torch.tensor(n, dtype=torch.int32), widths)
            assert got.dtype == torch.int32 and int(got) == cs.ladder_rung(n, widths)


def test_flight_record_in_place_equals_flight_record():
    from ceph_tpu_torch.obs import flight

    fs = flight.empty_flight(4, device="cpu")
    live = flight.empty_flight(4, device="cpu")
    for e in range(7):
        row = flight.flight_row(epoch=e, dirty=e % 2, rung=e - 3, served=10 * e)
        fs = flight.flight_record(fs, row)
        assert flight.flight_record_(live, row) is live
    assert torch.equal(fs.ring, live.ring) and int(fs.head) == int(live.head) == 7
