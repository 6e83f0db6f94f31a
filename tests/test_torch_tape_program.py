"""The one-cluster program with the tape and the salt as device inputs
(``recovery/superstep.py``, ``TapeProgram``) on the CPU: the fleet's
sequential baseline and the divergent ranks' epochs.

The program's body run eagerly (each decision one host read of its
predicate, the graph's body on the card) with two clusters' tapes and
seeds loaded one after the other into ONE program must equal a plain
``EpochDriver`` (the host-decided body, which ``tests/test_torch_fleet.py``
holds to the port's ``run_sequential``) and the reference's
``run_sequential`` (its one jitted tape-as-argument scan),
under ``tests/test_torch_superstep.py``'s rules: integer lanes exact,
``sums`` at ``rtol=1e-6``, the latency histograms outside R8's band.
A tape in the same row bucket keeps the program's buffers; the step
tables are the host driver's for that tape and salt.

``DivergentDriver.run`` with every rank's advance through the program
(``DivergentDriver(..., path="eager")``) must equal the host-decided
run and the reference's: the rounds, the fingerprints,
``detection_to_convergence_rounds``, every lane of every view and of
the merged view, the catch-up's journal record; a stale view (after the
program) is rebuilt from the state for the host-decided body.

Sizes are ``tests/test_torch_fleet.py``'s map (32 OSDs, 16 PGs) at 16
ops, on one torch thread.
"""

import copy

import numpy as np
import pytest
import torch

from ceph_tpu.obs import EventJournal as RefJournal
from ceph_tpu.recovery.fleet import FleetDriver as RefFleetDriver
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.obs import EventJournal
from ceph_tpu_torch.recovery import fleet as fl
from ceph_tpu_torch.recovery import reconcile as rc

from test_torch_fleet import _maps
from test_torch_reconcile import (
    _cfgs,
    _drivers,
    _leaves_equal,
    _timelines,
    assert_rounds_match,
    assert_views_equal,
)
from test_torch_superstep import assert_matches_reference

EPOCHS = 16
N_OPS = 16
SEED = 7


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """Put the reference's program caches back after this module."""
    from ceph_tpu.crush import interp, interp_batch as ib
    from ceph_tpu.osdmap import mapping
    from ceph_tpu.recovery import pipeline

    caches = (ib._FAST_CACHE, ib._PACK_CACHE, interp._BATCH_CACHE, mapping._POOL_FN_CACHE,
              pipeline.PIPELINES._entries)
    saved = [copy.copy(c) for c in caches]
    counts = (pipeline.PIPELINES.hits, pipeline.PIPELINES.misses, pipeline.PIPELINES.evictions)
    yield
    for cache, before in zip(caches, saved):
        cache.clear()
        cache.update(before)
    pipeline.PIPELINES.hits, pipeline.PIPELINES.misses, pipeline.PIPELINES.evictions = counts


# ---- the one-cluster program ------------------------------------------------


def test_two_tapes_in_one_program_equal_plain_driver_and_reference():
    ref_m, m = _maps()
    fd = fl.FleetDriver(m, seed=SEED, n_ops=N_OPS, device="cpu")
    tls = fd.sample(2, "ssd-burst")
    tapes = [rec.compile_event_tape(tl, m) for tl in tls]
    seeds = fd._seeds(2, None)
    r_pad = max(len(tp) for tp in tapes)
    r_pad = 1 << (r_pad - 1).bit_length()
    prog = fd.driver.compile_tape_program()
    body = fd.run_sequential(EPOCHS, tls, path="eager")
    assert prog is fd.driver.compile_tape_program() and prog.rows_pad == r_pad
    ref_fd = RefFleetDriver(ref_m, seed=SEED, n_ops=N_OPS)
    ref = ref_fd.run_sequential(EPOCHS, ref_fd.sample(2, "ssd-burst"))
    for k in range(2):
        assert body[k].dirty.sum() > 0
        d = rec.EpochDriver(m, tls[k], seed=SEED + k, n_ops=N_OPS, device="cpu")
        if k == 0:
            assert body[k].diff(d.run_superstep(EPOCHS)) == []
        assert_matches_reference(body[k], ref[k], d, EPOCHS)
    assert body[0].diff(body[1]) != []


def test_load_keeps_the_bucket_and_the_tables_are_the_host_drivers():
    """A tape within the row bucket reuses the buffers (no new capture on
    the card); a longer one makes new ones; each loaded tape's step
    tables equal a plain driver's on that tape and salt."""
    _ref_m, m = _maps()
    fd = fl.FleetDriver(m, seed=SEED, n_ops=N_OPS, device="cpu")
    prog = fd.driver.compile_tape_program()
    with pytest.raises(RuntimeError, match="load"):
        prog._tables(4)
    tls = fd.sample(3, "rack-cascade")
    tapes = [rec.compile_event_tape(tl, m) for tl in tls]
    pad = 1 << (max(len(tp) for tp in tapes) - 1).bit_length()
    prog.load(fl._padded_tape(tapes[0], pad), 11)
    kind = prog._kind
    for k, tp in enumerate(tapes):
        salt = int(fl._salt_base(SEED + k))
        prog.load(tp, salt)
        assert prog._kind is kind and prog.rows_pad == pad
        host, dev = prog._tables(EPOCHS)
        d = rec.EpochDriver(m, tls[k], seed=SEED + k, n_ops=N_OPS, device="cpu")
        want = d.step_tables(len(host["now"]))
        assert host.keys() == want.keys()
        for name, v in want.items():
            assert np.array_equal(host[name], v), (k, name)
            assert np.array_equal(dev[name].numpy(), v), (k, name)
        assert np.array_equal(prog._kind[:len(tp)].numpy(), tp.kind)
    prog.load(fl._padded_tape(tapes[0], 2 * pad), 11)
    assert prog._kind is not kind and prog.rows_pad == 2 * pad


# ---- the divergent ranks -------------------------------------------------------

CASES = {
    # a 2.5 s skew: rank 1 observably stale, detected, then re-converged
    "skew": ([(0.05, ("rankdelay:1.2500",)), (0.30, ("osd:3:down_out",)),
              (0.80, ("osd:9:down_out",))], 2, 4, 16),
    # a 20-epoch stall: rank 1 laggy, then revived through a catch-up
    "stall": ([(0.30, ("osd:3:down_out",)), (1.00, ("rankstall:1.20",))], 2, 5, 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_divergent_ranks_through_the_program(case):
    pairs, n_ranks, seed, n = CASES[case]
    maps = _maps()
    journals = (RefJournal(), EventJournal())
    ref_d, host_d = _drivers(pairs, n_ranks, seed, n_ops=N_OPS, maps=maps,
                             journal=journals)
    _ref_tl, tl = _timelines(pairs)
    prog_d = rc.DivergentDriver(maps[1], tl, n_ranks, config=_cfgs()[1], seed=seed,
                                n_ops=N_OPS, device="cpu", journal=EventJournal(),
                                path="eager")
    ref_res, want = ref_d.run(n), host_d.run(n)
    assert (host_d.path, prog_d.path) == ("host", "eager")
    got = prog_d.run(n)
    assert got.rounds == want.rounds and got.total_steps == want.total_steps
    assert got.converged and got.laggy == want.laggy == ()
    d2c = got.detection_to_convergence_rounds()
    assert d2c == want.detection_to_convergence_rounds() == (
        ref_res.detection_to_convergence_rounds())
    assert all(h.stale for h in prog_d.hosts)
    for a, b in zip(got.states + [got.merged], want.states + [want.merged]):
        assert _leaves_equal(a, b) == []
    assert_rounds_match(got.rounds, ref_res.rounds)
    for s, rs in zip(got.states + [got.merged], ref_res.states + [ref_res.merged]):
        assert_views_equal(s, rs)
    ref_state = prog_d.reference_state(got.total_steps)
    assert all(rc.view_fingerprint(s) == rc.view_fingerprint(ref_state) for s in got.states)
    catchups = [r["attrs"] for r in prog_d.journal.by_name("reconcile.catchup")]
    assert catchups == [r["attrs"] for r in host_d.journal.by_name("reconcile.catchup")]
    if case == "stall":
        assert any(1 in r.laggy for r in got.rounds) and catchups[0]["n_steps"] > 1
    else:
        assert d2c is not None and d2c >= 1


def test_a_stale_view_is_rebuilt_for_the_host_decided_body():
    """Rank 0 advanced by the program to epoch 8, then by the host-decided
    body to 16 (its stale view rebuilt from the state with one read),
    equals the host-decided body all the way."""
    _ref_m, m = _maps()
    _ref_tl, tl = _timelines([(0.30, ("osd:3:down_out",)), (1.30, ("slow:5",))])
    d = rc.DivergentDriver(m, tl, 1, config=_cfgs()[1], seed=3, n_ops=N_OPS, device="cpu")
    drv, tape = d.driver, d._tapes[0]
    host = drv._init_host.copy()
    state = rc._advance_view(drv, drv._init_state, host, tape, 0, 8, path="eager")
    assert host.stale and host.cursor == int(state.tape_cursor)
    state = rc._advance_view(drv, state, host, tape, 8, 16)
    assert not host.stale and host.epoch == int(state.epoch)
    want_host = drv._init_host.copy()
    want = rc._advance_view(drv, drv._init_state, want_host, tape, 0, 16)
    assert _leaves_equal(state, want) == []
    for f in ("step", "now", "last_tick", "epoch", "cursor", "any_down", "any_laggy"):
        assert getattr(host, f) == getattr(want_host, f), f
    assert np.array_equal(host.suppressed, want_host.suppressed)
    assert np.array_equal(host.slow, want_host.slow) and host.slow.any()
