"""The compiled write path (``workload/writepath.py``,
``WritepathProgram``) on the CPU, against the reference package.

On the card a chunk of write-path epochs is one CUDA graph (held in
``tests/test_torch_cuda.py``); on the CPU the same body runs eagerly
(``program.run_eager``), every decision one host read of its predicate.
The geometry is ``tests/test_torch_writepath.py``'s:
``build_osdmap(32, pg_num=64, size=6, erasure)``, 64 ops, ``n_sets=8,
ways=2, max_writes=32, full_permille=250``, 8 epochs in chunks of 4.

The eager compiled body must equal, bit for bit on both series, the
final buffer and the final state:

- the reference's ``WritepathDriver.run_superstep`` (its jitted
  ``compile_writepath`` scan): flap and mid-repair-loss with compaction
  ``auto`` and ``off``, the ``ssd-burst`` mix (the tabled capacity) and
  the ``ssd-skew`` mix (the skewed ids on the table's salt);
- the port's host-decided loop (``run_superstep`` on the CPU) and
  ``run_staged``.

This file holds the scenarios and the mixes;
``tests/test_torch_writepath_graph_modes.py`` the flight twin, the caps
and the rest.

Epoch series against the reference's are exact but ``sums``
(``rtol=1e-6``), ``hist`` by value (R10) and the latency histograms
outside R8's band (``test_torch_superstep``'s
``assert_matches_reference``); write-path lanes and buffers exact.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.recovery import EpochDriver as RefEpochDriver, build_scenario as ref_scenario
from ceph_tpu.workload import WritepathDriver as RefWritepathDriver
from ceph_tpu_torch import convert
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.recovery.checkpoint import diff_states
from ceph_tpu_torch.workload import WritepathDriver
from ceph_tpu_torch.workload.writepath import WritepathProgram
from test_torch_superstep import assert_matches_reference

N_EPOCHS = 8
EVERY = 4
N_OPS = 64
WP = dict(n_sets=8, ways=2, max_writes=32, full_permille=250)
BUF_FIELDS = ("keys", "data", "parity", "dirty", "lru", "tick", "totals")


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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many test workers share the CPU: one intra-op thread a worker keeps
    the epochs' small batches from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MAPS: list = []


def _maps():
    if not _MAPS:
        ref = ref_build_osdmap(32, pg_num=64, size=6, pool_kind="erasure")
        _MAPS.extend([ref, convert.osdmap_from_reference(ref.encode())])
    return _MAPS


def _configs(compaction: str, flight_on: bool):
    """The same settings for both packages: ``auto`` with a bucket small
    enough that 64 PGs reach the ladder."""
    out = []
    for cls in (RefConfig, Config):
        cfg = cls(env={})
        cfg.set("sparse_dirty_compaction", compaction)
        cfg.set("sparse_min_bucket", 1)
        cfg.set("flight_recorder", "on" if flight_on else "off")
        out.append(cfg)
    return out


def _drivers(scenario="flap", compaction="auto", flight_on=False, mix=None, reference=True):
    ref_m, m = _maps()
    ref_cfg, cfg = _configs(compaction, flight_on)
    w = WritepathDriver(rec.EpochDriver(m, rec.build_scenario(scenario, m), n_ops=N_OPS,
                                        config=cfg, mix=mix, device="cpu"), **WP)
    if not reference:
        return None, w
    rd = RefEpochDriver(ref_m, ref_scenario(scenario, ref_m), n_ops=N_OPS, config=ref_cfg,
                        mix=mix)
    return RefWritepathDriver(rd, **WP), w


def _ref_lanes(state) -> list:
    return [np.asarray(a) for a in jax.device_get(jax.tree_util.tree_flatten(state)[0])]


def _assert_state_matches_reference(port_state, ref_state):
    got, want = convert.state_lanes(port_state), _ref_lanes(ref_state)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), i


def _assert_buffer_matches_reference(port, ref):
    ref = jax.device_get(ref)
    for f in BUF_FIELDS:
        want = np.asarray(getattr(ref, f))
        got = getattr(port, f).numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.shape == want.shape and np.array_equal(got, want), f


def _buffers_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in BUF_FIELDS)


def _check(rw, w, *, n=N_EPOCHS, every=EVERY, cap=None):
    """The eager compiled body against the reference's scan, the host
    loop and ``run_staged``; returns the body's series."""
    d = w.driver
    prog = w.compile_writepath_flight() if d.flight_on else w.compile_writepath()
    body, wbody = prog.run_eager(n, snapshot_every=every, cap=cap)
    state, buf, rungs = w.final_state, w.final_buf, list(d.rungs_taken)
    ring = d.drain_flight()["rows"] if d.flight_on else None
    host, whost = w.run_superstep(n, snapshot_every=every, cap=cap)
    assert body.diff(host) == [] and wbody.diff(whost) == [] and rungs == d.rungs_taken
    assert _buffers_equal(buf, w.final_buf) and diff_states(state, w.final_state) == []
    if ring is not None:
        np.testing.assert_array_equal(ring, d.drain_flight()["rows"])
    staged, wstaged = w.run_staged(n, cap=cap)
    assert body.diff(staged) == [] and wbody.diff(wstaged) == []
    assert diff_states(state, w.final_state) == [] and _buffers_equal(buf, w.final_buf)
    rsup, rwsup = rw.run_superstep(n, snapshot_every=every,
                                   cap=w.max_writes if cap is None else cap)
    assert_matches_reference(body, rsup, d, n)
    assert np.array_equal(wbody.lanes, np.asarray(rwsup.lanes))
    _assert_buffer_matches_reference(buf, rw.final_buf)
    _assert_state_matches_reference(state, rw.final_state)
    assert wbody.totals()["delta_writes"] > 0 and wbody.totals()["full_writes"] > 0
    return body, wbody, ring


@pytest.mark.parametrize("scenario,compaction", [("flap", "auto"), ("mid-repair-loss", "auto"),
                                                 ("flap", "off"), ("mid-repair-loss", "off")])
def test_compiled_body_equals_reference_host_loop_and_staged(scenario, compaction):
    rw, w = _drivers(scenario, compaction)
    assert w.driver.compaction_enabled == (compaction == "auto")
    body, _wbody, _ring = _check(rw, w)
    assert body.dirty.sum() > 0
    assert w.compile_writepath() is w.compile_writepath()
    assert isinstance(w.compile_writepath(), WritepathProgram)


@pytest.mark.parametrize("mix", ["ssd-burst", "ssd-skew"])
def test_compiled_body_with_a_mix_equals_reference(mix):
    """``ssd-burst`` reads the tabled capacity, ``ssd-skew`` skews the ids
    on the table's salt."""
    rw, w = _drivers("flap", "auto", mix=mix)
    _check(rw, w)
    tab = w.driver.step_tables(N_EPOCHS)
    if mix == "ssd-burst":
        assert len(set(tab["cap"].tolist())) == 2
