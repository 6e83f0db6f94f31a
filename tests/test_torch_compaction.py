"""The port's dirty-set compaction vs the reference package's.

The ladder (``sparse_dirty_compaction``) gathers the dirty PG rows into
a power-of-two bucket, re-peers only those, and scatters the results
back: an execution strategy, never a different answer.  The primitives
(``compact_dirty_indices``, ``dirty_ladder``, ``ladder_rung``,
``gather_rows``/``scatter_rows``, ``bucket_valid``) go through both
packages on the same seeded inputs on the CPU and must be equal; the
port's epoch loop with compaction ``on`` (``sparse_min_bucket=4``: the
ladder (4, 16, 64) below 128 PGs) must equal its dense ``off`` run,
its staged run, and the reference's series, bit for bit on every lane
the reference comparison of ``tests/test_torch_superstep.py`` holds
exactly (``sums`` at ``rtol=1e-6``; the latency histograms exact, as
no epoch here has an op in R8's band), over the netsplit hold and
three scenarios of the zoo.  The netsplit hold and flap must each take
a compacted rung at least once, or the ladder went untested (the other
two scenarios' dirty epochs are all weight edits: the dense rung).
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu import recovery as ref_rec
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.core import cluster_state as ref_cs
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.recovery.chaos import ChaosEvent as RefEvent, ChaosTimeline as RefTimeline
from ceph_tpu.recovery.failure import parse_spec as ref_parse_spec
from ceph_tpu_torch import convert
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.core import cluster_state as cs
from ceph_tpu_torch.recovery.chaos import ChaosEvent, ChaosTimeline
from ceph_tpu_torch.recovery.failure import parse_spec
from ceph_tpu_torch.workload.traffic import dirty_fraction

EXACT = ("now", "epoch", "dirty", "hist", "aux", "counts", "lat_hist", "qd_hist",
         "max_rho", "writes", "deg_reads", "down_total", "eff_down", "eff_up", "eff_out",
         "down_checksum", "scrub_due")


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


def _maps(n_osd=64, pg_num=128):
    ref = ref_build_osdmap(n_osd, pg_num=pg_num, size=6, pool_kind="erasure")
    return ref, convert.osdmap_from_reference(ref.encode())


def _cfg(cls, mode, min_bucket=4, **extra):
    cfg = cls(env={})
    cfg.set("sparse_dirty_compaction", mode)
    cfg.set("sparse_min_bucket", min_bucket)
    for key, val in extra.items():
        cfg.set(key, val)
    return cfg


# --- the primitives ---------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_compact_dirty_indices_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    dirty = rng.random(n) < rng.random()
    take, n_dirty = cs.compact_dirty_indices(torch.from_numpy(dirty))
    ref_take, ref_n = ref_cs.compact_dirty_indices(jnp.asarray(dirty))
    np.testing.assert_array_equal(take.numpy(), np.asarray(ref_take))
    assert int(n_dirty) == int(ref_n) == int(dirty.sum())
    assert n_dirty.dtype == torch.int32


def test_compact_dirty_indices_stable_with_sentinel_tail():
    take, n = cs.compact_dirty_indices(torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.bool))
    assert int(n) == 3 and take.tolist() == [1, 3, 4, 6, 6, 6]
    take, n = cs.compact_dirty_indices(torch.zeros(4, dtype=torch.bool))
    assert int(n) == 0 and take.tolist() == [4, 4, 4, 4]
    take, n = cs.compact_dirty_indices(torch.ones(4, dtype=torch.bool))
    assert int(n) == 4 and take.tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("total,kw", [
    (100_000, {}), (16, {"min_bucket": 32}), (128, {"min_bucket": 4}),
    (8192, {"min_bucket": 32, "max_rungs": 4}), (1000, {"min_bucket": 3, "growth": 3}),
    (1 << 20, {"min_bucket": 1, "max_rungs": 8}),
])
def test_dirty_ladder_and_rung_match_reference(total, kw):
    widths = cs.dirty_ladder(total, **kw)
    assert widths == ref_cs.dirty_ladder(total, **kw)
    for n_dirty in sorted({0, 1, total, *widths, *(w + 1 for w in widths)}):
        assert cs.ladder_rung(n_dirty, widths) == int(
            ref_cs.ladder_rung(jnp.int32(n_dirty), widths)), n_dirty
    assert cs.ladder_rung(torch.tensor(3, dtype=torch.int32), widths) == cs.ladder_rung(3, widths)
    assert cs.dirty_ladder(100_000) == (32, 128, 512, 2048)


def test_gather_scatter_roundtrip_matches_reference():
    rng = np.random.default_rng(7)
    table = rng.integers(-5, 1000, (40, 6)).astype(np.int32)
    dirty = rng.random(40) < 0.2
    take, n_dirty = cs.compact_dirty_indices(torch.from_numpy(dirty))
    ref_take, ref_n = ref_cs.compact_dirty_indices(jnp.asarray(dirty))
    for W in (16, 32):
        rows = cs.gather_rows(torch.from_numpy(table), take, W)
        ref_rows = ref_cs.gather_rows(jnp.asarray(table), ref_take, W)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(ref_rows))
        valid = cs.bucket_valid(n_dirty, W)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_cs.bucket_valid(ref_n, W)))
        out = cs.scatter_rows(torch.from_numpy(table), take, W, rows * 10 + 1)
        ref_out = ref_cs.scatter_rows(jnp.asarray(table), ref_take, W, ref_rows * 10 + 1)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
        # sentinel slots dropped: clean rows untouched bit for bit
        np.testing.assert_array_equal(out.numpy()[~dirty], table[~dirty])
    assert cs.bucket_valid(2, 4, device="cpu").tolist() == [True, True, False, False]


# --- gating -----------------------------------------------------------


def test_compaction_gating_matches_reference():
    ref_m, m = _maps()
    cases = [("on", 4, True), ("off", 4, False), ("on", 256, False), ("auto", 4, False),
             ("auto", 2, True)]
    for mode, mb, want in cases:
        d = rec.EpochDriver(m, ChaosTimeline([ChaosEvent(0.3, (parse_spec("osd:3"),))]),
                            n_ops=16, config=_cfg(Config, mode, mb), device="cpu")
        ref = ref_rec.EpochDriver(
            ref_m, RefTimeline([RefEvent(0.3, (ref_parse_spec("osd:3"),))]), n_ops=16,
            config=_cfg(RefConfig, mode, mb))
        assert d.compaction_enabled == ref.compaction_enabled == want, (mode, mb)
        assert d._dirty_ladder == ref._dirty_ladder


# --- compacted == dense == staged == reference, bit for bit -----------


def _walk(ref_m, m, ref_timeline, timeline, n_epochs, **knobs):
    on = rec.EpochDriver(m, timeline(), n_ops=64, config=_cfg(Config, "on", **knobs),
                         device="cpu")
    off = rec.EpochDriver(m, timeline(), n_ops=64, config=_cfg(Config, "off", **knobs),
                          device="cpu")
    assert on.compaction_enabled and not off.compaction_enabled
    sup = on.run_superstep(n_epochs)
    assert sup.diff(off.run_superstep(n_epochs)) == []
    assert sup.diff(on.run_staged(n_epochs)) == []
    assert sup.diff(off.run_staged(n_epochs)) == []
    ref = ref_rec.EpochDriver(ref_m, ref_timeline(), n_ops=64,
                              config=_cfg(RefConfig, "on", **knobs)).run_superstep(n_epochs)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(sup, f), np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(sup.sums, np.asarray(ref.sums), rtol=1e-6, atol=0)
    assert dirty_fraction(sup) == float(sup.dirty.sum()) / n_epochs
    return sup, on.rungs_taken, len(on._dirty_ladder)


def test_compacted_bitequal_netsplit_hold():
    # mark-down -> auto-out -> restore: the out flip is a weight change,
    # so the walk crosses the heavy (dense-rung) branch too
    ref_m, m = _maps()

    def tl(parse, event, timeline):
        return lambda: timeline([
            event(0.3, (parse("netsplit:3"), parse("netsplit:9"))),
            event(8.0, (parse("netsplit:3:restore"), parse("netsplit:9:restore"))),
        ])

    sup, rungs, top = _walk(ref_m, m, tl(ref_parse_spec, RefEvent, RefTimeline),
                            tl(parse_spec, ChaosEvent, ChaosTimeline), 48,
                            osd_heartbeat_grace=0.5, mon_osd_down_out_interval=2.0)
    assert sup.eff_down.sum() == 2 and sup.eff_out.sum() == 2
    assert any(0 <= r < top for r in rungs) and top in rungs, rungs


@pytest.mark.parametrize("scenario", ("flap", "mid-repair-loss", "scrub-storm"))
def test_compacted_bitequal_over_zoo(scenario):
    ref_m, m = _maps()
    sup, rungs, top = _walk(ref_m, m, lambda: ref_rec.build_scenario(scenario, ref_m),
                            lambda: rec.build_scenario(scenario, m), 40)
    assert sup.dirty.sum() > 0 and rungs
    if scenario == "flap":
        assert any(0 <= r < top for r in rungs), rungs
