"""The compiled epoch superstep (``recovery/superstep.py``,
``SuperstepProgram``) on the CPU, against the reference package.

On the CPU the program runs its body eagerly, every decision of the
epoch (the tape window's rows and their edits, the liveness tick, the
dirty branch, the compaction ladder's rung) made from a value on the
device and read to the host as a predicate; on the card the same body
is one CUDA graph a chunk (held in ``tests/test_torch_cuda.py``).  The
body run eagerly must equal the reference's ``run_superstep`` over
``tests/test_torch_superstep.py``'s zoo (its tolerances: ``EXACT``
lanes bit-equal, ``sums`` at ``rtol=1e-6``, the latency histograms
outside R8's band) with compaction on, auto and off, and the port's own
``run_staged`` and host-decided superstep bit for bit; so must its
flight recorder's ring and its chunks with snapshots.  This file holds
the zoo with compaction on; ``tests/test_torch_superstep_graph_modes.py``
the rest.
"""

import pytest

from ceph_tpu import recovery as ref_rec
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu_torch import recovery as rec
from ceph_tpu_torch.common.config import Config

from test_torch_superstep import N_OPS, ZOO, _maps, assert_matches_reference

EPOCHS = 40


def _configs(compaction: str, flight: bool = False):
    """The same settings for the reference's driver and the port's: the
    ladder (4, 16, 64) under ``on`` at 128 PGs, and under ``auto`` with
    a bucket small enough that 128 PGs reach it."""
    out = []
    for cls in (RefConfig, Config):
        cfg = cls(env={})
        cfg.set("sparse_dirty_compaction", compaction)
        cfg.set("sparse_min_bucket", 2 if compaction == "auto" else 4)
        cfg.set("flight_recorder", "on" if flight else "off")
        out.append(cfg)
    return out


def _drivers(scenario: str, compaction: str, flight: bool = False, mix=None):
    ref_m, m = _maps()
    ref_cfg, cfg = _configs(compaction, flight)
    ref = ref_rec.EpochDriver(ref_m, ref_rec.build_scenario(scenario, ref_m), n_ops=N_OPS,
                              config=ref_cfg, mix=mix)
    d = rec.EpochDriver(m, rec.build_scenario(scenario, m), n_ops=N_OPS, config=cfg,
                        mix=mix, device="cpu")
    return ref, d


def _check(scenario: str, compaction: str):
    ref, d = _drivers(scenario, compaction)
    body = rec.compile_epoch_superstep(d)(EPOCHS)
    rungs = list(d.rungs_taken)
    assert body.diff(d.run_staged(EPOCHS)) == []
    assert_matches_reference(body, ref.run_superstep(EPOCHS), d, EPOCHS)
    assert d.compaction_enabled == (compaction != "off")
    if compaction == "off":
        assert rungs == []
    return body, rungs


@pytest.mark.parametrize("scenario", ZOO)
def test_device_body_equals_reference_over_zoo_compaction_on(scenario):
    body, rungs = _check(scenario, "on")
    assert len(rungs) == int(body.dirty.sum())
    if scenario == "flap":  # a compacted rung, not only the dense one
        assert any(0 <= r < 3 for r in rungs), rungs
