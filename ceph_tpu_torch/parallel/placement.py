"""Batch placement and the rebalance simulation on one device.

The counterpart of the reference package's ``parallel/placement.py``,
with its names: :func:`sharded_placement_step` places a batch of object
seeds and tallies a per-OSD histogram (the cluster-wide statistic the
reference gathers through its messenger and mgr aggregation path, and
that ``crushtool --test --show-statistics`` tallies serially), and
:func:`sharded_rebalance_sim` streams an object space through placement
before and after a failure and counts the objects that move (BASELINE
config 5).

Both take ``device=`` where the reference takes a mesh: the port runs on
one card, so the reference's ``psum`` over the mesh is the identity
here.  A mesh of cards (``torch.distributed`` and the cross-device sum)
waits for the multi-device slice of the port (ROADMAP section 1, item
5).  Each uses the best engine tier for the map
(:func:`ceph_tpu_torch.crush.engine.make_batch_runner`).
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..crush.engine import make_batch_runner
from ..crush.interp_batch import as_i32
from ..crush.map import ITEM_NONE, DenseCrushMap, Rule

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF


def sharded_placement_step(dense: DenseCrushMap, rule: Rule, result_max: int, device="cuda"):
    """Build ``step(osd_weight, xs) -> (results, lens, histogram)``.

    ``results`` [n, result_max] and ``lens`` [n] are int32 on ``device``;
    ``histogram`` [max_devices] int32 counts each OSD's placements, with
    ITEM_NONE (and any other entry that is no OSD) dropped."""
    dev = resolve_device(device)
    crush_arg, run = make_batch_runner(dense, rule, result_max, device=dev)
    n_osds = dense.max_devices

    def step(osd_weight, xs):
        results, lens = run(crush_arg, osd_weight, xs)
        chosen = results.reshape(-1).to(I64)
        chosen = chosen[(chosen >= 0) & (chosen < n_osds) & (chosen != ITEM_NONE)]
        hist = torch.bincount(chosen, minlength=n_osds)[:n_osds].to(I32)
        return results, lens, hist

    return step


def sharded_rebalance_sim(dense: DenseCrushMap, rule: Rule, result_max: int, chunk: int,
                          n_chunks: int, device="cuda"):
    """Build the rebalance step: ``f(w_before, w_after, start) -> moved``.

    One call places ``n_chunks`` chunks of ``chunk`` object seeds,
    ``start + k * chunk + arange(chunk)`` (u32, made on the device: no
    host-to-device traffic for objects), under the before- and
    after-failure weight vectors, and sums the objects whose placement
    changed (``any(rb != ra, dim=1)``) on the device; only the running
    count outlives a chunk.  ``moved`` is an int64 tensor on ``device``.
    """
    dev = resolve_device(device)
    crush_arg, run = make_batch_runner(dense, rule, result_max, device=dev)
    iota = torch.arange(chunk, dtype=I64, device=dev)

    def step(w_before, w_after, start):
        wb, wa = as_i32(w_before, dev), as_i32(w_after, dev)
        base = int(start) & M32
        moved = torch.zeros((), dtype=I64, device=dev)
        for k in range(n_chunks):
            xs = as_i32((iota + (base + k * chunk)) & M32, dev)
            rb, _ = run(crush_arg, wb, xs)
            ra, _ = run(crush_arg, wa, xs)
            moved += (rb != ra).any(dim=1).sum()
        return moved

    return step
