"""Batch placement and the rebalance simulation, on one device or a mesh.

The counterpart of the reference package's ``parallel/placement.py``,
with its names: :func:`sharded_placement_step` places a batch of object
seeds and tallies a per-OSD histogram (the cluster-wide statistic the
reference gathers through its messenger and mgr aggregation path, and
that ``crushtool --test --show-statistics`` tallies serially), and
:func:`sharded_rebalance_sim` streams an object space through placement
before and after a failure and counts the objects that move (BASELINE
config 5).

Both take a :class:`~ceph_tpu_torch.parallel.mesh.Mesh` first, as the
reference takes its mesh: each rank places its :func:`~ceph_tpu_torch.
parallel.multihost.local_shard` slice of the batch (or its own range of
the object space) on its device, and the histogram and the moved count
are summed over the ranks.  ``mesh=None`` runs on ``device`` alone.
Each uses the best engine tier for the map (:func:`ceph_tpu_torch.crush.
engine.make_batch_runner`): K3 on the fast engine's straw2 maps, K1 on
the general engine's straw2 levels.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..crush.engine import make_batch_runner
from ..crush.interp_batch import as_i32
from ..crush.map import ITEM_NONE, DenseCrushMap, Rule
from .mesh import Mesh, make_mesh

__all__ = ["make_mesh", "sharded_placement_step", "sharded_rebalance_sim"]

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF


def _mesh_device(mesh: Mesh | None, device) -> torch.device:
    return mesh.device if mesh is not None else resolve_device(device)


def sharded_placement_step(mesh: Mesh | None, dense: DenseCrushMap, rule: Rule,
                           result_max: int, axis: str | None = None, device="cuda",
                           gather: bool = False):
    """Build ``step(osd_weight, xs) -> (results, lens, histogram)``.

    ``xs`` is the global batch of object seeds (every rank passes the
    same one); a rank places its even share, ``xs[rank * n / size :
    (rank + 1) * n / size]`` (the batch must divide over the ranks, as
    the reference's sharded axis must).  ``results`` [n_local,
    result_max] and ``lens`` [n_local] are int32 on the rank's device —
    the whole batch's on every rank with ``gather``; ``histogram``
    [max_devices] int32 counts each OSD's placements over the whole
    batch, with ITEM_NONE (and any other entry that is no OSD) dropped,
    summed over the ranks."""
    dev = _mesh_device(mesh, device)
    crush_arg, run = make_batch_runner(dense, rule, result_max, device=dev)
    n_osds = dense.max_devices

    def step(osd_weight, xs):
        if mesh is not None:
            n = int(xs.shape[0])
            if n % mesh.size:
                raise ValueError(
                    f"global batch {n} must be divisible by the device count "
                    f"{mesh.size}; pad the operand to a device multiple "
                    f"(parallel.padding.pad_to_multiple), or trim the batch")
            per = n // mesh.size
            xs = xs[mesh.rank * per:(mesh.rank + 1) * per]
        results, lens = run(crush_arg, osd_weight, xs)
        chosen = results.reshape(-1).to(I64)
        chosen = chosen[(chosen >= 0) & (chosen < n_osds) & (chosen != ITEM_NONE)]
        hist = torch.bincount(chosen, minlength=n_osds)[:n_osds].to(I32)
        if mesh is not None:
            hist = mesh.psum(hist)
            if gather:
                results, lens = mesh.all_gather(results), mesh.all_gather(lens)
        return results, lens, hist

    return step


def sharded_rebalance_sim(mesh: Mesh | None, dense: DenseCrushMap, rule: Rule,
                          result_max: int, chunk: int, n_chunks: int,
                          axis: str | None = None, device="cuda"):
    """Build the rebalance step: ``f(w_before, w_after, start) -> moved``.

    One call places, on each rank, ``n_chunks`` chunks of ``chunk``
    object seeds, ``base + k * chunk + arange(chunk)`` with the
    reference's layout ``base = start + rank * chunk * n_chunks`` (u32,
    made on the device: no host-to-device traffic for objects), under
    the before- and after-failure weight vectors, and counts the objects
    whose placement changed (``any(rb != ra, dim=1)``) on the device;
    only the running count outlives a chunk.  ``moved`` is an int64
    tensor on the rank's device, summed over the ranks: the whole
    world's ``size * n_chunks * chunk`` objects.
    """
    dev = _mesh_device(mesh, device)
    crush_arg, run = make_batch_runner(dense, rule, result_max, device=dev)
    iota = torch.arange(chunk, dtype=I64, device=dev)
    rank = mesh.rank if mesh is not None else 0

    def step(w_before, w_after, start):
        wb, wa = as_i32(w_before, dev), as_i32(w_after, dev)
        base = (int(start) + rank * chunk * n_chunks) & M32
        moved = torch.zeros((), dtype=I64, device=dev)
        for k in range(n_chunks):
            xs = as_i32((iota + (base + k * chunk)) & M32, dev)
            rb, _ = run(crush_arg, wb, xs)
            ra, _ = run(crush_arg, wa, xs)
            moved += (rb != ra).any(dim=1).sum()
        return mesh.psum(moved) if mesh is not None else moved

    return step
