"""Fused placement->peering pipeline: one program from PG seeds to flags.

The counterpart of the reference package's ``recovery/pipeline.py``.
The staged peering pass (:meth:`~ceph_tpu_torch.recovery.peering.
PeeringEngine.run_staged`) maps the previous epoch, maps the current one
and classifies the diff, three steps driven from Python, each CRUSH
retry round a host read.  Here the whole chain -- pps seeds -> CRUSH ->
upmap/up-set/primary/affinity/temp post-processing for BOTH epochs ->
state flags and survivor bitmask -- is one program
(:class:`FusedPeering`):

- on the card it is one CUDA graph (:mod:`ceph_tpu_torch.core.graphs`),
  captured on the first call for its key and replayed for every later
  one: the retry ladders' later rounds are a WHILE node on a device
  condition, so a replay reads nothing back and no Python runs between
  its launches.  The first call runs the program once eagerly (the warm-up: kernels
  built, tables uploaded), then captures it into static input buffers.
  Every call copies its inputs into those buffers, replays, and returns
  copies of the outputs (a later replay overwrites the graph's own).
  The previous epoch's up/up_primary/acting_primary are not returned.
- on the CPU the same program runs eagerly, with the kernels' plain
  versions; under another capture (the compiled epoch superstep of
  :mod:`ceph_tpu_torch.recovery.superstep`) it runs inline, into that
  graph.

Programs are memoized in a :class:`PipelineCache`.  The key is
:func:`ceph_tpu_torch.osdmap.mapping.pool_program_key` (CRUSH program
signature, pool constants, kernel mode), the device, and what the CRUSH
program bakes in beyond its signature (the general engine's level
bounds); a program's graphs are keyed further by every shape and dtype
of its inputs and by ``min_size``.  Incremental map epochs, which change
only state tensors, hit one entry and replay one graph; a map object
with the same key has its CRUSH tables copied into the graph's buffers.

Only the reference's two routes stay staged: a map on the host C++
CRUSH tier (:func:`compile_fused_peering` returns ``(None, None)``) and
``CEPH_TPU_FUSED_PIPELINE=0``.  Anything else that stops a capture (a
host read, a runtime without conditional nodes) raises.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from collections import OrderedDict

import torch

from .. import resolve_device
from ..crush.interp import StaticCrushMap, program_constants
from ..osdmap.mapping import compile_pool_mapping, pool_program_key


def fused_pipeline_enabled() -> bool:
    """Whether peering may use the fused pipeline at all
    (``CEPH_TPU_FUSED_PIPELINE=0`` pins the staged path)."""
    return os.environ.get("CEPH_TPU_FUSED_PIPELINE", "1") != "0"


class PipelineCache:
    """Fused-pipeline cache, one entry per key (see the module
    docstring): equal-key epochs reuse one program and its graphs.
    ``max_entries`` bounds the LRU (0 = unbounded); evicting an entry
    frees its graphs and their buffers."""

    def __init__(self, max_entries: int = 0):
        self.max_entries = int(max_entries)
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key, build):
        """Fetch the pipeline for ``key``, building (and counting) once;
        refreshes the key's LRU position and evicts past the bound."""
        fn = self._entries.get(key)
        if fn is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return fn
        self.misses += 1
        fn = self._entries[key] = build()
        if self.max_entries > 0:
            while len(self._entries) > self.max_entries:
                _, old = self._entries.popitem(last=False)
                release = getattr(old, "release", None)
                if release is not None:
                    release()
                self.evictions += 1
        return fn

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }


#: entries :data:`PIPELINES` keeps.  The reference's cache is unbounded,
#: its entries compiled programs; here an entry on the card holds its
#: graphs' buffers and memory pools (:meth:`FusedPeering.device_bytes`),
#: so a long-lived process over many pool geometries is bounded.
PIPELINES_MAX_ENTRIES = 32

#: process-wide cache (the ScheduleCache analog for placement programs)
PIPELINES = PipelineCache(PIPELINES_MAX_ENTRIES)


def dump_placement_caches() -> dict:
    """Admin-socket hook body: the process-global caches the placement
    path builds -- the fused-peering :data:`PIPELINES` cache and the EC
    schedule cache's aggregate (hit/miss/eviction counters)."""
    from ..ec.schedule import schedule_counters

    sched = schedule_counters().dump().get("ec_schedule", {})
    return {
        "pipeline": PIPELINES.stats(),
        "schedule": {
            "hits": int(sched.get("schedule_cache_hits", 0)),
            "misses": int(sched.get("schedules_compiled", 0)),
            "evictions": int(sched.get("schedule_cache_evictions", 0)),
        },
    }


# ---------------------------------------------------------------- static buffers
# A program's inputs are tensors, PoolMapStates (dataclasses of tensors),
# tuples of them, and the CRUSH argument (stacked straw2 tables or the
# general engine's map, each class naming its tensors in ``TENSORS``),
# walked in a fixed order.


def _leaves(obj) -> list:
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _leaves(o)]
    if dataclasses.is_dataclass(obj):
        return [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    return [getattr(obj, a) for a in type(obj).TENSORS]


def _clone(obj):
    """A copy of ``obj`` with every tensor cloned (the graph's buffers)."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_clone(o) for o in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).clone()
                                           for f in dataclasses.fields(obj)})
    out = copy.copy(obj)
    for a in type(obj).TENSORS:
        setattr(out, a, getattr(obj, a).clone())
    return out


def _copy_into(dst, src) -> None:
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        d.copy_(s)


def _shapes(obj) -> tuple:
    return tuple((tuple(t.shape), t.dtype, str(t.device)) for t in _leaves(obj))


def _bytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(obj))


class _Captured:
    """One graph of a program, with the buffers it reads."""

    def __init__(self, static, graph):
        self.static = static      # (crush_arg, *inputs), graph-owned
        self.graph = graph
        self.crush_arg = None     # the caller's crush_arg last copied in
        self.static_bytes = _bytes(static)


def peer_current(map_fn, crush_arg, state, prev_acting, pg_indices, min_size: int, k: int):
    """One epoch's pool state mapped (``map_fn``, the program of
    :func:`~ceph_tpu_torch.osdmap.mapping.compile_pool_mapping`),
    classified against ``prev_acting`` and reduced to the PG-state
    histogram: ``(up, up_primary, acting, acting_primary, flags,
    survivor_mask, n_alive, pg_hist, pg_aux)``.  The epoch loop's dense
    dirty branch, eagerly; :meth:`FusedPeering.peer_hist` captures it."""
    from ..obs.pg_states import pg_state_reduce
    from .peering import classify_rows

    up, upp, acting, actp = map_fn(crush_arg, state, pg_indices)
    flags, mask, n_alive = classify_rows(prev_acting, up, acting, min_size)
    hist, aux = pg_state_reduce(mask, n_alive, flags, k, acting.shape[1])
    return up, upp, acting, actp, flags, mask, n_alive, hist, aux


class FusedPeering:
    """The fused program of one pipeline key and its CUDA graphs.

    ``fn(crush_arg, state_prev, state_cur, pg_indices, min_size) -> (up,
    up_primary, acting, acting_primary, prev_acting, flags,
    survivor_mask, n_alive)``: the current epoch's mapping and the
    classifier's outputs, with the previous epoch's acting table.
    :meth:`peer_hist` is its current-epoch half, which the epoch loop
    runs against a fixed baseline."""

    def __init__(self, map_fn, device):
        self._map_fn = map_fn  # compile_pool_mapping's program
        self.device = device
        self._graphs: dict = {}
        self.captures = 0
        self.replays = 0

    # -- the programs (eager) ------------------------------------------

    def program(self, crush_arg, state_prev, state_cur, pg_indices, min_size: int):
        """Both epochs and the classifier, run eagerly."""
        from .peering import classify_rows

        _pup, _pupp, prev_acting, _pactp = self._map_fn(crush_arg, state_prev, pg_indices)
        up, upp, acting, actp = self._map_fn(crush_arg, state_cur, pg_indices)
        flags, mask, n_alive = classify_rows(prev_acting, up, acting, min_size)
        return up, upp, acting, actp, prev_acting, flags, mask, n_alive

    def current(self, crush_arg, state, prev_acting, pg_indices, min_size: int, k: int):
        """:func:`peer_current` with this program's mapping, eagerly."""
        return peer_current(self._map_fn, crush_arg, state, prev_acting, pg_indices,
                            min_size, k)

    # -- the calls -----------------------------------------------------

    def __call__(self, crush_arg, state_prev, state_cur, pg_indices, min_size: int):
        from ..core import graphs

        min_size = int(min_size)
        if not pg_indices.is_cuda or graphs.capturing(pg_indices):
            return self.program(crush_arg, state_prev, state_cur, pg_indices, min_size)
        return self._replay(("peer", min_size), crush_arg, (state_prev, state_cur, pg_indices),
                            lambda c, sp, sc, pgs: self.program(c, sp, sc, pgs, min_size))

    def peer_hist(self, crush_arg, state, prev_acting, pg_indices, min_size: int, k: int):
        """:meth:`current`, through its own graph on the card; inline
        while another graph is captured (the compiled epoch superstep's
        dense branch), whose capture then holds the program."""
        from ..core import graphs

        min_size, k = int(min_size), int(k)
        if not pg_indices.is_cuda or graphs.capturing(pg_indices):
            return self.current(crush_arg, state, prev_acting, pg_indices, min_size, k)
        return self._replay(("hist", min_size, k), crush_arg, (state, prev_acting, pg_indices),
                            lambda c, st, pa, pgs: self.current(c, st, pa, pgs, min_size, k))

    def _replay(self, consts, crush_arg, inputs, program):
        from ..core import graphs

        key = (consts, _shapes(crush_arg), _shapes(inputs))
        g = self._graphs.get(key)
        if g is None:
            static = (_clone(crush_arg),) + _clone(inputs)
            program(*static)  # the warm-up
            g = _Captured(static, graphs.capture(lambda: program(*static),
                                                 inputs[-1].device))
            g.crush_arg = crush_arg
            self._graphs[key] = g
            self.captures += 1
        elif g.crush_arg is not crush_arg:
            _copy_into(g.static[0], crush_arg)
            g.crush_arg = crush_arg
        _copy_into(g.static[1:], inputs)
        outs = g.graph.replay()
        self.replays += 1
        return tuple(o.clone() for o in outs)

    def graphs(self) -> list:
        """The captured :class:`~ceph_tpu_torch.core.graphs.Graph` s."""
        return [g.graph for g in self._graphs.values()]

    def device_bytes(self) -> int:
        """Device memory the program's graphs hold: their static input
        buffers and the memory their captures reserved."""
        return sum(g.static_bytes + g.graph.pool_bytes for g in self._graphs.values())

    def release(self) -> None:
        """Free every graph and its buffers."""
        for g in self._graphs.values():
            g.graph.release()
        self._graphs.clear()


def compile_fused_peering(dense, pool, rule, cache: PipelineCache | None = None,
                          mode: str | None = None, device="cuda"):
    """Build (or fetch) the fused peering program for one pool.

    Returns ``(crush_arg, fn)`` with ``fn(crush_arg, state_prev,
    state_cur, pg_indices, min_size) -> (up, up_primary, acting,
    acting_primary, prev_acting, flags, survivor_mask, n_alive)`` on
    ``device`` (a :class:`FusedPeering`).  Returns ``(None, None)`` when
    the map routes to the host C++ CRUSH tier or the fused pipeline is
    disabled; callers then take the staged path.
    """
    if not fused_pipeline_enabled():
        return None, None
    cache = PIPELINES if cache is None else cache
    key = pool_program_key(dense, pool, rule, mode)
    if key[0][0] == "host":
        return None, None
    dev = resolve_device(device)
    crush_arg, map_fn = compile_pool_mapping(dense, pool, rule, mode, dev)
    baked = (program_constants(crush_arg, rule) if isinstance(crush_arg, StaticCrushMap)
             else ())

    def build():
        return FusedPeering(map_fn, dev)

    return crush_arg, cache.get((key, str(dev), baked), build)
