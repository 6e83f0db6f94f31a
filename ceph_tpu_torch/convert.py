"""Carry map and codec state across from the reference package.

Each function takes the reference's own serialized forms (a plain dict,
bytes or numpy arrays), so the port imports nothing from it:

- :func:`crushmap_from_reference` takes ``CrushMap.to_obj()``;
- :func:`osdmap_from_reference` takes ``OSDMap.encode()``;
- :func:`ec_codec_from_reference` takes a codec's (or a decoder's)
  numpy state: ``matrix`` or ``bitmatrix``, ``w``, ``packetsize``,
  ``technique``;
- :func:`plan_from_reference` takes a ``RecoveryPlan`` (its fields are
  ints, tuples and numpy arrays).

The result computes on the same state: same bucket ids and weights,
rules, tunables, choose_args, shadow trees, OSD states and overrides;
the same coding matrices.

State crosses in both directions as **lanes**, the checkpoint file's
unit: one array a leaf in the reference's flatten order and dtype
(:func:`state_lanes`, :func:`state_from_lanes`; a ``ClusterState``,
stacked or not, a ``StripeBufferState``, a ``FlightState``, or a tuple
of them).  The port's carriers differ where torch lacks the type: u32
lanes ride int64 (``primary_affinity``, ``checksums``) or int32 (the
pool's weights, the stripe words and dirty masks), the u64 survivor mask
int64, and ``n_alive``/``pg_hist`` (int64 in the reference under x64)
int32.  A lane is written in the reference's dtype and read back into
the port's carrier; :func:`state_lanes` takes a ``ClusterState``'s 0-d
scalars from the epoch loop's host view when one is given.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .crush.map import CrushMap
from .osdmap.map import OSDMap


def crushmap_from_reference(obj: dict) -> CrushMap:
    """The port's :class:`CrushMap` from a reference ``to_obj()`` dict."""
    return CrushMap.from_obj(copy.deepcopy(obj))


def osdmap_from_reference(data: bytes) -> OSDMap:
    """The port's :class:`OSDMap` from a reference ``encode()`` blob."""
    return OSDMap.decode(bytes(data))


def ec_codec_from_reference(state: dict, device="cuda"):
    """The port's :class:`~.ec.backend.MatrixCodec` (``state["matrix"]``,
    GF(2^8), with ``technique`` "table" or "bitmatrix") or
    :class:`~.ec.backend.BitmatrixCodec` (``state["bitmatrix"]``, GF(2),
    word size ``w``) on ``device``.  Its ``encode`` applies the same
    product as the reference codec or decoder the state came from."""
    from .ec.backend import BitmatrixCodec, MatrixCodec

    packetsize = int(state.get("packetsize", 64))
    if state.get("matrix") is not None:
        return MatrixCodec(np.asarray(state["matrix"], np.uint8),
                           state.get("technique", "table"), packetsize, device)
    return BitmatrixCodec(np.asarray(state["bitmatrix"], np.uint8), int(state["w"]),
                          packetsize, device)


def plan_from_reference(plan):
    """The port's :class:`~.recovery.planner.RecoveryPlan` from a
    reference one: the same groups in the same order, with the same
    masks, shard tuples, PG arrays and repair (bit)matrices, so the
    port's executor runs the identical repairs."""
    from .recovery.planner import PatternGroup, RecoveryPlan

    def arr(a):
        return None if a is None else np.array(a, copy=True)

    groups = [
        PatternGroup(
            mask=int(g.mask),
            survivors=tuple(int(s) for s in g.survivors),
            rows=tuple(int(s) for s in g.rows),
            missing=tuple(int(s) for s in g.missing),
            pgs=np.array(g.pgs, copy=True),
            repair_matrix=arr(g.repair_matrix),
            repair_bitmatrix=arr(g.repair_bitmatrix),
            w=int(g.w),
            packetsize=int(g.packetsize),
        )
        for g in plan.groups
    ]
    return RecoveryPlan(k=int(plan.k), m=int(plan.m), groups=groups,
                        unrecoverable=np.array(plan.unrecoverable, copy=True))


# ---------------------------------------------------------------------------
# state lanes (the checkpoint format)

_U32, _U64, _I32, _I64 = np.uint32, np.uint64, np.int32, np.int64
_F32, _F64, _BOOL = np.float32, np.float64, np.bool_

#: PoolMapState leaves in the reference's order and dtypes
_POOL_LANES = (("osd_weight", _U32), ("osd_up", _BOOL), ("osd_exists", _BOOL),
               ("primary_affinity", _U32), ("upmap_full", _I32), ("has_upmap", _BOOL),
               ("upmap_items", _I32), ("n_upmap_items", _I32), ("pg_temp", _I32),
               ("n_pg_temp", _I32), ("primary_temp", _I32))
#: ClusterState leaves after the pool's (``checksums`` only when set)
_STATE_LANES = (("last_ack", _F32), ("laggy", _F32), ("markdowns", _F32), ("down", _BOOL),
                ("down_since", _F32), ("suppressed", _BOOL), ("slow", _BOOL),
                ("out", _BOOL), ("reporters", _I32), ("up", _I32), ("up_primary", _I32),
                ("acting", _I32), ("acting_primary", _I32), ("flags", _I32),
                ("survivor_mask", _U64), ("n_alive", _I64), ("pg_hist", _I64),
                ("pg_aux", _I32), ("checksums", _U32))
_SCALAR_LANES = (("epoch", _I32), ("now", _F64), ("last_tick", _F64),
                 ("tape_cursor", _I32), ("step", _I32))
_BUFFER_LANES = (("keys", _I32), ("data", _U32), ("parity", _U32), ("dirty", _U32),
                 ("lru", _I32), ("tick", _I32), ("totals", _I64))
_FLIGHT_LANES = (("ring", _I64), ("head", _I64))

#: the torch dtype whose bits a reference dtype's bytes are read as
_BITS = {np.dtype(_U32): torch.int32, np.dtype(_U64): torch.int64,
         np.dtype(_I32): torch.int32, np.dtype(_I64): torch.int64,
         np.dtype(_F32): torch.float32, np.dtype(_F64): torch.float64,
         np.dtype(_BOOL): torch.bool}


def _leaves(obj, host=None) -> list:
    """``[(value, reference dtype, setter)]`` of ``obj``'s lanes in the
    reference's order: value a tensor (or a host number from ``host``),
    setter rebuilding ``obj`` kind by kind in :func:`_rebuild`."""
    from .core.cluster_state import ClusterState
    from .ec.online import StripeBufferState
    from .obs.flight import FlightState

    if isinstance(obj, tuple):
        return [leaf for o in obj for leaf in _leaves(o, host)]
    if isinstance(obj, ClusterState):
        out = [(getattr(obj.pool, f), dt) for f, dt in _POOL_LANES]
        out += [(getattr(obj, f), dt) for f, dt in _STATE_LANES
                if getattr(obj, f) is not None]
        if host is None:
            out += [(getattr(obj, f), dt) for f, dt in _SCALAR_LANES]
        else:
            out += [(host.epoch, _I32), (host.now, _F64), (host.last_tick, _F64),
                    (host.cursor, _I32), (host.step, _I32)]
        return out
    if isinstance(obj, StripeBufferState):
        return [(getattr(obj, f), dt) for f, dt in _BUFFER_LANES]
    if isinstance(obj, FlightState):
        return [(getattr(obj, f), dt) for f, dt in _FLIGHT_LANES]
    raise TypeError(f"no lanes for {type(obj).__name__}")


def lane_specs(obj) -> list[tuple[np.dtype, tuple]]:
    """Each lane's reference dtype and shape (no data moves)."""
    return [(np.dtype(dt), tuple(v.shape) if isinstance(v, torch.Tensor) else ())
            for v, dt in _leaves(obj)]


def _to_reference_bits(v, dt, device) -> torch.Tensor:
    """One lane as a tensor holding the reference dtype's bits (u32 as
    int32 bits, u64 as int64)."""
    dt = np.dtype(dt)
    if not isinstance(v, torch.Tensor):
        return torch.full((), v, dtype=_BITS[dt], device=device)
    if dt == np.dtype(_U32) and v.dtype == torch.int64:
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return v.to(_BITS[dt])


def lane_bytes(obj, host=None, device=None) -> list[torch.Tensor]:
    """Each lane's bytes in the reference dtype, as flat uint8 tensors on
    ``obj``'s device."""
    leaves = _leaves(obj, host)
    if device is None:
        device = next(v.device for v, _dt in leaves if isinstance(v, torch.Tensor))
    out = []
    for v, dt in leaves:
        dev = v.device if isinstance(v, torch.Tensor) else device
        t = _to_reference_bits(v, dt, dev).contiguous()
        out.append(t.reshape(-1).view(torch.uint8) if t.numel() else
                   torch.zeros(0, dtype=torch.uint8, device=dev))
    return out


def state_lanes(obj, host=None) -> list[np.ndarray]:
    """``obj``'s lanes as host arrays in the reference's dtypes (the
    arrays its flatten gives, ``jax.device_get``-ed)."""
    out = []
    for (v, dt), b in zip(_leaves(obj, host), lane_bytes(obj, host, torch.device("cpu"))):
        shape = tuple(v.shape) if isinstance(v, torch.Tensor) else ()
        out.append(b.cpu().numpy().view(np.dtype(dt)).reshape(shape))
    return out


def _carrier(bits: torch.Tensor, dt, like: torch.Tensor) -> torch.Tensor:
    """A lane read as its reference dtype's bits -> the port's carrier
    (``like``'s dtype)."""
    if np.dtype(dt) == np.dtype(_U32) and like.dtype == torch.int64:
        return bits.to(torch.int64) & 0xFFFFFFFF
    return bits.to(like.dtype)


def _rebuild(template, it):
    from dataclasses import replace

    from .core.cluster_state import ClusterState
    from .ec.online import StripeBufferState
    from .obs.flight import FlightState

    def take(like, dt):
        return _carrier(next(it), dt, like)

    if isinstance(template, tuple):
        return tuple(_rebuild(t, it) for t in template)
    if isinstance(template, ClusterState):
        pool = replace(template.pool, **{
            f: take(getattr(template.pool, f), dt) for f, dt in _POOL_LANES})
        kw = {f: take(getattr(template, f), dt) for f, dt in _STATE_LANES
              if getattr(template, f) is not None}
        kw.update({f: take(getattr(template, f), dt) for f, dt in _SCALAR_LANES})
        return replace(template, pool=pool, **kw)
    if isinstance(template, StripeBufferState):
        return StripeBufferState(**{f: take(getattr(template, f), dt)
                                    for f, dt in _BUFFER_LANES})
    if isinstance(template, FlightState):
        return FlightState(**{f: take(getattr(template, f), dt) for f, dt in _FLIGHT_LANES})
    raise TypeError(f"no lanes for {type(template).__name__}")


def _np_bits(a: np.ndarray) -> torch.Tensor:
    """A host lane as a tensor holding its dtype's bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a.copy())


def state_from_lanes(lanes, template, device=None):
    """Rebuild an object shaped like ``template`` from its lanes (host
    arrays in the reference's dtypes, or tensors holding those dtypes'
    bits) in the port's carriers, on ``device`` (host arrays; default
    the template's) or the lane tensors' device.  The caller checks
    dtypes and shapes against :func:`lane_specs`."""
    if device is None:
        device = next(v.device for v, _dt in _leaves(template) if isinstance(v, torch.Tensor))
    bits = []
    for a, (_dt, shape) in zip(lanes, lane_specs(template)):
        if isinstance(a, np.ndarray):
            a = _np_bits(a).to(device)
        bits.append(a.reshape(shape))
    return _rebuild(template, iter(bits))
