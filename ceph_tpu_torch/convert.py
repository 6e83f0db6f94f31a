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
"""

from __future__ import annotations

import copy

import numpy as np

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
