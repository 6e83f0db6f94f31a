"""Carry map state across from the reference package.

Both functions take the reference's own serialized forms (a plain dict
or bytes), so the port imports nothing from it:

- :func:`crushmap_from_reference` takes ``CrushMap.to_obj()``;
- :func:`osdmap_from_reference` takes ``OSDMap.encode()``.

The result computes on the same state: same bucket ids and weights,
rules, tunables, choose_args, shadow trees, OSD states and overrides.
"""

from __future__ import annotations

import copy

from .crush.map import CrushMap
from .osdmap.map import OSDMap


def crushmap_from_reference(obj: dict) -> CrushMap:
    """The port's :class:`CrushMap` from a reference ``to_obj()`` dict."""
    return CrushMap.from_obj(copy.deepcopy(obj))


def osdmap_from_reference(data: bytes) -> OSDMap:
    """The port's :class:`OSDMap` from a reference ``encode()`` blob."""
    return OSDMap.decode(bytes(data))
