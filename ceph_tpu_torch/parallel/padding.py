"""Axis padding for sharded operands (numpy host code, a copy of the
reference package's).

A mesh splits an axis evenly over its ranks, so the axis must divide
the world size exactly; real operands (a pattern group's ``n_pgs *
chunk`` byte axis, an odd-sized object batch) rarely oblige.  These
helpers round an axis up to a device multiple with zeros and trim the
result back.  Zero fill is exact for the GF(2^8) decode path — every
table lookup of byte 0 is 0, so padded columns decode to 0 and carry
no information into the real columns (byte lanes are independent).
"""

from __future__ import annotations

import numpy as np


def padded_size(size: int, multiple: int) -> int:
    """``size`` rounded up to the next multiple of ``multiple``."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return -(-size // multiple) * multiple


def pad_to_multiple(
    arr: np.ndarray, multiple: int, axis: int = -1
) -> tuple[np.ndarray, int]:
    """Zero-pad ``arr`` along ``axis`` to a multiple of ``multiple``.

    Returns ``(padded, original_size)`` — the original size is what
    :func:`trim_to_size` needs to undo the padding.  No copy when the
    axis already divides evenly.
    """
    size = arr.shape[axis]
    target = padded_size(size, multiple)
    if target == size:
        return arr, size
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - size)
    return np.pad(arr, widths), size


def trim_to_size(arr: np.ndarray, size: int, axis: int = -1) -> np.ndarray:
    """Drop the padding :func:`pad_to_multiple` added along ``axis``."""
    if arr.shape[axis] == size:
        return arr
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(0, size)
    return arr[tuple(sl)]
