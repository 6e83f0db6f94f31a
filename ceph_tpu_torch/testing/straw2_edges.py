"""Edge inputs for the straw2 kernels K1 (negdraw) and K3 (descend_fused).

``chip_smoke.py``'s kernels phase and the card tests hold each kernel
against its plain version on these, bit for bit.  Every case is made
from a seed with numpy and placed on ``device``:

- K1: fanout 1, 2, an odd fanout (5), 33 and 32 (the paired path), zero
  weights mid-row, weights 1 and 0xFFFFFFFF in most rows, rows 4 bytes
  past a 16-byte boundary (the slot-by-slot path), and a batch of 4099
  rows (not a multiple of a 256-thread block);
- K3: one level of fanout 1, 5 and 33 with the same weights and some
  empty rows, under ``empty_is_hard`` both ways, and a flat root of
  12000 OSDs whose tables outgrow shared memory (the global-memory path).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import hashes, straw2

ROWS = 4099  # not a multiple of the kernels' 256-thread block
EDGE_WEIGHTS = (1, 0xFFFFFFFF)


def _weights(rng, rows: int, fanout: int) -> np.ndarray:
    """u32 weights with zeros mid-row, 1 first and 0xFFFFFFFF last."""
    w = rng.integers(0, 1 << 32, (rows, fanout), dtype=np.uint64)
    w[:, fanout // 2] = 0
    w[:, 0] = EDGE_WEIGHTS[0]
    w[:, -1] = EDGE_WEIGHTS[1] if fanout > 1 else w[:, -1]
    w[1::3, (fanout - 1) // 3] = 0
    return w.astype(np.uint32)


def _i32(a: np.ndarray, device, offset: int = 0) -> torch.Tensor:
    """An int32 tensor of ``a``'s bits, ``offset`` elements into its storage."""
    flat = np.zeros(a.size + offset, np.uint32)
    flat[offset:] = a.reshape(-1)
    return torch.from_numpy(flat.view(np.int32)).to(device)[offset:].view(a.shape)


def _i64(a: np.ndarray, device, offset: int = 0) -> torch.Tensor:
    flat = np.zeros(a.size + offset, np.uint64)
    flat[offset:] = a.reshape(-1)
    return torch.from_numpy(flat.view(np.int64)).to(device)[offset:].view(a.shape)


def negdraw_edges(device, seed: int = 20261017) -> list[tuple[str, tuple]]:
    """(label, (x, r, ids, weights, magic)) for K1."""
    rng = np.random.default_rng(seed)
    cases = []
    for fanout, offset in ((1, 0), (5, 0), (33, 0), (32, 0), (32, 1), (2, 0)):
        x = rng.integers(0, 1 << 32, ROWS, dtype=np.uint64).astype(np.uint32)
        r = rng.integers(0, 50, ROWS, dtype=np.uint32)
        ids = rng.integers(0, 1 << 32, (ROWS, fanout), dtype=np.uint64).astype(np.uint32)
        w = _weights(rng, ROWS, fanout)
        magic = hashes.magic_reciprocal(w)
        label = f"negdraw fanout={fanout} rows={ROWS}"
        if offset:
            label += " rows 4 bytes past a 16-byte boundary"
        cases.append((label, (_i32(x, device), _i32(r, device), _i32(ids, device, offset),
                              _i32(w, device, offset), _i64(magic, device, offset))))
    return cases


def _one_level(rng, nb: int, fanout: int, max_devices: int):
    ids = rng.integers(0, max_devices, (nb, fanout), dtype=np.uint32)
    w = _weights(rng, nb, fanout)
    sizes = np.full(nb, fanout, np.uint32)
    sizes[::5] = 0           # empty rows
    sizes[1::7] = max(fanout // 2, 1)  # rows shorter than the fanout
    w[np.arange(fanout)[None, :] >= sizes[:, None]] = 0  # padded as the packer pads
    zero = np.zeros((nb, fanout), np.uint32)
    return (ids, w, zero, zero, sizes)


def descend_edges(device, seed: int = 20261017) -> list[tuple[str, tuple]]:
    """(label, (x, r, lidx0, active, tables, target_type, empty_is_hard,
    max_devices)) for K3."""
    from ..crush import interp_batch
    from ..models.clusters import build_flat

    rng = np.random.default_rng(seed)
    cases = []
    lanes = lambda n: (
        torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
                         .view(np.int32)).to(device),
        torch.from_numpy(rng.integers(0, 50, n, dtype=np.int32)).to(device))
    for fanout in (1, 5, 33):
        nb, max_devices = 37, 1000
        tb = straw2.pack_descend_tables([_one_level(rng, nb, fanout, max_devices)], device)
        x, r = lanes(ROWS)
        lidx = torch.from_numpy(rng.integers(0, nb, ROWS, dtype=np.int32)).to(device)
        active = torch.from_numpy(rng.random(ROWS) < 0.9).to(device)
        for hard in (False, True):
            cases.append((f"descend fanout={fanout} empty_is_hard={hard}",
                          (x, r, lidx, active, tb, 0, hard, max_devices)))
    dense = build_flat(12000).to_dense()
    tb, _ = interp_batch.build_pack(dense, [0], 0, {}, device)
    x, r = lanes(2053)
    zero = torch.zeros_like(x)
    cases.append(("descend flat 12000 OSDs (global-memory tables)",
                  (x, r, zero, torch.ones_like(x, dtype=torch.bool), tb, 0, False, 12000)))
    return cases
