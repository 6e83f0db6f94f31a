"""Multi-device recovery: pattern-group decodes sharded over the mesh.

The counterpart of the reference package's ``recovery/sharded.py``.
The single-device executor collapses a rack failure into one decode
launch per erasure pattern, but each launch runs on ONE device while the
rest of the world idles.  This module spreads a pattern group's
``[k, n_pgs * chunk]`` operand along the byte axis over the ranks of a
:class:`~ceph_tpu_torch.parallel.mesh.Mesh`:

- every rank holds the whole operand on the host (each read it through
  the same ``read_shard``) and the group's repair tables, a few KiB;
- each rank decodes only its contiguous slice of the byte axis through
  K4 (:func:`ceph_tpu_torch.ec.gf_kernels.matrix_encode`, through a
  :class:`~ceph_tpu_torch.ec.backend.TableEncoder` of the repair matrix;
  the plain version on the CPU) — per-PG columns are independent in
  GF(2^8), so a slice boundary can fall anywhere, even mid-chunk;
- the recovered-byte and shards-rebuilt counters are summed over the
  ranks, so every rank observes the same global progress;
- with ``gather``, the ranks' slices are all-gathered along the byte
  axis, so every rank can commit the rebuilt bytes.

Group widths that don't divide the world size are zero-padded to a
rank multiple (:mod:`ceph_tpu_torch.parallel.padding`; a zero byte
decodes to zero and never leaks into real columns) and trimmed on the
way back; the counters use the *unpadded* width so padding never
inflates progress.  A rank's slice of an uneven width may miss K4's TMA
alignment, and then takes the kernel's unaligned variant.

This static split is also the *bit-equality reference* for the
work-stealing dispatcher (:mod:`ceph_tpu_torch.recovery.dispatch`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..analysis import runtime_guard
from ..ec.backend import TableEncoder
from ..parallel.padding import pad_to_multiple, trim_to_size

I64 = torch.int64


def sharded_decode_step(mesh, gather: bool = False):
    """Build the sharded decode:
    ``f(enc, src, valid, chunk) -> (out, bytes_rebuilt, shards_rebuilt)``.

    ``enc`` is the group's :class:`TableEncoder` on the rank's device
    (K4's operand); ``src`` the ``[k, W]`` u8 survivor operand, padded so
    ``W`` divides the world size (every rank passes the same); ``valid``
    the un-padded payload width and ``chunk`` the per-PG chunk size.

    ``out`` is this rank's ``[n_missing, W / size]`` slice on its device
    — the whole ``[n_missing, W]`` with ``gather``.  ``bytes_rebuilt``
    and ``shards_rebuilt`` are int64 tensors summed over the ranks."""
    size, rank = mesh.size, mesh.rank

    def step(enc, src, valid: int, chunk: int):
        width = src.shape[1]
        if width % size:
            raise ValueError(f"sharded decode: width {width} does not divide over {size} ranks")
        w = width // size
        start = rank * w
        out = enc.encode_async(src[:, start:start + w])
        # this rank owns columns [rank * w, (rank + 1) * w) of the padded
        # width; clip against the valid prefix so padding never counts
        valid_here = min(max(int(valid) - start, 0), w)
        n_missing = enc.m
        bytes_rebuilt = mesh.psum(torch.tensor(valid_here * n_missing, dtype=I64,
                                               device=mesh.device))
        shards_rebuilt = bytes_rebuilt // max(int(chunk), 1)
        if gather:
            out = mesh.all_gather(out, dim=1)
        return out, bytes_rebuilt, shards_rebuilt

    return step


class ShardedDecoder:
    """Pattern-group decodes over a mesh, with padding.

    One instance per executor, which passes each group's repair encoder
    (K4's product and nibble tables on the rank's device, cached by
    survivor mask in the executor's encoder cache).  ``gather`` (the
    default) all-gathers every decode's output, so :meth:`fetch` gives
    every rank the whole group; without it each rank fetches its own
    columns (the reference's sharded output layout)."""

    def __init__(self, mesh, axis: str | None = None, gather: bool = True):
        self.mesh = mesh
        self.axis = axis or mesh.axis_names[0]
        self.gather = bool(gather)
        self.n_devices = mesh.size
        self._step = sharded_decode_step(mesh, gather=self.gather)

    def decode_async(self, enc: TableEncoder, src: np.ndarray, chunk: int):
        """Dispatch one sharded decode without a host sync.

        ``src`` is ``[k, width]`` u8 with any width — zero-padded here to
        a rank multiple.  Returns ``(out, bytes_rebuilt, shards_rebuilt,
        valid)``; pass ``out``/``valid`` to :meth:`fetch` for the trimmed
        host bytes."""
        padded, valid = pad_to_multiple(np.asarray(src, np.uint8), self.n_devices, axis=1)
        if runtime_guard.rank_checks_enabled():
            runtime_guard.assert_rank_identical(
                "sharded_decode", enc.matrix, padded, np.int64(int(chunk)),
                mesh=self.mesh, axis=self.axis)
        out, nbytes, shards = self._step(enc, padded, valid, chunk)
        return out, nbytes, shards, valid

    def decode(self, enc: TableEncoder, src: np.ndarray, chunk: int):
        """Synchronous decode: ``(out, bytes_rebuilt, shards_rebuilt)``,
        ``out`` the host bytes with the padding trimmed."""
        out, nbytes, shards, valid = self.decode_async(enc, src, chunk)
        return self.fetch(out, valid), int(nbytes), int(shards)

    def fetch(self, out: torch.Tensor, valid: int) -> np.ndarray:
        """One decode's output as host bytes, the padding trimmed: the
        whole ``[n_missing, valid]`` with ``gather``, else this rank's
        columns that fall inside ``valid``."""
        host = out.cpu().numpy()
        if self.gather:
            return trim_to_size(host, valid, axis=1)
        w = host.shape[1]
        return host[:, :max(0, min(w, valid - self.mesh.rank * w))]
