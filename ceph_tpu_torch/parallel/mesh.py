"""The port's device mesh: one process a rank over ``torch.distributed``.

The reference package's mesh is one controller over many devices
(``shard_map`` with ``psum``/``all_gather`` inside one program).  The
PyTorch idiom is one process a rank, each with its own device, joined by
a process group: :class:`Mesh` is that rank's handle on the world.  It
carries the group (``None`` for a world of one where no group was
formed), this rank's index and device, the world size, and the
collectives the reference's mesh programs use:

- :meth:`Mesh.psum` — an integer sum over ranks (``all_reduce``);
- :meth:`Mesh.psum_ordered` — a floating-point sum in rank order (an
  ``all_gather``, then the partials added rank 0 first), so every rank
  and every run rounds alike; ``all_reduce`` leaves the order to the
  backend;
- :meth:`Mesh.pmax` / :meth:`Mesh.pmin` — element-wise max / min;
- :meth:`Mesh.all_gather` — the ranks' tensors concatenated along a
  dimension (the reference's ``all_gather(..., tiled=True)``), and
  :meth:`Mesh.gather_stack`, stacked along a new leading one;
- :meth:`Mesh.axis_index` — this rank.

``bool`` tensors travel as ``uint8`` (no backend reduces bools), and u32
values ride in int64 as everywhere in the port.  A world formed on the
card takes ``nccl``, on the CPU ``gloo``; :func:`make_mesh` refuses a
device the group's backend cannot serve rather than quietly moving the
tensors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import resolve_device

#: the backend each device type's process group must use
BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D world of ranks, one device a rank.

    ``group`` is the process group (``None``: a world of one with no
    group, where every collective is the identity); ``rank`` and
    ``size`` this rank's index and the world size; ``device`` this
    rank's device; ``axis_names`` the reference's mesh axis names."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_names: tuple = ("objects",)

    def axis_index(self) -> int:
        return self.rank

    # -- collectives ---------------------------------------------------

    def _wire(self, t: torch.Tensor) -> tuple[torch.Tensor, torch.dtype]:
        """``t`` on this rank's device, contiguous, bools as uint8."""
        dtype = t.dtype
        t = t.to(self.device)
        if dtype == torch.bool:
            t = t.to(torch.uint8)
        return t.contiguous(), dtype

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        shape = t.shape
        t, dtype = self._wire(t)
        if self.group is not None:
            t = t.reshape(-1).clone()
            dist.all_reduce(t, op=op, group=self.group)
        return t.reshape(shape).to(dtype)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks of an integer (or bool-as-count) tensor."""
        if t.dtype.is_floating_point:
            raise TypeError("psum sums integers; use psum_ordered for floats")
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def gather_stack(self, t: torch.Tensor) -> torch.Tensor:
        """``[size, *t.shape]``: every rank's tensor, rank 0 first.  Every
        rank must pass the same shape and dtype."""
        shape = t.shape
        t, dtype = self._wire(t)
        if self.group is None:
            return t.unsqueeze(0).to(dtype)
        flat = t.reshape(-1)
        parts = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(parts, flat, group=self.group)
        return torch.stack(parts).reshape((self.size, *shape)).to(dtype)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' tensors concatenated along ``dim``, rank 0 first."""
        stacked = self.gather_stack(t)
        return torch.cat(list(stacked.unbind(0)), dim=dim)

    def psum_ordered(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks added in rank order (rank 0's partial first):
        the floating-point sum every rank rounds alike."""
        stacked = self.gather_stack(t)
        out = stacked[0].clone()
        for r in range(1, self.size):
            out = out + stacked[r]
        return out

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def _rank_device(device, rank: int) -> torch.device:
    """``device`` resolved for this rank: a bare ``"cuda"`` is the card
    ``LOCAL_RANK`` names under torchrun (else the rank, modulo the
    cards on this host)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: int | None = None, axis: str = "objects", device="cuda") -> Mesh:
    """This rank's mesh over the whole world.

    The world is the default process group when one is formed
    (:func:`ceph_tpu_torch.parallel.multihost.init`, or ``torchrun``
    with ``init`` called), else a world of one with no group.
    ``n_devices`` must be None or the world size.  The group's backend
    must serve ``device`` (``nccl`` the card, ``gloo`` the CPU)."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        rank, size = dist.get_rank(), dist.get_world_size()
        dev = _rank_device(device, rank)
        backend = str(dist.get_backend(group))
        if backend != BACKEND_FOR[dev.type]:
            raise ValueError(
                f"make_mesh: the process group runs {backend}, which does not serve "
                f"{dev}; form the world with backend {BACKEND_FOR[dev.type]!r}")
    else:
        group, rank, size = None, 0, 1
        dev = _rank_device(device, rank)
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(
            f"make_mesh: asked for {int(n_devices)} devices, but the world has {size} "
            f"rank(s) of one device each")
    return Mesh(group, rank, size, dev, (axis,))
