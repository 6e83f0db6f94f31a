"""Forming the world: the process group behind :class:`~.mesh.Mesh`.

The counterpart of the reference package's ``parallel/multihost.py``.
The reference joins processes with ``jax.distributed`` and builds one
global mesh over every process's chips; here every rank is a process
with one device, joined by ``torch.distributed``:

    from ceph_tpu_torch.parallel import multihost
    multihost.init(device="cuda")          # under torchrun: RANK, WORLD_SIZE, ...
    mesh = multihost.global_mesh(device="cuda")
    step = sharded_placement_step(mesh, dense, rule, 3)

or, without a launcher, ``multihost.init("file:///tmp/store",
world_size=2, rank=r, device="cpu")`` in each of two processes
(:mod:`ceph_tpu_torch.testing.world` launches such worlds for the
tests).  The backend follows the device — ``nccl`` for the card, ``gloo``
for the CPU — and never quietly becomes the other; the timeout is finite,
so a lost rank fails its peers' collectives instead of hanging them.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from .mesh import BACKEND_FOR, Mesh, make_mesh
from .padding import padded_size

#: how long a collective waits for a lost rank before it fails
DEFAULT_TIMEOUT = timedelta(seconds=300)


def init(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
    device="cuda",
) -> None:
    """Join (or form) the process group.

    Arguments default to torchrun's environment (``RANK``,
    ``WORLD_SIZE``, and ``MASTER_ADDR``/``MASTER_PORT`` through
    ``env://``); ``init_method`` may name a ``file://`` store (or a
    ``tcp://`` address) instead.  ``backend`` defaults to the device's
    (``nccl`` for ``cuda``, ``gloo`` for ``cpu``) and must match it.
    Idempotent: a second call in a process with a group is a no-op.
    """
    if dist.is_initialized():
        return
    dev_type = torch.device(device).type
    want = BACKEND_FOR.get(dev_type)
    if want is None:
        raise ValueError(f"no process-group backend for device {device}")
    if backend is not None and backend != want:
        raise ValueError(f"backend {backend!r} does not serve {dev_type} tensors; "
                         f"use {want!r} (or let init choose it)")
    seconds = timeout.total_seconds() if isinstance(timeout, timedelta) else float(timeout)
    if not (seconds > 0 and math.isfinite(seconds)):
        raise ValueError(f"init: the timeout must be finite and positive, got {timeout!r}")
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError(
                "init: no rendezvous — pass init_method ('file://...' or "
                "'tcp://host:port') or launch under torchrun (MASTER_ADDR/MASTER_PORT)")
        init_method = "env://"
    if rank is None or world_size is None:
        raise ValueError("init: rank and world_size are needed (or RANK/WORLD_SIZE)")
    dist.init_process_group(want, init_method=init_method, world_size=int(world_size),
                            rank=int(rank), timeout=timedelta(seconds=seconds))


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(axis: str = "objects", device="cuda") -> Mesh:
    """The 1-D mesh over every rank of the world."""
    return make_mesh(axis=axis, device=device)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_shard(global_batch: int, pad: bool = False) -> tuple[int, int]:
    """(start, size) of this rank's slice of a global object batch.

    One device a rank, so the slice is the rank's even share.  The batch
    must divide evenly over the ranks — unless ``pad``, which rounds the
    batch up to a rank multiple first and returns this rank's slice of
    the PADDED batch (pad the operand to match with
    :func:`ceph_tpu_torch.parallel.padding.pad_to_multiple`).
    """
    n = process_count()
    if global_batch % n:
        if not pad:
            raise ValueError(
                f"global batch {global_batch} must be divisible by the "
                f"device count {n}; pad the operand to a device "
                f"multiple (parallel.padding.pad_to_multiple) and call "
                f"with pad=True, or trim the batch"
            )
        global_batch = padded_size(global_batch, n)
    per_dev = global_batch // n
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank * per_dev, per_dev
