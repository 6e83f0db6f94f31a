"""ceph_tpu_torch — batch CRUSH placement in PyTorch, with CUDA kernels.

The PyTorch/CUDA counterpart of the ``ceph_tpu`` package: the same
modules under the same names (``core/``, ``crush/``, ``osdmap/``,
``models/``, ``testing/``), with every tensor program written in
PyTorch and the straw2 hot loop in hand-written CUDA kernels
(``csrc/straw2.cu``) for Hopper (``sm_90a``).

All integer semantics are exact: u32 quantities ride in int64 in the
plain PyTorch code (CPU PyTorch has no u32 arithmetic), and the kernels
use native ``uint32_t``/``uint64_t``.  Entry points take an explicit
``device`` that defaults to ``"cuda"`` and raise when no card is
present; tests pass ``device="cpu"``.
"""

import torch


def resolve_device(device) -> torch.device:
    """The entry points' device check: ``"cuda"`` needs a card (there
    is no CPU fallback); ``"cpu"`` runs the plain PyTorch versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ceph_tpu_torch: device 'cuda' requested but no CUDA device is "
            "available (pass device='cpu' to run the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__version__ = "0.1.0"
