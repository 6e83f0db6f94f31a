"""Erasure coding: the plugin registry, the codecs and their kernels.

The counterpart of ``ceph_tpu.ec``.  ``create(profile, device="cuda")``
builds a jerasure, isa, lrc, shec or clay codec whose bulk byte work
runs on ``device``: GF(2^8) matrix products through K4
(``gf_kernels.matrix_encode``), GF(2) bitmatrix products through K5
(``kernels.bitmatrix_encode``) and CLAY's pair transforms through K7
(``gf_kernels.byte_lut``), hand-written in ``csrc/ec.cu``.
"""

from .interface import ErasureCode, ErasureCodeError, ErasureCodeInterface, Profile
from .registry import ErasureCodePluginRegistry, create, register_plugin

__all__ = [
    "ErasureCode",
    "ErasureCodeError",
    "ErasureCodeInterface",
    "Profile",
    "ErasureCodePluginRegistry",
    "create",
    "register_plugin",
]
