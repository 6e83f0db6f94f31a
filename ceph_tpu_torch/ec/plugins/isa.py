"""ISA-L-parity EC plugin.

Mirrors the reference's ``src/erasure-code/isa/ErasureCodeIsa{,TableCache}.{h,cc}``
surface: techniques ``reed_sol_van`` (default) and ``cauchy``, w = 8
only, 32-byte address alignment (``EC_ISA_ADDRESS_ALIGNMENT``), and an
instance-independent table cache keyed by (technique, k, m, device) — the
reference shares its precomputed ``ec_init_tables`` output across
plugin instances via ``ErasureCodeIsaTableCache``; here the cached
object is the compiled device codec, which serves the same purpose
(skip matrix/LUT/jit setup on repeat profiles).

The chunk mathematics is the same RS over GF(2^8) as jerasure's
``reed_sol_van`` — that is true upstream too (ISA-L is an alternate
CPU backend for identical codes, so encodings interoperate) — but the
plugin carries its own parsing, alignment and caching semantics
instead of aliasing the jerasure class.
"""

from __future__ import annotations

import threading

import numpy as np

from .. import gf
from ..backend import MatrixCodec
from ..interface import ErasureCode, ErasureCodeError, Profile

EC_ISA_ADDRESS_ALIGNMENT = 32
TECHNIQUES = ("reed_sol_van", "cauchy")


class _TableCache:
    """(technique, k, m, device) -> codec; the ErasureCodeIsaTableCache
    analog."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._codecs: dict[tuple, MatrixCodec] = {}

    def get(self, technique: str, k: int, m: int, device) -> MatrixCodec:
        key = (technique, k, m, str(device))
        with self._lock:
            codec = self._codecs.get(key)
            if codec is None:
                if technique == "cauchy":
                    matrix = gf.cauchy_good_matrix(k, m)
                else:
                    matrix = gf.vandermonde_matrix(k, m)
                codec = MatrixCodec(matrix, "table", device=device)
                self._codecs[key] = codec
            return codec


_CACHE = _TableCache()


class ErasureCodeIsa(ErasureCode):
    technique = "reed_sol_van"

    def init(self, profile: Profile) -> None:
        self.profile = profile
        self.k = profile.get_int("k", 7)      # reference DEFAULT_K
        self.m = profile.get_int("m", 3)      # reference DEFAULT_M
        self.technique = profile.get("technique", "reed_sol_van")
        if self.k < 1 or self.m < 1:
            raise ErasureCodeError(f"bad k={self.k} m={self.m}")
        if self.technique not in TECHNIQUES:
            raise ErasureCodeError(
                f"isa technique {self.technique!r} not in {TECHNIQUES}"
            )
        if self.k + self.m > 256:
            raise ErasureCodeError("isa: k+m > 2^8")
        self.w = 8
        self.codec = _CACHE.get(self.technique, self.k, self.m, self.device)

    def get_alignment(self) -> int:
        # reference: k * EC_ISA_ADDRESS_ALIGNMENT (ec_encode_data wants
        # 32-byte-aligned fragments)
        return self.k * EC_ISA_ADDRESS_ALIGNMENT

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        data = np.stack([chunks[i] for i in range(self.k)])
        coding = self.codec.encode(data)
        for i in range(self.m):
            chunks[self.k + i][:] = coding[i]

    def decode_chunks(
        self, want_to_read: set[int], chunks: dict[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        return self.codec.decode(dict(chunks), set(want_to_read))
