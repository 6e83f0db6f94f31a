"""Reed-Solomon / Cauchy / minimal-density codec family (jerasure-plugin
parity).

Technique semantics follow the reference's
``src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc}`` classes:

- ``reed_sol_van``   — Vandermonde RS over GF(2^w), w in {8, 16, 32}
- ``reed_sol_r6_op`` — RAID6 P+Q (m must be 2), w in {8, 16, 32}
- ``cauchy_orig``    — original Cauchy bit-matrix, w in {8, 16, 32}
- ``cauchy_good``    — improved Cauchy bit-matrix, w in {8, 16, 32}
- ``liberation``     — minimal-density RAID-6, w prime (e.g. 7, 11, 13)
- ``blaum_roth``     — minimal-density RAID-6, w+1 prime (e.g. 6, 10, 12)
- ``liber8tion``     — minimal-density RAID-6, w = 8, m = 2

Execution strategy (device-first, not gf-complete's):

- w=8 matrix techniques run on device through :class:`TableEncoder`
  (GF(2^8) product tables, kernel K4); w=8 cauchy through the GF(2)
  :class:`BitmatrixEncoder` (masked XOR of packet rows, kernel K5).
- Every w>8 technique and every minimal-density code is expanded once
  (host) to its GF(2) bit-matrix and runs through K5 for its own w
  (:class:`BitmatrixCodec`) — no GF(2^16)/GF(2^32) table path.
  Deviation notes (parameters and erasure tolerance identical in all
  cases; exact bytes pinned by the non-regression archive; re-verify
  against the reference mount when it returns):

  - for w>8 *matrix* techniques the on-wire chunk layout is the
    bit-sliced packet layout of the bitmatrix path, not gf-complete's
    contiguous w-bit-word region layout;
  - ``liber8tion`` Q-parity bytes come from in-repo block matrices
    (a deterministic search for k<=6, companion-matrix powers for
    k in {7,8}), not Plank's published search results, so that parity
    chunk is not byte-interchangeable with upstream jerasure's.
"""

from __future__ import annotations

import numpy as np

from .. import gf, gfw
from ..backend import BitmatrixCodec, MatrixCodec
from ..interface import ErasureCode, ErasureCodeError, Profile

MATRIX_TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op")
BITMATRIX_TECHNIQUES = ("cauchy_orig", "cauchy_good")
MINDENSITY_TECHNIQUES = ("liberation", "blaum_roth", "liber8tion")
SIZEOF_INT = 4


class ErasureCodeJerasure(ErasureCode):
    technique = "reed_sol_van"

    def init(self, profile: Profile) -> None:
        self.profile = profile
        self.k = profile.get_int("k", 2)
        self.m = profile.get_int("m", 1)
        self.technique = profile.get("technique", "reed_sol_van")
        self.w = profile.get_int(
            "w", 7 if self.technique == "liberation" else 8
        )
        self.packetsize = profile.get_int("packetsize", 2048)
        if self.k < 1 or self.m < 1:
            raise ErasureCodeError(f"bad k={self.k} m={self.m}")
        t, w = self.technique, self.w
        if t in MINDENSITY_TECHNIQUES:
            if self.m != 2:
                raise ErasureCodeError(f"{t} requires m=2 (RAID-6)")
            kmax = 8 if t == "liber8tion" else w
            if self.k > kmax:
                raise ErasureCodeError(f"{t} requires k <= w ({self.k} > {kmax})")
            try:
                bm = np.frombuffer(
                    gfw.bitmatrix_for(t, self.k, 2, 8 if t == "liber8tion" else w),
                    np.uint8,
                ).reshape(2 * (8 if t == "liber8tion" else w), -1)
            except ValueError as e:
                raise ErasureCodeError(str(e)) from e
            if t == "liber8tion":
                self.w = w = 8
            self.codec = BitmatrixCodec(bm.copy(), w, self.packetsize, self.device)
        elif w == 8:
            if self.k + self.m > 256:
                raise ErasureCodeError(f"k+m > 256 for w=8")
            if t == "reed_sol_van":
                matrix = gf.vandermonde_matrix(self.k, self.m)
            elif t == "reed_sol_r6_op":
                if self.m != 2:
                    raise ErasureCodeError("reed_sol_r6_op requires m=2")
                matrix = gf.raid6_matrix(self.k)
            elif t == "cauchy_orig":
                matrix = gf.cauchy_matrix(self.k, self.m)
            elif t == "cauchy_good":
                matrix = gf.cauchy_good_matrix(self.k, self.m)
            else:
                raise ErasureCodeError(f"technique {t!r} not implemented")
            kind = "bitmatrix" if t in BITMATRIX_TECHNIQUES else "table"
            self.codec = MatrixCodec(matrix, kind, self.packetsize, self.device)
        elif w in (16, 32):
            if self.k + self.m > (1 << w):
                raise ErasureCodeError(f"k+m > 2^{w}")
            if t == "reed_sol_van":
                matrix = gfw.vandermonde_matrix(self.k, self.m, w)
            elif t == "reed_sol_r6_op":
                if self.m != 2:
                    raise ErasureCodeError("reed_sol_r6_op requires m=2")
                matrix = gfw.raid6_matrix(self.k, w)
            elif t == "cauchy_orig":
                matrix = gfw.cauchy_matrix(self.k, self.m, w)
            elif t == "cauchy_good":
                matrix = gfw.cauchy_good_matrix(self.k, self.m, w)
            else:
                raise ErasureCodeError(f"technique {t!r} not implemented")
            bm = gfw.matrix_to_bitmatrix(matrix, w)
            # matrix techniques carry no packetsize in the reference's
            # alignment (k*w*sizeof(int)); run the bitmatrix path with
            # packetsize = sizeof(int) so chunk granularity matches
            ps = (
                self.packetsize
                if t in BITMATRIX_TECHNIQUES
                else SIZEOF_INT
            )
            self.codec = BitmatrixCodec(bm, w, ps, self.device)
        else:
            raise ErasureCodeError(
                f"w={w} unsupported (8/16/32 for matrix/cauchy; prime w "
                "for liberation; w+1 prime for blaum_roth; 8 for "
                "liber8tion)"
            )

    def get_alignment(self) -> int:
        # reference per-class get_alignment: matrix techniques are
        # k*w*sizeof(int); packetsize-schedule techniques (cauchy +
        # minimal-density) add the packetsize factor
        if self.technique in MATRIX_TECHNIQUES:
            return self.k * self.w * SIZEOF_INT
        return self.k * self.w * self.packetsize * SIZEOF_INT

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        data = np.stack([chunks[i] for i in range(self.k)])
        coding = self.codec.encode(data)
        for i in range(self.m):
            chunks[self.k + i][:] = coding[i]

    def decode_chunks(
        self, want_to_read: set[int], chunks: dict[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        return self.codec.decode(dict(chunks), set(want_to_read))
