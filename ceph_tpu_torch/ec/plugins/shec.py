"""Shingled erasure code (SHEC).

Semantics per the reference's ``src/erasure-code/shec`` (Miyamae et
al., "SHEC"): SHEC(k, m, c) places m parities, each covering a
*shingle* — a circular window of ceil(k*c/m) consecutive data chunks
starting at floor(i*k/m) — so single-chunk recovery reads only a window
instead of k chunks, trading durability (not MDS) for recovery
efficiency.  ``c`` is the average parity coverage per data chunk.

Matrix construction matches the reference's
``ErasureCodeShec::shec_reedsolomon_coding_matrix`` at the default
w = 8: start from jerasure's systematized extended-Vandermonde coding
matrix (``reed_sol_vandermonde_coding_matrix(k, m, 8)`` — the same
construction the jerasure reed_sol_van plugin here is bit-exact
against), then zero every entry outside the row's shingle window, so
encoded parity bytes equal upstream's.  Because the code is not MDS,
decode solves the available linear system: identity rows for surviving
data + shingle rows for surviving parities, Gauss-eliminated on the
host to produce a reconstruction matrix, with the bulk multiply on
device (:class:`TableEncoder`).
"""

from __future__ import annotations

import math

import numpy as np

from .. import gf
from ..backend import TableEncoder
from ..interface import ErasureCode, ErasureCodeError, Profile


def _shingle_matrix(k: int, m: int, c: int) -> np.ndarray:
    """reed_sol Vandermonde coding matrix masked to the shingle pattern
    (reference shec_reedsolomon_coding_matrix, w=8)."""
    width = math.ceil(k * c / m)
    mat = gf.vandermonde_matrix(k, m)
    for i in range(m):
        start = (i * k) // m
        for j in range(k):
            if (j - start) % k >= width:
                mat[i, j] = 0
    return mat


class ErasureCodeShec(ErasureCode):
    def init(self, profile: Profile) -> None:
        self.profile = profile
        self.k = profile.get_int("k", 4)
        self.m = profile.get_int("m", 3)
        self.c = profile.get_int("c", 2)
        if not (0 < self.c <= self.m <= self.k):
            raise ErasureCodeError(
                f"need 0 < c={self.c} <= m={self.m} <= k={self.k}"
            )
        self.w = profile.get_int("w", 8)
        if self.w != 8:
            # upstream allows w in {8,16,32}; the GF(2^8) table engine
            # here covers the default — reject the rest loudly
            raise ErasureCodeError(
                f"w={self.w} not supported (only the upstream default "
                "w=8)"
            )
        self.matrix = _shingle_matrix(self.k, self.m, self.c)
        self.encoder = TableEncoder(self.matrix, self.device)
        self._solvers: dict[tuple, TableEncoder] = {}

    def get_alignment(self) -> int:
        return self.k * 8 * 4

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        data = np.stack([chunks[i] for i in range(self.k)])
        coding = self.encoder.encode(data)
        for i in range(self.m):
            chunks[self.k + i][:] = coding[i]

    # ---- recovery algebra ----

    def _system_rows(self, available: set[int]) -> tuple[np.ndarray, list[int]]:
        """Rows of the k-column GF system contributed by survivors."""
        rows = []
        ids = []
        for i in sorted(available):
            if i < self.k:
                r = np.zeros(self.k, np.uint8)
                r[i] = 1
            else:
                r = self.matrix[i - self.k]
            rows.append(r)
            ids.append(i)
        return np.array(rows, np.uint8), ids

    def _eliminated(self, available: tuple[int, ...]):
        """Row-reduce the survivor system, tracking combinations.

        Returns (a, t, pivots, ids): ``a`` the reduced rows, ``t`` the
        combination matrix (row i of ``a`` = t[i] @ original rows),
        ``pivots`` mapping column -> reduced row index.
        """
        rows, ids = self._system_rows(set(available))
        n = len(ids)
        a = rows.copy()
        t = np.eye(n, dtype=np.uint8)
        pivots: dict[int, int] = {}
        used = np.zeros(n, bool)
        for col in range(self.k):
            pr = next(
                (r for r in range(n) if not used[r] and a[r, col] != 0), None
            )
            if pr is None:
                continue  # free column: not determined by this subset
            used[pr] = True
            pivots[col] = pr
            f = gf.gf_inv(int(a[pr, col]))
            a[pr] = gf.mul_region(f, a[pr])
            t[pr] = gf.mul_region(f, t[pr])
            for r in range(n):
                if r != pr and a[r, col] != 0:
                    fr = int(a[r, col])
                    a[r] ^= gf.mul_region(fr, a[pr])
                    t[r] ^= gf.mul_region(fr, t[pr])
        return a, t, pivots, ids

    def _target_row(self, i: int) -> np.ndarray:
        """Chunk i as a k-vector over the data chunks."""
        if i < self.k:
            r = np.zeros(self.k, np.uint8)
            r[i] = 1
            return r
        return self.matrix[i - self.k].copy()

    def _express(self, elim, targets: list[int]) -> np.ndarray | None:
        """Coefficients expressing each target chunk from survivors,
        or None if any target is outside the row space."""
        a, t, pivots, ids = elim
        out = np.zeros((len(targets), len(ids)), np.uint8)
        for row_i, tgt in enumerate(targets):
            v = self._target_row(tgt)
            comb = np.zeros(len(ids), np.uint8)
            for col, pr in pivots.items():
                f = int(v[col])
                if f:
                    v ^= gf.mul_region(f, a[pr])
                    comb ^= gf.mul_region(f, t[pr])
            if v.any():
                return None
            out[row_i] = comb
        return out

    def _touching_rows(self, chunk: int) -> list[int]:
        """Parity rows whose shingle involves this chunk."""
        if chunk >= self.k:
            return [chunk - self.k]
        return [i for i in range(self.m) if self.matrix[i, chunk]]

    def _candidate_pool(self, erased: set[int], available: set[int]) -> set[int]:
        """Survivors plausibly useful for repairing ``erased``: members
        of every shingle window that (transitively, through other
        erased chunks) touches an erasure.  Bounds the search the way
        the reference does, instead of scanning all survivor subsets."""
        relevant = set(erased)
        while True:
            rows = {i for e in relevant for i in self._touching_rows(e)}
            members = {self.k + i for i in rows} | {
                j
                for i in rows
                for j in range(self.k)
                if self.matrix[i, j]
            }
            grown = relevant | (members & erased)
            if grown == relevant:
                return (members - erased) & available
            relevant = grown

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> set[int]:
        erased = want_to_read - available
        if not erased:
            return set(want_to_read)
        import itertools

        pool = sorted(self._candidate_pool(erased, available))
        if len(pool) <= 12:  # exact minimal search on the window pool
            for r in range(1, len(pool) + 1):
                for sub in itertools.combinations(pool, r):
                    if self._can_recover(set(sub), erased):
                        return set(sub) | (want_to_read & available)
        # greedy shrink (polynomial): start wide, drop what isn't needed
        for base in (set(pool), set(available)):
            if self._can_recover(base, erased):
                keep = set(base)
                for c in sorted(base):
                    if self._can_recover(keep - {c}, erased):
                        keep.discard(c)
                return keep | (want_to_read & available)
        raise ErasureCodeError(f"cannot recover {sorted(erased)}")

    def _can_recover(self, subset: set[int], erased: set[int]) -> bool:
        """Do these survivors determine the erased chunks?"""
        elim = self._eliminated(tuple(sorted(subset)))
        return self._express(elim, sorted(erased)) is not None

    def decode_chunks(
        self, want_to_read: set[int], chunks: dict[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        available = tuple(sorted(chunks))
        targets = sorted(want_to_read)
        key = (available, tuple(targets))
        if key not in self._solvers:
            elim = self._eliminated(available)
            recon = self._express(elim, targets)
            if recon is None:
                raise ErasureCodeError(
                    f"cannot decode {targets} from chunks {sorted(chunks)}"
                )
            self._solvers[key] = TableEncoder(recon, self.device)
        ids = sorted(available)
        survivors = np.stack([chunks[i] for i in ids])
        decoded = self._solvers[key].encode(survivors)
        return {
            tgt: np.ascontiguousarray(decoded[i])
            for i, tgt in enumerate(targets)
        }
