"""GF(2^8) arithmetic and coding-matrix constructions (host, numpy).

Exact counterpart of ``cpp/gf_ref.cpp`` (primitive polynomial 0x11d),
which itself implements the algebra behind the reference's jerasure
plugin family (upstream ``src/erasure-code/jerasure`` + bundled
``jerasure/jerasure.c`` :: ``reed_sol_vandermonde_coding_matrix``,
``jerasure_matrix_to_bitmatrix``, ``jerasure_matrix_invert`` — spec in
SURVEY.md §2.2).  These tables/matrices are computed once per profile on
the host; the bulk byte work happens on device
(:mod:`ceph_tpu_torch.ec.backend`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

PRIM_POLY = 0x11D
W = 8


@lru_cache(maxsize=1)
def tables() -> tuple[np.ndarray, np.ndarray]:
    """(log, exp) tables; exp has 510 entries so log[a]+log[b] indexes it."""
    log = np.zeros(256, np.int32)
    exp = np.zeros(510, np.uint8)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    exp[255:510] = exp[0:255]
    log[0] = 0  # undefined; callers must special-case 0
    return log, exp


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    log, exp = tables()
    return int(exp[log[a] + log[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    log, exp = tables()
    return int(exp[255 - log[a]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("gf_div by 0")
    if a == 0:
        return 0
    log, exp = tables()
    return int(exp[(log[a] + 255 - log[b]) % 255])


@lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """Full 256x256 product table (device gather operand)."""
    log, exp = tables()
    a = np.arange(256)
    t = exp[(log[a][:, None] + log[a][None, :])]
    t[0, :] = 0
    t[:, 0] = 0
    return t.astype(np.uint8)


def mul_region(c: int, data: np.ndarray) -> np.ndarray:
    """c * data elementwise over GF(2^8) (vectorized host)."""
    return mul_table()[c][data]


# ---- coding matrices (all m x k over GF(2^8)) ----


def vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """reed_sol_van semantics: extended Vandermonde systematized so the
    top k x k block is the identity; returns the bottom m rows."""
    rows = k + m
    if rows > 256:
        raise ValueError("k + m must be <= 256 for w=8")
    v = np.zeros((rows, k), np.uint8)
    v[0, 0] = 1
    for i in range(1, rows - 1):
        e = 1
        for j in range(k):
            v[i, j] = e
            e = gf_mul(e, i)
    v[rows - 1, k - 1] = 1
    # systematize by column operations (mirrors gfref_vandermonde_matrix)
    for i in range(1, k):
        pr = next((r for r in range(i, rows) if v[r, i] != 0), None)
        if pr is None:
            raise ValueError("singular vandermonde block")
        if pr != i:
            v[[pr, i]] = v[[i, pr]]
        if v[i, i] != 1:
            inv = gf_div(1, int(v[i, i]))
            v[:, i] = mul_region(inv, v[:, i])
        for j in range(k):
            f = int(v[i, j])
            if j != i and f != 0:
                v[:, j] ^= mul_region(f, v[:, i])
    return v[k:].copy()


def raid6_matrix(k: int) -> np.ndarray:
    """reed_sol_r6_op semantics: P = XOR row, Q = powers of alpha."""
    out = np.zeros((2, k), np.uint8)
    e = 1
    for j in range(k):
        out[0, j] = 1
        out[1, j] = e
        e = gf_mul(e, 2)
    return out


def cauchy_matrix(k: int, m: int) -> np.ndarray:
    """Original Cauchy: M[i][j] = 1 / (i XOR (m + j))."""
    if k + m > 256:
        raise ValueError("k + m must be <= 256 for w=8")
    out = np.zeros((m, k), np.uint8)
    for i in range(m):
        for j in range(k):
            d = i ^ (m + j)
            if d == 0:
                raise ValueError("cauchy index collision")
            out[i, j] = gf_inv(d)
    return out


def cauchy_good_matrix(k: int, m: int) -> np.ndarray:
    """cauchy_good semantics: original Cauchy improved so row 0 and
    column 0 are all ones (divide each column by its row-0 element,
    then normalize each row by its column-0 element) — jerasure
    ``cauchy_original_coding_matrix`` + ``improve_coding_matrix``."""
    mat = cauchy_matrix(k, m)
    for j in range(k):
        f = int(mat[0, j])
        if f != 1:
            mat[:, j] = mul_region(gf_inv(f), mat[:, j])
    for i in range(1, m):
        f = int(mat[i, 0])
        if f != 1:
            mat[i] = mul_region(gf_inv(f), mat[i])
    return mat


def invert_matrix(mat: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^8); raises on singular."""
    k = mat.shape[0]
    a = mat.astype(np.uint8).copy()
    inv = np.eye(k, dtype=np.uint8)
    for col in range(k):
        pr = next((r for r in range(col, k) if a[r, col] != 0), None)
        if pr is None:
            raise ValueError("singular matrix")
        if pr != col:
            a[[pr, col]] = a[[col, pr]]
            inv[[pr, col]] = inv[[col, pr]]
        piv = int(a[col, col])
        if piv != 1:
            f = gf_inv(piv)
            a[col] = mul_region(f, a[col])
            inv[col] = mul_region(f, inv[col])
        for r in range(k):
            f = int(a[r, col])
            if r != col and f != 0:
                a[r] ^= mul_region(f, a[col])
                inv[r] ^= mul_region(f, inv[col])
    return inv


def matrix_encode(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Host reference encode: data [k, size] u8 -> coding [m, size]."""
    m, k = matrix.shape
    assert data.shape[0] == k
    mt = mul_table()
    out = np.zeros((m, data.shape[1]), np.uint8)
    for i in range(m):
        acc = out[i]
        for j in range(k):
            e = int(matrix[i, j])
            if e == 0:
                continue
            acc ^= mt[e][data[j]]
    return out


# ---- GF(2) bit-matrix forms (the masked-XOR kernel's representation) ----


def matrix_to_bitmatrix(matrix: np.ndarray) -> np.ndarray:
    """Expand m x k GF(2^8) to (m*8) x (k*8) GF(2): block (i,j) column l
    holds the bits of M[i][j] * alpha^l."""
    m, k = matrix.shape
    out = np.zeros((m * W, k * W), np.uint8)
    for i in range(m):
        for j in range(k):
            e = int(matrix[i, j])
            for l in range(W):
                for t in range(W):
                    out[i * W + t, j * W + l] = (e >> t) & 1
                e = gf_mul(e, 2)
    return out


def bitmatrix_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2) matrix product: exact integer matmul, parity = & 1.

    Because ``matrix_to_bitmatrix`` is a ring homomorphism (companion-
    matrix representation of GF(2^8)), composing repair matrices here
    is byte-identical to composing them over GF(2^8) and expanding.
    """
    prod = (a & 1).astype(np.int64) @ (b & 1).astype(np.int64)
    return (prod & 1).astype(np.uint8)


def invert_bitmatrix(mat: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2); raises on singular."""
    n = mat.shape[0]
    a = (mat & 1).astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        pr = next((r for r in range(col, n) if a[r, col]), None)
        if pr is None:
            raise ValueError("singular bitmatrix")
        if pr != col:
            a[[pr, col]] = a[[col, pr]]
            inv[[pr, col]] = inv[[col, pr]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= a[col]
                inv[r] ^= inv[col]
    return inv


def bitmatrix_encode(
    bitmatrix: np.ndarray, data: np.ndarray, packetsize: int
) -> np.ndarray:
    """Host reference bitmatrix encode with packet interleaving.

    Each chunk is groups of 8 packets of ``packetsize`` bytes; parity
    packet (i, t) of each group = XOR of data packets (j, l) where
    bitmatrix[i*8+t, j*8+l] == 1.  size must divide into 8*packetsize
    groups.
    """
    mw, kw = bitmatrix.shape
    k, m = kw // W, mw // W
    size = data.shape[1]
    group = W * packetsize
    assert size % group == 0, (size, group)
    ngroups = size // group
    d = data.reshape(k, ngroups, W, packetsize)
    c = np.zeros((m, ngroups, W, packetsize), np.uint8)
    for i in range(m):
        for t in range(W):
            row = bitmatrix[i * W + t]
            for j in range(k):
                for l in range(W):
                    if row[j * W + l]:
                        c[i, :, t, :] ^= d[j, :, l, :]
    return c.reshape(m, size)
