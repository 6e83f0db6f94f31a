"""ctypes bindings for the C++ CPU reference tier (cpp/).

Loads ``cpp/build/lib{crushref,gfref}.so`` when they are present and
newer than their sources; otherwise builds them with make into the
port's ignored build directory (``ceph_tpu_torch/_build/cpp``), never
into the tracked ``cpp/build``.  The C++ tier is the repo's ground truth
for CRUSH and GF semantics: the port's exact host tier and its test
oracle.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from functools import lru_cache

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPP_DIR = os.path.join(os.path.dirname(_PKG_DIR), "cpp")
_OWN_BUILD = os.path.join(_PKG_DIR, "_build", "cpp")
_LIBS = ("libcrushref.so", "libgfref.so")


def _current(build_dir: str) -> bool:
    srcs = [os.path.join(_CPP_DIR, f)
            for f in ("crush_ref.cpp", "crush_ln_tables.h", "gf_ref.cpp", "Makefile")]
    libs = [os.path.join(build_dir, f) for f in _LIBS]
    return all(os.path.exists(p) for p in libs) and not any(
        os.path.getmtime(s) > min(os.path.getmtime(p) for p in libs) for s in srcs
    )


def _build() -> str:
    tracked = os.path.join(_CPP_DIR, "build")
    if _current(tracked):
        return tracked
    os.makedirs(_OWN_BUILD, exist_ok=True)
    # one builder at a time across processes (parallel test workers)
    with open(os.path.join(_OWN_BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _current(_OWN_BUILD):
            subprocess.run(["make", "-C", _CPP_DIR, f"BUILD={_OWN_BUILD}"],
                           check=True, capture_output=True)
    return _OWN_BUILD


class _CMapSpec(ctypes.Structure):
    _fields_ = [
        ("n_buckets", ctypes.c_int32),
        ("max_fanout", ctypes.c_int32),
        ("max_devices", ctypes.c_int32),
        ("choose_total_tries", ctypes.c_int32),
        ("choose_local_tries", ctypes.c_int32),
        ("choose_local_fallback_tries", ctypes.c_int32),
        ("chooseleaf_descend_once", ctypes.c_int32),
        ("chooseleaf_vary_r", ctypes.c_int32),
        ("chooseleaf_stable", ctypes.c_int32),
        ("alg", ctypes.POINTER(ctypes.c_int32)),
        ("type", ctypes.POINTER(ctypes.c_int32)),
        ("size", ctypes.POINTER(ctypes.c_int32)),
        ("items", ctypes.POINTER(ctypes.c_int32)),
        ("weights", ctypes.POINTER(ctypes.c_uint32)),
        ("scaled", ctypes.POINTER(ctypes.c_uint32)),
        ("tree_weights", ctypes.POINTER(ctypes.c_uint32)),
        ("max_tree_nodes", ctypes.c_int32),
    ]


class _CRuleStep(ctypes.Structure):
    _fields_ = [
        ("op", ctypes.c_int32),
        ("arg1", ctypes.c_int32),
        ("arg2", ctypes.c_int32),
    ]


ITEM_NONE = 0x7FFFFFFF


@lru_cache(maxsize=1)
def _libs():
    build_dir = _build()
    crush = ctypes.CDLL(os.path.join(build_dir, "libcrushref.so"))
    gf = ctypes.CDLL(os.path.join(build_dir, "libgfref.so"))

    crush.ct_hash2.restype = ctypes.c_uint32
    crush.ct_hash2.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    crush.ct_hash3.restype = ctypes.c_uint32
    crush.ct_hash3.argtypes = [ctypes.c_uint32] * 3
    crush.ct_crush_ln.restype = ctypes.c_uint64
    crush.ct_crush_ln.argtypes = [ctypes.c_uint32]
    crush.ct_str_hash_rjenkins.restype = ctypes.c_uint32
    crush.ct_str_hash_rjenkins.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    crush.ct_do_rule_batch.restype = None
    crush.ct_hash4.restype = ctypes.c_uint32
    crush.ct_hash4.argtypes = [ctypes.c_uint32] * 4
    crush.ct_bucket_choose.restype = ctypes.c_int32
    gf.gfref_mul.restype = ctypes.c_uint8
    gf.gfref_mul.argtypes = [ctypes.c_uint8, ctypes.c_uint8]
    return crush, gf


def hash2(a: int, b: int) -> int:
    return _libs()[0].ct_hash2(a & 0xFFFFFFFF, b & 0xFFFFFFFF)


def hash3(a: int, b: int, c: int) -> int:
    return _libs()[0].ct_hash3(a & 0xFFFFFFFF, b & 0xFFFFFFFF, c & 0xFFFFFFFF)


def crush_ln(x: int) -> int:
    return _libs()[0].ct_crush_ln(x)


def str_hash_rjenkins(data: bytes) -> int:
    return _libs()[0].ct_str_hash_rjenkins(data, len(data))


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _make_spec(dense):
    """(_CMapSpec, keepalive-arrays) for a DenseCrushMap."""
    alg = np.ascontiguousarray(dense.alg, np.int32)
    btype = np.ascontiguousarray(dense.btype, np.int32)
    size = np.ascontiguousarray(dense.size, np.int32)
    items = np.ascontiguousarray(dense.items, np.int32)
    weights = np.ascontiguousarray(dense.weights, np.uint32)
    keep = [alg, btype, size, items, weights]
    scaled_p = tree_p = None
    if getattr(dense, "scaled", None) is not None:
        scaled = np.ascontiguousarray(dense.scaled, np.uint32)
        keep.append(scaled)
        scaled_p = _as_ptr(scaled, ctypes.c_uint32)
    if getattr(dense, "tree_weights", None) is not None:
        tree_w = np.ascontiguousarray(dense.tree_weights, np.uint32)
        keep.append(tree_w)
        tree_p = _as_ptr(tree_w, ctypes.c_uint32)
    spec = _CMapSpec(
        n_buckets=dense.n_buckets,
        max_fanout=dense.max_fanout,
        max_devices=dense.max_devices,
        choose_total_tries=dense.tunables.choose_total_tries,
        choose_local_tries=dense.tunables.choose_local_tries,
        choose_local_fallback_tries=dense.tunables.choose_local_fallback_tries,
        chooseleaf_descend_once=dense.tunables.chooseleaf_descend_once,
        chooseleaf_vary_r=dense.tunables.chooseleaf_vary_r,
        chooseleaf_stable=dense.tunables.chooseleaf_stable,
        alg=_as_ptr(alg, ctypes.c_int32),
        type=_as_ptr(btype, ctypes.c_int32),
        size=_as_ptr(size, ctypes.c_int32),
        items=_as_ptr(items, ctypes.c_int32),
        weights=_as_ptr(weights, ctypes.c_uint32),
        scaled=scaled_p,
        tree_weights=tree_p,
        max_tree_nodes=getattr(dense, "max_tree_nodes", 0),
    )
    return spec, keep


def bucket_choose(dense, bucket_idx: int, x: int, r: int) -> int:
    """Single legacy/modern bucket choose on the C++ tier (for
    differential tests against the Python oracle)."""
    crush, _ = _libs()
    spec, _keep = _make_spec(dense)
    return crush.ct_bucket_choose(
        ctypes.byref(spec), ctypes.c_int32(bucket_idx),
        ctypes.c_uint32(x & 0xFFFFFFFF), ctypes.c_int32(r)
    )


def hash4(a: int, b: int, c: int, d: int) -> int:
    return _libs()[0].ct_hash4(
        a & 0xFFFFFFFF, b & 0xFFFFFFFF, c & 0xFFFFFFFF, d & 0xFFFFFFFF
    )


def reset_retry_stats() -> None:
    _libs()[0].ct_reset_stats()


def retry_histogram() -> np.ndarray:
    """[64] int64 histogram of top-level failure counts per slot since
    the last reset (last bucket clamps) — crushtool --show-choose-tries
    data."""
    hist = np.zeros(64, np.int64)
    _libs()[0].ct_get_try_hist(_as_ptr(hist, ctypes.c_int64))
    return hist


def retry_stats() -> tuple[int, float, int]:
    """(max_ftotal, mean_ftotal, slots) accumulated since the last
    reset.  Counts top-level FAILURE rounds only (leaf sub-descents
    excluded; indep normalized to the same unit), so max_ftotal + 1
    bounds the batch engine's masked whole-batch retry-round
    (lax.while_loop trip) count for the same inputs — the number
    bench/PERF_MODEL.md's suspect 4 asks for."""
    crush, _ = _libs()
    mx = ctypes.c_int32()
    sm = ctypes.c_int64()
    n = ctypes.c_int64()
    crush.ct_get_stats(ctypes.byref(mx), ctypes.byref(sm), ctypes.byref(n))
    slots = max(int(n.value), 1)
    return int(mx.value), float(sm.value) / slots, int(n.value)


def do_rule_batch(
    dense,  # ceph_tpu_torch.crush.map.DenseCrushMap
    steps: list[tuple[int, int, int]],
    xs: np.ndarray,
    osd_weight: np.ndarray,
    result_max: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Run a rule for every x on the C++ reference; returns (results, lens).

    results is int32 [n_x, result_max], padded with ITEM_NONE.
    """
    crush, _ = _libs()
    spec, _keep = _make_spec(dense)
    csteps = (_CRuleStep * len(steps))(*[_CRuleStep(*s) for s in steps])
    if result_max > 256:
        raise ValueError(
            f"result_max={result_max} exceeds the C++ reference's scratch "
            "cap of 256 (ct_do_rule_batch would silently no-op)"
        )
    xs = np.ascontiguousarray(xs, np.uint32)
    osd_weight = np.ascontiguousarray(osd_weight, np.uint32)
    n = len(xs)
    results = np.full((n, result_max), ITEM_NONE, np.int32)
    lens = np.zeros(n, np.int32)
    crush.ct_do_rule_batch(
        ctypes.byref(spec),
        csteps,
        ctypes.c_int32(len(steps)),
        _as_ptr(xs, ctypes.c_uint32),
        ctypes.c_int64(n),
        _as_ptr(osd_weight, ctypes.c_uint32),
        ctypes.c_int32(len(osd_weight)),
        _as_ptr(results, ctypes.c_int32),
        _as_ptr(lens, ctypes.c_int32),
        ctypes.c_int32(result_max),
    )
    return results, lens


# ---- GF reference wrappers ----


def gf_tables() -> tuple[np.ndarray, np.ndarray]:
    _, gf = _libs()
    log = np.zeros(256, np.uint8)
    exp = np.zeros(256, np.uint8)
    gf.gfref_tables(_as_ptr(log, ctypes.c_uint8), _as_ptr(exp, ctypes.c_uint8))
    return log, exp


def gf_mul(a: int, b: int) -> int:
    return _libs()[1].gfref_mul(a, b)


def vandermonde_matrix(k: int, m: int) -> np.ndarray:
    _, gf = _libs()
    out = np.zeros((m, k), np.uint8)
    rc = gf.gfref_vandermonde_matrix(k, m, _as_ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"vandermonde_matrix({k},{m}) failed rc={rc}")
    return out


def raid6_matrix(k: int) -> np.ndarray:
    _, gf = _libs()
    out = np.zeros((2, k), np.uint8)
    gf.gfref_raid6_matrix(k, _as_ptr(out, ctypes.c_uint8))
    return out


def cauchy_matrix(k: int, m: int) -> np.ndarray:
    _, gf = _libs()
    out = np.zeros((m, k), np.uint8)
    rc = gf.gfref_cauchy_matrix(k, m, _as_ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"cauchy_matrix({k},{m}) failed rc={rc}")
    return out


def matrix_encode(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """data: [k, size] uint8 -> coding [m, size] uint8."""
    _, gf = _libs()
    m, k = matrix.shape
    data = np.ascontiguousarray(data, np.uint8)
    assert data.shape[0] == k
    size = data.shape[1]
    coding = np.zeros((m, size), np.uint8)
    gf.gfref_matrix_encode_flat(
        k,
        m,
        _as_ptr(np.ascontiguousarray(matrix, np.uint8), ctypes.c_uint8),
        _as_ptr(data, ctypes.c_uint8),
        _as_ptr(coding, ctypes.c_uint8),
        ctypes.c_int64(size),
    )
    return coding


def invert_matrix(mat: np.ndarray) -> np.ndarray:
    _, gf = _libs()
    k = mat.shape[0]
    inv = np.zeros((k, k), np.uint8)
    rc = gf.gfref_invert_matrix(
        k,
        _as_ptr(np.ascontiguousarray(mat, np.uint8), ctypes.c_uint8),
        _as_ptr(inv, ctypes.c_uint8),
    )
    if rc != 0:
        raise ValueError("singular matrix")
    return inv


def matrix_to_bitmatrix(matrix: np.ndarray) -> np.ndarray:
    _, gf = _libs()
    m, k = matrix.shape
    out = np.zeros((m * 8, k * 8), np.uint8)
    gf.gfref_matrix_to_bitmatrix(
        k,
        m,
        _as_ptr(np.ascontiguousarray(matrix, np.uint8), ctypes.c_uint8),
        _as_ptr(out, ctypes.c_uint8),
    )
    return out


def bitmatrix_encode(
    bitmatrix: np.ndarray, data: np.ndarray, packetsize: int
) -> np.ndarray:
    """data: [k, size] -> coding [m, size] with packet-interleave layout."""
    _, gf = _libs()
    mw, kw = bitmatrix.shape
    k, m = kw // 8, mw // 8
    data = np.ascontiguousarray(data, np.uint8)
    size = data.shape[1]
    assert size % (8 * packetsize) == 0
    coding = np.zeros((m, size), np.uint8)
    gf.gfref_bitmatrix_encode(
        k,
        m,
        _as_ptr(np.ascontiguousarray(bitmatrix, np.uint8), ctypes.c_uint8),
        _as_ptr(data, ctypes.c_uint8),
        _as_ptr(coding, ctypes.c_uint8),
        ctypes.c_int64(size),
        ctypes.c_int64(packetsize),
    )
    return coding


def invert_bitmatrix(mat: np.ndarray) -> np.ndarray:
    _, gf = _libs()
    n = mat.shape[0]
    inv = np.zeros((n, n), np.uint8)
    rc = gf.gfref_invert_bitmatrix(
        n,
        _as_ptr(np.ascontiguousarray(mat, np.uint8), ctypes.c_uint8),
        _as_ptr(inv, ctypes.c_uint8),
    )
    if rc != 0:
        raise ValueError("singular bitmatrix")
    return inv
