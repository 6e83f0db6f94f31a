"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, into the build
directory (:mod:`~ceph_tpu_torch.common.compile_cache`: the ignored
``ceph_tpu_torch/_build/`` unless overridden).  A library is named by a
hash of its source and the compiler flags (:func:`lib_path`) and reused
while that file exists.  The libraries are loaded with ctypes.  Nothing is imported or
built when this module is imported: the CPU tests import every module of
the package and never reach a kernel.

There is no fallback: a missing ``nvcc``, a failed build or a failed
launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
# the package's ignored scratch directory (work files of the chip checks);
# the libraries go to the build cache's directory (lib_path)
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of every kernel launcher, by library
SIGNATURES = {
    "straw2": {
        "straw2_negdraw": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
        "straw2_level_choose": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                                _P, _P],
        "straw2_descend": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _P,
                           _P, _P, _P, _P, _P],
    },
    "ec": {
        "ec_matrix_encode": [_P, _P, _P, _I, _I, _L, _P],
        "ec_bitmatrix_encode": [_P, _I, _P, _P, _I, _I, _I, _I, _L, _P],
        "ec_xor_program": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _L, _P],
        "ec_byte_lut": [_P, _P, _P, _L, _P],
    },
    "scrub": {
        "scrub_crc32c_rows": [_P, _L, _L, _I, _L, _P, _L, _P, _P],
    },
    "online": {
        "online_stripe_absorb": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "online_stripe_commit": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
    "graph": {
        "graph_runtime": [_P, _P],
        "graph_stream_create": [_P],
        "graph_cond_add": [_P, _P, _I, _I, _I, _P, _P],
        "graph_body_begin": [_P, _P, _I],
        "graph_cond_set": [_P, ctypes.c_ulonglong, _P],
        "graph_cond_end": [_P, _P, _P],
        "graph_capture_nodes": [_P, _P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds each library took to build in this process (0.0 when reused)
BUILD_SECONDS: dict[str, float] = {}
#: ``callable(name, event)`` for every :func:`build`, ``event`` being
#: "compile" (nvcc ran) or "cache_hit" (the library was on disk):
#: ``analysis.runtime_guard.CompileCounter`` registers here
BUILD_LISTENERS: list = []


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_key(name: str) -> str:
    """16 hex digits of the SHA-256 of ``csrc/<name>.cu`` and
    ``NVCC_FLAGS``: the library's content address."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        h.update(f.read())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str, directory: str | None = None) -> str:
    """Where library ``name`` of this checkout's source lives in the
    build directory (``lib<name>-<sha16>.so``)."""
    from .common.compile_cache import cache_dir

    return os.path.join(cache_dir(directory), f"lib{name}-{source_key(name)}.so")


def ptxas_path(name: str, directory: str | None = None) -> str:
    """The compiler's resource report kept beside :func:`lib_path`."""
    return lib_path(name, directory)[:-len(".so")] + ".ptxas.txt"


def _notify(name: str, event: str) -> None:
    for fn in list(BUILD_LISTENERS):
        fn(name, event)


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is in the build
    directory; returns the library's path.  The compiler's resource
    report (registers, shared memory, spills) is kept beside it
    (:func:`ptxas_path`)."""
    src = os.path.join(CSRC, f"{name}.cu")
    lib = lib_path(name)
    if os.path.exists(lib):
        BUILD_SECONDS.setdefault(name, 0.0)
        _notify(name, "cache_hit")
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    with open(ptxas_path(name), "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    _notify(name, "compile")
    return lib


def build_all() -> dict[str, float]:
    """Build every library, one ``nvcc`` per source, all at once."""
    threads = [threading.Thread(target=build, args=(n,)) for n in SIGNATURES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n in SIGNATURES:  # re-raise a build error on this thread
        build(n)
    return dict(BUILD_SECONDS)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _LOCK:
        hit = _LIBS.get(name)
        if hit is None:
            hit = ctypes.CDLL(build(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(hit, fn).argtypes = argtypes
                getattr(hit, fn).restype = ctypes.c_int
            err = getattr(hit, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = hit
        return hit


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call one launcher on ``device``'s current stream; raise on any
    CUDA error."""
    lb = lib(name)
    with torch.cuda.device(device):
        rc = getattr(lb, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = getattr(lb, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()
