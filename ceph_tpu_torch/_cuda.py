"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, into the ignored
``ceph_tpu_torch/_build/`` directory; a library newer than its source is
reused.  The libraries are loaded with ctypes.  Nothing is imported or
built when this module is imported: the CPU tests import every module of
the package and never reach a kernel.

There is no fallback: a missing ``nvcc``, a failed build or a failed
launch raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
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
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds each library took to build in this process (0.0 when reused)
BUILD_SECONDS: dict[str, float] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless the library is current; returns
    the library's path.  The compiler's resource report (registers,
    shared memory, spills) is kept beside it as ``<name>.ptxas.txt``."""
    src = os.path.join(CSRC, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        BUILD_SECONDS.setdefault(name, 0.0)
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w") as f:
        f.write(proc.stdout + proc.stderr)
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
