"""The build cache: where ``_cuda.py`` keeps the kernels' libraries.

The counterpart of the reference package's persistent XLA cache.  The
port has no traced programs; its "compile" is ``nvcc`` building one
``csrc/*.cu`` into a shared library.  Each library is content-addressed
(``lib<name>-<sha16>.so``, the hash of its source and the compiler
flags: ``_cuda.source_key``), so a directory shared by several
checkouts never hands one of them a library built from another's
source, and a restart rebuilds nothing it built before.

Location precedence: the argument of :func:`enable_persistent_cache` >
the ``CEPH_TPU_TORCH_CACHE_DIR`` environment variable > the package's
ignored ``ceph_tpu_torch/_build/``.  ``_cuda.build`` reads it when it
builds, not at import.
"""

from __future__ import annotations

import os

ENV = "CEPH_TPU_TORCH_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "_build")

_enabled: str | None = None


def cache_dir(directory: str | None = None) -> str:
    """The build directory: ``directory``, else the one
    :func:`enable_persistent_cache` set, else ``$CEPH_TPU_TORCH_CACHE_DIR``,
    else the package's ``_build/``."""
    return directory or _enabled or os.environ.get(ENV) or DEFAULT_DIR


def enable_persistent_cache(directory: str | None = None) -> str:
    """Make ``directory`` (default: :func:`cache_dir`) the build
    directory for the rest of the process; idempotent.  Returns it."""
    global _enabled
    directory = os.path.abspath(cache_dir(directory))
    if _enabled != directory:
        os.makedirs(directory, exist_ok=True)
        _enabled = directory
    return directory
