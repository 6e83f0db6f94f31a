"""Runtime half of the port's lint: measure the hot path's builds,
kernel calls and host reads on a live run, and the guards that turn
them into assertions.

The counterpart of the reference package's ``analysis/runtime_guard.py``.
The port traces nothing, so its three counts are:

- :class:`CompileCounter`: ``nvcc`` builds of a ``csrc/*.cu`` library in
  scope (``backend_compiles``), libraries found in the build cache
  (``cache_hits``), from ``_cuda.build``'s listeners, and CUDA graph
  captures (``captures``, from :func:`note_capture`).  ``n_compiles`` is
  their sum, as in the reference: a cache hit still means a library was
  asked for, and a capture is the port's compile of a program.
- :class:`LaunchCounter`: calls of the hand-written kernels' wrappers by
  kernel name, from each kernel module's ``CALLS`` (ticked on entry to
  the wrapper, before the device branch, so a CPU run counts them too),
  and the kernel launches that ran, from ``LAUNCHES``: those a wrapper
  made and those CUDA graph replays ran.  A call captured into a graph
  runs nothing then: it ticks ``CALLS`` only (``captured``).  Each
  replay adds the launches it ran to ``LAUNCHES`` and to the module's
  ``REPLAYS`` (``replays``; :func:`note_replay`, and for the launches in
  the graph's conditional bodies -- WHILE, IF and else, SWITCH branches,
  each counted as often as it ran --
  :func:`ceph_tpu_torch.core.graphs.collect`, which :func:`kernel_counts`
  runs before it reads).  On the card it
  also asserts that every call outside a capture launched its kernel:
  ``launches - replays`` equals ``calls - captured``.
- :class:`TransferCounter`: device->host reads at the seams the port
  uses (``Tensor.item``/``.tolist``/``.cpu``/``.numpy``, ``__bool__``,
  ``__int__``, ``__float__``, ``__index__``, ``__array__`` and
  ``torch.nonzero``), patched on ``torch.Tensor`` and undone on exit.
  Each seam call counts once (``t.cpu().numpy()`` is two seams; a seam
  called inside another, as ``__array__`` calls ``numpy``, is not
  counted again), and nothing counts inside a kernel's plain stand-in
  (:func:`plain_stand_in`), whose reads the card's kernel does not make.
  So the count is the same on the CPU as on the card.  On the card it
  also counts the warnings of ``torch.cuda.set_sync_debug_mode("warn")``
  (``sync_warnings``).  :func:`forbid_host_reads` turns the same seams
  into errors for CUDA tensors (a graph capture's scope).

:func:`track` composes them::

    with track() as g:
        run_hot_path()
    record(g.snapshot())

The rest are the reference's guards, with its semantics:
:func:`assert_no_recompile` and :class:`CompileBudget` (builds),
:func:`assert_bucketed` (the ``debug_bucket_checks`` knob),
:class:`FsyncAudit` (``debug_fsync_audit``) and the rank pieces
(``debug_rank_checks``): :func:`rank_fingerprint`,
:func:`assert_rank_identical`, :class:`RankDivergenceError` and
:class:`RankStalledError`.
"""

from __future__ import annotations

import contextlib
import zlib
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------- builds


#: ``callable(captured)`` for every CUDA graph capture
#: (:func:`note_capture`): :class:`CompileCounter` and
#: :class:`LaunchCounter` register here
CAPTURE_LISTENERS: list = []


def note_capture(captured: dict | None = None) -> None:
    """Tell the listeners that a CUDA graph was captured
    (:func:`ceph_tpu_torch.core.graphs.capture`), with the wrapper calls
    it recorded by kernel (``captured``)."""
    for fn in list(CAPTURE_LISTENERS):
        fn(dict(captured or {}))


class CompileCounter:
    """Counts kernel-library builds, build-cache hits and CUDA graph
    captures in scope."""

    def __init__(self) -> None:
        self.backend_compiles = 0
        self.cache_hits = 0
        self.captures = 0
        self._registered = False

    @property
    def n_compiles(self) -> int:
        return self.backend_compiles + self.cache_hits + self.captures

    def _on_build(self, name: str, event: str) -> None:
        if event == "compile":
            self.backend_compiles += 1
        else:
            self.cache_hits += 1

    def _on_capture(self, _captured: dict) -> None:
        self.captures += 1

    def __enter__(self) -> "CompileCounter":
        from .. import _cuda

        _cuda.BUILD_LISTENERS.append(self._on_build)
        CAPTURE_LISTENERS.append(self._on_capture)
        self._registered = True
        return self

    def __exit__(self, *exc) -> None:
        if not self._registered:
            return
        from .. import _cuda

        _cuda.BUILD_LISTENERS.remove(self._on_build)
        CAPTURE_LISTENERS.remove(self._on_capture)
        self._registered = False


# ---------------------------------------------------------------- kernel calls


def kernel_modules() -> tuple:
    """The modules of the hand-written kernels' wrappers, each with its
    ``CALLS``, ``LAUNCHES`` and ``reset_launches()`` (and ``REPLAYS``
    where a graph replays its kernels)."""
    from ..core import straw2
    from ..ec import gf_kernels, kernels, online
    from ..recovery import scrub

    return (straw2, gf_kernels, kernels, scrub, online)


def kernel_counts(which: str = "CALLS") -> dict[str, int]:
    """Every kernel module's ``CALLS`` (or ``LAUNCHES``, or ``REPLAYS``
    where a module's kernels are replayed in graphs), merged.  Before it
    reads ``LAUNCHES`` or ``REPLAYS`` it counts the launches of graph
    bodies replayed since (:func:`ceph_tpu_torch.core.graphs.collect`:
    one read of the card, when such a graph was replayed)."""
    if which != "CALLS":
        from ..core import graphs

        graphs.collect()
    out: dict[str, int] = {}
    for mod in kernel_modules():
        out.update(getattr(mod, which, {}))
    return out


def note_replay(launched: dict) -> None:
    """Count kernel launches that graph replays ran (kernel -> launches)
    in their modules' ``LAUNCHES`` and ``REPLAYS``."""
    for mod in kernel_modules():
        replays = getattr(mod, "REPLAYS", None)
        if replays is None:
            continue
        for k in replays:
            replays[k] += launched.get(k, 0)
            mod.LAUNCHES[k] += launched.get(k, 0)


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


class LaunchCounter:
    """Kernel-wrapper calls by kernel name in scope (``calls``), those
    among them captured into CUDA graphs (``captured``), the kernel
    launches that ran (``launches``: 0 on the CPU, where each wrapper
    runs its plain version), and those among them that graph replays ran
    (``replays``).  ``check_launches=True`` raises on exit when some call
    on the card outside a capture did not launch its kernel
    (``launches - replays`` differs from ``calls - captured``); pass it
    only where every tensor is on the card."""

    def __init__(self, check_launches: bool = False) -> None:
        self.check_launches = check_launches
        self.calls: dict[str, int] = {}
        self.launches: dict[str, int] = {}
        self.replays: dict[str, int] = {}
        self.captured: dict[str, int] = {}
        self._c0: dict[str, int] | None = None
        self._l0: dict[str, int] | None = None
        self._r0: dict[str, int] | None = None

    def __enter__(self) -> "LaunchCounter":
        self._c0 = kernel_counts("CALLS")
        self._l0 = kernel_counts("LAUNCHES")
        self._r0 = kernel_counts("REPLAYS")
        CAPTURE_LISTENERS.append(self._on_capture)
        return self

    def _on_capture(self, captured: dict) -> None:
        for k, v in captured.items():
            self.captured[k] = self.captured.get(k, 0) + v

    def __exit__(self, exc_type, exc, tb) -> None:
        CAPTURE_LISTENERS.remove(self._on_capture)
        c1, l1 = kernel_counts("CALLS"), kernel_counts("LAUNCHES")
        r1 = kernel_counts("REPLAYS")
        self.calls = {k: c1[k] - self._c0[k] for k in c1 if c1[k] != self._c0[k]}
        self.launches = {k: l1[k] - self._l0[k] for k in l1 if l1[k] != self._l0[k]}
        self.replays = {k: r1[k] - self._r0[k] for k in r1 if r1[k] != self._r0[k]}
        issued = _nonzero({k: v - self.captured.get(k, 0) for k, v in self.calls.items()})
        eager = _nonzero({k: v - self.replays.get(k, 0) for k, v in self.launches.items()})
        if exc_type is None and self.check_launches and eager != issued:
            raise AssertionError(
                f"kernel calls that did not launch their kernel: calls {self.calls} "
                f"({self.captured} captured), launches {self.launches} "
                f"({self.replays} by graph replays)")


# ---------------------------------------------------------------- host reads

#: ``torch.Tensor`` methods that read a tensor's values to the host
TENSOR_SEAMS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
                "__index__", "__array__", "nonzero")

# depth of seams and plain stand-ins in progress: a seam counts only at 0
_DEPTH = [0]


def _patch_seams(wrap) -> list:
    """Replace every seam by ``wrap(name, original)`` (on ``torch.Tensor``
    and ``torch.nonzero``); returns the undo callables, to run last
    first."""
    import torch

    cls = torch.Tensor
    undo = []
    for name in TENSOR_SEAMS:
        own = name in cls.__dict__
        orig = getattr(cls, name)
        setattr(cls, name, wrap(name, orig))
        undo.append((lambda n=name, o=orig: setattr(cls, n, o)) if own
                    else (lambda n=name: delattr(cls, n)))
    orig_nz = torch.nonzero
    torch.nonzero = wrap("torch.nonzero", orig_nz)
    undo.append(lambda: setattr(torch, "nonzero", orig_nz))
    return undo


@contextlib.contextmanager
def plain_stand_in():
    """Scope of a kernel wrapper's plain version on the CPU: host reads
    inside it are not counted (the card's kernel makes none)."""
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1


class TransferCounter:
    """Counts device->host reads at the seams while active (see the
    module docstring); ``sync_debug=True`` (on the card) also counts the
    sync-debug warnings into ``sync_warnings``."""

    def __init__(self, sync_debug: bool = False) -> None:
        self.host_transfers = 0
        self.by_seam: dict[str, int] = {}
        self.sync_debug = sync_debug
        self.sync_warnings = 0
        self._undo: list = []
        self._warn_cm = None
        self._seen: list | None = None

    def _wrap(self, name: str, orig):
        counter = self

        def wrapped(*a, **kw):
            if _DEPTH[0] == 0:
                counter.host_transfers += 1
                counter.by_seam[name] = counter.by_seam.get(name, 0) + 1
            _DEPTH[0] += 1
            try:
                return orig(*a, **kw)
            finally:
                _DEPTH[0] -= 1

        return wrapped

    def __enter__(self) -> "TransferCounter":
        import torch

        self._undo.extend(_patch_seams(self._wrap))
        if self.sync_debug:
            import warnings

            self._warn_cm = warnings.catch_warnings(record=True)
            self._seen = self._warn_cm.__enter__()
            warnings.simplefilter("always")
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            self._undo.append(lambda: torch.cuda.set_sync_debug_mode(prev))
        return self

    def __exit__(self, *exc) -> None:
        while self._undo:
            self._undo.pop()()
        if self._warn_cm is not None:
            self.sync_warnings = sum(1 for w in self._seen if "synchroniz" in str(w.message))
            self._warn_cm.__exit__(*exc)
            self._warn_cm = None


@contextlib.contextmanager
def guard_read():
    """Scope of the guard's own reads of the card (a graph's pass
    counters, :func:`ceph_tpu_torch.core.graphs.collect`): a
    :class:`TransferCounter` does not count them, and they raise no
    sync-debug warning, since the program did not make them."""
    import torch

    _DEPTH[0] += 1
    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else None
    if mode is not None:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        _DEPTH[0] -= 1


@contextlib.contextmanager
def forbid_host_reads(what: str):
    """Scope in which a host read of a CUDA tensor at a seam raises
    :class:`~ceph_tpu_torch.core.graphs.HostReadInCapture` (CPU tensors
    read as usual)."""
    import torch

    from ..core.graphs import HostReadInCapture

    def guard(name, orig):
        def wrapped(t, *a, **kw):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                raise HostReadInCapture(f"{name} reads a CUDA tensor to the host inside {what}")
            return orig(t, *a, **kw)
        return wrapped

    undo = _patch_seams(guard)
    try:
        yield
    finally:
        while undo:
            undo.pop()()


@dataclass
class GuardStats:
    """Combined counters from one :func:`track` scope."""

    compile_counter: CompileCounter = field(default_factory=CompileCounter)
    transfer_counter: TransferCounter = field(default_factory=TransferCounter)
    launch_counter: LaunchCounter = field(default_factory=LaunchCounter)

    @property
    def n_compiles(self) -> int:
        return self.compile_counter.n_compiles

    @property
    def backend_compiles(self) -> int:
        return self.compile_counter.backend_compiles

    @property
    def cache_hits(self) -> int:
        return self.compile_counter.cache_hits


    @property
    def host_transfers(self) -> int:
        return self.transfer_counter.host_transfers

    def snapshot(self) -> dict:
        return {
            "n_compiles": self.n_compiles,
            "backend_compiles": self.backend_compiles,
            "compile_cache_hits": self.cache_hits,
            "host_transfers": self.host_transfers,
            "sync_warnings": self.transfer_counter.sync_warnings,
            "kernel_calls": dict(self.launch_counter.calls),
            "kernel_launches": dict(self.launch_counter.launches),
        }


@contextlib.contextmanager
def track(transfers: bool = True, sync_debug: bool = False, check_launches: bool = False):
    """Measure builds, kernel calls and (optionally) host reads in a
    scope; ``sync_debug`` and ``check_launches`` are for the card."""
    stats = GuardStats(transfer_counter=TransferCounter(sync_debug),
                       launch_counter=LaunchCounter(check_launches))
    with contextlib.ExitStack() as stack:
        stack.enter_context(stats.compile_counter)
        stack.enter_context(stats.launch_counter)
        if transfers:
            stack.enter_context(stats.transfer_counter)
        yield stats


@contextlib.contextmanager
def assert_no_recompile(what: str = "steady state"):
    """Raise if any kernel library is built or looked up, or any CUDA
    graph captured, in the scope."""
    with CompileCounter() as cc:
        yield cc
    if cc.n_compiles:
        raise AssertionError(
            f"{what}: expected zero recompiles, observed "
            f"{cc.backend_compiles} backend compile(s) + "
            f"{cc.cache_hits} cache hit(s) + {cc.captures} graph capture(s)"
        )


class CompileBudget:
    """Context manager failing the scope when more than ``budget``
    kernel libraries are built (or looked up in the build cache), or CUDA
    graphs captured, in it.

    ::

        with CompileBudget(0, "fleet superstep, same pad bucket"):
            driver.run_fleet(8, tls)   # every library already loaded
    """

    def __init__(self, budget: int, what: str = "scope"):
        self.budget = int(budget)
        self.what = what
        self._cc = CompileCounter()

    @property
    def n_compiles(self) -> int:
        return self._cc.n_compiles

    def __enter__(self) -> "CompileBudget":
        self._cc.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._cc.__exit__(exc_type, exc, tb)
        if exc_type is None and self._cc.n_compiles > self.budget:
            raise AssertionError(
                f"{self.what}: compile budget {self.budget} exceeded — "
                f"observed {self._cc.backend_compiles} backend "
                f"compile(s) + {self._cc.cache_hits} cache hit(s) + "
                f"{self._cc.captures} graph capture(s)"
            )


# ---------------------------------------------------------------- rank guard
# A fingerprint of the operands about to enter a mesh seam is gathered
# from every rank; if any rank computed a different one, every rank sees
# the same disagreement and raises RankDivergenceError, instead of some
# subset deadlocking inside the real collective that would have followed.


class RankDivergenceError(AssertionError):
    """Ranks disagree on data that must be rank-identical."""


class RankStalledError(RuntimeError):
    """A rank stopped advancing and exhausted the reconcile retry
    budget.

    Raised by the reconcile protocol at the same round on every rank:
    the verdict is computed from the per-rank progress vector every rank
    sees, so each evaluates the identical condition and raises in
    lockstep instead of the live ranks waiting on the dead one.
    """


#: fingerprints are folded into this many bits so n * h^2 stays far
#: inside int64 for any plausible device count
_HASH_BITS = 20


def rank_fingerprint(*arrays) -> int:
    """Order-sensitive CRC of (shape, dtype, bytes) per operand, folded
    to ``_HASH_BITS`` bits and never zero (an accidental all-zero sum
    cannot fake a pass)."""
    h = 0
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h = zlib.crc32(repr((a.shape, str(a.dtype))).encode(), h)
        h = zlib.crc32(a.tobytes(), h)
    return (h % ((1 << _HASH_BITS) - 3)) + 1


def rank_checks_enabled() -> bool:
    """The ``debug_rank_checks`` config knob (env:
    ``CEPH_TPU_DEBUG_RANK_CHECKS=1``)."""
    from ..common.config import global_config

    return bool(global_config().get("debug_rank_checks"))


def assert_rank_identical(tag: str, *arrays, mesh, axis=None) -> None:
    """Raise :class:`RankDivergenceError` (on every rank) when the
    operands' fingerprint differs across ``mesh``'s ranks.

    Call at mesh seams *before* launching sharded work, gated by
    :func:`rank_checks_enabled`.  Every rank all-gathers every rank's
    fingerprint and evaluates the same verdict, so divergence raises
    everywhere at once rather than deadlocking a subset inside a later
    collective.  Tensors are read back to the host to be hashed."""
    import torch

    host = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in arrays]
    h = rank_fingerprint(*host)
    fps = mesh.gather_stack(torch.tensor([h], dtype=torch.int64)).reshape(-1).tolist()
    if len(set(fps)) > 1:
        name = axis or mesh.axis_names[0]
        raise RankDivergenceError(
            f"{tag}: rank-divergent operands at a mesh seam — this rank's "
            f"fingerprint {h} disagrees across the {mesh.size}-rank {name!r} "
            f"axis (fingerprints by rank {fps}).  Some rank observed different "
            "bytes/shape/dtype; the collective that would have followed could "
            "deadlock or silently mix divergent state")


# ---------------------------------------------------------------- bucket guard
# The seam sizes that go through a bucketing helper really are powers of
# two: a broken helper would give every batch a shape of its own.


class UnbucketedShapeError(AssertionError):
    """A padded seam dimension is not a power of two."""


def is_pow2(n: int) -> bool:
    n = int(n)
    return n > 0 and (n & (n - 1)) == 0


def bucket_checks_enabled() -> bool:
    """The ``debug_bucket_checks`` config knob (env:
    ``CEPH_TPU_DEBUG_BUCKET_CHECKS=1``)."""
    from ..common.config import global_config

    return bool(global_config().get("debug_bucket_checks"))


def assert_bucketed(tag: str, *sizes) -> None:
    """Raise :class:`UnbucketedShapeError` unless every size is a
    power of two.  Each operand is an int, or an array whose leading
    dimension is checked (the padded-lane convention).  Call at the
    seams where bucketed shapes enter the device path, gated by
    :func:`bucket_checks_enabled`."""
    for s in sizes:
        n = s if isinstance(s, int) else int(getattr(s, "shape", (0,))[0])
        if not is_pow2(n):
            raise UnbucketedShapeError(
                f"{tag}: seam size {n} is not a power of two — a "
                "data-dependent count reached the device path without "
                "bucketing (every distinct count is a shape of its own); "
                "route it through _pad_to/_pow2_bucket"
            )


# ---------------------------------------------------------------- fsync audit
# Every os.replace must be preceded by an fsync of a regular file (the
# data) and followed by an fsync of a directory (the rename) before the
# audit scope closes.


def fsync_audit_enabled() -> bool:
    """The ``debug_fsync_audit`` config knob (env:
    ``CEPH_TPU_DEBUG_FSYNC_AUDIT=1``)."""
    from ..common.config import global_config

    return bool(global_config().get("debug_fsync_audit"))


class FsyncAuditError(AssertionError):
    """A rename committed without the fsyncs that make it durable."""


class FsyncAudit:
    """Records every ``os.fsync``/``os.replace`` in scope and verifies
    the crash-consistency ordering::

        with FsyncAudit("checkpoint commit") as audit:
            store.save(...)
        audit.verify()

    ``verify()`` raises :class:`FsyncAuditError` when a replace had no
    prior file fsync (contents can vanish across the rename) or no
    later directory fsync (the rename itself is not durable).
    """

    def __init__(self, what: str = "durable write"):
        self.what = what
        self.events: list[tuple[str, object]] = []
        self._undo: list = []

    def __enter__(self) -> "FsyncAudit":
        import os as _os
        import stat as _stat

        audit = self
        orig_fsync, orig_replace = _os.fsync, _os.replace

        def fsync(fd):
            try:
                is_dir = _stat.S_ISDIR(_os.fstat(fd).st_mode)
            except OSError:
                is_dir = False
            audit.events.append(("fsync_dir" if is_dir else "fsync", fd))
            return orig_fsync(fd)

        def replace(src, dst, **kw):
            audit.events.append(("replace", str(dst)))
            return orig_replace(src, dst, **kw)

        _os.fsync, _os.replace = fsync, replace
        self._undo = [
            lambda: setattr(_os, "fsync", orig_fsync),
            lambda: setattr(_os, "replace", orig_replace),
        ]
        return self

    def __exit__(self, *exc) -> None:
        while self._undo:
            self._undo.pop()()

    def verify(self) -> None:
        kinds = [k for k, _ in self.events]
        for i, kind in enumerate(kinds):
            if kind != "replace":
                continue
            if "fsync" not in kinds[:i]:
                raise FsyncAuditError(
                    f"{self.what}: os.replace({self.events[i][1]!r}) "
                    "with no prior file fsync — the rename can commit "
                    "before the data"
                )
            if "fsync_dir" not in kinds[i + 1:]:
                raise FsyncAuditError(
                    f"{self.what}: os.replace({self.events[i][1]!r}) "
                    "with no later directory fsync — the rename itself "
                    "is not durable"
                )
