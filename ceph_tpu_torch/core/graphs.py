"""CUDA graphs with conditional nodes: capture a program once, replay it.

A program here is eager PyTorch code with kernel launches (the fused
placement->peering program of :mod:`ceph_tpu_torch.recovery.pipeline`).
:func:`capture` records one run of it on the card as a
``torch.cuda.CUDAGraph``; :meth:`Graph.replay` runs the recording with no
Python between its launches.  A data-dependent loop (the CRUSH retry
ladder of :mod:`ceph_tpu_torch.crush.interp_batch`) stays in the graph as
a conditional node: :func:`while_node` opens a WHILE node whose
condition is a bool on the device, recomputed at the end of each pass;
the code run inside is captured into the node's body, which a replay
runs while the condition holds.  No host read happens in a replay.

The nodes come from ``csrc/graph.cu`` (the CUDA runtime's conditional
nodes, CUDA 12.4 or later), since PyTorch's own binding is missing from
some releases.  A body is captured on a stream of its own, one a nesting
depth, and its memory comes from a pool of the capture's own
(``torch.cuda.MemPool``): PyTorch's capture pool serves only the main
capture's stream.

Rules of a capture, each of which raises when broken (there is no
fallback to running the program eagerly):

- the mode is ``"global"``: no thread may make an unsafe CUDA call
  (``cudaMalloc``, a synchronous copy) while the capture runs.  The
  kernel launchers make their one-time runtime calls (occupancy, the
  shared-memory limit) and the wrappers upload their tables on first
  use, so the caller runs the program once eagerly first (the warm-up);
- a host read of a CUDA tensor at a seam (``.item()``, ``bool()``,
  ``.cpu()``...) raises :class:`HostReadInCapture` before it reaches the
  driver;
- state a body updates must be updated in place: a tensor a body makes
  holds nothing where the body did not run.

A graph counts in the runtime guard.  Its capture is a build
(:func:`~ceph_tpu_torch.analysis.runtime_guard.note_capture`); the
launches it records run nothing then, so they count as wrapper calls
only.  Each replay counts the launches it ran
(:func:`~ceph_tpu_torch.analysis.runtime_guard.note_replay`): those
outside any WHILE node at once, and those in a body as often as the
body ran.  Every body adds one to its own counter on the card at each
pass; :func:`collect` reads the counters (one read, made by the guard's
readers of ``LAUNCHES``, never inside a replay) and counts each body's
launches that many times.
"""

from __future__ import annotations

import contextlib
import ctypes
import time

import torch

#: the capture's error mode (see the module docstring)
CAPTURE_MODE = "global"
#: WHILE nodes a capture may hold (each has a pass counter on the card)
MAX_LOOPS = 4096
_MODE_CODES = {"global": 0, "thread_local": 1, "relaxed": 2}


class HostReadInCapture(RuntimeError):
    """A CUDA tensor was read to the host while a graph was captured."""


class _Capture:
    """A capture in progress: its device, its bodies' pool, the depth of
    the WHILE node being captured, the nodes counted so far, and the
    WHILE nodes' pass counters and launches."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.pool = torch.cuda.MemPool()
        self.depth = 0
        self.nodes = 0
        self.cond_nodes = 0
        # one pass counter a WHILE node, made before the capture: no replay resets it
        self.passes = torch.zeros(MAX_LOOPS, dtype=torch.int64, device=dev)
        self.loops: list[dict] = []  # node -> kernel launches captured in its body, not nested
        self.inner: list[dict] = [{}]  # a level a depth: launches captured in its nodes' bodies


def _add(acc: dict, launched: dict, times: int = 1) -> None:
    for k, v in launched.items():
        acc[k] = acc.get(k, 0) + v * times


_ACTIVE: list[_Capture] = []
# graphs replayed since their pass counters were last read (collect)
_PENDING: dict[int, "Graph"] = {}
# per device index: the body streams, one a nesting depth
_BODY_STREAMS: dict[int, list] = {}


def _lib():
    from .. import _cuda

    return _cuda.lib("graph")


def _check(rc: int, what: str) -> None:
    if rc:
        msg = _lib().graph_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def capturing(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card and the current stream is being
    captured (a program's retry rounds then become a WHILE node)."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def runtime_versions() -> tuple[int, int]:
    """(CUDA runtime the graph library was built with, driver)."""
    rt, drv = ctypes.c_int(), ctypes.c_int()
    _check(_lib().graph_runtime(ctypes.byref(rt), ctypes.byref(drv)), "graph_runtime")
    return rt.value, drv.value


def _body_stream(dev: torch.device, depth: int):
    streams = _BODY_STREAMS.setdefault(dev.index, [])
    while len(streams) <= depth:
        handle = ctypes.c_void_p()
        with torch.cuda.device(dev):
            _check(_lib().graph_stream_create(ctypes.byref(handle)), "graph_stream_create")
        streams.append(torch.cuda.ExternalStream(handle.value, device=dev))
    return streams[depth]


@contextlib.contextmanager
def while_node(cond):
    """Capture the code run inside as the body of a WHILE node: a replay
    runs it again and again while ``cond()`` (a bool scalar on the card)
    holds, evaluated before the node and at the end of each pass of the
    body, whose in-place updates it sees.  Nests: a node opened inside a
    body lands in that body.  The body ends by adding one to the node's
    pass counter."""
    from ..analysis.runtime_guard import kernel_counts

    if not _ACTIVE:
        raise RuntimeError("a WHILE node needs a capture started by graphs.capture")
    cap = _ACTIVE[-1]
    slot = len(cap.loops)
    if slot == MAX_LOOPS:
        raise RuntimeError(f"more than {MAX_LOOPS} WHILE nodes in one capture")
    lib = _lib()

    def predicate() -> torch.Tensor:
        pred = cond()
        if not capturing(pred) or pred.dtype != torch.bool or pred.numel() != 1:
            raise TypeError("a WHILE node's condition is one bool on the card, "
                            "computed inside the capture")
        return pred.contiguous()

    pred = predicate()
    body = _body_stream(cap.dev, cap.depth)
    cur = torch.cuda.current_stream(cap.dev)
    graph, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
    _check(lib.graph_while_begin(cur.cuda_stream, pred.data_ptr(), body.cuda_stream,
                                 _MODE_CODES[CAPTURE_MODE], ctypes.byref(graph),
                                 ctypes.byref(handle)), "graph_while_begin")
    cap.depth += 1
    cap.cond_nodes += 1
    cap.loops.append({})
    cap.inner.append({})
    outer = cap.depth == 1
    before = kernel_counts("CALLS")
    failed = True
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.cuda.stream(body))
            if outer:  # nested bodies stay in the thread's pool
                stack.enter_context(torch.cuda.use_mem_pool(cap.pool, cap.dev))
            yield
            cap.passes.narrow(0, slot, 1).add_(1)
            _check(lib.graph_cond_set(body.cuda_stream, handle, predicate().data_ptr()),
                   "graph_cond_set")
        failed = False
    finally:
        cap.depth -= 1
        nodes = ctypes.c_longlong()
        rc = lib.graph_cond_end(body.cuda_stream, graph, ctypes.byref(nodes))
        cap.nodes += nodes.value
        total = _delta(before, kernel_counts("CALLS"))
        nested = cap.inner.pop()
        cap.loops[slot] = {k: v - nested.get(k, 0) for k, v in total.items()
                           if v > nested.get(k, 0)}
        _add(cap.inner[-1], total)
        if not failed:
            _check(rc, "graph_cond_end")


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


class Graph:
    """One captured program: the graph, the tensors its outputs live in
    (overwritten by every replay), and what the capture recorded."""

    def __init__(self, graph, outputs, pool, *, nodes: int, cond_nodes: int,
                 launches: dict, in_loops: dict, loops: list, passes: torch.Tensor,
                 capture_ms: float, pool_bytes: int):
        self.graph = graph
        self.outputs = outputs
        self.pool = pool
        self.nodes = nodes          # graph nodes, bodies included
        self.cond_nodes = cond_nodes  # conditional nodes among them
        self.launches = launches    # kernel launches captured, by kernel
        # the launches every replay makes: those outside the WHILE nodes
        self.sure = {k: v - in_loops.get(k, 0) for k, v in launches.items()
                     if v > in_loops.get(k, 0)}
        self.loops = loops          # WHILE node -> launches its body makes a pass
        self._passes = passes       # the nodes' pass counters since the last collect
        self.capture_ms = capture_ms
        self.pool_bytes = pool_bytes  # device memory the capture reserved (its pools)
        self.replays = 0
        self.launched: dict[str, int] = {}  # launches the replays ran, as collected

    def replay(self):
        """Run the graph on the current stream; returns the outputs."""
        from ..analysis.runtime_guard import note_replay

        self.graph.replay()
        self.replays += 1
        note_replay(self.sure)
        _add(self.launched, self.sure)
        if self.loops:
            _PENDING[id(self)] = self
        return self.outputs

    def _collect(self) -> None:
        from ..analysis.runtime_guard import guard_read, note_replay

        _PENDING.pop(id(self), None)
        with guard_read():
            torch.cuda.synchronize(self._passes.device)
            passes = self._passes[:len(self.loops)].tolist()
        self._passes.zero_()
        launched: dict[str, int] = {}
        for n, body in zip(passes, self.loops):
            _add(launched, body, n)
        note_replay(launched)
        _add(self.launched, launched)

    def release(self) -> None:
        """Free the graph and the memory of its buffers (its bodies'
        launches counted first)."""
        if id(self) in _PENDING:
            self._collect()
        self.graph.reset()
        self.graph = self.outputs = self.pool = self._passes = None


def collect() -> None:
    """Count the launches the WHILE bodies of the replays since the last
    call ran: one read of each such graph's pass counters (none when no
    graph with a WHILE node was replayed).  Never inside a capture."""
    if not _PENDING or torch.cuda.is_current_stream_capturing():
        return
    for g in list(_PENDING.values()):
        g._collect()


def capture(fn, device) -> Graph:
    """Capture ``fn()`` on ``device`` (warmed up by the caller) into a
    :class:`Graph` holding its outputs.  Raises on any fault of the
    capture (see the module docstring)."""
    from ..analysis import runtime_guard

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("a graph is captured on the card")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    lib = _lib()
    cap = _Capture(dev)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    calls0 = runtime_guard.kernel_counts("CALLS")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _ACTIVE.append(cap)
    try:
        with torch.cuda.device(dev), runtime_guard.forbid_host_reads("a CUDA graph capture"):
            with torch.cuda.graph(graph, stream=side, capture_error_mode=CAPTURE_MODE):
                # read here: entering the capture empties the allocator's cache
                reserved0 = torch.cuda.memory_reserved(dev)
                outputs = fn()
                top = ctypes.c_longlong()
                _check(lib.graph_capture_nodes(side.cuda_stream, ctypes.byref(top)),
                       "graph_capture_nodes")
    finally:
        _ACTIVE.pop()
    torch.cuda.synchronize(dev)
    capture_ms = (time.perf_counter() - t0) * 1e3
    # a captured launch ran nothing: it is a wrapper call, not a launch
    captured = _delta(calls0, runtime_guard.kernel_counts("CALLS"))
    runtime_guard.note_capture(captured)
    return Graph(graph, outputs, cap.pool, nodes=cap.nodes + top.value,
                 cond_nodes=cap.cond_nodes, launches=captured, in_loops=cap.inner[0],
                 loops=cap.loops, passes=cap.passes, capture_ms=capture_ms,
                 pool_bytes=torch.cuda.memory_reserved(dev) - reserved0)
