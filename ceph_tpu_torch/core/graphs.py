"""CUDA graphs with conditional nodes: capture a program once, replay it.

A program here is eager PyTorch code with kernel launches (the fused
placement->peering program of :mod:`ceph_tpu_torch.recovery.pipeline`,
a chunk of the epoch loop of :mod:`ceph_tpu_torch.recovery.superstep`).
:func:`capture` records one run of it on the card as a
``torch.cuda.CUDAGraph``; :meth:`Graph.replay` runs the recording with no
Python between its launches.  The program's decisions stay in the graph
as conditional nodes, each on a value on the device:

- :func:`while_node` opens a WHILE node (the CRUSH retry ladder of
  :mod:`ceph_tpu_torch.crush.interp_batch`, the epoch loop's steps and
  its tape window) whose condition is a bool recomputed at the end of
  each pass of the body;
- :func:`if_node` adds an IF node with an optional else body (the
  liveness tick, the dirty branch);
- :func:`switch_node` adds a SWITCH node that runs the body an int32
  index names, or none when it is out of range (a tape row's edit, the
  compaction ladder's rung).

The code run inside is captured into the node's bodies, which nest: a
node opened inside a body lands in that body.  No host read happens in a
replay.  Each of the three raises outside a capture; :func:`loop`,
:func:`cond` and :func:`switch` are the same decisions for code that
also runs eagerly, reading the predicate to the host there.

The nodes come from ``csrc/graph.cu`` (the CUDA runtime's conditional
nodes: IF and WHILE need CUDA 12.4, an else body and SWITCH 12.8), since
PyTorch's own binding is missing from some releases.  A body is captured
on a stream of its own, one a nesting depth, and its memory comes from a
pool of the capture's own (``torch.cuda.MemPool``): PyTorch's capture
pool serves only the main capture's stream.

Rules of a capture, each of which raises when broken (there is no
fallback to running the program eagerly):

- the mode is ``"global"``: no thread may make an unsafe CUDA call
  (``cudaMalloc``, a synchronous copy) while the capture runs.  The
  kernel launchers make their one-time runtime calls (occupancy, the
  shared-memory limit) and the wrappers upload their tables on first
  use, so the caller runs the program once eagerly first (the warm-up),
  every branch of it;
- a host read of a CUDA tensor at a seam (``.item()``, ``bool()``,
  ``.cpu()``...) raises :class:`HostReadInCapture` before it reaches the
  driver;
- state a body updates must be updated in place, in buffers made before
  the node: a tensor a body makes holds nothing where the body did not
  run;
- Python's cyclic garbage collector is off while a capture runs: a
  collection could free another graph or its memory pool (a driver
  left in a reference cycle with its program), which a capturing stream
  refuses and PyTorch's allocator aborts on.  :func:`capture` collects
  first, outside it.

A graph counts in the runtime guard.  Its capture is a build
(:func:`~ceph_tpu_torch.analysis.runtime_guard.note_capture`); the
launches it records run nothing then, so they count as wrapper calls
only.  Each replay counts the launches it ran
(:func:`~ceph_tpu_torch.analysis.runtime_guard.note_replay`): those
outside every conditional body at once, and those in a body as often as
the body ran.  Every body (a WHILE node's, each of an IF node's two,
each of a SWITCH node's) adds one to its own counter on the card at each
pass; :func:`collect` reads the counters (one read, made by the guard's
readers of ``LAUNCHES``, never inside a replay) and counts each body's
launches that many times.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import time

import torch

#: the capture's error mode (see the module docstring)
CAPTURE_MODE = "global"
#: conditional bodies a capture may hold (each has a pass counter on the card)
MAX_BODIES = 4096
_MODE_CODES = {"global": 0, "thread_local": 1, "relaxed": 2}
#: ``csrc/graph.cu``'s node types
_IF, _WHILE, _SWITCH = 0, 1, 2

#: predicates the eager forms (:func:`loop`, :func:`cond`, :func:`switch`)
#: read to the host, outside a capture
PREDICATE_READS = 0


class HostReadInCapture(RuntimeError):
    """A CUDA tensor was read to the host while a graph was captured."""


class _Capture:
    """A capture in progress: its device, its bodies' pool, the depth of
    the body being captured, the nodes counted so far, and the
    conditional bodies' pass counters and launches."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.pool = torch.cuda.MemPool()
        self.depth = 0
        self.nodes = 0
        self.cond_nodes = 0
        # one pass counter a body, made before the capture: no replay resets it
        self.passes = torch.zeros(MAX_BODIES, dtype=torch.int64, device=dev)
        self.bodies: list[dict] = []  # body -> kernel launches captured in it, not nested
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
    captured (a program's decisions then become conditional nodes)."""
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


def _active(what: str) -> _Capture:
    if not _ACTIVE:
        raise RuntimeError(f"{what} needs a capture started by graphs.capture")
    return _ACTIVE[-1]


def _operand(t: torch.Tensor, dtype, what: str) -> torch.Tensor:
    if not capturing(t) or t.dtype != dtype or t.numel() != 1:
        raise TypeError(f"{what} is one {dtype} on the card, computed inside the capture")
    return t.contiguous()


def _node(cap: _Capture, operand: torch.Tensor, kind: int, size: int, what: str):
    """Add a conditional node of ``kind`` with ``size`` bodies after the
    kernel that sets its handle from ``operand``; returns the bodies'
    graphs and the handle."""
    bodies = (ctypes.c_void_p * size)()
    handle = ctypes.c_ulonglong()
    cur = torch.cuda.current_stream(cap.dev)
    _check(_lib().graph_cond_add(cur.cuda_stream, operand.data_ptr(), int(kind == _SWITCH),
                                 kind, size, bodies, ctypes.byref(handle)), what)
    cap.cond_nodes += 1
    return list(bodies), handle


@contextlib.contextmanager
def _body(cap: _Capture, graph, last=None):
    """Capture the code run inside into the body graph ``graph``.  The
    body ends by adding one to its pass counter, then ``last(stream)``
    (a WHILE node's next condition)."""
    from ..analysis.runtime_guard import kernel_counts

    slot = len(cap.bodies)
    if slot == MAX_BODIES:
        raise RuntimeError(f"more than {MAX_BODIES} conditional bodies in one capture")
    lib = _lib()
    stream = _body_stream(cap.dev, cap.depth)
    _check(lib.graph_body_begin(stream.cuda_stream, graph, _MODE_CODES[CAPTURE_MODE]),
           "graph_body_begin")
    cap.depth += 1
    cap.bodies.append({})
    cap.inner.append({})
    outer = cap.depth == 1
    before = kernel_counts("CALLS")
    failed = True
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.cuda.stream(stream))
            if outer:  # nested bodies stay in the thread's pool
                stack.enter_context(torch.cuda.use_mem_pool(cap.pool, cap.dev))
            yield
            cap.passes.narrow(0, slot, 1).add_(1)
            if last is not None:
                last(stream)
        failed = False
    finally:
        cap.depth -= 1
        nodes = ctypes.c_longlong()
        rc = lib.graph_cond_end(stream.cuda_stream, graph, ctypes.byref(nodes))
        cap.nodes += nodes.value
        total = _delta(before, kernel_counts("CALLS"))
        nested = cap.inner.pop()
        cap.bodies[slot] = {k: v - nested.get(k, 0) for k, v in total.items()
                            if v > nested.get(k, 0)}
        _add(cap.inner[-1], total)
        if not failed:
            _check(rc, "graph_cond_end")


@contextlib.contextmanager
def while_node(cond):
    """Capture the code run inside as the body of a WHILE node: a replay
    runs it again and again while ``cond()`` (a bool scalar on the card)
    holds, evaluated before the node and at the end of each pass of the
    body, whose in-place updates it sees."""
    cap = _active("a WHILE node")

    def predicate() -> torch.Tensor:
        return _operand(cond(), torch.bool, "a WHILE node's condition")

    (graph,), handle = _node(cap, predicate(), _WHILE, 1, "graph_cond_add(WHILE)")

    def again(stream):
        _check(_lib().graph_cond_set(stream.cuda_stream, handle, predicate().data_ptr()),
               "graph_cond_set")

    with _body(cap, graph, again):
        yield


def if_node(pred: torch.Tensor, then, otherwise=None) -> None:
    """Capture ``then()`` as the body of an IF node on ``pred`` (a bool
    scalar on the card) and ``otherwise()``, when given, as its else
    body."""
    cap = _active("an IF node")
    fns = (then,) if otherwise is None else (then, otherwise)
    bodies, _handle = _node(cap, _operand(pred, torch.bool, "an IF node's condition"), _IF,
                            len(fns), "graph_cond_add(IF)")
    for graph, fn in zip(bodies, fns):
        with _body(cap, graph):
            fn()


def switch_node(index: torch.Tensor, branches) -> None:
    """Capture each of ``branches`` as a body of a SWITCH node on
    ``index`` (one int32 on the card): a replay runs ``branches[index]``,
    or none when ``index`` is negative or past the last."""
    cap = _active("a SWITCH node")
    branches = list(branches)
    bodies, _handle = _node(cap, _operand(index, torch.int32, "a SWITCH node's index"),
                            _SWITCH, len(branches), "graph_cond_add(SWITCH)")
    for graph, fn in zip(bodies, branches):
        with _body(cap, graph):
            fn()


# The same three decisions for code that also runs eagerly: under a
# capture a conditional node, otherwise one host read of the predicate.


def _read(what):
    global PREDICATE_READS
    PREDICATE_READS += 1
    return what


def loop(cond, body) -> None:
    """``while cond(): body()``: a WHILE node under a capture."""
    probe = cond()
    if capturing(probe):
        first = [probe]
        with while_node(lambda: first.pop() if first else cond()):
            body()
        return
    while bool(_read(probe)):
        body()
        probe = cond()


def cond(pred: torch.Tensor, then, otherwise=None) -> None:
    """``then() if pred else otherwise()``: an IF node under a capture."""
    if capturing(pred):
        if_node(pred, then, otherwise)
    elif bool(_read(pred)):
        then()
    elif otherwise is not None:
        otherwise()


def switch(index: torch.Tensor, branches) -> None:
    """``branches[index]()`` (none out of range): a SWITCH node under a
    capture."""
    if capturing(index):
        switch_node(index.to(torch.int32), branches)
        return
    i = int(_read(index))
    if 0 <= i < len(branches):
        branches[i]()


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


class Graph:
    """One captured program: the graph, the tensors its outputs live in
    (overwritten by every replay), and what the capture recorded."""

    def __init__(self, graph, outputs, pool, *, nodes: int, cond_nodes: int,
                 launches: dict, in_bodies: dict, bodies: list, passes: torch.Tensor,
                 capture_ms: float, pool_bytes: int):
        self.graph = graph
        self.outputs = outputs
        self.pool = pool
        self.nodes = nodes          # graph nodes, bodies included
        self.cond_nodes = cond_nodes  # conditional nodes among them
        self.launches = launches    # kernel launches captured, by kernel
        # the launches every replay makes: those outside the conditional bodies
        self.sure = {k: v - in_bodies.get(k, 0) for k, v in launches.items()
                     if v > in_bodies.get(k, 0)}
        self.bodies = bodies        # conditional body -> launches it makes a pass
        self._passes = passes       # the bodies' pass counters since the last collect
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
        if self.bodies:
            _PENDING[id(self)] = self
        return self.outputs

    def _collect(self) -> None:
        from ..analysis.runtime_guard import guard_read, note_replay

        _PENDING.pop(id(self), None)
        with guard_read():
            if self._passes.is_cuda:
                torch.cuda.synchronize(self._passes.device)
            passes = self._passes[:len(self.bodies)].tolist()
        self._passes.zero_()
        launched: dict[str, int] = {}
        for n, body in zip(passes, self.bodies):
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
    """Count the launches the conditional bodies of the replays since the
    last call ran: one read of each such graph's pass counters (none when
    no graph with a conditional node was replayed).  Never inside a
    capture."""
    if not _PENDING or (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
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
    collecting = gc.isenabled()
    gc.collect()  # the garbage's graphs and pools freed before the capture begins
    t0 = time.perf_counter()
    _ACTIVE.append(cap)
    gc.disable()
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
        if collecting:
            gc.enable()
    torch.cuda.synchronize(dev)
    capture_ms = (time.perf_counter() - t0) * 1e3
    # a captured launch ran nothing: it is a wrapper call, not a launch
    captured = _delta(calls0, runtime_guard.kernel_counts("CALLS"))
    runtime_guard.note_capture(captured)
    return Graph(graph, outputs, cap.pool, nodes=cap.nodes + top.value,
                 cond_nodes=cap.cond_nodes, launches=captured, in_bodies=cap.inner[0],
                 bodies=cap.bodies, passes=cap.passes, capture_ms=capture_ms,
                 pool_bytes=torch.cuda.memory_reserved(dev) - reserved0)
