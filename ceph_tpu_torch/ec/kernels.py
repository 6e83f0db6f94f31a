"""GF(2) kernels K5 and K6: wrappers, launch counters, plain versions.

The counterpart of ``ceph_tpu/ec/pallas_kernels.py``.  Each wrapper
takes tensors on one device: on a CUDA tensor it launches the kernel
from ``csrc/ec.cu`` (or raises), on a CPU tensor it runs the plain
PyTorch version.  Calls are counted in ``CALLS`` (on entry, on any
device), launches in ``LAUNCHES``.  A call captured into a CUDA graph
(:mod:`ceph_tpu_torch.core.graphs`: K6 in the compiled write path's
body) ticks ``CALLS`` only; the launches its replays run are added to
``LAUNCHES`` and ``REPLAYS`` by the runtime guard.

- K5 :func:`bitmatrix_encode`: the GF(2) bitmatrix product over packet
  rows, ``out[r] = XOR_s (d[s] & bitmatrix[r, s])``, for any word size
  ``w`` — every bitmatrix codec's encode and decode
  (``backend.BitmatrixEncoder``).  The kernel walks only the set
  entries: :class:`Bitmatrix` compiles the bitmatrix once into
  per-output-row lists of input rows in balanced row groups
  (``Bitmatrix.prog``), which :func:`bitmatrix_walk_plain` interprets
  in plain PyTorch, tile by tile as the kernel stages them, so the CPU
  tests hold the lists and the tile order to the reference.

Packet layout (``gfref_bitmatrix_encode``'s, generalised to any w):
each chunk is groups of ``w`` packets of ``packetsize`` bytes; packet
row ``s = j*w + l`` of group ``g`` is bytes ``[g*w*p + l*p, +p)`` of
chunk ``j``, and output row ``r = i*w + t`` lands at the same place in
output chunk ``i``.  The kernel indexes that layout in place, so there
is no packing step.

- K6 :func:`schedule_apply`: the XOR-schedule interpreter over u32 word
  rows (carried as int32: XOR is bit-identical).  Buffers are
  ``[inputs | outputs | derived]``, non-input buffers start zeroed, each
  step ``(dst, src)`` does ``buf[dst] ^= buf[src]``, and the result is
  rows ``n_in : n_in + n_out`` — every compiled schedule of
  ``ec.schedule.XorScheduleEncoder`` (the recovery executor's bit-level
  pattern groups), whose steps are checked once on the host
  (:class:`StepTable`).  The kernel does not read the steps: it runs an
  :class:`XorProgram` compiled from them on the host
  (:func:`compile_program`: one register-accumulated op per run of
  same-``dst`` steps, groups of loads issued before their stores, slots
  reused by liveness), with every slot of a block's columns in shared
  memory where they fit (:func:`schedule_config`), else on a
  ``[n_work, NW]`` scratch the wrapper allocates.
  :func:`program_apply_plain` interprets a program in plain PyTorch, so
  the CPU tests hold the compiler to :func:`schedule_apply_plain`.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

from ..analysis.runtime_guard import plain_stand_in
from .gf_kernels import SMEM_BYTES

U8 = torch.uint8
MAX_KW = 0xFFFF  # input packet rows: a K5 entry holds its row in 16 bits
# K5 (csrc/ec.cu): bytes of each packet row in a staged tile, row groups
# (one warp each), and the uint4 of group starts before the first row
K5_TILE = 512  # kTileK5
K5_GROUPS = 8  # kWarpsK5
K5_HEAD = 3

# K6 (csrc/ec.cu): threads a block on the shared-memory path, u32 words a
# thread, terms a group; a term's 16-bit dst code
SCHEDULE_THREADS = (128, 64, 32)
WORDS_PER_THREAD = 4  # kWords
GROUP_TERMS = 16  # kGroupTerms
NOT_END = 0xFFFF  # kNotEnd: the op goes on
TO_OUT = 0x8000  # kToOut: store to output row dst & SLOT_LIMIT
SLOT_LIMIT = 0x7FFF
CONTINUE = 0x80000000  # a shared-memory destination word whose op goes on
SM_SMEM_BYTES = 233472  # shared memory of an H100 SM (228 KB)
BLOCK_SMEM_RESERVED = 1024  # the shared memory the runtime keeps per block
MAX_THREADS_SM = 2048

LAUNCHES = {"bitmatrix_encode": 0, "schedule_apply": 0}
CALLS = dict.fromkeys(LAUNCHES, 0)
REPLAYS = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = CALLS[k] = REPLAYS[k] = 0


def _launched(name: str) -> None:
    """Count a launch that ran: one captured into a graph runs when the
    graph replays, and is counted then."""
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1


class Bitmatrix:
    """A GF(2) bitmatrix ``[MW, KW]`` of a code with word size ``w``,
    compiled for K5 on one device.

    ``prog`` is int32 ``[4 * prog16]``, read as uint4: words 0 to
    :data:`K5_GROUPS` of the first :data:`K5_HEAD` hold the uint4 index
    of each row group's first row, then the end.  A row is a header
    ``(n, i, t, 0)`` (its ``n`` entries, output chunk ``i``, packet
    ``t``) and ``ceil(n / 4)`` uint4 of entries ``s | (s // w) << 16``,
    its set input rows in order, the last padded with zeros.  The rows
    are dealt to the groups longest first, each to the group with the
    fewest entries (a row's store counts as one), so the kernel's warps
    finish a tile together."""

    def __init__(self, bitmatrix: np.ndarray, w: int, device):
        bits = np.asarray(bitmatrix, np.uint8) & 1
        self.mw, self.kw = bits.shape
        if self.mw % w or self.kw % w:
            raise ValueError(f"bitmatrix {bits.shape} is not in whole {w}-row blocks")
        if self.kw > MAX_KW:
            raise ValueError(f"{self.kw} input packet rows; K5 takes at most {MAX_KW}")
        self.w = w
        self.bits = bits
        words = [0] * (4 * K5_HEAD)
        for q, rows in enumerate(_row_groups(bits.sum(axis=1))):
            words[q] = len(words) // 4
            for r in rows:
                cols = np.flatnonzero(bits[r])
                words += [len(cols), r // w, r % w, 0]
                words += (cols | (cols // w) << 16).tolist() + [0] * (-len(cols) % 4)
        words[K5_GROUPS] = len(words) // 4
        self.prog16 = len(words) // 4
        self.prog = torch.tensor(np.asarray(words, np.uint32).view(np.int32)).to(device)


def _row_groups(counts) -> list[list[int]]:
    """K5's row groups: rows longest first (then by index), each to the
    group with the fewest entries so far, a row's store counting as one
    (the lowest group on a tie); each group's rows in that order."""
    groups: list[list[int]] = [[] for _ in range(K5_GROUPS)]
    heap = [(0, q) for q in range(K5_GROUPS)]
    for r in sorted(range(len(counts)), key=lambda r: (-int(counts[r]), r)):
        load, q = heapq.heappop(heap)
        groups[q].append(r)
        heapq.heappush(heap, (load + int(counts[r]) + 1, q))
    return groups


def _groups(bm: Bitmatrix, data: torch.Tensor, packetsize: int) -> int:
    k = bm.kw // bm.w
    if data.dim() != 2 or data.shape[0] != k:
        raise ValueError(f"bitmatrix_encode takes [{k}, S] data, got {tuple(data.shape)}")
    size = data.shape[1]
    group = bm.w * packetsize
    if size % group:
        raise ValueError(f"chunk size {size} not a multiple of w*packetsize={group}")
    return size // group


def bitmatrix_encode_plain(bm: Bitmatrix, data: torch.Tensor, packetsize: int) -> torch.Tensor:
    """Plain K5: one in-place XOR of a strided packet-row view per set
    bitmatrix entry."""
    g = _groups(bm, data, packetsize)
    w, p = bm.w, packetsize
    d = data.view(bm.kw // w, g, w, p)
    out = torch.zeros((bm.mw // w, g, w, p), dtype=U8, device=data.device)
    for r in range(bm.mw):
        acc = out[r // w, :, r % w, :]
        for s in np.nonzero(bm.bits[r])[0].tolist():
            acc ^= d[s // w, :, s % w, :]
    return out.view(bm.mw // w, data.shape[1])


def _prog_rows(bm: Bitmatrix):
    """(group, output chunk, packet, input rows) of every row of
    ``bm.prog``, decoded from the words the kernel reads."""
    words = bm.prog.cpu().numpy().view(np.uint32)
    quads = words.reshape(-1, 4)
    for q in range(K5_GROUPS):
        h = int(words[q])
        while h < int(words[q + 1]):
            n, i, t, _ = (int(v) for v in quads[h])
            ents = quads[h + 1:h + 1 + -(-n // 4)].reshape(-1)[:n]
            yield q, i, t, ents
            h += 1 + -(-n // 4)


def bitmatrix_walk_plain(bm: Bitmatrix, data: torch.Tensor, packetsize: int,
                         staged: bool) -> torch.Tensor:
    """Plain interpreter of K5's walk over ``bm.prog``, as each path of
    the kernel runs it.  ``staged`` (``packetsize % 16 == 0``): tiles of
    :data:`K5_TILE` columns, every input row's columns of a tile copied
    piece by piece (split where a packet ends) into one stage buffer
    that keeps stale bytes past the ragged end, then each group's rows
    XOR their entries' staged rows and store 16 bytes a lane where the
    column is in range.  Else the global walk: every row's entries
    read from the chunks at each column.  ``[k, S]`` u8 -> ``[MW / w,
    S]``."""
    g_count = _groups(bm, data, packetsize)
    w, p, S = bm.w, packetsize, data.shape[1]
    d = data.reshape(-1)
    cols, wp = g_count * p, w * p
    out = torch.zeros((bm.mw // w) * S, dtype=U8, device=data.device)
    rows = list(_prog_rows(bm))

    def src(ents, base):
        """Flat byte offsets in ``data`` of each entry's row at ``base``."""
        j = torch.from_numpy((ents >> 16).astype(np.int64))
        s = torch.from_numpy((ents & 0xFFFF).astype(np.int64))
        return (j * S + (s - j * w) * p)[:, None] + base[None, :]

    if not staged:
        x = torch.arange(cols, device=data.device)
        g = x // p
        base = g * wp + (x - g * p)
        for _, i, t, ents in rows:
            acc = torch.zeros(cols, dtype=U8, device=data.device)
            for e in src(ents, base):
                acc ^= d[e]
            out[i * S + base + t * p] = acc
        return out.view(bm.mw // w, S)
    if p % 16:
        raise ValueError(f"the staged walk takes packets of whole 16-byte units, not {p}")
    stage = torch.full((bm.kw, K5_TILE), 0xA5, dtype=U8, device=data.device)
    lane_bytes = torch.arange(K5_TILE, device=data.device)
    for x0 in range(0, cols, K5_TILE):
        n_cols = min(K5_TILE, cols - x0)
        for s in range(bm.kw):
            j, l = divmod(s, w)
            for g in range(x0 // p, (x0 + n_cols - 1) // p + 1):
                a, b = max(g * p, x0), min((g + 1) * p, x0 + n_cols)
                start = j * S + g * wp + l * p + (a - g * p)
                stage[s, a - x0:b - x0] = d[start:start + b - a]
        x = x0 + lane_bytes
        live = x - (lane_bytes % 16) < cols  # a lane stores all 16 bytes or none
        g = x // p
        dst = g * wp + (x - g * p)
        for _, i, t, ents in rows:
            acc = torch.zeros(K5_TILE, dtype=U8, device=data.device)
            # the plain walk of K5's program: host program entries, no device read
            # torchlint: disable=J003
            for s in (ents & 0xFFFF).tolist():
                acc ^= stage[s]
            out[(i * S + dst + t * p)[live]] = acc[live]
    return out.view(bm.mw // w, S)


def bitmatrix_encode(bm: Bitmatrix, data: torch.Tensor, packetsize: int) -> torch.Tensor:
    """K5: ``[k, S]`` u8 chunks -> ``[MW / w, S]`` u8 through the GF(2)
    bitmatrix, ``S`` a multiple of ``w * packetsize``."""
    _groups(bm, data, packetsize)
    CALLS["bitmatrix_encode"] += 1
    if data.device.type == "cpu":
        with plain_stand_in():
            return bitmatrix_encode_plain(bm, data, packetsize)
    from .. import _cuda

    if data.dtype != U8 or not data.is_contiguous():
        raise TypeError("bitmatrix_encode takes a contiguous uint8 tensor")
    if bm.prog.device != data.device:
        raise ValueError(f"bitmatrix on {bm.prog.device}, data on {data.device}")
    S = data.shape[1]
    out = torch.empty((bm.mw // bm.w, S), dtype=U8, device=data.device)
    if S == 0:
        return out
    _cuda.launch("ec", "ec_bitmatrix_encode", data.device, _cuda.ptr(bm.prog), bm.prog16,
                 _cuda.ptr(data), _cuda.ptr(out), bm.kw, bm.mw, bm.w, packetsize, S)
    _launched("bitmatrix_encode")
    return out


# ---------------------------------------------------------------- K6


@dataclass(frozen=True)
class XorProgram:
    """A step table compiled for K6 (:func:`compile_program`).

    ``terms`` u32: ``src | dst << 16``.  Each term XORs slot ``src``
    into a running accumulator; ``dst`` ends an op: :data:`NOT_END`
    (the op goes on), ``TO_OUT | r`` (store to output row ``r``) or a
    work slot (store there); the accumulator then restarts at zero.
    ``src < n_work`` is a work slot, else input row ``src - n_work``.
    ``groups`` are the term counts of consecutive groups: no group reads
    a slot that one of its own ops writes, so the kernel issues a
    group's loads before its stores.  An op may span groups."""

    terms: np.ndarray  # uint32 [n_terms]
    groups: np.ndarray  # uint16 [n_groups]
    n_in: int
    n_out: int
    n_work: int  # work slots, after reuse by liveness
    n_ops: int
    n_levels: int  # read-after-write depth of the ops

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    def smem_slots(self, stages: int) -> tuple[int, int, int, int]:
        """Slots a thread holds on K6's shared-memory path: (all, the
        zero slot, the first output slot, stage 0's first input slot),
        laid out as work slots, the zero slot, ``n_out`` output slots,
        then ``stages`` copies of the inputs."""
        zero = self.n_work
        return (zero + 1 + self.n_out + stages * self.n_in, zero, zero + 1,
                zero + 1 + self.n_out)

    def smem_terms(self, threads: int, stages: int) -> np.ndarray:
        """The program as K6's shared-memory path reads it: u32
        ``[stages, n_groups, 2, GROUP_TERMS]``, per group the source
        offsets then the destination words, each group padded with terms
        that read the zero slot.  An offset is ``slot * threads * 16``
        bytes from a thread's first slot (a slot holds 4 words a thread);
        a destination word is the offset of the slot an op ends in (an
        output row's slot for ``TO_OUT``), or has bit 31 set while the op
        goes on.  Copy ``s`` reads the inputs of stage ``s``."""
        n_slots, zero, out0, in0 = self.smem_slots(stages)
        unit = threads * WORDS_PER_THREAD * 4
        src = (self.terms & 0xFFFF).astype(np.int64)
        dst = (self.terms >> 16).astype(np.int64)
        go_on = dst == NOT_END
        dst = np.where(dst & TO_OUT != 0, out0 + (dst & SLOT_LIMIT), dst) * unit
        dst = np.where(go_on, CONTINUE, dst)
        out = np.empty((stages, len(self.groups), 2, GROUP_TERMS), np.uint32)
        for stage in range(stages):
            slot = np.where(src < self.n_work, src, src - self.n_work + in0 + stage * self.n_in)
            t0 = 0
            # K6's program groups are host data (numpy), read while packing
            # torchlint: disable=J003
            for g, size in enumerate(self.groups.tolist()):
                out[stage, g, 0, :size] = slot[t0:t0 + size] * unit
                out[stage, g, 1, :size] = dst[t0:t0 + size]
                out[stage, g, 0, size:] = zero * unit
                out[stage, g, 1, size:] = CONTINUE
                t0 += size
        return out


def _ssa_ops(steps: list, n_bufs: int, n_in: int):
    """Runs of same-``dst`` steps as ops over values.  Values ``0 ..
    n_in - 1`` are the inputs, ``n_in + j`` the result of op ``j``; a
    buffer holding zero has value None.  Returns (ops as lists of source
    values, each buffer's final value)."""
    cur = [b if b < n_in else None for b in range(n_bufs)]
    ops: list[list[int]] = []
    i, n = 0, len(steps)
    while i < n:
        d = steps[i][0]
        odd: dict[int, int] = {}  # source value -> parity of its count
        keep = True  # the run starts from buf[d]; buf[d] ^= buf[d] clears it
        while i < n and steps[i][0] == d:
            src = steps[i][1]
            if src == d:
                odd.clear()
                keep = False
            elif cur[src] is not None:
                odd[cur[src]] = odd.get(cur[src], 0) ^ 1
            i += 1
        srcs = [v for v, p in odd.items() if p]
        if keep and cur[d] is not None:
            srcs.insert(0, cur[d])
        if len(srcs) > 1:
            ops.append(srcs)
            cur[d] = n_in + len(ops) - 1
        else:  # zero, or a copy: the buffer takes the value itself
            cur[d] = srcs[0] if srcs else None
    return ops, cur


def compile_program(steps, n_bufs: int, n_in: int, n_out: int,
                    group_terms: int = GROUP_TERMS) -> XorProgram:
    """Compile a step table into K6's program; the result equals
    :func:`schedule_apply_plain` for any table and any words.

    - a run of consecutive steps with one ``dst`` is one op that
      accumulates in a register, a source XORed in an even number of
      times drops out, ``buf ^= buf`` restarts it at zero, and a run
      onto a buffer still zero assigns it (no zeroing pass);
    - ops whose value nothing reads and no output keeps are dropped; an
      op whose value only one output keeps stores straight to it and
      takes no slot; an output left at zero or a copy of another value
      gets a one-term op (zero: input 0 XORed twice);
    - ops are ordered by read-after-write level (values are renamed, so
      no write-after-read or write-after-write order remains) and packed
      into groups of at most ``group_terms`` terms that read nothing
      written in the same group;
    - slots are assigned by liveness: a value's slot is free again after
      the group of its last read."""
    steps = np.asarray(steps).reshape(-1, 2).tolist()
    if n_in < 1:
        raise ValueError("a program needs at least one input row")
    ops, final = _ssa_ops(steps, n_bufs, n_in)
    outs = final[n_in:n_in + n_out]
    # liveness from the outputs back (dead-op removal)
    live = [False] * len(ops)
    stack = [v - n_in for v in outs if v is not None and v >= n_in]
    while stack:
        j = stack.pop()
        if not live[j]:
            live[j] = True
            stack.extend(v - n_in for v in ops[j] if v >= n_in)
    readers = [0] * len(ops)
    for j, srcs in enumerate(ops):
        if live[j]:
            for v in srcs:
                if v >= n_in:
                    readers[v - n_in] += 1
    kept_rows: dict[int, list[int]] = {}
    for r, v in enumerate(outs):
        kept_rows.setdefault(-1 if v is None else v, []).append(r)
    # program ops: (sources, target), target ("slot", value) or ("out", row)
    prog: list[tuple[list[int], tuple[str, int]]] = []
    for j, srcs in enumerate(ops):
        if not live[j]:
            continue
        v = n_in + j
        rows = kept_rows.get(v, [])
        if readers[j] == 0 and len(rows) == 1:
            prog.append((srcs, ("out", rows[0])))
        else:
            prog.append((srcs, ("slot", v)))
            prog.extend(([v], ("out", r)) for r in rows)
    for v, rows in kept_rows.items():
        if v < n_in:  # an input's copy, or zero
            prog.extend(([0, 0] if v < 0 else [v], ("out", r)) for r in rows)
    # read-after-write levels; stable sort keeps the table's order within one
    level = {}
    for srcs, (kind, v) in prog:
        lv = 1 + max((level.get(u, 0) for u in srcs), default=0)
        if kind == "slot":
            level[v] = lv
    levels = [1 + max((level.get(u, 0) for u in srcs), default=0) for srcs, _ in prog]
    order = sorted(range(len(prog)), key=lambda i: levels[i])
    # groups
    sizes: list[int] = []
    flat: list[tuple[int, tuple[str, int] | None]] = []
    term_group: list[int] = []
    written: set[int] = set()
    count = 0
    for i in order:
        srcs, target = prog[i]
        if count and any(u in written for u in srcs):
            sizes.append(count)
            count, written = 0, set()
        for t, u in enumerate(srcs):
            if count == group_terms:
                sizes.append(count)
                count, written = 0, set()
            flat.append((u, target if t == len(srcs) - 1 else None))
            term_group.append(len(sizes))
            count += 1
        if target[0] == "slot":
            written.add(target[1])
    if count:
        sizes.append(count)
    # slots by liveness
    born: dict[int, int] = {}
    last: dict[int, int] = {}
    for (u, target), g in zip(flat, term_group):
        if u >= n_in:
            last[u] = g
        if target is not None and target[0] == "slot":
            born[target[1]] = g
    frees: dict[int, list[int]] = {}
    for v, g in last.items():
        frees.setdefault(g, []).append(v)
    births: dict[int, list[int]] = {}
    for v, g in born.items():
        births.setdefault(g, []).append(v)
    slot: dict[int, int] = {}
    free: list[int] = []
    n_work = 0
    for g in range(len(sizes)):
        for v in frees.get(g, ()):
            heapq.heappush(free, slot[v])
        for v in births.get(g, ()):
            if free:
                slot[v] = heapq.heappop(free)
            else:
                slot[v] = n_work
                n_work += 1
    if n_work > SLOT_LIMIT or n_work + n_in >= NOT_END or n_out >= SLOT_LIMIT:
        raise ValueError(f"program too large for 16-bit slots: {n_work} work slots, "
                         f"{n_in} inputs, {n_out} outputs")
    terms = np.empty(len(flat), np.uint32)
    for t, (u, target) in enumerate(flat):
        src = slot[u] if u >= n_in else n_work + u
        if target is None:
            dst = NOT_END
        elif target[0] == "out":
            dst = TO_OUT | target[1]
        else:
            dst = slot[target[1]]
        terms[t] = src | dst << 16
    return XorProgram(terms=terms, groups=np.asarray(sizes, np.uint16), n_in=n_in, n_out=n_out,
                      n_work=n_work, n_ops=len(prog), n_levels=max(levels, default=0))


def program_apply_plain(program: XorProgram, words: torch.Tensor) -> torch.Tensor:
    """Plain K6 program interpreter: each group's loads, then its XORs
    and stores, as the kernel runs it; ``words [n_in, NW]`` int32 ->
    ``[n_out, NW]``.  Raises if an output row is left unwritten."""
    nw = words.shape[1]
    slots = torch.zeros((program.n_work, nw), dtype=torch.int32, device=words.device)
    out = torch.zeros((program.n_out, nw), dtype=torch.int32, device=words.device)
    written = [False] * program.n_out
    acc = torch.zeros(nw, dtype=torch.int32, device=words.device)
    t0 = 0
    for size in program.groups.tolist():
        # torchlint: disable=J003  # the plain model of K6's program: host program terms
        group = program.terms[t0:t0 + size].tolist()
        vals = [slots[s & 0xFFFF].clone() if (s & 0xFFFF) < program.n_work
                else words[(s & 0xFFFF) - program.n_work] for s in group]
        for term, val in zip(group, vals):
            acc = acc ^ val
            dst = term >> 16
            if dst == NOT_END:
                continue
            if dst & TO_OUT:
                out[dst & SLOT_LIMIT] = acc
                written[dst & SLOT_LIMIT] = True
            else:
                slots[dst] = acc
            acc = torch.zeros_like(acc)
        t0 += size
    if not all(written):
        raise AssertionError(f"program left output rows unwritten: {written}")
    return out


def smem_program_apply_plain(program: XorProgram, words: torch.Tensor, threads: int,
                             stages: int, stage: int) -> torch.Tensor:
    """Plain interpreter of :meth:`XorProgram.smem_terms` copy
    ``stage``: byte offsets as the kernel adds them, padding and output
    slots included; ``words [n_in, NW]`` int32 -> ``[n_out, NW]``."""
    n_slots, zero, out0, in0 = program.smem_slots(stages)
    unit = threads * WORDS_PER_THREAD * 4
    nw = words.shape[1]
    mem = torch.zeros((n_slots, nw), dtype=torch.int32, device=words.device)
    mem[in0 + stage * program.n_in:in0 + (stage + 1) * program.n_in] = words
    acc = torch.zeros(nw, dtype=torch.int32, device=words.device)
    keep = False
    for src, dst in program.smem_terms(threads, stages)[stage].tolist():
        if any(o % unit for o in src):
            raise AssertionError("a source offset is not a slot's")
        vals = [mem[o // unit].clone() for o in src]
        for d, val in zip(dst, vals):
            acc = (acc if keep else torch.zeros_like(acc)) ^ val
            keep = d == CONTINUE
            if not keep:
                if d % unit:
                    raise AssertionError("a destination offset is not a slot's")
                mem[d // unit] = acc
    if bool(mem[zero].any()):
        raise AssertionError("the zero slot was written")
    return mem[out0:out0 + program.n_out].clone()


def schedule_config(program: XorProgram) -> tuple[int, int]:
    """K6's launch shape for a program: (threads a block, input stages)
    of the shared-memory path, or (0, 0), the global-memory path.  Among
    the shapes whose block fits, the one with the most threads resident
    on an SM (its shared memory divided among blocks), then two stages,
    then larger blocks: the kernel is bound by how many warps hide its
    latencies."""
    best, best_key = (0, 0), None
    for stages in (2, 1):
        for threads in SCHEDULE_THREADS:
            smem = program_smem_bytes(program, threads, stages)
            if smem > SMEM_BYTES:
                continue
            blocks = min(SM_SMEM_BYTES // (smem + BLOCK_SMEM_RESERVED), MAX_THREADS_SM // threads)
            key = (blocks * threads, stages, threads)
            if best_key is None or key > best_key:
                best, best_key = (threads, stages), key
    return best


def program_smem_bytes(program: XorProgram, threads: int, stages: int) -> int:
    """Shared memory of a K6 block: every slot (work, zero, output and
    ``stages`` copies of the inputs) for ``threads`` x 4 words,
    ``stages`` copies of the padded program, and two mbarriers."""
    slots = program.smem_slots(stages)[0] * threads * WORDS_PER_THREAD * 4
    return slots + stages * len(program.groups) * GROUP_TERMS * 8 + 16


class StepTable:
    """A compiled XOR schedule's step table, on one device, for K6.

    ``steps`` are ``[n_steps, 2]`` ``(dst, src)`` buffer indices.  They
    are checked against ``[0, n_bufs)`` here, once, on the host; the
    kernel runs the program compiled from them (:meth:`program`, cached
    per ``(n_in, n_out)`` and built here when both are given), whose
    terms and groups are copied to the device once."""

    def __init__(self, steps, n_bufs: int, device, n_in: int | None = None,
                 n_out: int | None = None):
        host = np.asarray(steps)
        if host.ndim != 2 or host.shape[1] != 2 or not np.issubdtype(host.dtype, np.integer):
            raise TypeError(f"steps are [n_steps, 2] integers, got {host.shape} {host.dtype}")
        if host.size and (host.min() < 0 or host.max() >= n_bufs):
            raise ValueError(f"step buffer indices span [{host.min()}, {host.max()}], "
                             f"outside [0, {n_bufs})")
        self.host = host.astype(np.int32)
        self.n_bufs = int(n_bufs)
        self.steps = torch.from_numpy(self.host.copy()).to(device)
        self._programs: dict[tuple[int, int], tuple] = {}
        if n_in is not None and n_out is not None and n_in > 0:
            self.program(n_in, n_out)

    @property
    def n_steps(self) -> int:
        return len(self.host)

    def program(self, n_in: int, n_out: int) -> XorProgram:
        return self._device_program(n_in, n_out)[0]

    def _device_program(self, n_in: int, n_out: int):
        """(program, launch shape, terms and groups on the device): the
        shared-memory path's padded terms, or the global path's flat
        terms and group sizes."""
        hit = self._programs.get((n_in, n_out))
        if hit is None:
            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                from ..core.graphs import HostReadInCapture

                raise HostReadInCapture(
                    "K6's program uploads on first use, which a graph capture cannot: run "
                    "the program once before capturing it")
            prog = compile_program(self.host, self.n_bufs, n_in, n_out)
            config = schedule_config(prog)
            dev = self.steps.device
            if config[0]:
                terms = prog.smem_terms(*config)
                groups = None
            else:
                terms = prog.terms
                groups = torch.from_numpy(prog.groups.view(np.int16).copy()).to(dev)
            hit = (prog, config, torch.from_numpy(terms.view(np.int32).copy()).to(dev), groups)
            self._programs[(n_in, n_out)] = hit
        return hit


def _check_schedule(table: StepTable, words: torch.Tensor, n_out: int) -> None:
    if words.dim() != 2 or words.dtype != torch.int32:
        raise TypeError(f"words are [n_in, NW] int32, got {tuple(words.shape)} {words.dtype}")
    if n_out < 0 or table.n_bufs < words.shape[0] + n_out:
        raise ValueError(f"n_bufs={table.n_bufs} < n_in={words.shape[0]} + n_out={n_out}")
    if table.steps.device != words.device:
        raise ValueError(f"steps on {table.steps.device}, words on {words.device}")


def schedule_apply_plain(table: StepTable, words: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain K6: one in-place row XOR per step (``_xla_apply``'s
    semantics)."""
    _check_schedule(table, words, n_out)
    n_in = words.shape[0]
    bufs = torch.zeros((table.n_bufs, words.shape[1]), dtype=torch.int32, device=words.device)
    bufs[:n_in] = words
    for dst, src in table.host.tolist():
        bufs[dst] ^= bufs[src]
    return bufs[n_in:n_in + n_out].clone()


def schedule_apply(table: StepTable, words: torch.Tensor, n_out: int) -> torch.Tensor:
    """K6: run an XOR schedule over ``words [n_in, NW]`` int32 ->
    ``[n_out, NW]`` int32, the output buffers ``n_in : n_in + n_out`` of
    ``table``."""
    _check_schedule(table, words, n_out)
    CALLS["schedule_apply"] += 1
    if words.device.type == "cpu":
        with plain_stand_in():
            return schedule_apply_plain(table, words, n_out)
    from .. import _cuda

    if not words.is_contiguous():
        raise TypeError("schedule_apply takes contiguous words")
    n_in, nw = words.shape
    if nw == 0 or n_out == 0:
        return torch.empty((n_out, nw), dtype=torch.int32, device=words.device)
    if n_in == 0:  # every buffer starts and stays zero
        return torch.zeros((n_out, nw), dtype=torch.int32, device=words.device)
    prog, (threads, stages), terms, groups = table._device_program(n_in, n_out)
    out = torch.empty((n_out, nw), dtype=torch.int32, device=words.device)
    scratch = None
    if not threads and prog.n_work:
        scratch = torch.empty((prog.n_work, -(-nw // WORDS_PER_THREAD) * WORDS_PER_THREAD),
                              dtype=torch.int32, device=words.device)
    n_slots, zero, out0, in0 = prog.smem_slots(stages)
    _cuda.launch("ec", "ec_xor_program", words.device, _cuda.ptr(terms),
                 None if groups is None else _cuda.ptr(groups), prog.n_terms, len(prog.groups),
                 _cuda.ptr(words), _cuda.ptr(out), None if scratch is None else _cuda.ptr(scratch),
                 n_in, n_out, prog.n_work, n_slots, zero, out0, in0, threads, stages, nw)
    _launched("schedule_apply")
    return out
