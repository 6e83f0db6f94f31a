"""Counts over the SASS of the port's built kernels (``cuobjdump -sass``).

    python -m ceph_tpu_torch.testing.sass ceph_tpu_torch/_build/libstraw2-<sha16>.so

prints, for each straw2 kernel, the instructions it issues per straw2
draw, split by the pipe that executes them.  The count is taken over the
kernel's draw loop: the innermost loop (a backward ``BRA`` and the
instructions from its target up to it) that holds the most ``FLO``
instructions, one per draw (the clz of ``crush_ln``).  Everything in
the loop counts, loads, stores and loop control included, divided by
the draws in it; for K2 and K3 that is the row loop (draw, record load,
compare and select), for K1 the slot loop (draw, loads, store; in the
port's first kernel also its per-slot ``i / fanout``).  K8's fold loop is
counted per byte (``crc_split``): the innermost loop that holds the most
``LDS``, one 32-bit table lookup a byte.

Pipes (sm_90; the CUDA C++ Programming Guide's throughput table for
compute capability 9.0 gives each integer pipe 64 lanes a clock per SM,
half the issue rate):

- ``alu``: integer add, logic, shift, compare, select, min/max, address
  arithmetic and bit scans (``IADD3``, ``LOP3``, ``SHF``, ``ISETP``,
  ``SEL``, ``VIMNMX``, ``VIADD``, ``LEA``, ``FLO``, ...);
- ``fma``: the integer multiply-adds (``IMAD`` in all its forms: ``.HI``,
  ``.WIDE``, ``.SHL``, ``.IADD``, ``.MOV``, ``.X``);
- ``memory``: loads and stores (``LDS``, ``LDG``, ``STG``, ...);
- ``other``: branches, barriers, uniform-datapath and special-register
  instructions, ``NOP``.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys

_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\b(0x[0-9a-f]+)\b")

PIPES = ("alu", "fma", "memory", "other")
_ALU = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "VIMNMX", "VIADD", "LEA", "FLO", "PRMT",
        "PLOP3", "MOV", "IABS")
_MEMORY = ("LD", "ST")
# each straw2 kernel and the mangled template arguments of the form its
# main path runs: K1 with paired slots, K2 and K3 on shared-memory tables
STRAW2_KERNELS = {"straw2_negdraw_kernel": "ILi2E", "straw2_level_kernel": "ILb1E",
                  "straw2_descend_kernel": "ILb1E"}


def kernel_instructions(sass: str, name: str) -> list[tuple[int, str]]:
    """(address, instruction) of the first function whose mangled name
    holds ``name``, in order."""
    out: list[tuple[int, str]] = []
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = name in line
            continue
        m = _INSN.match(line)
        if inside and m:
            out.append((int(m.group(1), 16), m.group(2)))
    if not out:
        raise ValueError(f"no function {name!r} in the SASS")
    return out


def opcode(insn: str) -> str:
    body = re.sub(r"^@!?U?P[T0-9]+\s+", "", insn)
    return body.split()[0]


def pipe(op: str) -> str:
    """The pipe of one opcode (see the module docstring)."""
    if op.startswith("IMAD"):
        return "fma"
    if op.startswith(_MEMORY):
        return "memory"
    if op.split(".")[0] in _ALU:
        return "alu"
    return "other"


def draw_loop(insns: list[tuple[int, str]], marker: str = "FLO") -> tuple[list[str], int]:
    """(opcodes, draws) of the draw loop: among the innermost loops that
    hold a ``marker`` instruction, the one holding the most."""
    loops = []
    for addr, insn in insns:
        if not opcode(insn).startswith("BRA"):
            continue
        m = _TARGET.search(insn.split(None, 2)[-1] if insn.startswith("@") else insn)
        target = int(m.group(1), 16) if m else addr
        if target < addr:
            loops.append((target, addr))
    best: tuple[int, int, list[str]] | None = None  # (draws, -length, opcodes)
    for lo, hi in loops:
        if any(lo <= a < b <= hi and (a, b) != (lo, hi) for a, b in loops):
            continue  # holds an inner loop
        body = [opcode(s) for a, s in insns if lo <= a <= hi]
        draws = sum(1 for op in body if op.startswith(marker))
        if draws and (best is None or (draws, -len(body)) > best[:2]):
            best = (draws, -len(body), body)
    if best is None:
        raise ValueError(f"no loop with a {marker} in the kernel")
    return best[2], best[0]


def draw_split(sass: str, kernel: str = "straw2_negdraw_kernel", marker: str = "FLO") -> dict:
    """Instructions per draw (per ``marker`` instruction) in ``kernel``'s
    draw loop, by pipe, with their total."""
    body, draws = draw_loop(kernel_instructions(sass, kernel), marker)
    split = {p: 0 for p in PIPES}
    for op in body:
        split[pipe(op)] += 1
    out = {p: n / draws for p, n in split.items()}
    out["total"] = len(body) / draws
    out["draws_per_loop"] = draws
    return out


def straw2_splits(sass: str) -> dict:
    """``draw_split`` of each straw2 kernel in the SASS, in the form its
    main path runs where the SASS has it (``STRAW2_KERNELS``)."""
    out = {}
    for k, form in STRAW2_KERNELS.items():
        out[k] = draw_split(sass, k + form if k + form in sass else k)
    return out


def crc_split(sass: str) -> dict:
    """Instructions per byte in K8's fold loop (the innermost loop with the
    most ``LDS``), by pipe, with their total; a byte is one 32-bit table
    ``LDS`` (the loop's ``LDS.128`` read staged lines)."""
    body, _ = draw_loop(kernel_instructions(sass, "crc32c_rows_kernel"), "LDS")
    lookups = sum(1 for op in body if op == "LDS")
    split = {p: 0 for p in PIPES}
    for op in body:
        split[pipe(op)] += 1
    out = {p: n / lookups for p, n in split.items()}
    out["total"] = len(body) / lookups
    out["bytes_per_loop"] = lookups
    return out


def cuobjdump_sass(lib: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True)
    return proc.stdout


if __name__ == "__main__":
    for name, split in straw2_splits(cuobjdump_sass(sys.argv[1])).items():
        print(name, {k: round(v, 2) for k, v in split.items()})
