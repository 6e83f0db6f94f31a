"""Counts over the SASS of the port's built kernels (``cuobjdump -sass``).

    python -m ceph_tpu_torch.testing.sass ceph_tpu_torch/_build/libstraw2.so

prints the instructions of one straw2 draw as nvcc compiled it.  The
count is taken in ``straw2_negdraw_kernel`` (K1), whose loop body is one
draw: from the hash's first instruction (the three-input XOR that mixes
the seed, LUT 0x96) up to the close of the branch that skips zero
weights (the first ``BSYNC`` after it), less the global loads and their
address arithmetic (``LDG``, ``LEA``) that the compiler interleaves.
Uniform-datapath instructions count: each takes an issue slot.  The
kernels' operation bounds (``chip_smoke.py``) are this count per draw
over the card's instruction issue rate.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys

_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def kernel_instructions(sass: str, name: str) -> list[str]:
    """The instructions of the first function whose mangled name holds
    ``name``, in order, without addresses."""
    out: list[str] = []
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = name in line
            continue
        m = _INSN.match(line)
        if inside and m:
            out.append(m.group(2))
    if not out:
        raise ValueError(f"no function {name!r} in the SASS")
    return out


def _opcode(insn: str) -> str:
    body = re.sub(r"^@!?U?P[T0-9]+\s+", "", insn)
    return body.split()[0]


def draw_instructions(sass: str) -> int:
    """Instructions of one straw2 draw in K1's SASS (see the module
    docstring for the bounds of the count)."""
    insns = kernel_instructions(sass, "straw2_negdraw_kernel")
    start = next(i for i, s in enumerate(insns) if _opcode(s) == "LOP3.LUT" and ", 0x96," in s)
    end = next(i for i in range(start, len(insns)) if _opcode(insns[i]) == "BSYNC")
    body = [_opcode(s) for s in insns[start:end]]
    return sum(1 for op in body if not op.startswith(("LDG", "LEA")))


def cuobjdump_sass(lib: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True)
    return proc.stdout


if __name__ == "__main__":
    print(draw_instructions(cuobjdump_sass(sys.argv[1])))
