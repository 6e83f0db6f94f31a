"""Generator for the crush_ln fixed-point logarithm lookup tables.

The CRUSH straw2 draw needs ``crush_ln(u) ~= 2^44 * log2(u+1)`` for
u in [0, 0xffff], computed exactly the same way everywhere (host oracle,
C++ CPU reference, the PyTorch plain versions and the CUDA kernels).
Upstream ceph ships these tables as
``src/crush/crush_ln_table.h :: __RH_LH_tbl / __LL_tbl``; they are
regenerated here from their mathematical definition with deterministic
high-precision integer arithmetic (``decimal`` at 50 digits, floored):

  RH_LH_tbl[2*i]     = ceil(2^56 / (2*(128+i)))         # reciprocal of index1
  RH_LH_tbl[2*i + 1] = round(2^48 * log2((128+i)/128))  # log of the high byte
  LL_tbl[j]          = round(2^48 * log2(1 + j/2^15))   # low-order correction

for i in [0, 384) (normalized high part h = x>>8 in [128, 511]) and
j in [0, 256).  Ceiling matters for RH: with floor (or round-down cases
of nearest), an input that is an exact multiple of the table stride
lands at xl64 = 2^15 - 1 instead of 2^15 and picks up a spurious LL(255)
correction (~0.011 in log2 units).  Ceil can never overshoot: the true
residual is at least 2^48/1022 ~ 2^38 below the next integer while the
ceil excess contributes < 2^17.

``python -m ceph_tpu_torch.core.lutgen`` writes the port's
``ceph_tpu_torch/core/_crush_ln_tables.py`` and nothing else;
``--check`` writes nothing and exits 1 when that file differs from
:func:`render_py`.  :func:`render_cpp` renders the C++ tier's header
(``cpp/crush_ln_tables.h``) for comparison; the port never writes it.
"""

from __future__ import annotations

import argparse
import os
import sys
from decimal import Decimal, getcontext

getcontext().prec = 50

_TWO = Decimal(2)
_LN2 = None

PY_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_crush_ln_tables.py")


def _log2(x: Decimal) -> Decimal:
    global _LN2
    if _LN2 is None:
        _LN2 = _TWO.ln()
    return x.ln() / _LN2


def _round(x: Decimal) -> int:
    return int((x + Decimal("0.5")).to_integral_value(rounding="ROUND_FLOOR"))


def gen_rh_lh() -> list[int]:
    tbl = []
    for i in range(384):
        h = 128 + i
        rh = -((-(1 << 56)) // (2 * h))  # ceil division on exact integers
        lh = _round((_TWO**48) * _log2(Decimal(h) / 128))
        tbl.append(rh)
        tbl.append(lh)
    return tbl


def gen_ll() -> list[int]:
    return [_round((_TWO**48) * _log2(1 + Decimal(j) / (1 << 15))) for j in range(256)]


PY_HEADER = '"""Generated by ceph_tpu_torch.core.lutgen -- do not edit by hand."""\n\n'


def render_py() -> str:
    rh_lh = gen_rh_lh()
    ll = gen_ll()
    lines = [PY_HEADER]
    lines.append("RH_LH_TBL = (\n")
    for k in range(0, len(rh_lh), 4):
        lines.append("    " + " ".join(f"{v}," for v in rh_lh[k : k + 4]) + "\n")
    lines.append(")\n\nLL_TBL = (\n")
    for k in range(0, len(ll), 4):
        lines.append("    " + " ".join(f"{v}," for v in ll[k : k + 4]) + "\n")
    lines.append(")\n")
    return "".join(lines)


def render_cpp() -> str:
    rh_lh = gen_rh_lh()
    ll = gen_ll()
    lines = [
        "// Generated by ceph_tpu_torch.core.lutgen -- do not edit by hand.\n",
        "#pragma once\n#include <cstdint>\n\n",
        f"static const uint64_t CRUSH_RH_LH_TBL[{len(rh_lh)}] = {{\n",
    ]
    for k in range(0, len(rh_lh), 4):
        lines.append("  " + " ".join(f"{v}ull," for v in rh_lh[k : k + 4]) + "\n")
    lines.append(f"}};\n\nstatic const uint64_t CRUSH_LL_TBL[{len(ll)}] = {{\n")
    for k in range(0, len(ll), 4):
        lines.append("  " + " ".join(f"{v}ull," for v in ll[k : k + 4]) + "\n")
    lines.append("};\n")
    return "".join(lines)


def main(argv: list[str] | None = None, path: str = PY_PATH) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="write nothing; exit 1 when the table file differs")
    args = ap.parse_args(argv)
    text = render_py()
    if args.check:
        with open(path) as f:
            same = f.read() == text
        print(f"{path}: {'up to date' if same else 'differs from render_py()'}")
        return 0 if same else 1
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
