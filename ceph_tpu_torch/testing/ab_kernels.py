"""Run ``chip_smoke.py`` of several checkouts in turns on one card and
compare their K4 and K6 times.

    python -m ceph_tpu_torch.testing.ab_kernels DIR_A DIR_B DIR_B DIR_A

Each DIR is a checkout of the repository (``git archive`` of a commit,
unpacked).  In the order given, each checkout's ``python3 chip_smoke.py``
runs in that directory (it builds the checkout's kernels and drives
every phase); its output is kept as ``DIR/chip_smoke.out``.  This prints
one JSON line per run with the card, whether the run ended with
``"ok": true``, and K4's (k=8 m=3 and k=4 m=2), K5's and K6's times
with K6's same-repair K5 time, then a summary.  The runs share one
card, so the checkouts are compared under one power limit; give them in
turns (A B B A) so that drift hits both alike.  Exits non-zero if a run
fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def run(checkout: str, timeout: int = 1200) -> dict:
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=checkout, capture_output=True,
                          text=True, timeout=timeout)
    with open(os.path.join(checkout, "chip_smoke.out"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    lines = proc.stdout.splitlines()
    out = {"checkout": checkout, "exit": proc.returncode,
           "ok": proc.returncode == 0 and '"ok": true' in (lines[-1] if lines else ""),
           "card": lines[-2] if len(lines) > 1 else None}
    for ln in lines:
        if not ln.startswith('{"phase": "ec_kernels"') and not ln.startswith(
                '{"phase": "schedule_kernel"'):
            continue
        for r in json.loads(ln)["results"]:
            shape = r.get("shape", "")
            if r["name"] == "matrix_encode":
                out["matrix_encode_" + ("k8_m3" if "k=8" in shape else "k4_m2") + "_ms"] = r["ms"]
            elif r["name"] == "bitmatrix_encode":
                out["bitmatrix_encode_ms"] = r["ms"]
            elif r["name"] == "schedule_apply":
                out["schedule_apply_ms"] = r["ms"]
                out["k5_same_repair_ms"] = r["k5_same_repair_ms"]
    return out


def main(dirs: list[str]) -> int:
    results = []
    for d in dirs:
        res = run(d)
        print(json.dumps(res), flush=True)
        results.append(res)
    print(json.dumps({"ab_kernels": results}), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]) if len(sys.argv) > 1 else 2)
