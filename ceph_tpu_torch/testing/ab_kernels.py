"""Run ``chip_smoke.py`` of several checkouts in turns on one card and
compare their kernel times.

    python -m ceph_tpu_torch.testing.ab_kernels DIR_A DIR_B DIR_B DIR_A

Each DIR is a checkout of the repository (``git archive`` of a commit,
unpacked).  In the order given, each checkout's ``python3 chip_smoke.py``
runs in that directory (it builds the checkout's kernels and drives
every phase); its output is kept as ``DIR/chip_smoke.out``.
This prints one JSON line per run with the card, whether the run ended
with ``"ok": true``, K1's, K2's and K3's times (with their pipe floors
where the checkout reports them) and each straw2 kernel's instructions
per draw split by pipe (this checkout's ``testing/sass.py`` applied to
the library the run built), K4's (k=8 m=3 and k=4 m=2), K5's (encode
and, where the checkout has it, the 64-row decoder), K6's and K7's (64
and 32 MiB) times with K6's same-repair K5 time, the placements per
second of each CRUSH mode, the OSDMap update seconds, each EC code's
device and interface GB/s and the CLAY repair GB/s, and each recovery
code's ``recover_pool`` and peering seconds, and K8's times at a scrub
pass (``[90112, 32768]``) and a decode-verify group (``[32, 32768]``),
then a summary.  K8 is timed after the checkout's ``chip_smoke.py`` by
one more process in its directory (``K8_PROBE``: the checkout's own
``crc_rows`` through its own ``chip_smoke.time_ms``, three times a
shape), so a checkout whose script times one shape is measured at both;
its ``scrub_kernel`` records are read too where it has them.  The runs
share one card, so the checkouts are compared under one power limit;
give them in turns (A B B A) so that drift hits both alike.  Exits
non-zero if a run fails.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

from . import sass

K8_PROBE = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from ceph_tpu_torch.recovery import scrub
out = {}
for key, rows in (("scrub", 90112), ("verify", 32)):
    data = cs.card_bytes((rows, 32768), cs.SEED + 12, torch.device("cuda"))
    out[f"crc32c_rows_{key}_ms"] = [cs.time_ms(lambda: scrub.crc_rows(data)) for _ in range(3)]
    del data
print(json.dumps(out))
"""


def k8_times(checkout: str, timeout: int = 300) -> dict:
    """K8's times in ``checkout`` by ``K8_PROBE`` (its library is built
    already by the checkout's ``chip_smoke.py``)."""
    proc = subprocess.run([sys.executable, "-c", K8_PROBE], cwd=checkout, capture_output=True,
                          text=True, timeout=timeout)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines:
        return {"k8_probe_error": (proc.stderr or proc.stdout)[-2000:]}
    return json.loads(lines[-1])


def run(checkout: str, timeout: int = 1200) -> dict:
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=checkout, capture_output=True,
                          text=True, timeout=timeout)
    with open(os.path.join(checkout, "chip_smoke.out"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    lines = proc.stdout.splitlines()
    out = {"checkout": checkout, "exit": proc.returncode,
           "ok": proc.returncode == 0 and '"ok": true' in (lines[-1] if lines else ""),
           "card": lines[-2] if len(lines) > 1 else None}
    # a checkout names its library libstraw2.so, or by its content hash
    libs = sorted(glob.glob(os.path.join(checkout, "ceph_tpu_torch", "_build", "libstraw2*.so")))
    if libs:
        out["draw_split"] = sass.straw2_splits(sass.cuobjdump_sass(libs[-1]))
    for ln in lines:
        if ln.startswith('{"phase": "kernels"'):
            for r in json.loads(ln)["results"]:
                out[r["name"] + "_ms"] = r["ms"]
                if "pipe_floor_ms" in r:
                    out[r["name"] + "_pipe_floor_ms"] = r["pipe_floor_ms"]
        if ln.startswith('{"phase": "crush"'):
            for mode, v in json.loads(ln)["modes"].items():
                out[f"placements_per_s_{mode}"] = v["placements_per_s"]
        if ln.startswith('{"phase": "osdmap"'):
            out["osdmap_update_s"] = json.loads(ln)["update_s"]
        if ln.startswith('{"phase": "ec_encode"') or ln.startswith('{"phase": "ec_decode"'):
            kind, iface = (("encode", "encode_object_GBps") if "ec_encode" in ln[:25]
                           else ("decode", "decode_GBps"))
            for code, v in json.loads(ln)["codes"].items():
                out[f"ec_{kind}_device_GBps_{code}"] = v["device_GBps"]
                out[f"ec_{kind}_GBps_{code}"] = v[iface]
        if ln.startswith('{"phase": "ec_plugins"'):
            out["clay_repair_GBps"] = json.loads(ln)["clay"]["repair_GBps"]
        if ln.startswith('{"phase": "recovery"'):
            for code, v in json.loads(ln)["codes"].items():
                out[f"recover_pool_s_{code}"] = v["recover_pool_s"]
                out[f"l_peering_s_{code}"] = v["l_peering_s"]
        if ln.startswith('{"phase": "scrub_kernel"'):
            for r in json.loads(ln)["results"]:
                key = "verify" if r.get("shape", "").startswith("[32,") else "scrub"
                out[f"chip_smoke_crc32c_rows_{key}_ms"] = r["ms"]
        if not ln.startswith('{"phase": "ec_kernels"') and not ln.startswith(
                '{"phase": "schedule_kernel"'):
            continue
        for r in json.loads(ln)["results"]:
            shape = r.get("shape", "")
            if r["name"] == "matrix_encode":
                out["matrix_encode_" + ("k8_m3" if "k=8" in shape else "k4_m2") + "_ms"] = r["ms"]
            elif r["name"] == "bitmatrix_encode":
                out["bitmatrix_" + ("decoder" if "decoder" in shape else "encode") + "_ms"] = r["ms"]
            elif r["name"] == "byte_lut":
                out["byte_lut_" + ("64MiB" if "encode" in shape else "32MiB") + "_ms"] = r["ms"]
            elif r["name"] == "schedule_apply":
                out["schedule_apply_ms"] = r["ms"]
                out["k5_same_repair_ms"] = r["k5_same_repair_ms"]
    out.update(k8_times(checkout))
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
