"""The port's CLI harnesses vs the reference package's, as text.

``crushtool`` (``--test`` with ``--show-mappings``,
``--show-statistics`` and ``--show-bad-mappings``, ``-c`` and ``-d``),
``osdmaptool`` (``--createsimple``, ``--print``, ``--test-map-pgs``,
``--test-map-object``, ``--upmap`` with its command file), ``ec_bench``
and ``recovery`` (``--inject``/``--plan``/``--execute``, ``--chaos``)
run through their ``main()`` with ``--device cpu``; their output must
equal the reference's, except for wall-clock fields.  ``recovery``'s
multi-device flags exit non-zero.  The
port's CRUSH engine (``run_batch`` on the CPU, every mode) also
reproduces the three ``"crush"`` digests of ``tests/golden/archive.json``.
"""

import hashlib
import json
import os
import re

import numpy as np
import pytest

from ceph_tpu.cli import crushtool as ref_crushtool
from ceph_tpu.cli import osdmaptool as ref_osdmaptool
from ceph_tpu.cli import recovery as ref_recovery_cli
from ceph_tpu_torch.cli import crushtool, ec_bench, osdmaptool
from ceph_tpu_torch.cli import recovery as recovery_cli
from ceph_tpu_torch.crush.engine import run_batch
from ceph_tpu_torch.crush.interp_batch import MODES
from ceph_tpu_torch.models.clusters import build_flat, build_hierarchy

ARCHIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "archive.json")

SAMPLE = """
tunable choose_total_tries 50
tunable chooseleaf_vary_r 1
tunable chooseleaf_stable 1

device 0 osd.0
device 1 osd.1
device 2 osd.2 class ssd
device 3 osd.3
device 4 osd.4
device 5 osd.5

type 0 osd
type 1 host
type 2 root

host host0 {
    id -2
    alg straw2
    hash 0
    item osd.0 weight 1.000
    item osd.1 weight 2.000
}
host host1 {
    id -3
    alg straw2
    hash 0
    item osd.2 weight 1.000
    item osd.3 weight 1.000
}
host host2 {
    id -4
    alg straw2
    hash 0
    item osd.4 weight 0.500
    item osd.5 weight 1.500
}
root default {
    id -1
    alg straw2
    hash 0
    item host0 weight 3.000
    item host1 weight 2.000
    item host2 weight 2.000
}

rule replicated_rule {
    id 0
    type replicated
    step take default
    step chooseleaf firstn 0 type host
    step emit
}
rule ec_rule {
    id 1
    type erasure
    step set_chooseleaf_tries 5
    step take default
    step chooseleaf indep 0 type host
    step emit
}
"""


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """Put the reference's process-wide program caches back after this
    module (see tests/test_torch_osdmap.py)."""
    from ceph_tpu.crush import interp, interp_batch as ib
    from ceph_tpu.osdmap import mapping
    from ceph_tpu.recovery import pipeline

    caches = (ib._FAST_CACHE, ib._PACK_CACHE, interp._BATCH_CACHE, mapping._POOL_FN_CACHE,
              pipeline.PIPELINES._entries)
    saved = [dict(c) for c in caches]
    counts = (pipeline.PIPELINES.hits, pipeline.PIPELINES.misses, pipeline.PIPELINES.evictions)
    yield
    for cache, before in zip(caches, saved):
        cache.clear()
        cache.update(before)
    pipeline.PIPELINES.hits, pipeline.PIPELINES.misses, pipeline.PIPELINES.evictions = counts


@pytest.fixture(autouse=True)
def _reference_state_left_as_found(monkeypatch):
    from ceph_tpu.balancer import upmap as rup

    monkeypatch.setattr(rup, "LAST_RUN_STATS", rup.LAST_RUN_STATS)
    monkeypatch.delenv("CEPH_TPU_VMAPPED_UPMAP", raising=False)


def _run(capsys, main, argv):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out


@pytest.fixture
def sample(tmp_path):
    path = tmp_path / "map.txt"
    path.write_text(SAMPLE)
    return str(path)


@pytest.mark.parametrize("flags", [
    ["--show-mappings"],
    ["--show-statistics"],
    ["--show-bad-mappings"],
    ["--show-mappings", "--show-statistics", "--rule", "1", "--num-rep", "4"],
    ["--show-bad-mappings", "--show-statistics", "--min-rep", "2", "--max-rep", "4"],
    ["--show-statistics", "--weight", "1:0", "--weight", "4:0.25", "--max-x", "2047"],
])
def test_crushtool_test_matches_reference(capsys, sample, flags):
    argv = ["-i", sample, "--test", "--max-x", "511"] + flags
    want = _run(capsys, ref_crushtool.main, argv)
    got = _run(capsys, crushtool.main, argv + ["--device", "cpu"])
    cpu = _run(capsys, crushtool.main, argv + ["--cpu"])
    assert want[1]
    assert got == want
    assert cpu == want


def test_crushtool_compile_decompile_match_reference(capsys, tmp_path, sample):
    outs = {}
    for name, main in (("ref", ref_crushtool.main), ("port", crushtool.main)):
        dest = str(tmp_path / f"{name}.json")
        assert main(["-c", sample, "-o", dest]) == 0
        with open(dest, "rb") as f:
            outs[name] = f.read()
        capsys.readouterr()
        outs[name + "_d"] = _run(capsys, main, ["-d", dest])
    assert outs["port"] == outs["ref"]
    assert outs["port_d"] == outs["ref_d"]
    assert "rule ec_rule" in outs["port_d"][1]


def test_crushtool_on_a_saved_json_map(capsys, tmp_path):
    from ceph_tpu.models.clusters import build_simple

    path = tmp_path / "simple.json"
    path.write_bytes(build_simple(64).encode())
    argv = ["-i", str(path), "--test", "--show-statistics", "--show-mappings",
            "--max-x", "1023"]
    want = _run(capsys, ref_crushtool.main, argv)
    assert _run(capsys, crushtool.main, argv + ["--device", "cpu"]) == want


def _strip_timing(text):
    return [ln for ln in text.splitlines() if not ln.startswith("mapping time")]


def test_osdmaptool_matches_reference(capsys, tmp_path):
    ref_map, port_map = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    create = ["--createsimple", "64", "--pg-num", "256"]
    assert ref_osdmaptool.main([ref_map] + create) == 0
    assert osdmaptool.main([port_map] + create + ["--device", "cpu"]) == 0
    capsys.readouterr()
    with open(ref_map, "rb") as a, open(port_map, "rb") as b:
        assert a.read() == b.read()

    for flags in (["--print"], ["--test-map-pgs"], ["--test-map-pgs", "--pool", "1"],
                  ["--test-map-object", "rbd_data.1234", "--pool", "1"],
                  ["--mark-out", "3", "--test-map-pgs", "--print"]):
        rc, want = _run(capsys, ref_osdmaptool.main, [ref_map] + flags)
        rc2, got = _run(capsys, osdmaptool.main, [ref_map] + flags + ["--device", "cpu"])
        assert rc2 == rc == 0
        assert _strip_timing(got) == _strip_timing(want)
        assert want.strip()


def _harmful_entries_map():
    """Entries that divert PGs onto osd 0: the optimizer retires them,
    so the command file opens with ``rm-pg-upmap-items`` lines."""
    from ceph_tpu.models.clusters import build_osdmap
    from ceph_tpu.osdmap.map import PGId

    m = build_osdmap(32, pg_num=256)
    for ps, raw in m.pg_to_raw_osds_batch(1, list(range(64))).items():
        if 0 not in raw and len(m.pg_upmap_items) < 24:
            m.pg_upmap_items[PGId(1, ps)] = ((raw[0], 0),)
    return m


@pytest.mark.parametrize("case,extra", [
    ("skewed", []),
    ("skewed", ["--upmap-deviation", "0.5", "--upmap-max", "40"]),
    ("harmful", ["--upmap-max", "200"]),
])
def test_osdmaptool_upmap_file_matches_reference(capsys, tmp_path, case, extra):
    from ceph_tpu.models.clusters import build_skewed_osdmap

    m = build_skewed_osdmap(96, pg_num=512) if case == "skewed" else _harmful_entries_map()
    path = str(tmp_path / "map.json")
    with open(path, "wb") as f:
        f.write(m.encode())
    files = {}
    for name, main in (("ref", ref_osdmaptool.main), ("port", osdmaptool.main)):
        files[name] = str(tmp_path / f"{name}.sh")
        argv = [path, "--upmap", files[name]] + extra
        files[name + "_out"] = _run(capsys, main, argv + (["--device", "cpu"]
                                                          if name == "port" else []))
    with open(files["ref"], "rb") as a, open(files["port"], "rb") as b:
        want, got = a.read(), b.read()
    assert got == want
    assert want.count(b"pg-upmap-items") > 5
    assert (b"rm-pg-upmap-items" in want) == (case == "harmful")
    assert files["port_out"][1].replace(files["port"], "OUT") == \
        files["ref_out"][1].replace(files["ref"], "OUT")


def test_osdmaptool_crush_compat_matches_reference(capsys, tmp_path):
    from ceph_tpu.models.clusters import build_osdmap

    path = str(tmp_path / "m.json")
    with open(path, "wb") as f:
        f.write(build_osdmap(32, pg_num=256).encode())
    want = _run(capsys, ref_osdmaptool.main, [path, "--crush-compat"])
    got = _run(capsys, osdmaptool.main, [path, "--crush-compat", "--device", "cpu"])
    assert got == want and "crush-compat: max deviation" in got[1]


@pytest.mark.parametrize("workload", ["encode", "decode"])
def test_ec_bench_runs_and_prints_two_fields(capsys, workload):
    rc, out = _run(capsys, ec_bench.main, [
        "--device", "cpu", "--workload", workload, "--size", "65536", "--iterations", "2",
        "--parameter", "k=4", "--parameter", "m=2", "--erasures", "2"])
    assert rc == 0
    secs, rate = out.strip().split("\t")
    assert float(secs) > 0 and rate.endswith(" MB/s") and float(rate.split()[0]) > 0


def test_ec_bench_reports_a_bad_profile(capsys):
    rc, _ = _run(capsys, ec_bench.main, ["--device", "cpu", "--parameter", "k=0"])
    assert rc == 1


def _weighted_flat():
    m = build_flat(7)
    root = m.bucket_by_name("default")
    for i, osd in enumerate(root.items):
        m.adjust_item_weight(root.id, osd, 0x8000 + i * 0x4000)
    return m


GOLDEN_MAPS = {
    "flat_16": lambda: build_flat(16),
    "flat_7_weighted": _weighted_flat,
    "rack_host_osd": lambda: build_hierarchy([("rack", 2), ("host", 4)], 4),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(GOLDEN_MAPS))
def test_engine_reproduces_golden_crush_digests(name, mode):
    with open(ARCHIVE) as f:
        want = json.load(f)["crush"][name]
    m = GOLDEN_MAPS[name]()
    dense = m.to_dense()
    w = np.full(dense.max_devices, 0x10000, np.uint32)
    res, lens = run_batch(dense, m.rule_by_name("replicated_rule"),
                          np.arange(2048, dtype=np.uint32), w, 3, mode=mode, device="cpu")
    digest = lambda t: hashlib.sha256(np.ascontiguousarray(t.numpy()).tobytes()).hexdigest()
    assert res.dtype == lens.dtype and res.numpy().dtype == np.int32
    assert digest(res) == want["mappings_sha256"]
    assert digest(lens) == want["lens_sha256"]


@pytest.mark.parametrize("argv", [
    ["--inject", "rack:0", "--plan"],
    ["--inject", "host:host0_1:down_out", "--inject", "osd:40", "--execute"],
    ["--flap", "osd:3", "--cycles", "2", "--plan", "--num-osd", "32", "--pg-num", "64"],
])
def test_recovery_plan_and_execute_match_reference(capsys, argv):
    want = _run(capsys, ref_recovery_cli.main, argv)
    got = _run(capsys, recovery_cli.main, argv + ["--device", "cpu"])
    wall = lambda text: re.sub(r"[0-9.]+ MB/s decode", "MB/s decode", text)  # noqa: E731
    assert got[0] == want[0] == 0
    assert wall(got[1]) == wall(want[1])
    assert "plan:" in got[1]


@pytest.mark.parametrize("scenario", ["mid-repair-loss", "flap"])
def test_recovery_chaos_json_line_matches_reference(capsys, scenario):
    argv = ["--chaos", scenario, "--pg-num", "64", "--chunk-size", "512", "--seed", "3"]
    want = _run(capsys, ref_recovery_cli.main, argv)
    got = _run(capsys, recovery_cli.main, argv + ["--device", "cpu"])
    assert got == want  # the summary holds no wall-clock field
    line = json.loads(got[1].strip().splitlines()[-1])
    assert line["scenario"] == scenario and line["converged"] and line["launches"] > 0


@pytest.mark.parametrize("flags,bad", [
    (["--mesh", "1"], ["--mesh", "3"]),
    (["--work-stealing", "on"], ["--work-stealing", "off", "--chip-fault", "chipslow:0.4"]),
    (["--chip-fault", "chipslow:0.4"], ["--chip-fault", "osd:3"]),
    (["--shard-min-bytes", "1024"], ["--shard-min-bytes", "lots"]),
])
def test_recovery_multi_device_flags_exit_non_zero(capsys, flags, bad):
    """The multi-device flags run as the reference's do on a one-device
    mesh (a world of one; the reference's ``make_mesh(1)``): the same
    report, the same JSON line.  Misused, they exit non-zero."""
    argv = ["--chaos", "mid-repair-loss", "--pg-num", "64", "--chunk-size", "512", "--seed", "3"]
    want = _run(capsys, ref_recovery_cli.main, argv + flags)
    got = _run(capsys, recovery_cli.main, argv + flags + ["--device", "cpu"])
    assert got == want and got[0] == 0
    with pytest.raises(SystemExit) as exc:
        recovery_cli.main(argv + bad + ["--device", "cpu"])
    assert exc.value.code not in (0, None)
