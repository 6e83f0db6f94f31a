"""The port stands alone: no jax, nothing of ceph_tpu, no hidden device.

An AST scan of every module of ``ceph_tpu_torch`` and of
``chip_smoke.py`` finds no import of ``jax`` or of the reference package
``ceph_tpu``; importing every module of the port in a fresh interpreter
leaves both out of ``sys.modules``.  Entry points default to the card
and raise without one.
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.models.clusters import build_osdmap
from ceph_tpu_torch import convert, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ceph_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not sources
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_reference_or_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    mods = sorted(m.name for m in pkgutil.walk_packages([PKG], "ceph_tpu_torch."))
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules "
        "if k.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    assert len(mods) > 10
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_scan_covers_the_ec_subpackage():
    """The EC slice (``ec/``, its plugins and kernels) is in both scans."""
    rel = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("ec/backend.py", "ec/gf_kernels.py", "ec/kernels.py", "ec/plugins/clay.py",
                "ec/plugins/lrc.py", "ec/registry.py"):
        assert mod in rel
    mods = {m.name for m in pkgutil.walk_packages([PKG], "ceph_tpu_torch.")}
    assert {"ceph_tpu_torch.ec.backend", "ceph_tpu_torch.ec.plugins.clay"} <= mods


def test_scan_covers_the_recovery_and_common_subpackages():
    """The recovery slice (``recovery/``, ``common/``, ``ec/schedule.py``)
    is in both scans."""
    rel = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("recovery/executor.py", "recovery/peering.py", "recovery/planner.py",
                "recovery/failure.py", "common/tracing.py", "common/prometheus.py",
                "ec/schedule.py"):
        assert mod in rel
    mods = {m.name for m in pkgutil.walk_packages([PKG], "ceph_tpu_torch.")}
    assert {"ceph_tpu_torch.recovery.executor", "ceph_tpu_torch.common.config",
            "ceph_tpu_torch.ec.schedule"} <= mods


def test_cuda_device_needs_a_card():
    """No CPU fallback: asking for the card without one raises."""
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        from ceph_tpu_torch.models.clusters import build_simple
        from ceph_tpu_torch.crush.engine import make_batch_runner

        m = build_simple(8)
        with pytest.raises(RuntimeError):
            make_batch_runner(m.to_dense(), m.rule_by_name("replicated_rule"), 3)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_convert_carries_the_reference_state():
    ref = build_osdmap(32, pg_num=64)
    ref.mark_down(3)
    ref.crush.create_choose_args("compat")
    port = convert.osdmap_from_reference(ref.encode())
    assert json.loads(port.encode()) == json.loads(ref.encode())
    crush = convert.crushmap_from_reference(ref.crush.to_obj())
    assert json.loads(crush.encode()) == json.loads(ref.crush.encode())
    assert type(crush).__module__.startswith("ceph_tpu_torch.")
    assert ceph_tpu_torch.__version__


def test_scan_covers_the_balancer_and_cli_subpackages():
    """The balancer and CLI slice (``balancer/``, ``cli/``, the text
    crushmap compiler, ``common/log.py``) is in both scans."""
    rel = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("balancer/__init__.py", "balancer/upmap.py", "balancer/module.py",
                "balancer/crush_compat.py", "balancer/pg_autoscaler.py", "cli/__init__.py",
                "cli/crushtool.py", "cli/osdmaptool.py", "cli/ec_bench.py",
                "crush/compiler.py", "common/log.py", "testing/golden.py"):
        assert mod in rel
    mods = {m.name for m in pkgutil.walk_packages([PKG], "ceph_tpu_torch.")}
    assert {"ceph_tpu_torch.balancer.upmap", "ceph_tpu_torch.balancer.crush_compat",
            "ceph_tpu_torch.cli.crushtool", "ceph_tpu_torch.cli.osdmaptool",
            "ceph_tpu_torch.cli.ec_bench", "ceph_tpu_torch.crush.compiler"} <= mods


def _device_default(fn):
    import inspect

    return inspect.signature(fn).parameters["device"].default


def test_balancer_and_clis_default_to_the_card(tmp_path):
    """``Balancer``, ``calc_pg_upmaps``, ``do_crush_compat`` and the three
    CLIs run on the card unless asked for the CPU, and raise without one."""
    from ceph_tpu_torch.balancer import Balancer, calc_pg_upmaps
    from ceph_tpu_torch.balancer.crush_compat import do_crush_compat
    from ceph_tpu_torch.cli import crushtool, ec_bench, osdmaptool
    from ceph_tpu_torch.models.clusters import build_osdmap as port_build_osdmap

    for fn in (Balancer, calc_pg_upmaps, do_crush_compat):
        assert _device_default(fn) == "cuda"
    m = port_build_osdmap(16, pg_num=32)
    path = str(tmp_path / "m.json")
    with open(path, "wb") as f:
        f.write(m.encode())
    calls = [
        lambda: Balancer(m),
        lambda: Balancer(m, mode="crush-compat"),
        lambda: calc_pg_upmaps(m),
        lambda: do_crush_compat(m),
        lambda: osdmaptool.main([path, "--test-map-pgs"]),
        lambda: osdmaptool.main([path, "--upmap", str(tmp_path / "out.sh")]),
        lambda: osdmaptool.main([path, "--crush-compat"]),
        lambda: crushtool.main(["-i", path.replace("m.json", "c.json"), "--test"]),
        lambda: ec_bench.main(["--size", "4096", "--iterations", "1"]),
    ]
    with open(path.replace("m.json", "c.json"), "wb") as f:
        f.write(m.crush.encode())
    if torch.cuda.is_available():
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Balancer(m, device="cpu").mapping.device.type == "cpu"


def test_scan_covers_the_rest_of_placement():
    """The general engine, the placement module and the table generator
    are in both scans."""
    rel = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("crush/interp.py", "parallel/__init__.py", "parallel/placement.py",
                "core/lutgen.py"):
        assert mod in rel
    mods = {m.name for m in pkgutil.walk_packages([PKG], "ceph_tpu_torch.")}
    assert {"ceph_tpu_torch.crush.interp", "ceph_tpu_torch.parallel.placement",
            "ceph_tpu_torch.core.lutgen"} <= mods


def test_placement_entry_points_default_to_the_card():
    """The general engine's map and the placement module run on the card
    unless asked for the CPU, and raise without one."""
    from ceph_tpu_torch.crush.interp import StaticCrushMap
    from ceph_tpu_torch.models.clusters import build_simple
    from ceph_tpu_torch.parallel import placement

    for fn in (StaticCrushMap, placement.sharded_placement_step,
               placement.sharded_rebalance_sim):
        assert _device_default(fn) == "cuda"
    if torch.cuda.is_available():
        return
    m = build_simple(8)
    dense, rule = m.to_dense(), m.rule_by_name("replicated_rule")
    for call in (lambda: StaticCrushMap(dense),
                 lambda: placement.sharded_placement_step(None, dense, rule, 3),
                 lambda: placement.sharded_rebalance_sim(None, dense, rule, 3, 16, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_scan_covers_fleets_durability_and_reconcile():
    """The fleet, durability and reconcile modules, the rank guard (in the
    runtime guard since the tooling slice) and the status CLI's panels
    are in both scans, and their entry points run on the card unless
    asked for the CPU."""
    rel = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("recovery/fleet.py", "recovery/durability.py", "recovery/reconcile.py",
                "analysis/runtime_guard.py", "cli/status.py"):
        assert mod in rel
    assert "common/rank_guard.py" not in rel
    mods = {m.name for m in pkgutil.walk_packages([PKG], "ceph_tpu_torch.")}
    assert {"ceph_tpu_torch.recovery.fleet", "ceph_tpu_torch.recovery.durability",
            "ceph_tpu_torch.recovery.reconcile", "ceph_tpu_torch.analysis.runtime_guard"} <= mods
    from ceph_tpu_torch.models.clusters import build_osdmap as port_build_osdmap
    from ceph_tpu_torch.recovery import (
        ChaosTimeline,
        DivergentDriver,
        FleetDriver,
        estimate_durability,
    )
    from ceph_tpu_torch.recovery.superstep import EpochDriver

    assert _device_default(EpochDriver) == "cuda"
    assert _device_default(estimate_durability) == "cuda"
    if torch.cuda.is_available():
        return
    m = port_build_osdmap(16, pg_num=16, size=6, pool_kind="erasure")
    for call in (lambda: FleetDriver(m, n_ops=8),
                 lambda: DivergentDriver(m, ChaosTimeline(), 2, n_ops=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_scan_covers_checkpoints_flight_and_the_write_path(tmp_path):
    """The checkpoint store and its crash child, the flight recorder and
    its trace export, the stripe buffer and the write path are in both
    scans, and their entry points run on the card unless asked for the
    CPU (the crash child's config without a "device" key too)."""
    rel = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("recovery/checkpoint.py", "recovery/_crashbox.py", "obs/flight.py",
                "obs/traceexport.py", "ec/online.py", "workload/writepath.py"):
        assert mod in rel
    mods = {m.name for m in pkgutil.walk_packages([PKG], "ceph_tpu_torch.")}
    assert {"ceph_tpu_torch.recovery.checkpoint", "ceph_tpu_torch.recovery._crashbox",
            "ceph_tpu_torch.obs.flight", "ceph_tpu_torch.obs.traceexport",
            "ceph_tpu_torch.ec.online", "ceph_tpu_torch.workload.writepath"} <= mods
    from ceph_tpu_torch.ec.online import ParityDeltaEngine, empty_stripe_buffer
    from ceph_tpu_torch.obs.flight import empty_flight
    from ceph_tpu_torch.recovery import _crashbox
    from ceph_tpu_torch.recovery.checkpoint import CheckpointStore

    for fn in (CheckpointStore, empty_flight, empty_stripe_buffer, ParityDeltaEngine):
        assert _device_default(fn) == "cuda"
    if torch.cuda.is_available():
        return
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"mode": "superstep", "store": str(tmp_path / "s"),
                               "out": str(tmp_path / "o.npz"), "n_osds": 16, "pg_num": 16}))
    for call in (lambda: CheckpointStore(str(tmp_path / "c")),
                 lambda: empty_flight(4), lambda: empty_stripe_buffer(4, 2, 4, 2, 1),
                 lambda: _crashbox.main([str(cfg)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_scan_covers_the_mesh_modules():
    """The multi-device modules (the mesh, the world launcher, the
    sharded decode, the dispatcher) are in both scans; the mesh and the
    world default to the card and raise without one; ``init`` never
    forms a group whose backend cannot serve the device."""
    rel = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("parallel/mesh.py", "parallel/multihost.py", "parallel/padding.py",
                "recovery/sharded.py", "recovery/dispatch.py", "testing/world.py",
                "testing/mesh_cases.py"):
        assert mod in rel
    mods = {m.name for m in pkgutil.walk_packages([PKG], "ceph_tpu_torch.")}
    assert {"ceph_tpu_torch.parallel.mesh", "ceph_tpu_torch.parallel.multihost",
            "ceph_tpu_torch.recovery.sharded", "ceph_tpu_torch.recovery.dispatch",
            "ceph_tpu_torch.testing.world"} <= mods
    from ceph_tpu_torch.parallel import make_mesh, multihost
    from ceph_tpu_torch.testing.world import run_world

    assert _device_default(run_world) == "cuda"
    assert _device_default(make_mesh) == "cuda"
    assert _device_default(multihost.init) == "cuda"
    assert _device_default(multihost.global_mesh) == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_scan_covers_the_tooling():
    """The tooling (``analysis/``, ``cli/lint.py``, ``common/compile_cache.py``,
    ``testing/nonregression.py``) is in both scans, and importing it in a
    fresh interpreter loads neither jax nor the reference package."""
    rel = {os.path.relpath(p, PKG) for p in _sources()}
    tooling = ("analysis/__init__.py", "analysis/findings.py", "analysis/runner.py",
               "analysis/checkers.py", "analysis/runtime_guard.py", "cli/lint.py",
               "common/compile_cache.py", "testing/nonregression.py")
    for mod in tooling:
        assert mod in rel
    assert "common/hermetic.py" not in rel  # not ported on purpose
    names = ["ceph_tpu_torch." + m[:-3].replace("/", ".").removesuffix(".__init__")
             for m in tooling]
    assert set(names) <= {m.name for m in pkgutil.walk_packages([PKG], "ceph_tpu_torch.")} | {
        "ceph_tpu_torch.analysis"}
    code = (
        "import importlib, json, sys\n"
        f"for m in {names!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules "
        "if k.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
