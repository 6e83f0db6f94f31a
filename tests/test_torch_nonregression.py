"""The port's non-regression archive and launch budgets
(``ceph_tpu_torch/testing/nonregression.py``) on the CPU.

``generate("cpu")``, printed as the module prints it, is byte-equal to
``tests/golden/archive.json`` (the reference's archive: CRUSH mapping
digests through the port's batch engine, EC chunk digests through
``ceph_tpu_torch.ec.create``), in process and through ``python -m``.
Every ``launch_budget_cases`` scenario stays inside its budget on the
CPU (no build, the kernel calls and seam reads of ``BUDGETS``), each
budget is tight there, and the scenario names are pinned: the
reference's ``compile_once_cases``, ``fused_placement`` among them.
"""

import os
import subprocess
import sys

import pytest
import torch

from ceph_tpu_torch.testing import nonregression as nr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVE = os.path.join(REPO, "tests", "golden", "archive.json")
SCENARIOS = ("pool_mapping", "pattern_decode", "schedule_decode", "scrub_pass",
             "heartbeat_tick", "fused_placement", "epoch_superstep", "fleet_superstep",
             "compacted_superstep", "online_write_batch", "reconcile_round",
             "worksteal_dispatch")


def _archive() -> str:
    with open(ARCHIVE) as f:
        return f.read()


def test_generate_is_byte_equal_to_the_archive():
    assert nr.render(nr.generate("cpu")) == _archive()


def test_module_prints_the_archive():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "ceph_tpu_torch.testing.nonregression",
                          "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout == _archive()


def test_scenario_names_are_pinned():
    assert tuple(nr._CASES) == SCENARIOS
    assert set(nr.BUDGETS) == set(SCENARIOS)
    # the reference's scenarios, the fused placement program's among them
    from ceph_tpu.testing import nonregression as ref_nr

    doc = ref_nr.compile_once_cases.__doc__
    assert all(f"``{name}``" in doc for name in SCENARIOS)


@pytest.mark.parametrize("name", SCENARIOS)
def test_second_run_inside_its_budget(name):
    seen = nr._CASES[name](torch.device("cpu"))
    nr._check(name, seen)  # raises over budget
    budget = nr.BUDGETS[name]
    # tight on the CPU: the budget is what the CPU counts
    assert seen["builds"] == 0
    assert seen["calls"] == budget.calls
    assert seen["host_reads"] == budget.host_reads
    assert seen["launches"] == {} and seen["sync_warnings"] == 0
    # a budget above the reference's zero says why
    assert budget.host_reads == 0 or budget.why


def test_check_refuses_a_run_over_budget():
    ok = {"builds": 0, "calls": {"descend": 18}, "host_reads": 17}
    nr._check("pool_mapping", ok)
    for bad in ({**ok, "builds": 1}, {**ok, "host_reads": 18},
                {**ok, "calls": {"descend": 19}}, {**ok, "calls": {"descend": 1, "negdraw": 1}}):
        with pytest.raises(AssertionError, match="over budget"):
            nr._check("pool_mapping", bad)


def test_launch_budget_cases_default_to_the_card():
    import inspect

    for fn in (nr.launch_budget_cases, nr.generate, nr.crush_cases, nr.ec_cases):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            nr.launch_budget_cases()
