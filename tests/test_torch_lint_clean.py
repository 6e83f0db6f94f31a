"""The port's tree is torchlint-clean: no active finding, every
suppression silences a real finding and gives its reason, and
``python -m ceph_tpu_torch.cli.lint ceph_tpu_torch/`` exits 0."""

import os
import subprocess
import sys

import pytest

from ceph_tpu_torch.analysis import Suppressions, iter_py_files, lint_paths
from ceph_tpu_torch.analysis.runner import package_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def result():
    return lint_paths([package_dir()])


def test_package_has_no_active_findings(result):
    assert result.files > 100 and not result.errors
    assert [f.render() for f in result.active] == []


def test_package_has_no_dead_suppression(result):
    assert result.unused_suppressions == []
    assert result.suppressed  # the intended syncs are there, each suppressed


def test_every_suppression_gives_its_reason():
    """A suppression carries its reason on its line or the line above."""
    bad = []
    for path in iter_py_files([package_dir()]):
        lines = open(path, encoding="utf-8").read().splitlines()
        for ln in Suppressions.parse("\n".join(lines)).by_line:
            reason = lines[ln - 1].split("disable=", 1)[1].partition("#")[2].strip()
            above = lines[ln - 2].strip() if ln > 1 else ""
            if not reason and not (above.startswith("#") and "torchlint" not in above):
                bad.append(f"{os.path.relpath(path, REPO)}:{ln}")
    assert bad == []


def test_cli_exits_clean_on_the_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "ceph_tpu_torch.cli.lint", "ceph_tpu_torch/"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "torchlint: 0 findings" in out.stdout
