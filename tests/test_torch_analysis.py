"""torchlint (``ceph_tpu_torch/analysis/``, ``ceph_tpu_torch/cli/lint.py``):
one firing and one silent fixture for each rule, suppressions, and the
CLI's exit codes and baseline round trip."""

import json
import textwrap

import pytest

from ceph_tpu_torch.analysis import RULES, lint_source
from ceph_tpu_torch.cli.lint import (
    EXIT_CLEAN,
    EXIT_DEAD_SUPPRESSIONS,
    EXIT_FINDINGS,
    EXIT_NEW_FINDINGS,
    EXIT_USAGE,
    main,
)

HEAD = "import os, random, time\nimport numpy as np\nimport torch\nimport torch.distributed as dist\n"


def _rules(src: str, **kw) -> list[str]:
    res = lint_source(HEAD + textwrap.dedent(src), path="fixture.py", **kw)
    assert not res.errors, res.errors
    return [f.rule for f in res.active]


FIRING = {
    "J003 item in loop": ("J003", """
        def f(ts):
            for t in ts:
                t.sum().item()
        """),
    "J003 cpu in while": ("J003", """
        def f(t):
            while True:
                t.cpu()
        """),
    "J003 bool of a tensor": ("J003", """
        def f(t: torch.Tensor):
            for _ in range(3):
                if bool((t > 0).any()):
                    break
        """),
    "J003 int of a torch call": ("J003", """
        def f(t):
            return [int(torch.count_nonzero(t)) for _ in range(3)]
        """),
    "J003 nonzero": ("J003", """
        def f(t):
            for _ in range(3):
                torch.nonzero(t)
        """),
    "J003 synchronize": ("J003", """
        def f():
            for _ in range(3):
                torch.cuda.synchronize()
        """),
    "J003 helper that reads": ("J003", """
        def _any(t: torch.Tensor) -> bool:
            return bool(t.any())

        def ladder(t):
            while _any(t):
                t = t - 1
        """),
    "J008 get_rank guards all_reduce": ("J008", """
        def f(t):
            if dist.get_rank() == 0:
                dist.all_reduce(t)
        """),
    "J008 mesh rank guards a helper's psum": ("J008", """
        def _sum(mesh, t):
            return mesh.psum(t)

        def f(mesh, t):
            if mesh.rank == 0:
                _sum(mesh, t)
        """),
    "J008 wall clock guards a barrier": ("J008", """
        def f():
            start = time.monotonic()
            while start > 0:
                dist.barrier()
        """),
    "J009 set feeds appends": ("J009", """
        def f(items, out):
            for x in set(items):
                out.append(x)
        """),
    "J009 list from a set": ("J009", """
        def f(a, b):
            return [x for x in set(a) | set(b)]
        """),
    "J010 wall clock": ("J010", """
        def f():
            return time.perf_counter()
        """),
    "J011 torch.rand": ("J011", """
        def f():
            return torch.rand(3)
        """),
    "J011 torch.randint": ("J011", """
        def f():
            return torch.randint(0, 9, (3,))
        """),
    "J011 manual_seed": ("J011", """
        def f():
            torch.manual_seed(0)
        """),
    "J011 in-place sampling": ("J011", """
        def f(t):
            t.uniform_()
        """),
    "J011 numpy global": ("J011", """
        def f():
            return np.random.rand(3)
        """),
    "J011 unseeded default_rng": ("J011", """
        def f():
            return np.random.default_rng()
        """),
    "J011 python global": ("J011", """
        def f():
            return random.random()
        """),
    "J016 replace without fsync": ("J016", """
        def save(path, data):
            with open(path + ".tmp", "wb") as fh:
                fh.write(data)
            os.replace(path + ".tmp", path)
            _fsync_dir(os.path.dirname(path))
        """),
    "J016 replace without dir fsync": ("J016", """
        def save(path, data):
            with open(path + ".tmp", "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(path + ".tmp", path)
        """),
    "J016 append without repair": ("J016", """
        def log(path, line):
            with open(path, "a") as fh:
                fh.write(line)
        """),
    "J018 buffer read after the step": ("J018", """
        def f(buf, table, lanes):
            new, row = stripe_buffer_step(buf, table, 8, 4, 7, *lanes)
            return buf.keys
        """),
    "J018 step in a loop, not rebound": ("J018", """
        def f(buf, table, batches):
            rows = []
            for lanes in batches:
                _, row = stripe_buffer_step(buf, table, 8, 4, 7, *lanes)
                rows.append(row)
            return rows
        """),
    "J018 a docstring contract": ("J018", """
        def absorb(state, x):
            \"\"\"Fold x into state in place (consumes=state).\"\"\"
            state += x
            return state

        def f(s, x):
            out = absorb(s, x)
            return s + out
        """),
}

SILENT = {
    "J003 read after the loop": ("J003", """
        def f(ts):
            acc = torch.zeros(3)
            for t in ts:
                acc = acc + t
            return acc.sum().item()
        """),
    "J003 numpy tolist in a loop": ("J003", """
        def f(rows):
            for r in rows:
                cols = np.flatnonzero(r)
                cols.tolist()
        """),
    "J003 int of a host value": ("J003", """
        def f(xs):
            return [int(x) for x in xs]
        """),
    "J003 suppressed with a reason": ("J003", """
        def f(ts):
            for t in ts:
                # torchlint: disable=J003  # the round's one read decides the next
                t.sum().item()
        """),
    "J008 rank-identical predicate": ("J008", """
        def f(t, n):
            if n > 0:
                dist.all_reduce(t)
        """),
    "J008 rank branch with no collective": ("J008", """
        def f(path):
            if dist.get_rank() == 0:
                print(path)
        """),
    "J009 sorted set": ("J009", """
        def f(items, out):
            for x in sorted(set(items)):
                out.append(x)
        """),
    "J009 set loop without order sink": ("J009", """
        def f(items):
            n = 0
            for x in set(items):
                n += x
            return n
        """),
    "J010 virtual clock": ("J010", """
        def f(clock):
            return clock.now()
        """),
    "J011 seeded generator": ("J011", """
        def f(dev):
            g = torch.Generator(dev).manual_seed(7)
            return torch.rand(3, generator=g), np.random.default_rng(0).random(3)
        """),
    "J016 full commit chain": ("J016", """
        def save(path, data):
            with open(path + ".tmp", "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(path + ".tmp", path)
            _fsync_dir(os.path.dirname(path))
            _repair_torn_tail(path + ".log")
            with open(path + ".log", "a") as fh:
                fh.write("x")
        """),
    "J018 rebound to the result": ("J018", """
        def f(buf, table, batches):
            rows = []
            for lanes in batches:
                buf, row = stripe_buffer_step(buf, table, 8, 4, 7, *lanes)
                rows.append(row)
            return buf.keys, rows
        """),
    "J018 a clone passed": ("J018", """
        def f(buf, table, lanes):
            new, row = stripe_buffer_step(buf.clone(), table, 8, 4, 7, *lanes)
            return buf.keys, new
        """),
}


@pytest.mark.parametrize("case", list(FIRING))
def test_rule_fires(case):
    rule, src = FIRING[case]
    assert rule in _rules(src), case


@pytest.mark.parametrize("case", list(SILENT))
def test_rule_stays_silent(case):
    rule, src = SILENT[case]
    assert rule not in _rules(src), case


def test_every_rule_has_a_firing_and_a_silent_fixture():
    assert {r for r, _ in FIRING.values()} == set(RULES)
    assert {r for r, _ in SILENT.values()} == set(RULES)
    assert sorted(RULES) == ["J003", "J008", "J009", "J010", "J011", "J016", "J018"]


def test_scoping_keeps_rules_to_their_modules():
    assert _rules(FIRING["J003 item in loop"][1], hot=False) == []
    assert _rules(FIRING["J010 wall clock"][1], vclock=False) == []
    assert _rules(FIRING["J016 append without repair"][1], durable=False) == []
    from ceph_tpu_torch.analysis import is_durable, is_hot, is_vclock

    assert is_hot("ceph_tpu_torch/crush/interp_batch.py")
    assert not is_hot("ceph_tpu_torch/common/log.py")
    assert is_vclock("ceph_tpu_torch/recovery/superstep.py")
    assert is_durable("ceph_tpu_torch/recovery/checkpoint.py")
    assert is_durable("ceph_tpu_torch/obs/traceexport.py")


def test_suppressions_are_tracked_and_dead_ones_reported():
    src = HEAD + textwrap.dedent("""
        def f(ts):
            for t in ts:
                t.cpu()  # torchlint: disable=J003
            x = 1  # torchlint: disable=J011
            # torchlint: disable=all
            return time.time()
        """)
    res = lint_source(src, path="fixture.py")
    assert [f.rule for f in res.suppressed] == ["J003", "J010"]
    assert res.active == []
    assert [ln for _, ln in res.unused_suppressions] == [src.splitlines().index(
        "    x = 1  # torchlint: disable=J011") + 1]
    # a suppression example inside a docstring is not a suppression
    doc = lint_source('"""use ``# torchlint: disable=J003``"""\n', path="d.py")
    assert doc.unused_suppressions == []


def test_syntax_error_is_an_error_not_a_crash():
    res = lint_source("def f(:\n", path="bad.py")
    assert res.errors and "syntax error" in res.errors[0]


# ---------------------------------------------------------------- the CLI


def _tree(tmp_path, body: str):
    pkg = tmp_path / "recovery"
    pkg.mkdir(exist_ok=True)
    (pkg / "mod.py").write_text(HEAD + textwrap.dedent(body))
    return str(pkg)


def test_cli_exit_codes(tmp_path, capsys):
    clean = _tree(tmp_path, "def f(clock):\n    return clock.now()\n")
    assert main([clean]) == EXIT_CLEAN
    dirty = _tree(tmp_path, "def f(ts):\n    for t in ts:\n        t.item()\n")
    assert main([dirty]) == EXIT_FINDINGS
    assert "J003" in capsys.readouterr().out
    assert main(["--select", "J011", dirty]) == EXIT_CLEAN
    assert main(["--select", "J001", dirty]) == EXIT_USAGE
    assert main([str(tmp_path / "missing")]) == EXIT_USAGE
    assert main(["--explain", "J018"]) == EXIT_CLEAN
    assert "consumed-buffer-reuse" in capsys.readouterr().out
    assert main(["--explain", "J004"]) == EXIT_USAGE
    assert main(["--baseline", "a.json", "--write-baseline", "b.json", dirty]) == EXIT_USAGE


def test_cli_formats(tmp_path, capsys):
    dirty = _tree(tmp_path, "def f(ts):\n    for t in ts:\n        t.item()\n")
    capsys.readouterr()
    assert main(["--format=json", dirty]) == EXIT_FINDINGS
    doc = json.loads(capsys.readouterr().out)
    assert doc["tool"] == "torchlint" and doc["n_active"] == 1
    assert doc["findings"][0]["name"] == "host-sync-in-loop"
    assert doc["by_rule"]["J003"] == {"active": 1, "suppressed": 0}
    assert main(["--format=github", dirty]) == EXIT_FINDINGS
    assert capsys.readouterr().out.startswith("::error file=")


def test_cli_baseline_round_trip(tmp_path, capsys):
    dirty = _tree(tmp_path, "def f(ts):\n    for t in ts:\n        t.item()\n")
    base = str(tmp_path / "base.json")
    assert main(["--write-baseline", base, dirty]) == EXIT_CLEAN
    with open(base) as f:
        doc = json.load(f)
    assert doc["tool"] == "torchlint-baseline" and sum(doc["counts"].values()) == 1
    assert main(["--baseline", base, dirty]) == EXIT_CLEAN  # the debt, no more
    _tree(tmp_path, "def f(ts):\n    for t in ts:\n        t.item()\n        t.cpu()\n")
    assert main(["--baseline", base, dirty]) == EXIT_NEW_FINDINGS
    _tree(tmp_path, "def f(clock):\n    return clock.now()  # torchlint: disable=J010\n")
    assert main(["--baseline", base, dirty]) == EXIT_DEAD_SUPPRESSIONS
    _tree(tmp_path, "def f(clock):\n    return clock.now()\n")
    capsys.readouterr()
    assert main(["--baseline", base, dirty]) == EXIT_CLEAN
    assert "retired" in capsys.readouterr().out
    (tmp_path / "junk.json").write_text('{"tool": "other"}')
    assert main(["--baseline", str(tmp_path / "junk.json"), dirty]) == EXIT_USAGE
