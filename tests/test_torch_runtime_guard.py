"""The port's runtime guard (``ceph_tpu_torch/analysis/runtime_guard.py``)
and its build cache (``common/compile_cache.py``, ``_cuda.lib_path``).

Each counter on CPU tensors: builds through a stand-in ``nvcc`` (a
script that writes its ``-o`` file) and the content-addressed cache,
kernel-wrapper calls by kernel, and host reads at each seam.  The
guards the reference shares are held against the reference's
(``ceph_tpu.analysis.runtime_guard``) on the same inputs:
``FsyncAudit`` on the same commit sequences, ``assert_bucketed`` and
``is_pow2`` on the same sizes, ``CompileBudget``'s verdicts, and
``rank_fingerprint`` on the same arrays, bit for bit.  The sync-debug
count needs the card: ``tests/test_torch_cuda.py``.
"""

import os
import stat

import numpy as np
import pytest
import torch

from ceph_tpu.analysis import runtime_guard as ref_rg
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu_torch import _cuda
from ceph_tpu_torch.analysis import runtime_guard as rg
from ceph_tpu_torch.common import compile_cache
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.core import straw2
from ceph_tpu_torch.ec import gf_kernels
from ceph_tpu_torch.recovery import scrub


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in compiler that writes its ``-o`` file, and an empty
    build directory."""
    script = tmp_path / "nvcc"
    script.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                      'echo "ptxas info: 0 bytes" >&2\necho lib > "$2"\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_cuda, "nvcc", lambda: str(script))
    monkeypatch.setattr(compile_cache, "_enabled", None)
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "cache"))
    return tmp_path / "cache"


# ---------------------------------------------------------------- builds


def test_compile_counter_counts_builds_then_cache_hits(fake_nvcc):
    with rg.CompileCounter() as cc:
        path = _cuda.build("scrub")
    assert (cc.backend_compiles, cc.cache_hits, cc.n_compiles) == (1, 0, 1)
    assert path == _cuda.lib_path("scrub") and os.path.dirname(path) == str(fake_nvcc)
    assert os.path.exists(_cuda.ptxas_path("scrub"))
    with rg.CompileCounter() as cc:
        assert _cuda.build("scrub") == path
    assert (cc.backend_compiles, cc.cache_hits, cc.n_compiles) == (0, 1, 1)
    assert _cuda.BUILD_LISTENERS == []  # the counters unregistered


def test_assert_no_recompile_raises_on_a_build_or_a_lookup(fake_nvcc):
    with pytest.raises(AssertionError, match="1 backend compile"):
        with rg.assert_no_recompile("warm"):
            _cuda.build("online")
    with pytest.raises(AssertionError, match="1 cache hit"):
        with rg.assert_no_recompile("warm"):
            _cuda.build("online")
    with rg.assert_no_recompile("warm") as cc:
        pass
    assert cc.n_compiles == 0


def test_cache_dir_precedence(tmp_path, monkeypatch):
    monkeypatch.setattr(compile_cache, "_enabled", None)
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.cache_dir() == compile_cache.DEFAULT_DIR
    assert compile_cache.DEFAULT_DIR.endswith(os.path.join("ceph_tpu_torch", "_build"))
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "env"))
    assert compile_cache.cache_dir() == str(tmp_path / "env")
    set_dir = compile_cache.enable_persistent_cache(str(tmp_path / "set"))
    assert set_dir == str(tmp_path / "set") and os.path.isdir(set_dir)
    assert compile_cache.enable_persistent_cache(str(tmp_path / "set")) == set_dir  # idempotent
    assert compile_cache.cache_dir() == set_dir
    assert compile_cache.cache_dir(str(tmp_path / "arg")) == str(tmp_path / "arg")
    assert _cuda.lib_path("ec").startswith(set_dir + os.sep)


def test_library_name_is_its_source_and_flags(tmp_path, monkeypatch):
    """Another source or other flags name another library, so a shared
    build directory never serves one checkout another's kernels."""
    key = _cuda.source_key("ec")
    assert len(key) == 16 and os.path.basename(_cuda.lib_path("ec")) == f"libec-{key}.so"
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = (open(os.path.join(_cuda.CSRC, "ec.cu"), "rb").read())
    (csrc / "ec.cu").write_bytes(src)
    monkeypatch.setattr(_cuda, "CSRC", str(csrc))
    assert _cuda.source_key("ec") == key
    (csrc / "ec.cu").write_bytes(src + b"\n// edited\n")
    assert _cuda.source_key("ec") != key
    (csrc / "ec.cu").write_bytes(src)
    monkeypatch.setattr(_cuda, "NVCC_FLAGS", _cuda.NVCC_FLAGS + ["-lineinfo"])
    assert _cuda.source_key("ec") != key


# ---------------------------------------------------------------- kernel calls


def test_launch_counter_counts_wrapper_calls_on_the_cpu():
    x = torch.arange(6, dtype=torch.int32)
    ids = torch.tensor([[-1, -2, 3]] * 6, dtype=torch.int32)
    w = torch.full((6, 3), 0x10000, dtype=torch.int32)
    with rg.LaunchCounter() as lc:
        straw2.negdraw(x, x, ids, w, torch.zeros((6, 3), dtype=torch.int64))
        straw2.negdraw(x, x, ids, w, torch.zeros((6, 3), dtype=torch.int64))
        gf_kernels.byte_lut(torch.zeros(8, dtype=torch.uint8), torch.arange(256).to(torch.uint8))
        scrub.crc_rows(torch.zeros((2, 16), dtype=torch.uint8))
    assert lc.calls == {"negdraw": 2, "byte_lut": 1, "crc32c_rows": 1}
    assert lc.launches == {}
    # on the card every call must launch; a CPU call does not
    with pytest.raises(AssertionError, match="did not launch"):
        with rg.LaunchCounter(check_launches=True):
            scrub.crc_rows(torch.zeros((2, 16), dtype=torch.uint8))
    assert set(rg.kernel_counts("CALLS")) == set(rg.kernel_counts("LAUNCHES")) == {
        "negdraw", "level_choose", "descend", "matrix_encode", "byte_lut", "bitmatrix_encode",
        "schedule_apply", "crc32c_rows", "stripe_absorb", "stripe_commit"}


def test_reset_launches_resets_the_calls_too():
    scrub.crc_rows(torch.zeros((1, 4), dtype=torch.uint8))
    assert scrub.CALLS["crc32c_rows"] > 0
    scrub.reset_launches()
    assert scrub.CALLS["crc32c_rows"] == scrub.LAUNCHES["crc32c_rows"] == 0


# ---------------------------------------------------------------- host reads


def test_transfer_counter_counts_each_seam_once():
    t = torch.arange(4)
    before = dict(torch.Tensor.__dict__)
    with rg.TransferCounter() as tc:
        t.sum().item()
        t.tolist()
        bool(t[0])
        int(t[1])
        float(t[1])
        [1, 2, 3][t[1]]  # __index__
        np.asarray(t)  # __array__, whose .numpy() is not counted again
        t.cpu().numpy()  # two seams
        torch.nonzero(t)
        t.nonzero()
        t + 1  # no read
    assert tc.by_seam == {"item": 1, "tolist": 1, "__bool__": 1, "__int__": 1, "__float__": 1,
                          "__index__": 1, "__array__": 1, "cpu": 1, "numpy": 1,
                          "torch.nonzero": 1, "nonzero": 1}
    assert tc.host_transfers == 11 and tc.sync_warnings == 0
    assert dict(torch.Tensor.__dict__) == before  # every patch undone
    with rg.TransferCounter() as tc:
        with rg.plain_stand_in():
            t.tolist()
        gf_kernels.byte_lut(torch.zeros(4, dtype=torch.uint8), torch.arange(256).to(torch.uint8))
    assert tc.host_transfers == 0


def test_track_composes_the_counters():
    with rg.track() as g:
        scrub.crc_rows(torch.zeros((2, 8), dtype=torch.uint8)).tolist()
    snap = g.snapshot()
    assert snap == {"n_compiles": 0, "backend_compiles": 0, "compile_cache_hits": 0,
                    "host_transfers": 1, "sync_warnings": 0,
                    "kernel_calls": {"crc32c_rows": 1}, "kernel_launches": {}}
    with rg.track(transfers=False) as g:
        torch.arange(3).tolist()
    assert g.host_transfers == 0


# ---------------------------------------------------------------- the reference's guards


_FSYNC, _REPLACE = os.fsync, os.replace


def _commit(tmp_path, name, *, file_fsync=True, dir_fsync=True):
    tmp, final = tmp_path / f"{name}.tmp", tmp_path / f"{name}.bin"
    with open(tmp, "wb") as fh:
        fh.write(b"payload")
        fh.flush()
        if file_fsync:
            os.fsync(fh.fileno())
    os.replace(tmp, final)
    if dir_fsync:
        fd = os.open(tmp_path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


@pytest.mark.parametrize("case", [
    dict(), dict(file_fsync=False), dict(dir_fsync=False),
    dict(file_fsync=False, dir_fsync=False),
])
def test_fsync_audit_matches_reference(tmp_path, case):
    """The same commit sequence under both audits: the same events and
    the same verdict (a missing file fsync, a missing directory fsync)."""
    verdicts = []
    for audit_cls, err in ((rg.FsyncAudit, rg.FsyncAuditError),
                           (ref_rg.FsyncAudit, ref_rg.FsyncAuditError)):
        with audit_cls("commit") as audit:
            _commit(tmp_path, audit_cls.__module__.split(".")[0], **case)
        try:
            audit.verify()
            verdicts.append(([k for k, _ in audit.events], None))
        except err as e:
            verdicts.append(([k for k, _ in audit.events],
                             str(e).split(": ", 1)[1].split("(")[0]))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][1] is None or "os.replace" in verdicts[0][1]
    assert os.fsync is _FSYNC and os.replace is _REPLACE  # both audits unpatched


def test_fsync_audit_raises_on_missing_file_or_directory_fsync(tmp_path):
    with rg.FsyncAudit("bad commit") as audit:
        _commit(tmp_path, "a", file_fsync=False)
    with pytest.raises(rg.FsyncAuditError, match="no prior file fsync"):
        audit.verify()
    with rg.FsyncAudit("half commit") as audit:
        _commit(tmp_path, "b", dir_fsync=False)
    with pytest.raises(rg.FsyncAuditError, match="no later directory fsync"):
        audit.verify()


@pytest.mark.parametrize("sizes", [(1,), (2, 8, 64), (0,), (6,), (8, 6), (1 << 20, 3),
                                   (np.zeros((16, 3)),), (np.zeros((12, 2)),)])
def test_assert_bucketed_matches_reference(sizes):
    def verdict(mod):
        try:
            mod.assert_bucketed("seam", *sizes)
            return None
        except mod.UnbucketedShapeError as e:
            return str(e).split(" is not")[0]

    assert verdict(rg) == verdict(ref_rg)
    assert all(rg.is_pow2(n) == ref_rg.is_pow2(n) for n in range(-2, 70))
    torch_sizes = [torch.zeros(s.shape) if isinstance(s, np.ndarray) else s for s in sizes]
    try:
        rg.assert_bucketed("seam", *torch_sizes)
        assert verdict(ref_rg) is None
    except rg.UnbucketedShapeError:
        assert verdict(ref_rg) is not None


def test_compile_budget_behaves_as_the_reference():
    """The reference's ``test_compile_budget_enforced_and_satisfied`` on
    the port's builds: a cold build inside budget passes, a fresh build
    over budget 0 raises ``compile budget 0``, a warm path holds 0, and
    an error in scope is not masked.  (The reference's own counter
    cannot run on this JAX: its monitoring hook is gone, R2.)"""

    def builds(n):
        for _ in range(n):
            _cuda._notify("ec", "compile")

    with rg.CompileBudget(4, "cold build") as cb:
        builds(1)
    assert cb.n_compiles == 1
    with pytest.raises(AssertionError, match="compile budget 0 exceeded"):
        with rg.CompileBudget(0, "warm path"):
            builds(1)
    with pytest.raises(AssertionError, match="compile budget 1 exceeded"):
        with rg.CompileBudget(1, "warm path"):
            builds(2)
    with rg.CompileBudget(0, "warm path") as cb:
        pass
    assert cb.n_compiles == 0
    with pytest.raises(KeyError):
        with rg.CompileBudget(0, "scope"):
            builds(1)
            raise KeyError("in scope")
    assert _cuda.BUILD_LISTENERS == []


@pytest.mark.parametrize("arrays", [
    (np.arange(12, dtype=np.int32).reshape(3, 4),),
    (np.zeros(5, np.uint8), np.int64(7), np.arange(3, dtype=np.float32)),
    (np.asarray(3.5), np.ones((2, 2, 2), np.int16)),
    (np.array([], np.int64),),
])
def test_rank_fingerprint_matches_reference(arrays):
    assert rg.rank_fingerprint(*arrays) == ref_rg.rank_fingerprint(*arrays)
    assert 1 <= rg.rank_fingerprint(*arrays) < (1 << rg._HASH_BITS)


def test_debug_knobs_have_the_reference_defaults():
    port, ref = Config(env={}), RefConfig(env={})
    for knob in ("debug_bucket_checks", "debug_fsync_audit", "debug_rank_checks"):
        assert port.get(knob) is ref.get(knob) is False
    assert Config(env={"CEPH_TPU_DEBUG_BUCKET_CHECKS": "1"}).get("debug_bucket_checks") is True
