"""The port's crush_ln table generator (``ceph_tpu_torch.core.lutgen``).

Its rendered tables are the port's checked-in
``ceph_tpu_torch/core/_crush_ln_tables.py`` (``--check`` agrees), its
C++ rendering is ``cpp/crush_ln_tables.h`` but for the header line that
names the generator, its tables are the reference generator's, and
``main()`` writes the port's table file and nothing else.
"""

import io
import os

from ceph_tpu.core import lutgen as ref_lutgen
from ceph_tpu_torch.core import _crush_ln_tables, lutgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ceph_tpu_torch")


def test_rendered_tables_are_the_checked_in_file():
    with open(lutgen.PY_PATH) as f:
        assert f.read() == lutgen.render_py()
    assert lutgen.main(["--check"]) == 0
    assert _crush_ln_tables.RH_LH_TBL == tuple(lutgen.gen_rh_lh())
    assert _crush_ln_tables.LL_TBL == tuple(lutgen.gen_ll())


def test_tables_equal_the_reference_generators():
    assert lutgen.gen_rh_lh() == ref_lutgen.gen_rh_lh()
    assert lutgen.gen_ll() == ref_lutgen.gen_ll()
    body = lambda text: text.split("\n", 1)[1]
    assert body(lutgen.render_py()) == body(ref_lutgen.render_py())


def test_cpp_rendering_is_the_cpp_header_but_its_first_line():
    with open(os.path.join(REPO, "cpp", "crush_ln_tables.h")) as f:
        header = f.read()
    got = lutgen.render_cpp()
    assert got.split("\n", 1)[1] == header.split("\n", 1)[1]
    assert "ceph_tpu_torch.core.lutgen" in got.split("\n", 1)[0]


def test_check_fails_on_a_changed_table_file(tmp_path):
    path = tmp_path / "_crush_ln_tables.py"
    path.write_text(lutgen.render_py().replace("281474976710656", "281474976710657", 1))
    assert lutgen.main(["--check"], path=str(path)) == 1
    assert lutgen.main([], path=str(path)) == 0
    assert lutgen.main(["--check"], path=str(path)) == 0


def test_main_writes_only_the_ports_table(monkeypatch):
    """Every file ``main()`` opens for writing lies under ceph_tpu_torch/
    (recorded, not written: the tables stay as they are)."""
    written = {}

    def recording_open(path, mode="r", *a, **kw):
        if "w" in mode or "a" in mode:
            buf = written[os.path.abspath(path)] = io.StringIO()
            buf.close = lambda: None
            return buf
        return open(path, mode, *a, **kw)

    monkeypatch.setattr(lutgen, "open", recording_open, raising=False)
    assert lutgen.main([]) == 0
    assert list(written) == [lutgen.PY_PATH]
    assert all(p.startswith(PORT + os.sep) for p in written)
    assert written[lutgen.PY_PATH].getvalue() == lutgen.render_py()
