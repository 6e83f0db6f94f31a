"""Command-line harnesses over the port: ``crushtool``, ``osdmaptool``
and ``ec_bench``, each run as ``python -m ceph_tpu_torch.cli.<tool>``
with ``--device`` (``cuda`` by default, ``cpu`` for the plain
versions)."""
