"""The port reproduces the EC golden digests without the reference.

``tests/golden/archive.json["ec"]`` pins the SHA-256 of every chunk of a
40,000-byte object (``default_rng(0xCE9)``) encoded by 15 profiles
(``ceph_tpu.testing.nonregression.ec_cases``).  The profiles and the
seed are restated here, and the port encodes with ``device="cpu"``
(the kernels' plain versions); this file imports nothing of the
reference package.  Digests are compared exactly.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from ceph_tpu_torch.ec import create

ARCHIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "archive.json")
PROFILES = {
    "jerasure_rs_4_2": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2"},
    "jerasure_rs_8_3": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8", "m": "3"},
    "jerasure_r6_4_2": {"plugin": "jerasure", "technique": "reed_sol_r6_op", "k": "4", "m": "2"},
    "jerasure_cauchy_4_2_p8": {"plugin": "jerasure", "technique": "cauchy_good", "k": "4",
                               "m": "2", "packetsize": "8"},
    "lrc_4_2_3": {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
    "shec_4_3_2": {"plugin": "shec", "k": "4", "m": "3", "c": "2"},
    "clay_4_2": {"plugin": "clay", "k": "4", "m": "2"},
    "clay_4_3_d5": {"plugin": "clay", "k": "4", "m": "3", "d": "5"},
    "clay_4_3_d4": {"plugin": "clay", "k": "4", "m": "3", "d": "4"},
    "jerasure_liberation_4_2_w7": {"plugin": "jerasure", "technique": "liberation", "k": "4",
                                   "m": "2", "w": "7", "packetsize": "8"},
    "jerasure_blaum_roth_4_2_w6": {"plugin": "jerasure", "technique": "blaum_roth", "k": "4",
                                   "m": "2", "w": "6", "packetsize": "8"},
    "jerasure_liber8tion_4_2": {"plugin": "jerasure", "technique": "liber8tion", "k": "4",
                                "m": "2", "packetsize": "8"},
    "jerasure_rs_4_2_w16": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
                            "m": "2", "w": "16"},
    "jerasure_rs_4_2_w32": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
                            "m": "2", "w": "32"},
    "jerasure_cauchy_4_2_w16_p8": {"plugin": "jerasure", "technique": "cauchy_good", "k": "4",
                                   "m": "2", "w": "16", "packetsize": "8"},
}


def _golden() -> dict:
    with open(ARCHIVE) as f:
        return json.load(f)["ec"]


def test_every_archived_profile_is_restated():
    assert sorted(_golden()) == sorted(PROFILES)


@pytest.mark.parametrize("name", list(PROFILES))
def test_port_reproduces_golden_digests(name):
    obj = np.random.default_rng(0xCE9).integers(0, 256, 40_000, dtype=np.uint8)
    ec = create(PROFILES[name], device="cpu")
    enc = ec.encode(set(range(ec.get_chunk_count())), obj)
    want = _golden()[name]
    assert len(enc[0]) == want["chunk_size"]
    got = {str(i): hashlib.sha256(np.ascontiguousarray(enc[i]).tobytes()).hexdigest()
           for i in sorted(enc)}
    assert got == want["chunks_sha256"]
