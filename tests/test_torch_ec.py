"""The port's erasure coding vs the reference package's.

Both packages build each codec through their plugin registry (the port
with ``device="cpu"``, where every kernel wrapper runs its plain
version): the 15 profiles of ``nonregression.ec_cases`` encode the same
object chunk for chunk; four codes decode every erasure pattern of up
to m chunks as the reference does (bytes, or the same refusal); the
striped-object layer round-trips; and ``convert.ec_codec_from_reference``
carries a reference decoder's inverted matrix across.  One reference
codec per profile is built and reused.  All comparisons are integer:
exact equality.
"""

import itertools
from functools import lru_cache

import numpy as np
import pytest
import torch

from ceph_tpu.ec import ErasureCodeError as RefErasureCodeError
from ceph_tpu.ec import create as ref_create
from ceph_tpu.ec import stripe as ref_stripe
from ceph_tpu.ec.backend import BitmatrixCodec as RefBitmatrixCodec
from ceph_tpu.ec.backend import MatrixCodec as RefMatrixCodec
from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.ec import gfw as ref_gfw
from ceph_tpu_torch import convert
from ceph_tpu_torch.ec import ErasureCodeError, create, stripe
from ceph_tpu_torch.ec.backend import BitmatrixCodec, MatrixCodec, TableEncoder

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
OBJECT = np.random.default_rng(0x7EC).integers(0, 256, 9_000, dtype=np.uint8)


@lru_cache(maxsize=None)
def _ref(name):
    return ref_create(PROFILES[name])


@lru_cache(maxsize=None)
def _port(name):
    return create(PROFILES[name], device="cpu")


@lru_cache(maxsize=None)
def _encoded(name):
    ec = _ref(name)
    return ec.encode(set(range(ec.get_chunk_count())), OBJECT)


@pytest.mark.parametrize("name", list(PROFILES))
def test_encode_matches_reference(name):
    want = _encoded(name)
    got = _port(name).encode(set(range(_port(name).get_chunk_count())), OBJECT)
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i].dtype == np.uint8
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"{name} chunk {i}")


def _patterns(n, m):
    return [lost for r in range(1, m + 1) for lost in itertools.combinations(range(n), r)]


@pytest.mark.parametrize("name", ["jerasure_rs_4_2", "jerasure_cauchy_4_2_p8",
                                  "jerasure_liberation_4_2_w7", "shec_4_3_2"])
def test_decode_every_pattern_matches_reference(name):
    ref, port = _ref(name), _port(name)
    full = _encoded(name)
    n, m = ref.get_chunk_count(), ref.get_coding_chunk_count()
    size = len(full[0])
    decoded = refused = 0
    for lost in _patterns(n, m):
        avail = {i: c.copy() for i, c in full.items() if i not in lost}
        try:
            want = ref.decode(set(lost), dict(avail), size)
        except (RefErasureCodeError, ValueError):
            with pytest.raises((ErasureCodeError, ValueError)):
                port.decode(set(lost), dict(avail), size)
            refused += 1
            continue
        got = port.decode(set(lost), dict(avail), size)
        for i in lost:
            np.testing.assert_array_equal(got[i], want[i], err_msg=f"{name} lost {lost}")
            np.testing.assert_array_equal(got[i], full[i], err_msg=f"{name} lost {lost}")
        decoded += 1
    assert decoded > 0
    # only SHEC (not MDS) refuses some patterns of m erasures
    assert (refused > 0) == (name == "shec_4_3_2")


@pytest.mark.parametrize("name", ["jerasure_rs_4_2", "lrc_4_2_3", "clay_4_2",
                                  "jerasure_liberation_4_2_w7"])
def test_stripe_roundtrip_matches_reference(name):
    """encode_object streams equal the reference's; decode_object
    rebuilds the object from any k-subset, with shard failures mid-read."""
    ref, port = _ref(name), _port(name)
    obj = np.random.default_rng(5).integers(0, 256, 3 * 8192 + 17, dtype=np.uint8)
    sw = ref.get_data_chunk_count() * 2048
    rinfo, rshards = ref_stripe.encode_object(ref, obj, sw)
    pinfo, pshards = stripe.encode_object(port, obj, sw)
    assert (pinfo.k, pinfo.chunk_size) == (rinfo.k, rinfo.chunk_size)
    for s in rshards:
        np.testing.assert_array_equal(pshards[s], rshards[s], err_msg=f"shard {s}")
    shards = sorted(pshards)
    n_fail = ref.get_coding_chunk_count() if name != "lrc_4_2_3" else 1
    for failed in itertools.islice(itertools.combinations(shards, n_fail), 6):
        out = stripe.decode_object(port, pinfo, pshards, len(obj), failed=set(failed))
        assert out == obj.tobytes()


def test_stripe_info_and_short_streams():
    port = _port("jerasure_rs_4_2")
    info = stripe.stripe_info_for(port, 4096)
    assert (info.k, info.chunk_size, info.stripe_width) == (4, 1024, 4096)
    assert info.offset_len_to_stripe_bounds(5000, 100) == (4096, 4096)
    _, shards = stripe.encode_object(port, OBJECT, 4096)
    shards[0] = shards[0][:-1]
    with pytest.raises(ErasureCodeError):
        stripe.decode_object(port, info, shards, len(OBJECT), failed={4, 5})


def test_convert_carries_a_reference_decoder_across():
    """A reference codec's decoders (its inverted matrices) rebuilt in
    the port compute the same products."""
    rng = np.random.default_rng(11)
    ref = RefMatrixCodec(ref_gf.vandermonde_matrix(4, 2))
    data = rng.integers(0, 256, (4, 512), dtype=np.uint8)
    coding = ref.encode(data)
    chunks = {0: data[0], 2: data[2], 4: coding[0], 5: coding[1]}
    ref.decode(dict(chunks), {1, 3})
    (dec,) = ref._decoders.values()
    port = convert.ec_codec_from_reference({"matrix": dec.matrix}, "cpu")
    survivors = np.stack([chunks[r] for r in sorted(chunks)])
    np.testing.assert_array_equal(port.encode(survivors), dec.encode(survivors))
    np.testing.assert_array_equal(port.encode(survivors), data)

    bm = ref_gfw.liberation_bitmatrix(4, 7)
    rbc = RefBitmatrixCodec(bm, 7, 8)
    data = rng.integers(0, 256, (4, 7 * 8 * 4), dtype=np.uint8)
    coding = rbc.encode(data)
    chunks = {1: data[1], 3: data[3], 4: coding[0], 5: coding[1]}
    rbc.decode(dict(chunks), {0, 2})
    (bdec,) = rbc._decoders.values()
    port = convert.ec_codec_from_reference(
        {"bitmatrix": bdec.bitmatrix, "w": bdec.w, "packetsize": bdec.packetsize}, "cpu")
    survivors = np.stack([chunks[r] for r in sorted(chunks)])
    np.testing.assert_array_equal(port.encode(survivors), bdec.encode(survivors))
    # and a whole codec: the reference cauchy w=8 (bitmatrix technique)
    ref = RefMatrixCodec(ref_gf.cauchy_good_matrix(4, 2), "bitmatrix", 16)
    port = convert.ec_codec_from_reference(
        {"matrix": ref.matrix, "technique": ref.technique, "packetsize": ref.packetsize}, "cpu")
    data = rng.integers(0, 256, (4, 8 * 16 * 2), dtype=np.uint8)
    np.testing.assert_array_equal(port.encode(data), ref.encode(data))


def test_encode_async_and_decode_async_stay_on_the_device():
    codec = MatrixCodec(ref_gf.vandermonde_matrix(4, 2), device="cpu")
    data = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (4, 64), dtype=np.uint8))
    coding = codec.encode_async(data)
    assert isinstance(coding, torch.Tensor) and coding.shape == (2, 64)
    out = codec.decode_async({1: data[1], 2: data[2], 4: coding[0], 5: coding[1]}, {0, 3, 4})
    assert all(isinstance(t, torch.Tensor) for t in out.values())
    assert torch.equal(out[0], data[0]) and torch.equal(out[3], data[3])
    assert torch.equal(out[4], coding[0])


def test_device_reaches_every_inner_codec():
    lrc = create(PROFILES["lrc_4_2_3"], device="cpu")
    assert all(layer.ec.device == torch.device("cpu") for layer in lrc.layers)
    assert all(layer.ec.codec.device == torch.device("cpu") for layer in lrc.layers)
    clay = create(PROFILES["clay_4_2"], device="cpu")
    assert clay.base.device == torch.device("cpu")
    assert clay.base.encoder.tables.device == torch.device("cpu")
    isa = create({"plugin": "isa", "k": "4", "m": "2"}, device="cpu")
    assert isa.codec.device == torch.device("cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        create(PROFILES["jerasure_rs_4_2"])
    with pytest.raises(RuntimeError):
        TableEncoder(ref_gf.vandermonde_matrix(4, 2))
    with pytest.raises(RuntimeError):
        BitmatrixCodec(ref_gfw.liberation_bitmatrix(4, 7), 7, 8)
