"""Edge batches for K9 (the stripe buffer's write loop) and the write
path's codec gate.

``chip_smoke.py``'s ``online_kernel`` phase and the CPU tests hold K9
and its plain versions on these, bit for bit.  Every batch is made from
a seed with numpy (host arrays in the batch lanes' dtypes: keys and
chunks int32, fulls bool, seeds int32 holding u32 bits, valid bool):

- ``one_set_chain``: every write to one set, three times its ways in
  distinct keys, twice over (an eviction chain);
- ``all_full``: full-stripe writes only;
- ``cold_misses``: distinct keys on a cold buffer (every write a miss;
  half the slots, at most 256 writes);
- ``invalid_between``: invalid lanes between valid ones;
- ``evict_then_hit``: a key installed, evicted by its set's other keys,
  re-installed, then hit;
- ``b1`` and ``b512``: batches of one and 512 writes;
- ``cancelling_pair``: two small writes with the same key, chunk and
  seed to a slot resident in the warm buffer: its data comes back as it
  was, so its Δdata is zero and the slot is not a touched one.

:func:`gate_families` and :func:`bitequal_gate` are the port's copy of
``bench/config10_online_ec.py``'s ``writepath_bitequal`` gate: per codec
family a seeded sequence of delta updates through the footprint
programs must equal a dense re-encode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ec.online import set_index

EDGES = ("one_set_chain", "all_full", "cold_misses", "invalid_between", "evict_then_hit",
         "b1", "b512", "cancelling_pair")


def _keys_in_set(s: int, n: int, n_sets: int, start: int = 0) -> list[int]:
    """The first ``n`` keys from ``start`` whose set is ``s``."""
    cand = np.arange(start, start + 64 * n * n_sets, dtype=np.int64)
    sets = set_index(torch.from_numpy(cand), n_sets).numpy()
    return [int(k) for k in cand[sets == s][:n]]


def _batch(rng, keys, k: int, *, fulls=None, valid=None, full_share: float = 0.25) -> dict:
    keys = np.asarray(keys, np.int32)
    n = len(keys)
    return {
        "keys": keys,
        "chunks": rng.integers(0, k, n).astype(np.int32),
        "fulls": (rng.random(n) < full_share) if fulls is None else np.asarray(fulls, bool),
        "seeds": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32).view(np.int32),
        "valid": np.ones(n, bool) if valid is None else np.asarray(valid, bool),
    }


def random_batch(n_sets: int, ways: int, k: int, B: int, seed: int) -> dict:
    """``B`` writes over a key space of four times the buffer's slots
    (hits and misses both), a quarter of them full-stripe, nine in ten
    valid."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 4 * n_sets * ways, B)
    return _batch(rng, keys, k, valid=rng.random(B) < 0.9)


def resident_key(keys: torch.Tensor) -> int:
    """A key resident in a warm buffer (its ``keys`` lane): the first."""
    return int(keys[keys >= 0].reshape(-1)[0])


def edge_batches(n_sets: int, ways: int, k: int, seed: int = 0, *,
                 resident: int) -> list[tuple[str, dict, bool]]:
    """``(name, batch, cold)`` for every edge: ``cold`` asks for a cold
    buffer, else the caller applies the batch to a warm one, in which
    ``resident`` is a resident key (:func:`resident_key`)."""
    rng = np.random.default_rng(seed)
    chain = _keys_in_set(0, 3 * ways, n_sets)
    evictors = _keys_in_set(1, ways + 1, n_sets)
    target, others = evictors[0], evictors[1:]
    n_cold = min(max(2, n_sets * ways // 2), 256)
    cold_keys = rng.permutation(16 * n_sets * ways)[:n_cold] + 100000
    n = 64
    inval = random_batch(n_sets, ways, k, n, seed + 1)
    inval["valid"] = np.arange(n) % 3 != 1
    return [
        ("one_set_chain", _batch(rng, chain + chain, k), False),
        ("all_full", _batch(rng, rng.integers(0, 4 * n_sets * ways, n), k,
                            fulls=np.ones(n, bool)), False),
        ("cold_misses", _batch(rng, cold_keys, k, full_share=0.0), True),
        ("invalid_between", inval, False),
        ("evict_then_hit", _batch(rng, [target] + others + [target, target], k,
                                  full_share=0.0), False),
        ("b1", _batch(rng, [int(rng.integers(0, 4 * n_sets * ways))], k), False),
        ("b512", random_batch(n_sets, ways, k, 512, seed + 2), False),
        ("cancelling_pair", _batch(rng, [resident, resident], k, fulls=np.zeros(2, bool))
         | {"chunks": np.full(2, rng.integers(0, k), np.int32),
            "seeds": np.full(2, rng.integers(-(1 << 31), 1 << 31), np.int32)}, False),
    ]


def to_device(batch: dict, device) -> tuple[torch.Tensor, ...]:
    """A batch's lanes as tensors on ``device``, in
    :func:`~ceph_tpu_torch.ec.online.stripe_absorb`'s argument order."""
    return tuple(torch.from_numpy(np.ascontiguousarray(batch[f])).to(device)
                 for f in ("keys", "chunks", "fulls", "seeds", "valid"))


def gate_families():
    """(name, bitmatrix, w) of every codec family the write path's
    bit-equality gate holds on: the minimal-density RAID-6 codes plus the
    cauchy-good and RS-w8 GF(2^8) expansions (k=4, m=2)."""
    from ..ec import gf, gfw

    return (
        ("liberation", gfw.liberation_bitmatrix(4, 7), 7),
        ("blaum_roth", gfw.blaum_roth_bitmatrix(4, 6), 6),
        ("liber8tion", gfw.liber8tion_bitmatrix(4), 8),
        ("cauchy", gf.matrix_to_bitmatrix(gf.cauchy_good_matrix(4, 2)), 8),
        ("rs_w8", gf.matrix_to_bitmatrix(gf.vandermonde_matrix(4, 2)), 8),
    )


def bitequal_gate(n_updates: int, seed: int, device) -> dict:
    """The ``writepath_bitequal`` verdict a family: a seeded sequence of
    random-footprint delta updates through the cached footprint programs
    (K6 on ``device``) must leave parity equal to the dense re-encode of
    the final data (K5)."""
    from ..ec.online import ParityDeltaEngine

    rng = np.random.default_rng(seed)
    verdicts = {}
    for name, bits, w in gate_families():
        eng = ParityDeltaEngine(bits, w=w, packetsize=8, device=device)
        size = 2 * w * eng.packetsize
        data = rng.integers(0, 256, (eng.k, size), dtype=np.uint8)
        parity = eng.encode(data)
        ok = bool(np.array_equal(parity, eng.dense_parity(data)))
        for _ in range(n_updates):
            nf = int(rng.integers(1, eng.k + 1))
            fp = tuple(sorted(rng.choice(eng.k, nf, replace=False).tolist()))
            new = rng.integers(0, 256, (len(fp), size), dtype=np.uint8)
            parity = eng.apply_delta(parity, fp, data[list(fp)], new)
            data[list(fp)] = new
        verdicts[name] = ok and bool(np.array_equal(parity, eng.dense_parity(data)))
    return verdicts
