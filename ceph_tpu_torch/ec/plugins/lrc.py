"""Locally-repairable codes (LRC plugin parity).

Semantics follow the reference's ``src/erasure-code/lrc/ErasureCodeLrc.{h,cc}``:
a *mapping* string assigns global chunk positions ('D' = data, anything
else = coding) and *layers* are inner codes, each applied to the subset
of positions its descriptor selects ('D' = layer data, 'c' = layer
coding, '_' = not in this layer).  A single lost chunk is repaired from
its smallest covering layer (the locality win); larger failures fall
back to wider layers.

Both the generic ``mapping``/``layers`` profile and the simplified
``k``/``m``/``l`` generator are supported.  With k/m/l, the layout is
the reference's: one global layer (k data + m RS parities) followed by
one XOR local parity per group of ``l`` consecutive data+global
positions — total chunks k + m + (k+m)/l.

Inner codes are built through the plugin registry, on the LRC codec's
own device, so layer profiles may name any registered plugin (default
jerasure reed_sol_van).
"""

from __future__ import annotations

import json

import numpy as np

from ..interface import ErasureCode, ErasureCodeError, Profile


class _Layer:
    def __init__(self, descriptor: str, profile: dict[str, str], device):
        self.descriptor = descriptor
        # global positions participating in this layer, in order
        self.positions = [i for i, c in enumerate(descriptor) if c != "_"]
        self.data_pos = [i for i in self.positions if descriptor[i] == "D"]
        self.coding_pos = [i for i in self.positions if descriptor[i] != "D"]
        prof = dict(profile)
        prof.setdefault("plugin", "jerasure")
        prof["k"] = str(len(self.data_pos))
        prof["m"] = str(len(self.coding_pos))
        from ..registry import create

        self.ec = create(prof, device)

    def encode(self, chunks: dict[int, np.ndarray]) -> None:
        """Fill this layer's coding positions from its data positions.

        Layer-local ids: data first (order of 'D' positions), then
        coding — remapped to the inner code's 0..k-1 / k..k+m-1.
        """
        k = len(self.data_pos)
        inner = {j: chunks[p] for j, p in enumerate(self.data_pos)}
        for j, p in enumerate(self.coding_pos):
            inner[k + j] = chunks[p]
        self.ec.encode_chunks(inner)
        for j, p in enumerate(self.coding_pos):
            chunks[p][:] = inner[k + j]

    def repair(
        self, chunks: dict[int, np.ndarray], erased: set[int], size: int
    ) -> None:
        k = len(self.data_pos)
        ids = self.data_pos + self.coding_pos
        avail = {
            j: chunks[p] for j, p in enumerate(ids) if p not in erased
        }
        want = {j for j, p in enumerate(ids) if p in erased}
        decoded = self.ec.decode_chunks(want, avail)
        for j, p in enumerate(ids):
            if p in erased:
                chunks[p] = decoded[j]
                erased.discard(p)


class ErasureCodeLrc(ErasureCode):
    def init(self, profile: Profile) -> None:
        self.profile = profile
        if "mapping" in profile:
            mapping = profile["mapping"]
            layers_spec = json.loads(profile["layers"])
        else:
            mapping, layers_spec = self._generate(
                profile.get_int("k", 4),
                profile.get_int("m", 2),
                profile.get_int("l", 3),
            )
        self.mapping = mapping
        self.layers = [
            _Layer(desc, prof if isinstance(prof, dict) else {}, self.device)
            for desc, prof in layers_spec
        ]
        n = len(mapping)
        self.k = sum(1 for c in mapping if c == "D")
        self.m = n - self.k
        # base-class chunk_mapping from the 'D'/'_' string: raw chunk i
        # (0..k-1 data, k.. coding) -> global shard position; serves
        # get_chunk_mapping and _chunk_index
        dp = self._data_positions()
        self.chunk_mapping = dp + [p for p in range(n) if p not in dp]
        for layer in self.layers:
            if len(layer.descriptor) != n:
                raise ErasureCodeError(
                    f"layer {layer.descriptor!r} length != mapping {mapping!r}"
                )

    @staticmethod
    def _generate(k: int, m: int, l: int):
        """k/m/l layout: k data, m global RS, (k+m)/l local XOR parities.

        Matches the reference's generated layout (parities at the START
        of each group): each group of l+1 positions is [local parity,
        global parities..., data...], e.g. k=4 m=2 l=3 -> mapping
        ``__DD__DD``, layers ``_cDD_cDD`` / ``cDDD____`` / ``____cDDD``
        (upstream ``src/erasure-code/lrc/ErasureCodeLrc.cc`` parse_kml,
        doc/rados/operations/erasure-code-lrc.rst example).
        """
        if (k + m) % l:
            raise ErasureCodeError(f"k+m={k + m} must be divisible by l={l}")
        groups = (k + m) // l
        # distribute the m global parities over groups, earliest first
        per = [m // groups + (1 if g < m % groups else 0) for g in range(groups)]
        n = k + m + groups
        mapping = ""
        global_desc = ""
        local_descs = []
        for g in range(groups):
            ncod = per[g]
            mapping += "_" + "_" * ncod + "D" * (l - ncod)
            global_desc += "_" + "c" * ncod + "D" * (l - ncod)
            local = ["_"] * n
            base = g * (l + 1)
            local[base] = "c"
            for i in range(1, l + 1):
                local[base + i] = "D"
            local_descs.append("".join(local))
        layers = [[global_desc, {"plugin": "jerasure", "technique": "reed_sol_van"}]]
        for d in local_descs:
            layers.append([d, {"plugin": "jerasure", "technique": "reed_sol_van"}])
        return mapping, layers

    def get_chunk_count(self) -> int:
        return len(self.mapping)

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        # chunks are shared across layers, so per-chunk alignment of
        # w * sizeof(int) = 32 covers every inner matrix code
        return self.k * 32

    def _data_positions(self) -> list[int]:
        return [i for i, c in enumerate(self.mapping) if c == "D"]

    def create_rule(self, name: str, crush_map):
        """LRC's own rule construction (upstream ErasureCodeLrc::create_rule):
        the profile's ``crush-steps`` JSON — a list of
        ``[op, type, num]`` with op choose|chooseleaf — replaces the
        base's single chooseleaf step, so chunks land grouped by
        locality (e.g. pick 3 racks, then 4 hosts in each)."""
        from ...crush.map import (
            OP_CHOOSE_INDEP,
            OP_CHOOSELEAF_INDEP,
            OP_EMIT,
            OP_SET_CHOOSELEAF_TRIES,
            OP_TAKE,
            Step,
        )

        profile = getattr(self, "profile", None) or Profile()
        root, fd, dc = self._rule_profile()
        try:
            steps_spec = json.loads(
                profile.get("crush-steps", '[["chooseleaf", "%s", 0]]' % fd)
            )
            if not isinstance(steps_spec, list):
                raise ErasureCodeError(
                    f"crush-steps must be a JSON list, got {steps_spec!r}"
                )
            root_id = crush_map._resolve_take(root, dc)
            steps = [Step(OP_SET_CHOOSELEAF_TRIES, 5), Step(OP_TAKE, root_id)]
            for spec in steps_spec:
                if (
                    not isinstance(spec, (list, tuple))
                    or len(spec) != 3
                    or spec[0] not in ("choose", "chooseleaf")
                ):
                    raise ErasureCodeError(
                        f"crush-steps entry {spec!r} must be "
                        "[choose|chooseleaf, type, num]"
                    )
                op, type_name, num = spec
                opcode = (
                    OP_CHOOSELEAF_INDEP if op == "chooseleaf"
                    else OP_CHOOSE_INDEP
                )
                steps.append(
                    Step(opcode, int(num), crush_map.type_id(type_name))
                )
            steps.append(Step(OP_EMIT))
            return crush_map.add_rule(name, steps, kind="erasure")
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            raise ErasureCodeError(f"create_rule {name!r}: {e}") from e


    def encode_prepare(self, data: np.ndarray) -> dict[int, np.ndarray]:
        blocksize = self.get_chunk_size(len(data))
        chunks: dict[int, np.ndarray] = {
            p: np.zeros(blocksize, np.uint8)
            for p in range(len(self.mapping))
        }
        dp = self._data_positions()
        for i in range(self.k):
            lo = i * blocksize
            hi = min(len(data), (i + 1) * blocksize)
            if hi > lo:
                chunks[dp[i]][: hi - lo] = data[lo:hi]
        return chunks

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        for layer in self.layers:
            layer.encode(chunks)

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> set[int]:
        """Walk the layer structure the way decode_chunks will, smallest
        layers first (locality: a single lost chunk reads only its local
        group), accumulating the read set each repair needs — and raise
        when no repair chain reaches the wanted chunks.  Mirroring the
        decode iteration exactly keeps the claim and the decode in
        lockstep (LRC is not MDS: "any k available" is NOT sufficient,
        upstream ``ErasureCodeLrc::_minimum_to_decode`` walks layers and
        returns EIO likewise; a 157-trial fuzz found the old any-k
        fallback claiming patterns decode_chunks then failed)."""
        if not (want_to_read - available):
            return set(want_to_read)
        # feas_have: what decode_chunks (given every available chunk)
        # would hold after each repair — drives feasibility, keeping
        # the claim in lockstep with the decode.  present: what a
        # replay holding ONLY the returned read set would hold — each
        # repair selects its inputs from chunks already present (prior
        # reads/repairs) before adding fresh available reads, so the
        # returned set is always a subset of ``available`` AND
        # sufficient on its own (the contract decode_object in
        # ec/stripe.py enforces).
        feas_have = set(available)
        present: set[int] = set()
        read: set[int] = set()
        progress = True
        while (want_to_read - feas_have) and progress:
            progress = False
            for layer in sorted(self.layers, key=lambda s: len(s.positions)):
                lost_here = [p for p in layer.positions if p not in feas_have]
                have_here = [p for p in layer.positions if p in feas_have]
                needed = len(layer.data_pos)
                if lost_here and len(have_here) >= needed:
                    # inputs already present (prior reads OR prior
                    # repairs) are free: only chunks appended by the
                    # fresh-available loop below cost a read.  A
                    # present-sourced chunk can be in ``available``
                    # without ever having been read (a prior layer
                    # repair regenerates ALL its positions), so
                    # filtering sel by ``available`` would claim
                    # redundant reads (round-4 ADVICE).
                    sel = [p for p in have_here if p in present][:needed]
                    for p in have_here:
                        if len(sel) >= needed:
                            break
                        if p not in sel and p in available:
                            sel.append(p)
                            read.add(p)
                    present |= set(sel) | set(layer.positions)
                    feas_have |= set(layer.positions)
                    progress = True
                    break
        if want_to_read - feas_have:
            raise ErasureCodeError(
                f"cannot decode chunks {sorted(want_to_read - feas_have)}"
            )
        return read | (want_to_read & available)

    def decode_chunks(
        self, want_to_read: set[int], chunks: dict[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        size = len(next(iter(chunks.values())))
        work = dict(chunks)
        erased = set(range(len(self.mapping))) - set(work)
        progress = True
        while erased & self._needed(want_to_read, erased) and progress:
            progress = False
            for layer in sorted(self.layers, key=lambda s: len(s.positions)):
                lost_here = [p for p in layer.positions if p in erased]
                have = [p for p in layer.positions if p in work]
                if lost_here and len(have) >= len(layer.data_pos):
                    layer.repair(work, erased, size)
                    progress = True
                    break
        still = [p for p in want_to_read if p not in work]
        if still:
            raise ErasureCodeError(f"cannot repair chunks {still}")
        return {p: work[p] for p in want_to_read}

    def _needed(self, want: set[int], erased: set[int]) -> set[int]:
        return want & erased

    def decode_concat(self, chunks: dict[int, np.ndarray]) -> bytes:
        dp = self._data_positions()
        chunk_size = len(next(iter(chunks.values())))
        decoded = self.decode(set(dp), chunks, chunk_size)
        return b"".join(decoded[p].tobytes() for p in dp)
