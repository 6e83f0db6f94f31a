"""Pattern-grouped repair planning: one decode matrix per erasure pattern.

The reference decodes per object: every degraded object walks
``ECBackend::handle_recovery_read_complete`` and re-derives its decode
matrix from its own missing-shard set.  At cluster scale a failure
domain (host, rack) produces *thousands* of degraded PGs but only a
*handful* of distinct erasure patterns — every PG whose acting set lost
the same shard slots needs the exact same reconstruction matrix.

The planner exploits that: it groups degraded PGs by the survivor
bitmask from the peering pass (:mod:`ceph_tpu_torch.recovery.peering`), and
for each unique mask inverts ONE k x k generator submatrix on the host
(exact GF(2^8) Gauss-Jordan, :func:`ceph_tpu_torch.ec.gf.invert_matrix`) and
precomposes the repair matrix

    R = G[missing] @ inv(G[rows])        # [n_missing, k] over GF(2^8)

so the executor can rebuild every missing shard of every PG in the
group with ONE batched device multiply (survivor chunks concatenated
along the byte axis).  Because GF(2^8) matrix algebra is exact and
associative, ``R @ survivors`` is byte-identical to the reference's
two-step path (``inv @ survivors`` then re-encode).

Group ordering mirrors the reference's recovery priorities: patterns
with the most missing shards (closest to data loss) are planned first.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ec import gf
from .peering import PG_STATE_DEGRADED, PeeringResult


def mask_to_shards(mask: int, size: int) -> tuple[int, ...]:
    """Survivor bitmask -> sorted shard ids."""
    return tuple(s for s in range(size) if (mask >> s) & 1)


def _planning_codec(codec):
    """Accept a :class:`~ceph_tpu_torch.ec.backend.MatrixCodec` /
    :class:`~ceph_tpu_torch.ec.backend.BitmatrixCodec` or any plugin wrapper
    (``ceph_tpu_torch.ec.registry.create`` output) carrying one as
    ``.codec``.  Returns ``(codec, bit_level)`` — bit-level codecs
    (``generator_bits()``) pattern-group at the bit-row level.

    Locality-aware plugins (LRC / SHEC / CLAY) expose no single
    generator; their sub-chunk/local-group planning is the CLAY
    repair-locality follow-on (ROADMAP).
    """
    for c in (codec, getattr(codec, "codec", None)):
        if c is None:
            continue
        if hasattr(c, "generator_bits"):
            return c, True
        if hasattr(c, "generator"):
            return c, False
    technique = getattr(codec, "technique", None) or getattr(
        getattr(codec, "codec", None), "technique", None
    )
    raise TypeError(
        f"{type(codec).__name__}"
        f"{f' (technique={technique!r})' if technique else ''} exposes "
        "neither a GF(2^8) generator() nor a GF(2) generator_bits(); "
        "pattern-grouped repair supports matrix codecs (reed_sol_*, "
        "cauchy_*) and bitmatrix-native codecs (liberation, blaum_roth, "
        "liber8tion, w>8 expansions).  Locality-aware plugins (LRC, "
        "SHEC, CLAY) need the sub-chunk planner (ROADMAP: CLAY "
        "repair-locality)."
    )


@dataclass
class PatternGroup:
    """All degraded PGs sharing one erasure pattern.

    ``rows`` are the k source shard slots the decode reads (first k
    survivors in slot order — the same choice
    :class:`~ceph_tpu_torch.ec.backend._SystematicCodec` makes, so batch and
    serial decode agree bit-for-bit); ``missing`` is every dead slot,
    data and coding alike (recovery restores full redundancy).
    ``repair_matrix`` maps the k source chunks straight to the missing
    chunks: one device launch per group.

    Bit-level groups (bitmatrix-native codecs, and cauchy-technique
    matrix codecs whose chunks are packet-interleaved rather than
    byte-element) carry ``repair_bitmatrix`` instead — a
    ``[len(missing)*w, k*w]`` GF(2) matrix the executor lowers to a
    CSE-shrunk XOR schedule (:mod:`ceph_tpu_torch.ec.schedule`).
    ``repair_matrix`` is ``None`` for those groups so nothing byte-wise
    (TableEncoder, the sharded LUT path) can touch them by mistake.
    """

    mask: int
    survivors: tuple[int, ...]
    rows: tuple[int, ...]
    missing: tuple[int, ...]
    pgs: np.ndarray  # PG seeds in this pattern group
    repair_matrix: np.ndarray | None  # [len(missing), k] u8 over GF(2^8)
    repair_bitmatrix: np.ndarray | None = None  # [n_miss*w, k*w] GF(2)
    w: int = 8  # bit rows per chunk (bit-level groups)
    packetsize: int = 0  # packet bytes (bit-level groups)

    @property
    def n_pgs(self) -> int:
        return len(self.pgs)


@dataclass
class RecoveryPlan:
    """Host-side repair schedule for one pool's degraded PGs."""

    k: int
    m: int
    groups: list[PatternGroup] = field(default_factory=list)
    # degraded PGs with fewer than k surviving shards: data loss, the
    # reference would mark these ``incomplete`` and wait for an OSD to
    # return.  Never silently dropped — callers must surface them.
    unrecoverable: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64)
    )

    @property
    def n_patterns(self) -> int:
        return len(self.groups)

    @property
    def n_pgs(self) -> int:
        return sum(g.n_pgs for g in self.groups)

    @property
    def n_shards(self) -> int:
        """Total shard rebuilds the plan performs."""
        return sum(len(g.missing) * g.n_pgs for g in self.groups)

    def bytes_to_read(self, chunk_size: int) -> int:
        return sum(self.k * g.n_pgs * chunk_size for g in self.groups)

    def bytes_to_write(self, chunk_size: int) -> int:
        return sum(len(g.missing) * g.n_pgs * chunk_size for g in self.groups)

    def summary(self) -> dict:
        return {
            "patterns": self.n_patterns,
            "degraded_pgs": self.n_pgs,
            "shard_rebuilds": self.n_shards,
            "unrecoverable_pgs": int(len(self.unrecoverable)),
            "launches_required": self.n_patterns,
        }


def build_plan(
    peering: PeeringResult,
    codec,
    pgs: np.ndarray | None = None,
    inconsistent: np.ndarray | None = None,
) -> RecoveryPlan:
    """Group the peering pass's degraded PGs into pattern groups.

    ``codec`` is any systematic codec exposing ``k``, ``m`` and either
    ``generator()`` (:class:`ceph_tpu_torch.ec.backend.MatrixCodec`) or
    ``generator_bits()`` (:class:`ceph_tpu_torch.ec.backend.BitmatrixCodec`
    — liberation / blaum_roth / liber8tion / w>8 expansions, which
    pattern-group at the bit-row level); the pool's ``size`` must equal
    k+m (EC pools are positional: acting slot == shard id).  ``pgs``
    restricts planning to a PG subset — the mid-flight re-plan path,
    where only the epoch delta's invalidated PGs need fresh groups.

    ``inconsistent`` is a scrub pass's per-PG damage bitmask
    (:class:`ceph_tpu_torch.recovery.scrub.ScrubResult`): inconsistent PGs
    join the degraded set, and a damaged shard is struck from its PG's
    survivor mask — it can never be a decode source, and it lands in
    the group's ``missing`` set so the same batched launch that heals
    erasure also heals corruption.  A PG left with fewer than k CLEAN
    shards is unrecoverable (the caller reports it
    ``inconsistent-unrecoverable`` — bad bytes are never committed).
    """
    codec, bit_level = _planning_codec(codec)
    k, m = codec.k, codec.m
    if k + m != peering.size:
        raise ValueError(
            f"codec k+m={k + m} != pool size {peering.size}"
        )
    if bit_level:
        gen_bits = codec.generator_bits()  # [(k+m)*w, k*w] GF(2)
        w = codec.w
        packetsize = codec.packetsize
    else:
        gen = codec.generator()  # [(k+m), k] identity top block
        # cauchy-technique chunks are packet-interleaved GF(2) regions,
        # not byte-element streams: their repair must stay bit-level
        # (a byte-wise LUT product over them would be garbage)
        bit_technique = getattr(codec, "technique", "table") == "bitmatrix"
    degraded = peering.pgs_with(PG_STATE_DEGRADED)
    inc = None
    if inconsistent is not None:
        inc = np.asarray(inconsistent, dtype=np.uint32)
        if inc.shape != peering.survivor_mask.shape:
            raise ValueError(
                f"inconsistent mask shape {inc.shape} != "
                f"per-PG {peering.survivor_mask.shape}"
            )
        degraded = np.union1d(
            degraded, np.flatnonzero(inc).astype(np.int64)
        )
    if pgs is not None:
        degraded = np.intersect1d(
            degraded, np.asarray(pgs, dtype=np.int64)
        )
    masks = peering.survivor_mask[degraded]
    if inc is not None:
        # a corrupt shard is not a survivor: strike it so it can only
        # ever appear on the decode's OUTPUT side
        masks = masks & ~inc[degraded]
    plan = RecoveryPlan(k=k, m=m)
    unrecoverable: list[np.ndarray] = []
    for mask in np.unique(masks):
        pgs = degraded[masks == mask]
        survivors = mask_to_shards(int(mask), peering.size)
        if len(survivors) < k:
            unrecoverable.append(pgs)
            continue
        rows = survivors[:k]
        missing = tuple(
            s for s in range(peering.size) if s not in survivors
        )
        if bit_level:
            # bit-row block selection: survivor s contributes rows
            # [s*w, (s+1)*w) of the bit generator; one (k*w)^2 GF(2)
            # inversion per pattern, exactly BitmatrixCodec's decode
            # algebra so batch and serial decode agree bit-for-bit
            sub = np.vstack([gen_bits[r * w:(r + 1) * w] for r in rows])
            inv = gf.invert_bitmatrix(sub)
            need = np.vstack(
                [gen_bits[s * w:(s + 1) * w] for s in missing]
            )
            group = PatternGroup(
                mask=int(mask),
                survivors=survivors,
                rows=rows,
                missing=missing,
                pgs=pgs,
                repair_matrix=None,
                repair_bitmatrix=gf.bitmatrix_multiply(need, inv),
                w=w,
                packetsize=packetsize,
            )
        else:
            inv = gf.invert_matrix(gen[list(rows)])
            repair = gf.matrix_encode(gen[list(missing)], inv)
            group = PatternGroup(
                mask=int(mask),
                survivors=survivors,
                rows=rows,
                missing=missing,
                pgs=pgs,
                # expanding the GF(2^8) repair matrix commutes with
                # composing it (matrix_to_bitmatrix is a homomorphism),
                # so the bit-level product is byte-identical
                repair_matrix=None if bit_technique else repair,
                repair_bitmatrix=(
                    gf.matrix_to_bitmatrix(repair) if bit_technique else None
                ),
                w=8,
                packetsize=getattr(codec, "packetsize", 0)
                if bit_technique
                else 0,
            )
        plan.groups.append(group)
    # most shards lost first (the reference recovers the PGs nearest
    # data loss ahead of singly-degraded ones)
    plan.groups.sort(key=lambda g: (-len(g.missing), g.mask))
    if unrecoverable:
        plan.unrecoverable = np.concatenate(unrecoverable)
    return plan


def invalidated_groups(
    groups: list[PatternGroup], survivor_mask: np.ndarray
) -> tuple[list[PatternGroup], np.ndarray]:
    """Split pending groups against a fresh peering pass's masks.

    A group stays valid only while every member PG still has EXACTLY
    the erasure pattern it was planned for: a lost bit means a planned
    source row may be dead (the decode would read garbage), a gained
    bit means a flapped-back survivor made part of the decode
    pointless, and either way the precomposed repair matrix no longer
    matches.  Returns ``(valid_groups, invalid_pgs)`` — the invalid PGs
    re-enter planning (``build_plan(..., pgs=...)``), the valid groups'
    matrices (and their cached device encoders, keyed by mask) are
    reused untouched.
    """
    valid: list[PatternGroup] = []
    invalid: list[np.ndarray] = []
    for g in groups:
        if bool(np.all(survivor_mask[g.pgs] == np.uint32(g.mask))):
            valid.append(g)
        else:
            invalid.append(np.asarray(g.pgs, dtype=np.int64))
    return valid, (
        np.concatenate(invalid) if invalid else np.empty(0, np.int64)
    )
