"""Striped-object layer over the EC plugins (ECUtil parity).

The reference's ``src/osd/ECUtil.h :: stripe_info_t`` carries the
stripe geometry ECBackend uses to address objects on shards:
``stripe_width = k * chunk_size``, logical<->chunk offset conversion,
and stripe-aligned rounding.  :class:`StripeInfo` mirrors that API;
:func:`encode_object` / :func:`decode_object` implement the multi-
stripe object path on top of it (the part of
``src/osd/ECBackend.cc :: submit_transaction / objects_read_async``
that turns whole objects into per-shard streams and back, including
chunk->shard mapping application and re-selection of the read set when
a shard fails mid-recovery — the
``qa/standalone/erasure-code/test-erasure-eio.sh`` scenario).

Device-first design: the reference iterates stripes, calling
``encode_chunks`` per stripe.  Every device codec here is byte/packet
local along the chunk axis and ``chunk_size`` is alignment-divisible,
so a shard's stream (its chunks concatenated across all stripes) can
be encoded or decoded in ONE ``encode_chunks``/``decode_chunks`` call
over the whole object — stripes become batch width, not a loop.
"""

from __future__ import annotations

import numpy as np

from .interface import ErasureCode, ErasureCodeError


class StripeInfo:
    """``ECUtil::stripe_info_t`` analog: stripe geometry + conversions."""

    def __init__(self, k: int, chunk_size: int):
        if chunk_size <= 0 or k <= 0:
            raise ValueError("k and chunk_size must be positive")
        self.k = k
        self.chunk_size = chunk_size
        self.stripe_width = k * chunk_size

    # ---- reference stripe_info_t API ----

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.stripe_width

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.chunk_size

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0, offset
        return offset // self.k

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0, offset
        return offset * self.k

    def offset_len_to_stripe_bounds(
        self, offset: int, length: int
    ) -> tuple[int, int]:
        """Smallest stripe-aligned (offset, length) covering the range."""
        start = self.logical_to_prev_stripe_offset(offset)
        end = self.logical_to_next_stripe_offset(offset + length)
        return start, end - start

    def object_stripes(self, object_size: int) -> int:
        return -(-object_size // self.stripe_width) if object_size else 0


def stripe_info_for(ec: ErasureCode, stripe_unit_width: int) -> StripeInfo:
    """Geometry for a pool whose stripe width is ``stripe_unit_width``
    logical bytes (the reference derives chunk_size through the
    plugin's alignment the same way)."""
    return StripeInfo(
        ec.get_data_chunk_count(), ec.get_chunk_size(stripe_unit_width)
    )


def _shard_map(ec: ErasureCode) -> list[int]:
    """raw chunk index -> shard id (identity when the plugin declares
    no mapping)."""
    mapping = ec.get_chunk_mapping()
    return mapping if mapping else list(range(ec.get_chunk_count()))


def encode_object(
    ec: ErasureCode, data: bytes | np.ndarray, stripe_width: int
) -> tuple[StripeInfo, dict[int, np.ndarray]]:
    """Encode a whole (multi-stripe) object into per-shard streams.

    Logical byte ``o`` lives in stripe ``o // stripe_width``, raw chunk
    ``(o % stripe_width) // chunk_size`` — the ECBackend layout.  The
    object is zero-padded to a whole number of stripes; shard ``s``'s
    stream is its chunk from every stripe, concatenated.  One device
    encode call covers all stripes.

    Returns (stripe info, {shard id: stream}).
    """
    if isinstance(data, (bytes, bytearray)):
        data = np.frombuffer(bytes(data), np.uint8)
    sinfo = stripe_info_for(ec, stripe_width)
    k, m = ec.get_data_chunk_count(), ec.get_coding_chunk_count()
    shard = _shard_map(ec)
    n_stripes = max(sinfo.object_stripes(len(data)), 1)
    padded = np.zeros(n_stripes * sinfo.stripe_width, np.uint8)
    padded[: len(data)] = data
    # [n_stripes, k, chunk] -> raw chunk j's stream = [:, j, :] flattened
    view = padded.reshape(n_stripes, k, sinfo.chunk_size)
    chunks: dict[int, np.ndarray] = {}
    for j in range(k):
        chunks[shard[j]] = np.ascontiguousarray(view[:, j, :]).reshape(-1)
    stream_len = n_stripes * sinfo.chunk_size
    for j in range(k, k + m):
        chunks[shard[j]] = np.zeros(stream_len, np.uint8)
    ec.encode_chunks(chunks)
    return sinfo, chunks


def decode_object(
    ec: ErasureCode,
    sinfo: StripeInfo,
    shards: dict[int, np.ndarray],
    object_size: int,
    failed: set[int] | None = None,
) -> bytes:
    """Reassemble an object from (a subset of) its shard streams.

    ``failed`` marks shards whose reads errored after being selected
    (the EIO scenario): they are excluded and the minimum read set is
    re-selected from what remains, exactly like ECBackend re-issuing
    recovery reads.  Raises ErasureCodeError when fewer than k shards
    remain.
    """
    failed = set(failed or ())
    avail = {s: v for s, v in shards.items() if s not in failed}
    k = ec.get_data_chunk_count()
    shard = _shard_map(ec)
    want = {shard[j] for j in range(k)}
    need = ec.minimum_to_decode(want, set(avail))
    if not need <= set(avail):
        raise ErasureCodeError(f"minimum set {need} not available")
    n_stripes = max(sinfo.object_stripes(object_size), 1)
    stream_len = n_stripes * sinfo.chunk_size
    for s in need:
        if len(avail[s]) != stream_len:
            raise ErasureCodeError(
                f"shard {s}: stream length {len(avail[s])} != {stream_len}"
            )
    decoded = ec.decode(want, {s: avail[s] for s in need}, stream_len)
    out = np.empty((n_stripes, k, sinfo.chunk_size), np.uint8)
    for j in range(k):
        out[:, j, :] = decoded[shard[j]].reshape(
            n_stripes, sinfo.chunk_size
        )
    return out.reshape(-1)[:object_size].tobytes()
