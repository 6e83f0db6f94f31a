"""Erasure-code contract + shared chunking logic.

API parity with the reference's ``src/erasure-code/ErasureCodeInterface.h``
(``init``, ``get_chunk_count``, ``get_data_chunk_count``,
``get_chunk_size``, ``get_sub_chunk_count``, ``minimum_to_decode``,
``minimum_to_decode_with_cost``, ``encode``, ``encode_chunks``,
``decode``, ``decode_chunks``, ``get_chunk_mapping``, ``decode_concat``)
and the shared pad/align/split logic of
``src/erasure-code/ErasureCode.{h,cc}`` (``ErasureCode::encode`` ->
``encode_prepare`` -> ``encode_chunks``).  Plugins subclass
:class:`ErasureCode` and override ``encode_chunks``/``decode_chunks``
(+ ``minimum_to_decode`` for locality-aware codes).

Chunks are numpy uint8 arrays here (the bufferlist equivalent); device
plugins move them to their device (``self.device``, set by the
registry before ``init``) inside ``encode_chunks``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class ErasureCodeError(Exception):
    pass


@dataclass
class Profile:
    """String->string EC profile (reference plugin profiles)."""

    values: dict[str, str] = field(default_factory=dict)

    def get(self, key: str, default: str | None = None) -> str | None:
        return self.values.get(key, default)

    def get_int(self, key: str, default: int) -> int:
        v = self.values.get(key)
        return int(v) if v not in (None, "") else default

    def __getitem__(self, key: str) -> str:
        return self.values[key]

    def __contains__(self, key: str) -> bool:
        return key in self.values


class ErasureCodeInterface:
    """Abstract EC contract (reference ErasureCodeInterface.h)."""

    def init(self, profile: Profile) -> None:
        raise NotImplementedError

    def get_chunk_count(self) -> int:
        raise NotImplementedError

    def get_data_chunk_count(self) -> int:
        raise NotImplementedError

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        return 1

    def get_chunk_size(self, stripe_width: int) -> int:
        raise NotImplementedError

    def get_chunk_mapping(self) -> list[int]:
        return []

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> set[int]:
        raise NotImplementedError

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: dict[int, int]
    ) -> set[int]:
        raise NotImplementedError

    def encode(
        self, want_to_encode: set[int], data: bytes | np.ndarray
    ) -> dict[int, np.ndarray]:
        raise NotImplementedError

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        raise NotImplementedError

    def decode(
        self,
        want_to_read: set[int],
        chunks: dict[int, np.ndarray],
        chunk_size: int,
    ) -> dict[int, np.ndarray]:
        raise NotImplementedError

    def decode_chunks(
        self, want_to_read: set[int], chunks: dict[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        raise NotImplementedError

    def decode_concat(self, chunks: dict[int, np.ndarray]) -> bytes:
        raise NotImplementedError


class ErasureCode(ErasureCodeInterface):
    """Shared chunking/padding base (reference ErasureCode.cc)."""

    k: int = 0
    m: int = 0
    chunk_mapping: list[int] = []
    # where the codec's kernels run; the registry sets it before init()
    # (a codec built by hand defaults to the card and raises without one)
    device = "cuda"

    # ---- helpers plugins override ----

    def get_alignment(self) -> int:
        """Stripe alignment in bytes; chunk_size rounds the padded
        object up to a multiple of this before dividing by k."""
        return self.k * 8

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_chunk_size(self, stripe_width: int) -> int:
        alignment = self.get_alignment()
        tail = stripe_width % alignment
        padded = stripe_width + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    def get_chunk_mapping(self) -> list[int]:
        return list(self.chunk_mapping)

    def _chunk_index(self, i: int) -> int:
        """Shard id for raw chunk position i (reference to_mapping)."""
        return self.chunk_mapping[i] if self.chunk_mapping else i

    # ---- minimum_to_decode (reference default: any k available) ----

    def _minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> set[int]:
        if want_to_read <= available:
            return set(want_to_read)
        if len(available) < self.k:
            raise ErasureCodeError(
                f"need {self.k} chunks, only {len(available)} available"
            )
        minimum = set(want_to_read & available)
        for c in sorted(available):
            if len(minimum) == self.k:
                break
            minimum.add(c)
        return minimum

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> set[int]:
        return self._minimum_to_decode(want_to_read, available)

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: dict[int, int]
    ) -> set[int]:
        # default: cost-blind (reference base class does the same)
        return self.minimum_to_decode(want_to_read, set(available))

    # ---- create_rule (reference ErasureCode::create_rule) ----
    #
    # The bridge that makes an EC profile self-contained: the profile's
    # ``crush-root`` / ``crush-failure-domain`` / ``crush-device-class``
    # keys describe the CRUSH rule the pool needs, and the plugin builds
    # it on the map (upstream src/erasure-code/ErasureCode.cc ::
    # create_rule, defaults from ErasureCode::parse).

    DEFAULT_RULE_ROOT = "default"
    DEFAULT_RULE_FAILURE_DOMAIN = "host"

    def _rule_profile(self) -> tuple[str, str, str | None]:
        """(root, failure_domain, device_class|None) from the profile
        this plugin was init()ed with."""
        profile = getattr(self, "profile", None) or Profile()
        root = profile.get("crush-root", self.DEFAULT_RULE_ROOT)
        fd = profile.get(
            "crush-failure-domain", self.DEFAULT_RULE_FAILURE_DOMAIN
        )
        dc = profile.get("crush-device-class", "") or None
        return root, fd, dc

    def create_rule(self, name: str, crush_map):
        """Build this profile's erasure rule on ``crush_map`` and
        return it.  Raises ErasureCodeError on unknown root/type/class
        (upstream returns -ENOENT with an error stream)."""
        root, fd, dc = self._rule_profile()
        try:
            return crush_map.make_erasure_rule(name, root, fd, dc)
        except (KeyError, ValueError) as e:
            raise ErasureCodeError(
                f"create_rule {name!r}: {e}"
            ) from e

    # ---- encode: pad -> split -> encode_chunks ----

    def encode_prepare(self, data: np.ndarray) -> dict[int, np.ndarray]:
        """Zero-pad to k*chunk_size and split into k data chunks."""
        blocksize = self.get_chunk_size(len(data))
        chunks: dict[int, np.ndarray] = {}
        for i in range(self.k):
            chunk = np.zeros(blocksize, np.uint8)
            lo = i * blocksize
            hi = min(len(data), (i + 1) * blocksize)
            if hi > lo:
                chunk[: hi - lo] = data[lo:hi]
            chunks[self._chunk_index(i)] = chunk
        for i in range(self.k, self.k + self.m):
            chunks[self._chunk_index(i)] = np.zeros(blocksize, np.uint8)
        return chunks

    def encode(
        self, want_to_encode: set[int], data: bytes | np.ndarray
    ) -> dict[int, np.ndarray]:
        if isinstance(data, (bytes, bytearray)):
            data = np.frombuffer(bytes(data), np.uint8)
        chunks = self.encode_prepare(data)
        self.encode_chunks(chunks)
        return {i: chunks[i] for i in want_to_encode}

    # ---- decode: select k survivors -> decode_chunks ----

    def decode(
        self,
        want_to_read: set[int],
        chunks: dict[int, np.ndarray],
        chunk_size: int,
    ) -> dict[int, np.ndarray]:
        for c in chunks.values():
            if len(c) != chunk_size:
                raise ErasureCodeError("chunk size mismatch")
        if want_to_read <= set(chunks):
            return {i: chunks[i] for i in want_to_read}
        return self.decode_chunks(want_to_read, dict(chunks))

    def decode_concat(self, chunks: dict[int, np.ndarray]) -> bytes:
        """Reassemble the original stripe from data chunks in shard
        order (reference decode_concat)."""
        want = {self._chunk_index(i) for i in range(self.k)}
        chunk_size = len(next(iter(chunks.values())))
        decoded = self.decode(want, chunks, chunk_size)
        return b"".join(
            decoded[self._chunk_index(i)].tobytes() for i in range(self.k)
        )
