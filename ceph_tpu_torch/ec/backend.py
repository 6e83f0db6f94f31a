"""Device erasure-coding engines (PyTorch, kernels K4 and K5).

Two execution strategies behind the plugins:

- :class:`TableEncoder` — GF(2^8) matrix multiply through product
  tables of every coefficient: K4 (``gf_kernels.matrix_encode``, on
  split nibble tables) on CUDA, one gather per coefficient into the
  256-entry tables on the CPU.  General: works for
  any coding matrix.  (Replaces the reference's
  ``galois_w08_region_multiply`` SIMD loops, upstream bundled
  gf-complete.)

- :class:`BitmatrixEncoder` — the GF(2) bitmatrix product over packet
  rows (``jerasure_matrix_to_bitmatrix`` /
  ``jerasure_bitmatrix_encode`` semantics) for any word size ``w``:
  K5 (``kernels.bitmatrix_encode``), a masked XOR of packet rows.

Both are bit-exact against the host references in :mod:`.gf` /
``cpp/gf_ref.cpp``.

Decode strategy (both): select k surviving generator rows, invert on
host (tiny k x k / kw x kw, exact integer math), then run the same bulk
device multiply — mirroring the reference's ``jerasure_matrix_decode``
structure.

Every engine lives on one device.  ``encode`` keeps the numpy-in,
numpy-out contract of the plugins; ``encode_async`` and
``decode_async`` take numpy arrays or tensors and return tensors on the
device without a host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import gf, gf_kernels, kernels

W = 8


def to_device(data, device) -> torch.Tensor:
    """u8 numpy array or tensor -> contiguous u8 tensor on ``device``."""
    if not isinstance(data, torch.Tensor):
        arr = np.ascontiguousarray(data, np.uint8)
        if not arr.flags.writeable:
            arr = arr.copy()
        data = torch.from_numpy(arr)
    if data.dtype != torch.uint8:
        raise TypeError(f"chunks are uint8, got {data.dtype}")
    return data.to(device).contiguous()


def to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _stack(rows, device) -> torch.Tensor:
    """Stack chunk rows on ``device``: numpy rows are stacked on the
    host and copied once."""
    if all(isinstance(r, np.ndarray) for r in rows):
        return to_device(np.stack(rows), device)
    return torch.stack([to_device(r, device) for r in rows])


class TableEncoder:
    """GF(2^8) matrix x data on one device through per-coefficient
    product tables (K4 on CUDA)."""

    def __init__(self, matrix: np.ndarray, device="cuda"):
        self.matrix = np.asarray(matrix, np.uint8)
        self.m, self.k = self.matrix.shape
        self.device = resolve_device(device)
        self.tables = gf_kernels.mul_tables(self.matrix, self.device)  # [m, k, 256]
        self.nibbles = gf_kernels.nibble_tables(self.matrix, self.device)  # [m, k, 32]

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data [k, S] u8 -> coding [m, S] u8."""
        return to_host(self.encode_async(data))

    def encode_async(self, data) -> torch.Tensor:
        """The encode on the device, without a host sync: ``[k, S]``
        u8 (numpy or tensor) -> ``[m, S]`` u8 tensor on the device."""
        return gf_kernels.matrix_encode(self.tables, to_device(data, self.device), self.nibbles)


class BitmatrixEncoder:
    """GF(2) bitmatrix x packet rows on one device (K5 on CUDA).

    Packet layout matches the host/CPU reference
    (``gfref_bitmatrix_encode``): each chunk is groups of ``w`` packets
    of ``packetsize`` bytes; row (i*w+t) of the bitmatrix XORs data
    packets (j*w+l)."""

    def __init__(self, bitmatrix: np.ndarray, packetsize: int, w: int = W, device="cuda"):
        self.bitmatrix = np.asarray(bitmatrix, np.uint8)
        self.mw, self.kw = self.bitmatrix.shape
        self.w = w
        self.k, self.m = self.kw // w, self.mw // w
        self.packetsize = packetsize
        self.device = resolve_device(device)
        self.operand = kernels.Bitmatrix(self.bitmatrix, w, self.device)

    def encode(self, data: np.ndarray) -> np.ndarray:
        return to_host(self.encode_async(data))

    def encode_async(self, data) -> torch.Tensor:
        return kernels.bitmatrix_encode(self.operand, to_device(data, self.device),
                                        self.packetsize)


class _SystematicCodec:
    """Shared encode/decode flow for systematic [I; M] codes.

    Subclasses set ``self.encoder`` and implement ``_build_decoder``
    (the reconstruction program for a given surviving-row set); the
    decode flow — pick k survivors, cache the decoder, regenerate any
    wanted coding chunks — is identical for the GF(2^8) matrix and the
    GF(2) bit-matrix representations.
    """

    k: int
    m: int
    encoder: TableEncoder | BitmatrixEncoder

    def __init__(self, device):
        self.device = resolve_device(device)
        self._decoders: dict[tuple, TableEncoder | BitmatrixEncoder] = {}

    def encode(self, data: np.ndarray) -> np.ndarray:
        return self.encoder.encode(data)

    def encode_async(self, data) -> torch.Tensor:
        return self.encoder.encode_async(data)

    def _build_decoder(self, rows: tuple[int, ...]):
        raise NotImplementedError

    def decode(
        self, available: dict[int, np.ndarray], want: set[int]
    ) -> dict[int, np.ndarray]:
        """Reconstruct wanted chunk ids (0..k-1 data, k..k+m-1 coding)."""
        # torchlint: disable=J003  # the decoded chunks are the result: one read a wanted chunk
        return {i: to_host(t) for i, t in self.decode_async(available, want).items()}

    def decode_async(self, available: dict, want: set[int]) -> dict[int, torch.Tensor]:
        """:meth:`decode` on the device: chunks as numpy arrays or
        tensors in, tensors on the device out, no host sync."""
        have = set(available)
        if len(have) < self.k:
            raise ValueError("not enough chunks to decode")
        out: dict[int, torch.Tensor] = {}
        missing_data = [i for i in range(self.k) if i not in have]
        if missing_data:
            rows = tuple(sorted(have)[: self.k])
            key = ("d", rows)
            if key not in self._decoders:
                self._decoders[key] = self._build_decoder(rows)
            survivors = _stack([available[r] for r in rows], self.device)
            data = self._decoders[key].encode_async(survivors)
        else:
            data = _stack([available[i] for i in range(self.k)], self.device)
        for i in range(self.k):
            if i in want:
                out[i] = data[i]
        coding_want = [i for i in want if i >= self.k]
        if coding_want:
            coding = self.encode_async(data)
            for i in coding_want:
                out[i] = coding[i - self.k]
        return out


class MatrixCodec(_SystematicCodec):
    """Encode/decode for a systematic [I; M] GF(2^8) code."""

    def __init__(self, matrix: np.ndarray, technique: str = "table",
                 packetsize: int = 64, device="cuda"):
        super().__init__(device)
        self.matrix = np.asarray(matrix, np.uint8)
        self.m, self.k = self.matrix.shape
        self.technique = technique
        self.packetsize = packetsize
        if technique == "bitmatrix":
            self.bitmatrix = gf.matrix_to_bitmatrix(self.matrix)
            self.encoder = BitmatrixEncoder(self.bitmatrix, packetsize, device=self.device)
        else:
            self.encoder = TableEncoder(self.matrix, self.device)

    def generator(self) -> np.ndarray:
        """(k+m) x k generator with identity top block."""
        return np.vstack([np.eye(self.k, dtype=np.uint8), self.matrix])

    def _build_decoder(self, rows: tuple[int, ...]):
        inv = gf.invert_matrix(self.generator()[list(rows)])
        if self.technique == "bitmatrix":
            return BitmatrixEncoder(gf.matrix_to_bitmatrix(inv), self.packetsize,
                                    device=self.device)
        return TableEncoder(inv, self.device)


class BitmatrixCodec(_SystematicCodec):
    """Encode/decode for codes defined natively by a GF(2)
    bit-matrix (w>8 matrix techniques expanded host-side, and the
    liberation / blaum_roth / liber8tion minimal-density codes, which
    have no GF(2^w) matrix form at all).

    Decode works at the bit level: select the k surviving chunks' w-row
    blocks of the bit generator [I; B], invert the (k*w) x (k*w) GF(2)
    matrix on host (exact), and run the same bulk product (K5) —
    mirroring the reference's ``jerasure_bitmatrix`` decode structure.
    """

    def __init__(self, bitmatrix: np.ndarray, w: int, packetsize: int, device="cuda"):
        super().__init__(device)
        self.bitmatrix = np.asarray(bitmatrix, np.uint8)
        self.w = w
        self.mw, self.kw = self.bitmatrix.shape
        self.k, self.m = self.kw // w, self.mw // w
        self.packetsize = packetsize
        self.encoder = BitmatrixEncoder(self.bitmatrix, packetsize, w, self.device)

    def generator_bits(self) -> np.ndarray:
        """((k+m)*w) x (k*w) bit generator with identity top block."""
        return np.vstack(
            [np.eye(self.kw, dtype=np.uint8), self.bitmatrix]
        )

    def _build_decoder(self, rows: tuple[int, ...]):
        gen = self.generator_bits()
        w = self.w
        sub = np.vstack([gen[r * w:(r + 1) * w] for r in rows])
        return BitmatrixEncoder(
            gf.invert_bitmatrix(sub), self.packetsize, w, self.device
        )
