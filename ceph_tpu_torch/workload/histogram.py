"""Device-resident log-bucketed histograms for latency percentiles.

Estimating tail latency over millions of ops per step rules out
sorting or host round-trips: the device step scatter-adds each op into
a power-of-two bucket ladder (``edge[i] = lat_min * 2**i``) and the
host merges the [n_buckets] counts into p50/p95/p99 with one
O(n_buckets) pass.  Relative error is bounded by the bucket ratio (2x
worst case, halved by the in-bucket interpolation below) — the same
trade HDR-style histograms make.

The ladder doubles as the Prometheus histogram schema: ``edges()``
are the ``le`` upper bounds the perf-counter registry's
``TYPE_HISTOGRAM`` renders cumulatively.

The host pieces are copies of the reference package's; ``bucketize``
and ``scatter_hist`` are torch ops on the values' device.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
F32 = torch.float32

#: default ladder: 24 buckets from 0.0625 ms, topping out ~9 minutes
N_BUCKETS = 24
LAT_MIN_MS = 0.0625


def bucket_edges(
    n_buckets: int = N_BUCKETS, lat_min: float = LAT_MIN_MS
) -> np.ndarray:
    """Upper bounds of the log2 ladder (host float64, ``le`` values)."""
    return lat_min * np.exp2(np.arange(1, n_buckets + 1, dtype=np.float64))


def bucketize(values: torch.Tensor, n_buckets: int = N_BUCKETS,
              lat_min: float = LAT_MIN_MS) -> torch.Tensor:
    """Value -> bucket index (int32), the exact ``floor(log2(v /
    lat_min))``.  Values at or below ``lat_min`` land in bucket 0;
    anything past the top edge clips into the last bucket (the overflow
    slot).

    The floor of log2 is the exponent ``torch.frexp`` gives, less one:
    exact on every device, where a float32 ``log2`` is within an ulp
    (CUDA's ``log2f``) and would let the card and the CPU bucket an edge
    differently.  The reference's float32 ``log2`` is not exact either:
    it puts 512 and 2048 ms (quotients 2^13 and 2^15) one bucket low,
    and may differ on quotients within 4 ulps of a power of two
    (ROADMAP §3, R8); the two agree everywhere else.  The divisor is a
    tensor on the values' device, so CUDA divides rather than
    multiplying by a reciprocal."""
    lm = torch.full((), lat_min, dtype=F32, device=values.device)
    v = torch.maximum(values.to(F32), lm)
    _mant, exp = torch.frexp(v / lm)
    return (exp - 1).clamp_(0, n_buckets - 1).to(I32)


def lane_offsets(idx: torch.Tensor, width: int) -> torch.Tensor:
    """``[lanes, m]`` indices into one flat ``[lanes * width]`` buffer:
    lane ``i``'s index ``j`` becomes ``i * width + j``."""
    lanes = torch.arange(idx.shape[0], dtype=idx.dtype, device=idx.device)
    return (idx + lanes[:, None] * width).reshape(-1)


def scatter_hist(idx: torch.Tensor, weight: torch.Tensor,
                 n_buckets: int = N_BUCKETS) -> torch.Tensor:
    """Scatter-add ``weight`` (int32, 0 to drop an op) into the
    [n_buckets] int32 count vector; ``[lanes, n]`` ops into one
    ``[lanes, n_buckets]`` histogram a lane."""
    if idx.dim() == 1:
        out = torch.zeros(n_buckets, dtype=I32, device=idx.device)
        return out.index_add_(0, idx, weight.to(I32))
    lanes = idx.shape[0]
    out = torch.zeros(lanes * n_buckets, dtype=I32, device=idx.device)
    return out.index_add_(0, lane_offsets(idx, n_buckets),
                          weight.reshape(-1).to(I32)).view(lanes, n_buckets)


def percentile(counts: np.ndarray, edges: np.ndarray, q: float) -> float:
    """Host-side merge: the ``q``-quantile (0..1) of a bucketed
    distribution, linearly interpolated inside the bucket.  Zero-total
    histograms report 0.0."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return 0.0
    rank = q * total
    cum = np.cumsum(counts)
    i = int(np.searchsorted(cum, rank, side="left"))
    i = min(i, len(counts) - 1)
    lo = float(edges[i - 1]) if i > 0 else float(edges[0]) / 2.0
    hi = float(edges[i])
    before = int(cum[i - 1]) if i > 0 else 0
    inside = int(counts[i])
    frac = (rank - before) / inside if inside else 1.0
    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)


def percentiles(
    counts: np.ndarray, edges: np.ndarray, qs=(0.5, 0.95, 0.99)
) -> tuple[float, ...]:
    return tuple(percentile(counts, edges, q) for q in qs)


def count_at_least(counts: np.ndarray, edges: np.ndarray, floor: float) -> int:
    """Ops in buckets whose *lower* edge is >= ``floor`` — the
    conservative (never over-counting) slow-op estimate the SLO layer
    grades."""
    counts = np.asarray(counts, np.int64)
    lowers = np.concatenate(([0.0], np.asarray(edges)[:-1]))
    return int(counts[lowers >= floor].sum())
