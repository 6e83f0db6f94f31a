"""Monte Carlo durability estimation over scenario fleets.

The counterpart of the reference package's ``recovery/durability.py``.
A :class:`~ceph_tpu_torch.recovery.fleet.FleetSeries` is N independent
chaos-timeline outcomes of one cluster configuration — exactly the
sample a Monte Carlo durability estimate wants.  This module reduces
those outcomes on the device (torch ops over the ``[epochs, fleet,
...]`` arrays, then a seeded bootstrap over the per-cluster results;
only the O(1) summary scalars and the per-cluster lanes cross to the
host) into capacity-planning estimates, keyed per (codec, k, m,
placement policy, down-out interval):

- **survival / MTTDL** — a cluster is *lost* when any epoch shows an
  inactive PG (below-``k`` readable: the availability-loss proxy for
  data loss this simulator can observe).  With ``f`` losses over ``N``
  missions of ``T`` seconds, MTTDL ≈ ``N·T/f``; a zero-loss fleet
  reports the 95% rule-of-three lower bound ``N·T/3`` with
  ``mttdl_censored=True``.
- **availability** — per-cluster served fraction ``1 - blocked/ops``
  from the traffic outcome counts, fleet mean.
- **time-to-zero-degraded** — per-cluster span from the first to the
  last epoch whose PG histogram shows anything but active+clean.

Confidence intervals are seeded bootstrap percentiles: clusters are
resampled with replacement ``n_boot`` times.  The reference draws the
resample indices with ``jax.random.randint(PRNGKey(seed))``; the port
draws them from a ``torch.Generator`` seeded with ``seed`` on the same
device (:func:`bootstrap_indices`), and :func:`_bootstrap` takes the
``[n_boot, F]`` index matrix, so the quantiles can be held against the
reference's on the reference's own indices.  Zero-loss resamples take
the rule-of-three continuity floor so every MTTDL quantile stays finite
and JSON-safe.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64

#: zero-failure resamples read as this many failures (the 95%
#: rule-of-three bound), keeping bootstrap MTTDL quantiles finite
RULE_OF_THREE = 3.0


def _outcome_reduce(hist: torch.Tensor, counts: torch.Tensor, pg_num: int):
    """``[epochs, fleet, ...]`` series -> per-cluster outcome lanes:
    ``(lost bool[F], avail f64[F], degraded_epochs i32[F], ttzd_epochs
    i32[F])``."""
    # deferred: obs.pg_states imports recovery.peering; at import time
    # this module may load as part of the recovery package __init__
    from ..obs.pg_states import STATE_ACTIVE_CLEAN, STATE_INACTIVE

    n = hist.shape[0]
    inactive = hist[:, :, STATE_INACTIVE] > 0              # [n, F]
    lost = inactive.any(0)                                 # [F]
    blocked = counts[:, :, 2].to(I64).sum(0).to(F64)
    total = counts.to(I64).sum((0, 2)).to(F64)
    avail = 1.0 - blocked / total.clamp(min=1.0)           # [F]
    deg = hist[:, :, STATE_ACTIVE_CLEAN] < pg_num          # [n, F]
    any_deg = deg.any(0)
    first = deg.to(I32).argmax(0)
    last = (n - 1) - deg.flip(0).to(I32).argmax(0)
    deg_epochs = deg.to(I32).sum(0, dtype=I32)
    ttzd = torch.where(any_deg, last - first + 1, 0).to(I32)
    return lost, avail, deg_epochs, ttzd


def bootstrap_indices(seed: int, n_boot: int, n: int, device) -> torch.Tensor:
    """``[n_boot, n]`` int64 resample indices in ``[0, n)``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return torch.randint(0, n, (int(n_boot), n), generator=gen, device=dev)


def _bootstrap(idx: torch.Tensor, lost, avail, ttzd_s, q_lo: float, q_hi: float):
    """Cluster-resample bootstrap on the resample indices ``idx``
    (``[n_boot, F]``): the ``[q_lo, q_hi]`` quantiles (linear, as
    ``jnp.quantile``) of the fleet mean of the loss fraction, the
    availability and the time to zero degraded."""
    q = torch.tensor([q_lo, q_hi], dtype=F64).to(idx.device)

    def stat(v):
        return torch.quantile(v.to(F64)[idx].mean(1), q)

    return stat(lost), stat(avail), stat(ttzd_s)


@dataclass(frozen=True)
class DurabilityEstimate:
    """One fleet's Monte Carlo durability summary (host scalars), plus
    the configuration key it was measured under."""

    scenario: str
    n_clusters: int
    n_epochs: int
    mission_s: float
    survival_fraction: float
    n_lost: int
    mttdl_s: float
    mttdl_ci_lo_s: float
    mttdl_ci_hi_s: float
    mttdl_censored: bool
    availability_mean: float
    availability_ci_lo: float
    availability_ci_hi: float
    ttzd_mean_s: float
    ttzd_ci_lo_s: float
    ttzd_ci_hi_s: float
    worst_cluster: int
    worst_availability: float
    seed: int
    n_boot: int
    # the (codec, k, m, placement, down-out) configuration key
    codec: str = ""
    ec_k: int = 0
    ec_m: int = 0
    placement: str = ""
    down_out_interval_s: float = 0.0

    def to_dict(self, prefix: str = "durability_") -> dict:
        """Flat, typed record fields (the bench-record surface — every
        value JSON-scalar)."""
        return {
            f"{prefix}scenario": self.scenario,
            f"{prefix}n_clusters": int(self.n_clusters),
            f"{prefix}n_epochs": int(self.n_epochs),
            f"{prefix}mission_s": round(float(self.mission_s), 6),
            f"{prefix}survival_fraction": round(
                float(self.survival_fraction), 9
            ),
            f"{prefix}n_lost": int(self.n_lost),
            f"{prefix}mttdl_s": round(float(self.mttdl_s), 3),
            f"{prefix}mttdl_ci_lo_s": round(float(self.mttdl_ci_lo_s), 3),
            f"{prefix}mttdl_ci_hi_s": round(float(self.mttdl_ci_hi_s), 3),
            f"{prefix}mttdl_censored": bool(self.mttdl_censored),
            f"{prefix}availability_mean": round(
                float(self.availability_mean), 9
            ),
            f"{prefix}availability_ci_lo": round(
                float(self.availability_ci_lo), 9
            ),
            f"{prefix}availability_ci_hi": round(
                float(self.availability_ci_hi), 9
            ),
            f"{prefix}ttzd_mean_s": round(float(self.ttzd_mean_s), 6),
            f"{prefix}ttzd_ci_lo_s": round(float(self.ttzd_ci_lo_s), 6),
            f"{prefix}ttzd_ci_hi_s": round(float(self.ttzd_ci_hi_s), 6),
            f"{prefix}worst_cluster": int(self.worst_cluster),
            f"{prefix}worst_availability": round(
                float(self.worst_availability), 9
            ),
            f"{prefix}seed": int(self.seed),
            f"{prefix}n_boot": int(self.n_boot),
            f"{prefix}codec": self.codec,
            f"{prefix}ec_k": int(self.ec_k),
            f"{prefix}ec_m": int(self.ec_m),
            f"{prefix}placement": self.placement,
            f"{prefix}down_out_interval_s": round(
                float(self.down_out_interval_s), 6
            ),
        }


def estimate_durability(
    fleet,
    *,
    dt: float,
    scenario: str = "",
    seed: int = 0,
    n_boot: int = 256,
    alpha: float = 0.05,
    pg_num: int | None = None,
    codec: str = "",
    ec_k: int = 0,
    ec_m: int = 0,
    placement: str = "",
    down_out_interval_s: float = 0.0,
    indices: torch.Tensor | None = None,
    device="cuda",
) -> DurabilityEstimate:
    """Reduce one fleet's outcomes into a :class:`DurabilityEstimate`.

    ``fleet`` is a :class:`~ceph_tpu_torch.recovery.fleet.FleetSeries`
    (or anything with ``hist``/``counts`` arrays shaped ``[epochs,
    fleet, ...]``).  ``dt`` is the driver's epoch width; ``pg_num``
    defaults to the histogram row sum of epoch 0 (exact: the classifier
    histograms every PG exactly once).  ``indices`` are the ``[n_boot,
    fleet]`` resample indices, drawn by :func:`bootstrap_indices` from
    ``seed`` when None.  The reduction runs on ``device`` (the card by
    default).
    """
    dev = resolve_device(device)
    hist_h = np.asarray(fleet.hist)
    hist = torch.from_numpy(np.ascontiguousarray(hist_h)).to(dev)
    counts = torch.from_numpy(np.ascontiguousarray(np.asarray(fleet.counts))).to(dev)
    n_epochs, n_clusters = int(hist.shape[0]), int(hist.shape[1])
    if pg_num is None:
        pg_num = int(hist_h[0, 0].sum())
    mission_s = float(n_epochs) * float(dt)
    lost, avail, _deg_epochs, ttzd = _outcome_reduce(hist, counts, int(pg_num))
    ttzd_s = ttzd.to(F64) * float(dt)
    if indices is None:
        indices = bootstrap_indices(seed, n_boot, n_clusters, dev)
    lf_ci, av_ci, tz_ci = _bootstrap(indices.to(dev), lost, avail, ttzd_s,
                                     alpha / 2.0, 1.0 - alpha / 2.0)
    lost_h, avail_h, ttzd_h, lf_ci, av_ci, tz_ci = (
        # torchlint: disable=J003  # the estimate's lanes are the result
        t.cpu().numpy() for t in (lost, avail, ttzd_s, lf_ci, av_ci, tz_ci))
    n_lost = int(lost_h.sum())
    exposure = n_clusters * mission_s
    censored = n_lost == 0
    mttdl = exposure / (n_lost if n_lost else RULE_OF_THREE)
    # the CI is the monotone image of the loss-fraction quantiles.
    # Continuity floors keep a zero quantile from producing an
    # infinite (JSON-unsafe) bound: a censored fleet takes the
    # rule-of-three count on both ends, otherwise half an observed
    # failure
    floor = RULE_OF_THREE if censored else 0.5
    f_hi = max(float(lf_ci[1]) * n_clusters, floor)
    f_lo = max(float(lf_ci[0]) * n_clusters, floor)
    worst = int(np.argmin(avail_h)) if n_clusters else 0
    return DurabilityEstimate(
        scenario=scenario,
        n_clusters=n_clusters,
        n_epochs=n_epochs,
        mission_s=mission_s,
        survival_fraction=1.0 - n_lost / max(n_clusters, 1),
        n_lost=n_lost,
        mttdl_s=mttdl,
        mttdl_ci_lo_s=exposure / f_hi,
        mttdl_ci_hi_s=exposure / f_lo,
        mttdl_censored=censored,
        availability_mean=float(avail_h.mean()),
        availability_ci_lo=float(av_ci[0]),
        availability_ci_hi=float(av_ci[1]),
        ttzd_mean_s=float(ttzd_h.mean()),
        ttzd_ci_lo_s=float(tz_ci[0]),
        ttzd_ci_hi_s=float(tz_ci[1]),
        worst_cluster=worst,
        worst_availability=float(avail_h[worst]) if n_clusters else 1.0,
        seed=int(seed),
        n_boot=int(n_boot),
        codec=codec,
        ec_k=int(ec_k),
        ec_m=int(ec_m),
        placement=placement,
        down_out_interval_s=float(down_out_interval_s),
    )
