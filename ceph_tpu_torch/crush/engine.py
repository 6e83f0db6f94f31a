"""Engine dispatch: pick the CRUSH batch executor for a map and rule.

Three tiers, in the reference package's order, all with the placement
semantics of upstream ``src/crush/mapper.c :: crush_do_rule``:

1. :mod:`ceph_tpu_torch.crush.interp_batch`: the level-synchronous
   device engine with the straw2 kernels (straw2 maps, modern tunables);
2. :mod:`ceph_tpu_torch.crush.interp`: the general device engine
   (uniform and mixed uniform/straw2 maps; one choose step per take),
   whose straw2 levels run K1;
3. the in-repo C++ reference (:mod:`ceph_tpu_torch.testing.cppref`), the
   exact host tier: chained choose steps whose fan-out overflows
   ``result_max``, chained chooses on maps the fast engine rejects,
   legacy list/tree/straw1 buckets, and the legacy local-retry tunables.

The local-retry tunables (the argonaut profile, or SET_CHOOSE_LOCAL_*
steps with a positive argument) are the one deliberate difference from
the reference's router, which sends them to a general engine that
raises (ROADMAP's R6): here they run on tier 3 and answer.

Callers go through :func:`make_batch_runner` / :func:`run_batch` so they
always get reference semantics at the fastest qualifying tier.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import interp, interp_batch
from .interp_batch import as_i32, rule_signature
from .map import (
    DenseCrushMap,
    OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP,
    OP_CHOOSELEAF_FIRSTN,
    OP_CHOOSELEAF_INDEP,
    OP_EMIT,
    OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    OP_SET_CHOOSE_LOCAL_TRIES,
    OP_TAKE,
    Rule,
)

_CHOOSE_OPS = (
    OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP,
    OP_CHOOSELEAF_FIRSTN,
    OP_CHOOSELEAF_INDEP,
)


def _chain_overflows(rule: Rule, result_max: int) -> bool:
    """Static check: does any chained choose's fan-out exceed
    ``result_max``?  In that regime the reference caps each inner choose
    by the lane's *dynamic* remaining space (``result_max - osize``,
    mapper.c crush_do_rule), which the batch engine cannot express with
    static shapes — it raises instead of deviating."""
    width = 0
    for s in rule.steps:
        if s.op == OP_TAKE:
            width = 1
        elif s.op in _CHOOSE_OPS:
            numrep = s.arg1 if s.arg1 > 0 else s.arg1 + result_max
            if numrep <= 0:
                continue
            if width > 1 and width * numrep > result_max:
                return True
            width = min(width * numrep, result_max)
        elif s.op == OP_EMIT:
            width = 0
    return False


def _fast(dense: DenseCrushMap, rule: Rule, result_max: int) -> bool:
    return interp_batch.supports(dense, rule) and not _chain_overflows(rule, result_max)


def _interp_supports(rule: Rule) -> bool:
    """The general engine runs single-choose-per-take programs taken
    from a bucket (its working vector holds one pending take, not a
    chain).  A choose after a take of a device stays on the C++ tier,
    where the reference's general engine raises."""
    take: int | None = None
    for s in rule.steps:
        if s.op == OP_TAKE:
            take = s.arg1
        elif s.op in _CHOOSE_OPS:
            if take is None or take >= 0:
                return False
            take = None
        elif s.op == OP_EMIT:
            take = None
    return True


def _local_retries(dense: DenseCrushMap, rule: Rule) -> bool:
    """The legacy local-retry tunables, in the map or set by the rule."""
    tun = dense.tunables
    return bool(tun.choose_local_tries or tun.choose_local_fallback_tries) or any(
        s.op in (OP_SET_CHOOSE_LOCAL_TRIES, OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES) and s.arg1 > 0
        for s in rule.steps)


def _general(dense: DenseCrushMap, rule: Rule) -> bool:
    return (_interp_supports(rule) and not dense.legacy_algs_present()
            and not _local_retries(dense, rule))


_SMAP_CACHE: dict = {}


def _static_map(dense: DenseCrushMap, device) -> interp.StaticCrushMap:
    """The general engine's map, uploaded once per dense-map object."""
    key = (id(dense), str(device))
    hit = _SMAP_CACHE.get(key)
    if hit is None or hit[0] is not dense:
        hit = (dense, interp.StaticCrushMap(dense, device))
        interp_batch._memo_put(_SMAP_CACHE, key, hit)
    return hit[1]


def _host_runner(dense: DenseCrushMap, rule: Rule, result_max: int, device):
    """Exact-semantics tier on the C++ reference: the rule runs on the
    host and the results land on ``device``.  The map travels through
    ``crush_arg`` (the DenseCrushMap itself), not a closure."""
    from ..testing import cppref

    steps = [(s.op, s.arg1, s.arg2) for s in rule.steps]

    def fn(dense_arg, osd_weight, xs):
        to_np = lambda v: as_i32(v, "cpu").numpy().view(np.uint32)
        res, lens = cppref.do_rule_batch(
            dense_arg, steps, to_np(xs), to_np(osd_weight), result_max)
        return torch.from_numpy(res).to(device), torch.from_numpy(lens).to(device)

    return dense, fn


def make_batch_runner(dense: DenseCrushMap, rule: Rule, result_max: int,
                      mode: str | None = None, device="cuda"):
    """Return ``(crush_arg, fn)`` with ``fn(crush_arg, osd_weight, xs)
    -> (results [n, result_max] int32, lens [n] int32)`` on ``device``.

    ``mode`` picks the straw2 kernel path of the fast engine (``"draw"``,
    ``"level"`` or ``"descend"``; None: the default; the other tiers
    ignore it).  ``device`` defaults to the card and raises when there is
    none."""
    dev = resolve_device(device)
    mode = interp_batch.check_mode(mode)
    if _fast(dense, rule, result_max):
        return interp_batch.fast_runner(dense, rule, result_max, mode, dev)
    if _general(dense, rule):
        smap = _static_map(dense, dev)
        return smap, interp.batch_runner(smap, rule, result_max)
    return _host_runner(dense, rule, result_max, dev)


def runner_signature(dense: DenseCrushMap, rule: Rule, result_max: int,
                     mode: str | None = None) -> tuple:
    """Hashable static signature of the program make_batch_runner would
    build; its first field names the tier (``"fast"``, ``"general"`` or
    ``"host"``)."""
    if _fast(dense, rule, result_max):
        return ("fast",) + interp_batch.fast_signature(dense, rule, result_max, mode)
    if _general(dense, rule):
        return ("general", interp.dense_signature(dense), rule_signature(rule), result_max)
    return ("host", rule_signature(rule), result_max)


def run_batch(dense: DenseCrushMap, rule: Rule, xs, osd_weight, result_max: int,
              mode: str | None = None, device="cuda"):
    """One-shot batched rule execution on the best engine."""
    crush_arg, fn = make_batch_runner(dense, rule, result_max, mode, device)
    return fn(crush_arg, osd_weight, xs)
