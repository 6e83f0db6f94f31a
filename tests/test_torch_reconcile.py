"""The port's divergent ranks in one process vs the reference's.

The in-process cases of ``tests/test_reconcile.py`` (from
``test_rank_spec_roundtrip`` to ``test_driver_validates_rank_specs_loudly``)
as differentials, each at the reference test's own map
(``build_osdmap(64, pg_num=128, size=6, erasure)`` for the driver runs),
built in the reference package and carried across as ``encode()``
bytes; the port runs on the CPU.

Equal: the host pieces (spec parsing, rank schedules, skewed timelines,
the stall fixpoint) exactly; merged and normalized views lane by lane,
by value (the port keeps int32 where the reference widens, R4 and R10,
and carries u32 lanes in int64); each ``RoundResult``'s ``round``,
``target_step``, ``steps``, ``epochs``, ``laggy``, ``converged``,
``diverged``, ``retries`` and ``backoff_epochs`` exactly; fingerprints
by which ranks share one (``rank_fingerprint`` hashes dtypes, so the
numbers differ between the packages); journals by their record names,
the health timeline's rank series and SLO verdicts exactly.  Also the
merge laws (commutative, associative, idempotent on the normalized
domain; normalize a projection) on random views, and the multi-process
pieces (``RankReconciler``, ``ViewMerger``, ``assert_rank_identical``) on
a world of one; their gloo worlds of 2 and 4 are in
tests/test_torch_mesh_paths.py and tests/test_torch_mesh.py.
"""

import copy
import sys
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

from ceph_tpu.analysis.runtime_guard import rank_fingerprint as ref_rank_fingerprint
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.models.clusters import build_osdmap as ref_build_osdmap
from ceph_tpu.obs import (
    EventJournal as RefJournal,
    HealthTimeline as RefHealth,
    SLOSpec as RefSLOSpec,
    evaluate as ref_evaluate,
)
from ceph_tpu.recovery import reconcile as ref_rc
from ceph_tpu.recovery.chaos import ChaosEvent as RefEvent, ChaosTimeline as RefTimeline
from ceph_tpu.recovery.failure import (
    UnknownSpecKeyError as RefUnknownSpecKeyError,
    check_rank as ref_check_rank,
    parse_spec as ref_parse_spec,
)
from ceph_tpu.recovery.liveness import ClusterFlags as RefFlags
from ceph_tpu_torch import convert
from ceph_tpu_torch.analysis import runtime_guard as rank_guard
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.core.cluster_state import ClusterState
from ceph_tpu_torch.obs import EventJournal, HealthTimeline, SLOSpec, evaluate
from ceph_tpu_torch.osdmap.mapping import PoolMapState
from ceph_tpu_torch.recovery import reconcile as rc
from ceph_tpu_torch.recovery.chaos import ChaosEvent, ChaosTimeline
from ceph_tpu_torch.recovery.failure import UnknownSpecKeyError, check_rank, parse_spec
from ceph_tpu_torch.recovery.liveness import ClusterFlags

ROUND_FIELDS = ("round", "target_step", "steps", "epochs", "laggy", "converged", "diverged",
                "retries", "backoff_epochs")


@pytest.fixture(autouse=True, scope="module")
def _reference_caches_left_as_found():
    """Put the reference's program caches back after this module."""
    from ceph_tpu.crush import interp, interp_batch as ib
    from ceph_tpu.osdmap import mapping
    from ceph_tpu.recovery import pipeline

    caches = (ib._FAST_CACHE, ib._PACK_CACHE, interp._BATCH_CACHE, mapping._POOL_FN_CACHE,
              pipeline.PIPELINES._entries)
    saved = [copy.copy(c) for c in caches]
    counts = (pipeline.PIPELINES.hits, pipeline.PIPELINES.misses, pipeline.PIPELINES.evictions)
    yield
    for cache, before in zip(caches, saved):
        cache.clear()
        cache.update(before)
    pipeline.PIPELINES.hits, pipeline.PIPELINES.misses, pipeline.PIPELINES.evictions = counts


def _maps(n_osd=64, pg_num=128):
    ref = ref_build_osdmap(n_osd, pg_num=pg_num, size=6, pool_kind="erasure")
    return ref, convert.osdmap_from_reference(ref.encode())


def _cfgs(**kw):
    out = []
    for cls in (RefConfig, Config):
        cfg = cls(env={})
        cfg.set("reconcile_every_epochs", 4)
        for k, v in kw.items():
            cfg.set(k, v)
        out.append(cfg)
    return out


def _timelines(pairs):
    """The same timeline in both packages: ``(t, spec strings)`` pairs."""
    return (RefTimeline([RefEvent(t, tuple(ref_parse_spec(s) for s in specs))
                         for t, specs in pairs]),
            ChaosTimeline([ChaosEvent(t, tuple(parse_spec(s) for s in specs))
                           for t, specs in pairs]))


def _lanes(state) -> dict:
    """Every lane of a view (either package) as host numpy, by name."""
    out = {}
    for f in fields(ClusterState):
        v = getattr(state, f.name)
        if f.name == "pool":
            for g in fields(PoolMapState):
                out["pool." + g.name] = _np(getattr(v, g.name))
        elif v is not None:
            out[f.name] = _np(v)
    return out


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_views_equal(port, ref):
    """Lane by lane, by value."""
    p, r = _lanes(port), _lanes(ref)
    assert p.keys() == r.keys()
    bad = [k for k in p if p[k].shape != r[k].shape or not np.array_equal(p[k], r[k])]
    assert bad == []


def _leaves_equal(a: ClusterState, b: ClusterState):
    """Names of the lanes where two port views differ (dtype or bits)."""
    la, lb = _lanes(a), _lanes(b)
    return [k for k in la if la[k].dtype != lb[k].dtype or not np.array_equal(la[k], lb[k])]


def _same_groups(fps_a, fps_b) -> bool:
    """Two fingerprint vectors split the ranks into the same classes."""
    def groups(fps):
        return sorted(tuple(i for i, f in enumerate(fps) if f == g) for g in set(fps))

    return groups(fps_a) == groups(fps_b)


def assert_rounds_match(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        for f in ROUND_FIELDS:
            assert getattr(p, f) == getattr(r, f), f
        assert _same_groups(p.fingerprints, r.fingerprints)


def _drivers(pairs, n_ranks, seed, n_ops=64, maps=None, **kw):
    ref_m, m = maps or _maps()
    ref_tl, tl = _timelines(pairs)
    ref_cfg, cfg = _cfgs()
    ref_kw = {k: v[0] for k, v in kw.items()}
    port_kw = {k: v[1] for k, v in kw.items()}
    return (ref_rc.DivergentDriver(ref_m, ref_tl, n_ranks, config=ref_cfg, seed=seed,
                                   n_ops=n_ops, **ref_kw),
            rc.DivergentDriver(m, tl, n_ranks, config=cfg, seed=seed, n_ops=n_ops,
                               device="cpu", **port_kw))


# ---- rank-scoped spec parsing and the host pieces ----------------------


def test_rank_spec_roundtrip():
    for text in ("rankdelay:1.2500", "rankdelay:01.040", "rankdrop:0", "rankdrop:0:restore",
                 "rankstall:1.0", "rankstall:1.4"):
        s, r = parse_spec(text), ref_parse_spec(text)
        assert str(s) == str(r)
        assert (s.scope, s.is_rank, s.rank(), s.rank_arg() if s.scope != "rankdrop" else 0,
                s.action) == (r.scope, r.is_rank, r.rank(),
                              r.rank_arg() if r.scope != "rankdrop" else 0, r.action)
    assert str(parse_spec("rankdelay:01.040")) == str(parse_spec("rankdelay:1.40"))


@pytest.mark.parametrize("text", ["rankdelay:1", "rankdelay:1.0", "rankstall:-1.5",
                                  "rankdrop:0.5"])
def test_rank_spec_invalid_is_loud(text):
    with pytest.raises(RefUnknownSpecKeyError):
        ref_parse_spec(text)
    with pytest.raises(UnknownSpecKeyError):
        parse_spec(text)


def test_rank_spec_range_check_matches_reference():
    with pytest.raises(UnknownSpecKeyError):
        check_rank(parse_spec("rankdrop:5"), 2)
    with pytest.raises(RefUnknownSpecKeyError):
        ref_check_rank(ref_parse_spec("rankdrop:5"), 2)
    assert check_rank(parse_spec("rankdrop:1"), 2) == ref_check_rank(
        ref_parse_spec("rankdrop:1"), 2) == 1


def test_rank_spec_rejected_by_tape_compiler():
    from ceph_tpu.recovery.superstep import compile_event_tape as ref_compile
    from ceph_tpu_torch.recovery.superstep import compile_event_tape

    ref_m, m = _maps(16, 32)
    ref_tl, tl = _timelines([(0.1, ("rankdelay:0.40",))])
    with pytest.raises(ValueError):
        ref_compile(ref_tl, ref_m)
    with pytest.raises(ValueError):
        compile_event_tape(tl, m)


SCHED = [(1.0, ("rankdelay:1.1000",)), (2.0, ("rankdrop:0", "rankstall:1.4")),
         (3.0, ("rankdrop:0:restore",)), (0.5, ("osd:3:down_out",))]


def test_rank_schedule_decodes_directives():
    ref_tl, tl = _timelines(SCHED)
    for rank in (0, 1):
        s, r = rc.rank_schedule(tl, rank, 2), ref_rc.rank_schedule(ref_tl, rank, 2)
        assert (s.rank, s.delays, s.drops, s.stalls) == (r.rank, r.delays, r.drops, r.stalls)
        for t in (0.5, 1.0, 1.5, 1.9, 2.5, 3.0):
            assert s.skew_at(t) == r.skew_at(t) and s.reporting(t) == r.reporting(t)
        assert s.stall_windows(0.0, 0.25) == r.stall_windows(0.0, 0.25)
    assert rc.rank_schedule(tl, 1, 2).stalls == ((2.0, 4),)


def test_rank_schedule_unmatched_drop_runs_forever():
    ref_tl, tl = _timelines([(1.0, ("rankdrop:0",))])
    s, r = rc.rank_schedule(tl, 0, 1), ref_rc.rank_schedule(ref_tl, 0, 1)
    assert s.drops == r.drops == ((1.0, float("inf")),)
    assert not s.reporting(1e9)


def test_rank_view_timeline_shifts_and_strips():
    ref_tl, tl = _timelines(SCHED + [(4.0, ("slow:7",))])

    def sig(timeline):
        return [(ev.t, tuple(str(s) for s in ev.specs)) for ev in timeline.events()]

    for rank in (0, 1):
        got = sig(rc.rank_view_timeline(tl, rank, 2))
        assert got == sig(ref_rc.rank_view_timeline(ref_tl, rank, 2))
        assert all("rank" not in s for _t, specs in got for s in specs)
    assert [t for t, _s in sig(rc.rank_view_timeline(tl, 1, 2))] == [0.5, 5.0]
    assert sig(rc.strip_rank_specs(tl)) == sig(ref_rc.strip_rank_specs(ref_tl))


@pytest.mark.parametrize("windows,target", [
    (((4, 8),), 6), (((4, 8),), 8), (((4, 8),), 3), (((2, 4), (4, 6)), 5),
    (((3, 5), (1, 4)), 4), (((3, sys.maxsize),), 10**9)])
def test_stall_allowed_fixpoint(windows, target):
    assert rc._stall_allowed(windows, target) == ref_rc._stall_allowed(windows, target)


def test_rank_fingerprint_is_the_references():
    rng = np.random.default_rng(2)
    arrays = [rng.integers(0, 9, (4, 3)).astype(np.int32), rng.random(5).astype(np.float32),
              np.array([True, False])]
    assert rank_guard.rank_fingerprint(*arrays) == ref_rank_fingerprint(*arrays)
    assert rank_guard.rank_fingerprint(arrays[0]) != rank_guard.rank_fingerprint(
        arrays[0].astype(np.int64))


# ---- merge algebra ----------------------------------------------------


def _two_rank_drivers():
    return _drivers([], 2, seed=2, n_ops=32, maps=_maps(32, 64))


def _ref_edit(base, lane, i, v):
    return getattr(base, lane).at[i].set(v)


def _port_edit(base, lane, i, v):
    t = getattr(base, lane).clone()
    t[i] = v
    return t


def _edited(base, edit, spec):
    """``base`` with lanes edited: ``spec`` maps lane -> [(index, value)]."""
    out = {}
    for lane, items in spec.items():
        t = getattr(base, lane)
        for i, v in items:
            t = edit(replace(base, **{lane: t}), lane, i, v)
        out[lane] = t
    return replace(base, **out)


def test_quorum_merge_regression():
    """Two ranks at the same map epoch disagree on a detector down bit:
    a claim backed by >= min_reporters survives the merge (the union),
    a single-reporter claim is filtered, and a rankdrop window voids the
    dropped rank's evidence."""
    ref_d, d = _two_rank_drivers()
    a_spec = {"down": [(3, True)], "down_since": [(3, 1.0)], "reporters": [(3, 2)]}
    b_spec = {"down": [(7, True)], "down_since": [(7, 2.0)], "reporters": [(7, 2)]}
    ra, rb = (_edited(ref_d.states[0], _ref_edit, s) for s in (a_spec, b_spec))
    pa, pb = (_edited(d.states[0], _port_edit, s) for s in (a_spec, b_spec))
    for (px, py), (rx, ry) in (((pa, pb), (ra, rb)), ((pb, pa), (rb, ra))):
        m = rc.merge_views(px, py, min_reporters=2)
        assert_views_equal(m, ref_rc.merge_views(rx, ry, min_reporters=2))
        assert bool(m.down[3]) and bool(m.down[7]) and float(m.down_since[3]) == 1.0
    ra1 = _edited(ra, _ref_edit, {"reporters": [(3, 1)]})
    pa1 = _edited(pa, _port_edit, {"reporters": [(3, 1)]})
    m = rc.merge_views(pa1, pb, min_reporters=2)
    assert_views_equal(m, ref_rc.merge_views(ra1, rb, min_reporters=2))
    assert not bool(m.down[3]) and bool(m.down[7])
    m = rc.merge_views(pa, pb, min_reporters=2, report_b=False)
    assert_views_equal(m, ref_rc.merge_views(ra, rb, min_reporters=2, report_b=False))
    assert bool(m.down[3]) and not bool(m.down[7]) and float(m.down_since[7]) == 0.0
    # merge_stacked over the same views, with a host or a tensor report lane
    from ceph_tpu.core.cluster_state import stack_states as ref_stack
    from ceph_tpu_torch.core.cluster_state import stack_states
    import jax.numpy as jnp

    want = ref_rc.merge_stacked(ref_stack([ra, rb, ra1]), jnp.asarray([True, False, True]),
                                jnp.int32(2))
    for report in ([True, False, True], torch.tensor([True, False, True])):
        assert_views_equal(rc.merge_stacked(stack_states([pa, pb, pa1]), report, 2), want)


def test_merge_idempotent_on_normalized_domain():
    ref_d, d = _two_rank_drivers()
    spec = {"down": [(5, True)], "down_since": [(5, 3.0)], "reporters": [(5, 1)]}
    ra, pa = _edited(ref_d.states[0], _ref_edit, spec), _edited(d.states[0], _port_edit, spec)
    m = rc.merge_views(pa, d.states[0])
    assert_views_equal(m, ref_rc.merge_views(ra, ref_d.states[0]))
    assert _leaves_equal(rc.merge_views(m, m), m) == []


def test_normalize_is_a_projection():
    ref_d, d = _two_rank_drivers()
    spec = {"down": [(2, True)], "down_since": [(2, 4.0)], "reporters": [(2, 0)]}
    ra, pa = _edited(ref_d.states[0], _ref_edit, spec), _edited(d.states[0], _port_edit, spec)
    once = rc.normalize_view(pa, min_reporters=1)
    assert_views_equal(once, ref_rc.normalize_view(ra, min_reporters=1))
    assert _leaves_equal(rc.normalize_view(once, min_reporters=1), once) == []
    assert not bool(once.down[2]) and float(once.down_since[2]) == 0.0
    dropped = rc.normalize_view(pa, min_reporters=1, report=False)
    assert_views_equal(dropped, ref_rc.normalize_view(ra, min_reporters=1, report=False))
    assert float(dropped.last_ack.max()) == float(torch.finfo(torch.float32).min)


def _random_view(base: ClusterState, rng, epoch: int) -> ClusterState:
    n = base.n_osds
    pg = base.pg_num

    def bits(p):
        return torch.from_numpy(rng.random(n) < p)

    return replace(
        base,
        pool=replace(base.pool, osd_up=bits(0.8), osd_weight=torch.from_numpy(
            rng.choice([0, 0x8000, 0x10000], n).astype(np.int32))),
        down=bits(0.3), down_since=torch.from_numpy(rng.random(n).astype(np.float32) * 9),
        last_ack=torch.from_numpy(rng.random(n).astype(np.float32) * 9),
        laggy=torch.from_numpy(rng.random(n).astype(np.float32)),
        reporters=torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)),
        suppressed=bits(0.2), slow=bits(0.2), out=bits(0.1),
        survivor_mask=torch.from_numpy(rng.integers(0, 1 << 32, pg, dtype=np.int64)),
        n_alive=torch.from_numpy(rng.integers(0, 7, pg).astype(np.int32)),
        epoch=torch.tensor(epoch, dtype=torch.int32),
        step=torch.tensor(int(rng.integers(0, 9)), dtype=torch.int32),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_laws_on_random_views(seed):
    """Commutative, associative, idempotent on the normalized domain;
    normalize a projection; any order of a stacked merge lands on the
    same consensus (ties on the epoch included)."""
    _ref_d, d = _two_rank_drivers()
    rng = np.random.default_rng(seed)
    base = d.states[0]
    a, b, c = (_random_view(base, rng, e) for e in (5, 5 + seed % 2, 4))
    kw = {"min_reporters": 2}
    na, nb, nc = (rc.normalize_view(v, **kw) for v in (a, b, c))
    assert _leaves_equal(rc.normalize_view(na, **kw), na) == []
    ab = rc._join(na, nb)
    assert _leaves_equal(ab, rc._join(nb, na)) == []
    assert _leaves_equal(rc._join(ab, nc), rc._join(na, rc._join(nb, nc))) == []
    assert _leaves_equal(rc._join(ab, ab), ab) == []
    from ceph_tpu_torch.core.cluster_state import stack_states

    want = rc.merge_stacked(stack_states([a, b, c]), [True] * 3, 2)
    got = rc.merge_stacked(stack_states([c, a, b]), [True] * 3, 2)
    assert _leaves_equal(got, want) == []


# ---- in-process divergent runs ---------------------------------------


def test_subepoch_skew_bitequal_all_leaves():
    """A 40 ms skew never crosses an epoch boundary: every round
    converges and each rank's final view equals the single-rank
    reference on every lane."""
    ref_d, d = _drivers([(0.05, ("rankdelay:1.40",)), (0.30, ("osd:3:down_out",)),
                         (1.30, ("osd:7:down_out",))], 2, seed=3)
    ref_res, res = ref_d.run(16), d.run(16)
    assert_rounds_match(res.rounds, ref_res.rounds)
    assert res.converged and res.laggy == () and res.total_steps == ref_res.total_steps
    assert res.detection_to_convergence_rounds() is None
    ref = d.reference_state(res.total_steps)
    for s, rs in zip(res.states, ref_res.states):
        assert _leaves_equal(s, ref) == []
        assert rc.view_fingerprint(s) == rc.view_fingerprint(ref)
        assert_views_equal(s, rs)
    assert not bool(res.states[0].pool.osd_up[3])
    assert rc.view_fingerprint(res.merged) == rc.view_fingerprint(ref)
    assert_views_equal(res.merged, ref_res.merged)


def test_cross_epoch_skew_detected_then_reconverges():
    """A 2.5 s skew makes rank 1 observably stale at intermediate rounds
    (staleness, not divergence: no retries), then the views re-converge
    equal to the reference."""
    ref_d, d = _drivers([(0.05, ("rankdelay:1.2500",)), (0.30, ("osd:3:down_out",)),
                         (0.80, ("osd:9:down_out",))], 2, seed=4)
    ref_res, res = ref_d.run(24), d.run(24)
    assert_rounds_match(res.rounds, ref_res.rounds)
    d2c = res.detection_to_convergence_rounds()
    assert d2c == ref_res.detection_to_convergence_rounds() and d2c is not None and d2c >= 1
    assert res.converged and all(r.retries == 0 and not r.diverged for r in res.rounds)
    ref = d.reference_state(res.total_steps)
    for s in res.states:
        assert rc.view_fingerprint(s) == rc.view_fingerprint(ref)
        assert not bool(s.pool.osd_up[3]) and not bool(s.pool.osd_up[9])


def _observed(cls_journal, cls_flags, cls_health, tmp_path, name, **health_kw):
    return {"journal": cls_journal(path=str(tmp_path / name)), "flags": cls_flags(),
            "health": cls_health(lambda: 0.0, k=4, **health_kw)}


def test_finite_stall_marks_laggy_then_revives(tmp_path):
    """A 20-epoch rankstall parks rank 1 past the laggy deadline; the
    survivor keeps reconciling, the rank replays its missed span, and
    re-converges equal to the reference, clearing the flag."""
    obs_r = _observed(RefJournal, RefFlags, RefHealth, tmp_path, "r.jsonl")
    obs_p = _observed(EventJournal, ClusterFlags, HealthTimeline, tmp_path, "p.jsonl",
                      device="cpu")
    ref_d, d = _drivers([(0.30, ("osd:3:down_out",)), (1.00, ("rankstall:1.20",))], 2, seed=5,
                        **{k: (obs_r[k], obs_p[k]) for k in obs_r})
    ref_res, res = ref_d.run(32), d.run(32)
    assert_rounds_match(res.rounds, ref_res.rounds)
    assert res.converged and res.laggy == () and "rankstalled" not in obs_p["flags"]
    assert any(1 in r.laggy for r in res.rounds)
    names = [r["name"] for r in obs_p["journal"].records]
    assert names == [r["name"] for r in obs_r["journal"].records]
    assert {"reconcile.laggy", "reconcile.revived", "reconcile.catchup"} <= set(names)
    catchup = obs_p["journal"].by_name("reconcile.catchup")[0]["attrs"]
    assert catchup == obs_r["journal"].by_name("reconcile.catchup")[0]["attrs"]
    assert catchup["rank"] == 1 and catchup["n_steps"] > 1
    ref = d.reference_state(res.total_steps)
    for s in res.states:
        assert rc.view_fingerprint(s) == rc.view_fingerprint(ref)
    assert obs_p["health"].rank_series() == obs_r["health"].rank_series()
    assert obs_p["health"].max_rank_stall_rounds() == obs_r["health"].max_rank_stall_rounds() >= 3
    assert evaluate(obs_p["health"], SLOSpec(max_rank_stall_rounds=100)).check(
        "SLO_RANK_STALL").status == ref_evaluate(
        obs_r["health"], RefSLOSpec(max_rank_stall_rounds=100)).check("SLO_RANK_STALL").status


def test_permanent_stall_raises_with_flag_and_slo_breach(tmp_path):
    """``rankstall:1.0`` (permanent): the protocol raises a typed
    RankStalledError at the same round as the reference, with the flag
    set and ``SLO_RANK_STALL`` breached."""
    obs_r = _observed(RefJournal, RefFlags, RefHealth, tmp_path, "r.jsonl")
    obs_p = _observed(EventJournal, ClusterFlags, HealthTimeline, tmp_path, "p.jsonl",
                      device="cpu")
    ref_d, d = _drivers([(0.30, ("osd:3:down_out",)), (1.00, ("rankstall:1.0",))], 2, seed=6,
                        **{k: (obs_r[k], obs_p[k]) for k in obs_r})
    with pytest.raises(ref_rc.RankStalledError) as ref_e:
        ref_d.run(16)
    with pytest.raises(rc.RankStalledError) as e:
        d.run(16)
    assert str(e.value) == str(ref_e.value) and "rank(s) [1]" in str(e.value)
    assert "rankstalled" in obs_p["flags"]
    proto = d.protocol
    assert int(proto.stall_rounds[1]) == proto.deadline + proto.retry_max
    assert proto.stall_rounds.tolist() == ref_d.protocol.stall_rounds.tolist()
    names = [r["name"] for r in obs_p["journal"].records]
    assert names == [r["name"] for r in obs_r["journal"].records]
    assert "reconcile.stalled" in names and "reconcile.revived" not in names
    rep = evaluate(obs_p["health"], SLOSpec(max_rank_stall_rounds=1))
    ref_rep = ref_evaluate(obs_r["health"], RefSLOSpec(max_rank_stall_rounds=1))
    assert rep.check("SLO_RANK_STALL").status == ref_rep.check("SLO_RANK_STALL").status
    assert rep.status == ref_rep.status == "HEALTH_ERR"
    assert d.cur == ref_d.cur and d.cur[0] > d.cur[1] == 3


def test_rankdrop_window_gates_merge_evidence():
    ref_d, d = _drivers([(0.30, ("osd:3:down_out",)), (0.50, ("rankdrop:1",))], 2, seed=7)
    ref_res, res = ref_d.run(8), d.run(8)
    assert_rounds_match(res.rounds, ref_res.rounds)
    assert res.converged and not bool(res.merged.pool.osd_up[3])
    assert_views_equal(res.merged, ref_res.merged)


def test_single_rank_degenerates_to_plain_driver():
    ref_d, d = _drivers([(0.30, ("osd:3:down_out",))], 1, seed=8)
    ref_res, res = ref_d.run(8), d.run(8)
    assert_rounds_match(res.rounds, ref_res.rounds)
    assert res.converged and res.laggy == ()
    assert _leaves_equal(res.states[0], d.reference_state(res.total_steps)) == []
    assert_views_equal(res.states[0], ref_res.states[0])


def test_driver_validates_rank_specs_loudly():
    maps = _maps(16, 32)
    with pytest.raises(RefUnknownSpecKeyError):
        _drivers([(0.1, ("rankdelay:3.40",))], 2, seed=0, n_ops=16, maps=maps)
    _ref_tl, tl = _timelines([(0.1, ("rankdelay:3.40",))])
    cfg = _cfgs()[1]
    with pytest.raises(UnknownSpecKeyError):
        rc.DivergentDriver(maps[1], tl, 2, config=cfg, n_ops=16, device="cpu")
    with pytest.raises(ValueError):
        rc.DivergentDriver(maps[1], tl, 0, config=cfg, n_ops=16, device="cpu")


def test_rank_reconciler_on_a_world_of_one_equals_the_driver():
    """What waited for item 4 now runs; on a world of one: the
    multi-process ``RankReconciler`` (its merge through ``ViewMerger``'s
    collectives) equals the one-rank in-process driver round for round
    and lane for lane, and ``assert_rank_identical`` passes (worlds of
    2 and 4: tests/test_torch_mesh_paths.py and test_torch_mesh.py)."""
    from ceph_tpu_torch.parallel import make_mesh

    _ref_m, m = _maps(16, 32)
    # checkpointed runs (item 2d) are ported: tests/test_torch_checkpoint.py
    d = rc.DivergentDriver(m, ChaosTimeline(), 2, config=_cfgs()[1], n_ops=16, device="cpu")
    assert d.run(4).converged
    _ref_tl, tl = _timelines([(0.30, ("osd:3:down_out",))])
    mesh = make_mesh(device="cpu")
    _ref_m, m = _maps(32, 64)
    one = rc.DivergentDriver(m, tl, 1, config=_cfgs()[1], seed=8, n_ops=16, device="cpu")
    rr = rc.RankReconciler(m, tl, mesh=mesh, config=_cfgs()[1], seed=8, n_ops=16)
    want, got = one.run(8), rr.run(8)
    assert got.rounds == want.rounds and got.converged
    assert _leaves_equal(got.merged, want.merged) == []
    assert _leaves_equal(got.states[0], want.states[0]) == []
    assert rc.ViewMerger(mesh).gather_rows([1, 2, 3]).tolist() == [[1, 2, 3]]
    with pytest.raises(ValueError, match="one process a rank"):
        rc.RankReconciler(m, tl, rank=1, n_ranks=2, mesh=mesh, config=_cfgs()[1], n_ops=16)
    rank_guard.assert_rank_identical("seam", np.zeros(2), mesh=mesh)
    assert not rank_guard.rank_checks_enabled()
