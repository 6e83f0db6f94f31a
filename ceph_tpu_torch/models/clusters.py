"""Synthetic cluster-map builders (the framework's "model zoo").

Equivalents of the reference's synthetic map constructors used
throughout its tests and tools (upstream ``OSDMap::build_simple`` in
``src/osd/OSDMap.cc`` and ``crushtool --build``): generate flat or
multi-tier CRUSH hierarchies from device counts, for tests and
benchmarks.
"""

from __future__ import annotations

from ..crush.map import ALG_STRAW2, CrushMap, Tunables

W1 = 0x10000  # weight 1.0 in 16.16


def build_flat(n_osds: int, weight: int = W1, alg: int = ALG_STRAW2,
               tunables: Tunables | None = None) -> CrushMap:
    """One root bucket holding all OSDs."""
    m = CrushMap(tunables)
    m.add_type(1, "root")
    root = m.add_bucket("default", "root", alg=alg)
    for o in range(n_osds):
        m.insert_item(root.id, o, weight)
    m.make_replicated_rule("replicated_rule", "default", "osd")
    return m


def build_hierarchy(
    spec: list[tuple[str, int]],
    osds_per_leaf: int,
    weight: int = W1,
    alg: int = ALG_STRAW2,
    tunables: Tunables | None = None,
    failure_domain: str | None = None,
) -> CrushMap:
    """Multi-tier map.

    ``spec`` is outer-to-inner, e.g. ``[("rack", 4), ("host", 8)]`` with
    ``osds_per_leaf=4`` builds root -> 4 racks -> 8 hosts each -> 4 osds
    each (128 OSDs).  A replicated rule over ``failure_domain`` (default:
    the innermost non-osd tier) is added.
    """
    m = CrushMap(tunables)
    m.add_type(1, "root")
    for lvl, (tname, _) in enumerate(spec):
        m.add_type(len(spec) + 1 - lvl, tname)

    osd = [0]

    def build_level(lvl: int, prefix: str) -> tuple[int, int]:
        """Returns (bucket_id, subtree weight)."""
        tname = spec[lvl][0] if lvl < len(spec) else None
        if tname is None:
            raise AssertionError
        b = m.add_bucket(f"{tname}{prefix}", tname, alg=alg)
        total = 0
        if lvl == len(spec) - 1:
            for _ in range(osds_per_leaf):
                m.insert_item(b.id, osd[0], weight)
                osd[0] += 1
                total += weight
        else:
            for j in range(spec[lvl + 1][1]):
                cid, cw = build_level(lvl + 1, f"{prefix}_{j}")
                m.insert_item(b.id, cid, cw)
                total += cw
        return b.id, total

    root = m.add_bucket("default", "root", alg=alg)
    for i in range(spec[0][1]):
        cid, cw = build_level(0, f"{i}")
        m.insert_item(root.id, cid, cw)
    fd = failure_domain or spec[-1][0]
    m.make_replicated_rule("replicated_rule", "default", fd)
    return m


def build_osdmap(
    n_osds: int,
    pg_num: int = 64,
    size: int = 3,
    pool_kind: str = "replicated",
    osds_per_host: int = 4,
    hosts_per_rack: int = 8,
):
    """Synthetic OSDMap (the ``OSDMap::build_simple`` analog): simple
    rack/host/osd CRUSH tree, one pool, all OSDs up+in."""
    from ..osdmap.map import OSDMap, Pool

    crush = build_simple(n_osds, osds_per_host, hosts_per_rack)
    if pool_kind == "erasure":
        crush.make_erasure_rule("erasure_rule", "default", "host")
    m = OSDMap(crush)
    for o in range(n_osds):
        m.add_osd(o)
    rule = crush.rule_by_name(
        "erasure_rule" if pool_kind == "erasure" else "replicated_rule"
    )
    m.add_pool(
        Pool(
            id=1,
            name="pool1",
            kind=pool_kind,
            size=size,
            pg_num=pg_num,
            pgp_num=pg_num,
            crush_rule=rule.id,
        )
    )
    return m


def build_simple(n_osds: int, osds_per_host: int = 4, hosts_per_rack: int = 8,
                 tunables: Tunables | None = None) -> CrushMap:
    """root -> racks -> hosts -> osds sized to cover ``n_osds`` devices."""
    import math

    n_hosts = math.ceil(n_osds / osds_per_host)
    n_racks = max(1, math.ceil(n_hosts / hosts_per_rack))
    m = CrushMap(tunables)
    m.add_type(1, "root")
    m.add_type(2, "rack")
    m.add_type(3, "host")
    root = m.add_bucket("default", "root")
    osd = 0
    for r in range(n_racks):
        rack = m.add_bucket(f"rack{r}", "rack")
        rack_w = 0
        for h in range(hosts_per_rack):
            if osd >= n_osds:
                break
            host = m.add_bucket(f"host{r}_{h}", "host")
            host_w = 0
            for _ in range(osds_per_host):
                if osd >= n_osds:
                    break
                m.insert_item(host.id, osd, W1)
                host_w += W1
                osd += 1
            m.insert_item(rack.id, host.id, host_w)
            rack_w += host_w
        m.insert_item(root.id, rack.id, rack_w)
    m.make_replicated_rule("replicated_rule", "default", "host")
    return m


def build_skewed(
    n_osds: int,
    seed: int = 0,
    tunables: Tunables | None = None,
) -> CrushMap:
    """Deep, heterogeneous hierarchy: root -> dcs -> racks -> hosts ->
    osds with ragged fanouts and mixed device weights (0.5x-4x).

    The uniform ``build_simple`` topology never stresses straw2 retry
    divergence or the balancer's weight handling; this one does — use
    it wherever "realistic cluster" matters (benches, property tests).
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    m = CrushMap(tunables)
    m.add_type(1, "root")
    m.add_type(2, "dc")
    m.add_type(3, "rack")
    m.add_type(4, "host")
    root = m.add_bucket("default", "root")
    osd = 0
    dc_i = rack_i = host_i = 0
    while osd < n_osds:
        dc = m.add_bucket(f"dc{dc_i}", "dc")
        dc_i += 1
        dc_w = 0
        for _ in range(int(rng.integers(2, 5))):
            if osd >= n_osds:
                break
            rack = m.add_bucket(f"rack{rack_i}", "rack")
            rack_i += 1
            rack_w = 0
            for _ in range(int(rng.integers(2, 7))):
                if osd >= n_osds:
                    break
                host = m.add_bucket(f"host{host_i}", "host")
                host_i += 1
                host_w = 0
                for _ in range(int(rng.integers(2, 9))):
                    if osd >= n_osds:
                        break
                    w = int(rng.integers(0x8000, 0x40000))  # 0.5x-4x
                    m.insert_item(host.id, osd, w)
                    host_w += w
                    osd += 1
                m.insert_item(rack.id, host.id, host_w)
                rack_w += host_w
            m.insert_item(dc.id, rack.id, rack_w)
            dc_w += rack_w
        m.insert_item(root.id, dc.id, dc_w)
    m.make_replicated_rule("replicated_rule", "default", "host")
    return m


def build_skewed_osdmap(
    n_osds: int,
    pg_num: int = 1024,
    size: int = 3,
    seed: int = 0,
):
    """OSDMap over :func:`build_skewed` (one replicated pool)."""
    from ..osdmap.map import OSDMap, Pool

    crush = build_skewed(n_osds, seed=seed)
    m = OSDMap(crush)
    for o in range(n_osds):
        m.add_osd(o)
    rule = crush.rule_by_name("replicated_rule")
    m.add_pool(
        Pool(
            id=1,
            name="pool1",
            kind="replicated",
            size=size,
            pg_num=pg_num,
            pgp_num=pg_num,
            crush_rule=rule.id,
        )
    )
    return m
