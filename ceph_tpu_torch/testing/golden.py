"""Golden outcomes the port is held to on the card.

``CONFIG3_UPMAP_SHA256`` is the SHA-256 of the ``pg_upmap_items`` table
that the upmap balancer leaves on BASELINE config 3: starting from
``build_skewed_osdmap(1024, pg_num=10240)``, ``Balancer(max_deviation=1.0,
max_optimizations=2000)`` runs ``optimize()`` + ``execute()`` until a
plan comes back empty.  The table is serialised by :func:`upmap_table_json`.
``tests/test_torch_balancer.py`` re-derives the constant from the
reference package's own loop, and ``chip_smoke.py`` holds the card's
table to it.
"""

from __future__ import annotations

import hashlib
import json

CONFIG3_UPMAP_SHA256 = "e065d8240f6690e7728e9ebe5f292d5ca3bc4da678b12314e6aaa098048fe166"


def upmap_table_json(pg_upmap_items: dict) -> str:
    """``[[pool, ps, [[from, to], ...]], ...]`` sorted, without spaces;
    works on either package's ``PGId`` keys."""
    rows = sorted([pg.pool, pg.ps, [list(p) for p in items]]
                  for pg, items in pg_upmap_items.items())
    return json.dumps(rows, separators=(",", ":"))


def upmap_table_sha256(pg_upmap_items: dict) -> str:
    return hashlib.sha256(upmap_table_json(pg_upmap_items).encode()).hexdigest()
