"""Legacy bucket algorithms: straw1 / list / tree builder computations.

The reference keeps per-bucket derived state for its legacy bucket
types (upstream ``src/crush/builder.c``): ``sum_weights`` prefix sums
for list buckets, the float-computed ``straws`` scaling factors for
straw(1) buckets (``crush_calc_straw``), and the binary-tree
``node_weights`` array for tree buckets (``crush_make_tree_bucket``).
This module computes those arrays host-side from the recorded upstream
semantics; the C++ reference tier (``cpp/crush_ref.cpp``) and the test
oracle (:mod:`tests.test_crush_legacy`) consume them.

These algorithms are legacy for a reason — straw1's scaling skews for
>2 distinct weight classes (the motivation for straw2) and list/tree
reorganize data on most topology changes — so no device engine
implements them; maps containing them route to the exact C++ tier
(:func:`ceph_tpu_torch.crush.engine.make_batch_runner`).
"""

from __future__ import annotations

import math

import numpy as np


def list_sum_weights(weights: list[int]) -> list[int]:
    """Prefix sums of item weights (upstream list-bucket sum_weights)."""
    out = []
    acc = 0
    for w in weights:
        acc += int(w)
        out.append(acc)
    return out


def calc_straws(weights: list[int]) -> list[int]:
    """16.16 straw scaling factors (upstream crush_calc_straw).

    Items draw ``(hash & 0xffff) * straws[i]``; the scaling makes the
    argmax winner's probability track the weights for <= 2 distinct
    weight classes (the legacy algorithm's known skew beyond that is
    part of its semantics).  This is the ``straw_calc_version 1``
    algorithm — the fixed builder upstream defaults to; the buggier
    version-0 accumulation is not reproduced.
    """
    size = len(weights)
    straws = [0] * size
    if size == 0:
        return straws
    # stable insertion sort ascending by weight (upstream's loop)
    reverse = [0]
    for i in range(1, size):
        for j in range(i):
            if weights[i] < weights[reverse[j]]:
                reverse.insert(j, i)
                break
        else:
            reverse.append(i)

    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0

    i = 0
    while i < size:
        if weights[reverse[i]] == 0:
            straws[reverse[i]] = 0
            i += 1
            continue
        straws[reverse[i]] = min(int(straw * 0x10000), 0xFFFFFFFF)
        i += 1
        if i == size:
            break
        if weights[reverse[i]] == weights[reverse[i - 1]]:
            continue  # same weight class, same straw
        wbelow += (weights[reverse[i - 1]] - lastw) * numleft
        for j in range(i, size):
            if weights[reverse[j]] == weights[reverse[i]]:
                numleft -= 1
            else:
                break
        wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
        pbelow = wbelow / (wbelow + wnext)
        straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
        lastw = weights[reverse[i - 1]]
    return straws


def tree_depth(size: int) -> int:
    """Depth of the tree covering ``size`` leaves (upstream calc_depth)."""
    if size == 0:
        return 0
    depth = 1
    t = size - 1
    while t:
        t >>= 1
        depth += 1
    return depth


def tree_node_count(size: int) -> int:
    return 1 << tree_depth(size)


def _height(n: int) -> int:
    h = 0
    while n and (n & 1) == 0:
        h += 1
        n >>= 1
    return h


def _parent(n: int) -> int:
    h = _height(n)
    if n & (1 << (h + 1)):
        return n - (1 << h)
    return n + (1 << h)


def tree_node_weights(weights: list[int]) -> list[int]:
    """Node-weight array for a tree bucket: item i at node 2i+1, each
    internal node the sum of its subtree (upstream crush_make_tree_bucket)."""
    size = len(weights)
    if size == 0:
        return [0]
    depth = tree_depth(size)
    num_nodes = 1 << depth
    node_w = [0] * num_nodes
    root = num_nodes >> 1
    for i, w in enumerate(weights):
        node = 2 * i + 1
        node_w[node] = int(w)
        while node != root:
            node = _parent(node)
            node_w[node] += int(w)
    return node_w


def aux_arrays(
    algs: np.ndarray,
    sizes: np.ndarray,
    weights: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, int] | None:
    """Per-bucket aux table for a dense map: column-packed
    (straws-or-sums [n, max_fanout], tree_nodes [n, max_tree_nodes],
    max_tree_nodes); None when no legacy algs are present."""
    from .map import ALG_LIST, ALG_STRAW, ALG_TREE

    n, max_fanout = weights.shape
    present = set(int(a) for a in np.unique(algs[sizes > 0]))
    if not present & {ALG_LIST, ALG_STRAW, ALG_TREE}:
        return None
    max_nodes = 1
    for b in range(n):
        if algs[b] == ALG_TREE and sizes[b] > 0:
            max_nodes = max(max_nodes, tree_node_count(int(sizes[b])))
    scaled = np.zeros((n, max_fanout), np.uint32)  # straws or sum_weights
    tree_w = np.zeros((n, max_nodes), np.uint32)
    for b in range(n):
        sz = int(sizes[b])
        if sz == 0:
            continue
        ws = [int(w) for w in weights[b, :sz]]
        if algs[b] == ALG_LIST:
            scaled[b, :sz] = list_sum_weights(ws)
        elif algs[b] == ALG_STRAW:
            scaled[b, :sz] = calc_straws(ws)
        elif algs[b] == ALG_TREE:
            nw = tree_node_weights(ws)
            tree_w[b, : len(nw)] = nw
    return scaled, tree_w, max_nodes
