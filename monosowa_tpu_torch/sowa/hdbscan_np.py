"""Exact HDBSCAN (numpy, host-side) for the outlier-ensemble vote.

Behavioral contract: the reference's fifth ensemble voter is
``hdbscan.HDBSCAN()`` noise on standardized points
(pseudo_label_generator/3d/scripts/loader.py:4112-4115).  This module is
the real algorithm (not a second DBSCAN at a larger scale), differentially
tested against scikit-learn's ``sklearn.cluster.HDBSCAN`` (same algorithm,
same defaults: ``min_cluster_size=5``, ``min_samples=None`` ->
``min_cluster_size``, Euclidean, excess-of-mass cluster selection, no
single-cluster root).

The full pipeline for ~1e3-point candidate clouds is cheap on the host:
O(N^2) brute-force core distances + Prim's MST, then linear-size tree work.
HDBSCAN's hierarchy extraction is inherently sequential (union-find +
tree condensation), which is why this stays a numpy host stage rather than
a device one: it contributes one vote of five in a host-side filter that
runs once per aggregated candidate.

A numpy copy of the JAX package's ``sowa/hdbscan_np.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hdbscan_labels", "hdbscan_noise"]

_INF_LAMBDA = 1e18


def _core_distances(x: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Pairwise distances and distance to the k-th nearest neighbor
    (the point itself counts as neighbor 1, matching sklearn's
    ``NearestNeighbors`` on its own training set)."""
    d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
    np.maximum(d2, 0.0, out=d2)
    d = np.sqrt(d2)
    kth = np.partition(d, k - 1, axis=1)[:, k - 1]
    return d, kth


def _mst_prim(w: np.ndarray) -> np.ndarray:
    """Minimum spanning tree of a dense symmetric weight matrix.

    Returns (N-1, 3) rows [u, v, weight] in the order edges were added.
    """
    n = w.shape[0]
    in_tree = np.zeros(n, dtype=bool)
    best = np.full(n, np.inf)
    best_from = np.zeros(n, dtype=np.int64)
    in_tree[0] = True
    best = w[0].copy()
    best[0] = np.inf
    edges = np.empty((n - 1, 3))
    for i in range(n - 1):
        v = int(np.argmin(np.where(in_tree, np.inf, best)))
        edges[i] = (best_from[v], v, best[v])
        in_tree[v] = True
        upd = (~in_tree) & (w[v] < best)
        best_from[upd] = v
        best[upd] = w[v][upd]
    return edges


def _single_linkage(edges: np.ndarray, n: int) -> np.ndarray:
    """Union-find single-linkage over MST edges sorted by weight.

    Returns (N-1, 4) rows [left_node, right_node, dist, size] where new
    internal nodes are numbered N .. 2N-2 in merge order (scipy layout).
    """
    # NOTE: default (introsort) argsort, deliberately NOT stable — under the
    # pervasive equal-weight ties of mutual-reachability graphs the merge
    # order of equal edges determines the dendrogram shape, and sklearn's
    # HDBSCAN sorts its MST with a plain np.argsort (hdbscan.py:165); using
    # the same sort makes the full pipeline tie-for-tie comparable.
    order = np.argsort(edges[:, 2])
    parent = np.arange(2 * n - 1, dtype=np.int64)
    size = np.ones(2 * n - 1, dtype=np.int64)

    def find(a: int) -> int:
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    out = np.empty((n - 1, 4))
    nxt = n
    for row, ei in enumerate(order):
        u, v, dist = edges[ei]
        ru, rv = find(int(u)), find(int(v))
        out[row] = (ru, rv, dist, size[ru] + size[rv])
        parent[ru] = parent[rv] = nxt
        size[nxt] = size[ru] + size[rv]
        nxt += 1
    return out


def _condense(linkage: np.ndarray, n: int, min_cluster_size: int):
    """Condense the dendrogram: keep only splits where both sides have
    >= min_cluster_size points; smaller sides "fall out" as points.

    Returns parallel arrays (parent, child, lam, child_size) with cluster
    ids renumbered from n upward (root = n).
    """
    root = 2 * n - 2
    children = {}
    for i in range(n - 1):
        children[n + i] = (int(linkage[i, 0]), int(linkage[i, 1]),
                           float(linkage[i, 2]))

    def leaves(node: int) -> list[int]:
        acc, stack = [], [node]
        while stack:
            cur = stack.pop()
            if cur < n:
                acc.append(cur)
            else:
                l, r, _ = children[cur]
                stack.extend((l, r))
        return acc

    relabel = {root: n}
    next_label = n + 1
    p_arr: list[int] = []
    c_arr: list[int] = []
    l_arr: list[float] = []
    s_arr: list[int] = []

    def emit(parent: int, child: int, lam: float, csize: int) -> None:
        p_arr.append(parent)
        c_arr.append(child)
        l_arr.append(lam)
        s_arr.append(csize)

    # Iterative DFS over cluster nodes only.
    stack = [root]
    while stack:
        node = stack.pop()
        lab = relabel[node]
        l, r, dist = children[node]
        lam = 1.0 / dist if dist > 0 else _INF_LAMBDA
        lam = min(lam, _INF_LAMBDA)
        lsz = 1 if l < n else int(linkage[l - n, 3])
        rsz = 1 if r < n else int(linkage[r - n, 3])
        big_l = lsz >= min_cluster_size
        big_r = rsz >= min_cluster_size
        if big_l and big_r:
            # min_cluster_size >= 2, so a "big" side is always an internal
            # node (size >= 2), never a leaf point.
            for side, sz in ((l, lsz), (r, rsz)):
                relabel[side] = next_label
                emit(lab, next_label, lam, sz)
                next_label += 1
                stack.append(side)
        elif not big_l and not big_r:
            for p in leaves(l):
                emit(lab, p, lam, 1)
            for p in leaves(r):
                emit(lab, p, lam, 1)
        else:
            keep, drop = (l, r) if big_l else (r, l)
            for p in leaves(drop):
                emit(lab, p, lam, 1)
            relabel[keep] = lab
            stack.append(keep)
    return (np.asarray(p_arr), np.asarray(c_arr),
            np.asarray(l_arr), np.asarray(s_arr))


def _stability(parent: np.ndarray, child: np.ndarray, lam: np.ndarray,
               csize: np.ndarray, n: int) -> dict[int, float]:
    """Cluster stability: sum over members of (lambda_leave - lambda_birth)."""
    births: dict[int, float] = {n: 0.0}
    for p, c, la in zip(parent, child, lam):
        if c >= n:
            births[int(c)] = float(la)
    stab: dict[int, float] = {}
    for p, la, sz in zip(parent, lam, csize):
        p = int(p)
        stab[p] = stab.get(p, 0.0) + (float(la) - births[p]) * int(sz)
    return stab


def hdbscan_labels(x: np.ndarray, min_cluster_size: int = 5,
                   min_samples: int | None = None) -> np.ndarray:
    """Exact HDBSCAN labels (-1 = noise), excess-of-mass selection."""
    if min_cluster_size < 2:
        raise ValueError("min_cluster_size must be >= 2")
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if min_samples is None:
        min_samples = min_cluster_size
    if n < 2 or n < min_samples or n < min_cluster_size:
        return np.full(n, -1, dtype=np.int64)

    d, core = _core_distances(x, min_samples)
    mreach = np.maximum(np.maximum(core[:, None], core[None, :]), d)
    np.fill_diagonal(mreach, np.inf)
    linkage = _single_linkage(_mst_prim(mreach), n)
    parent, child, lam, csize = _condense(linkage, n, min_cluster_size)

    stab = _stability(parent, child, lam, csize, n)
    kids: dict[int, list[int]] = {}
    for p, c in zip(parent, child):
        if c >= n:
            kids.setdefault(int(p), []).append(int(c))

    # Excess-of-mass, bottom-up (higher labels are deeper).  The root
    # cluster (label n) is never selected (allow_single_cluster=False).
    clusters = sorted(stab.keys(), reverse=True)
    selected: dict[int, bool] = {}
    for c in clusters:
        sub = sum(stab[k] for k in kids.get(c, ()) if k in stab)
        if c == n:
            selected[c] = False
            continue
        if stab[c] < sub or not np.isfinite(stab[c]):
            selected[c] = False
            stab[c] = sub
        else:
            selected[c] = True
            # deselect the whole subtree
            stack = list(kids.get(c, ()))
            while stack:
                k = stack.pop()
                if k in stab:
                    selected[k] = False
                    stack.extend(kids.get(k, ()))

    chosen = sorted(c for c, s in selected.items() if s)
    label_of = {c: i for i, c in enumerate(chosen)}
    cluster_parent = {int(c): int(p) for p, c in zip(parent, child) if c >= n}

    point_parent = np.full(n, n, dtype=np.int64)
    for p, c in zip(parent, child):
        if c < n:
            point_parent[int(c)] = int(p)

    labels = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        c = int(point_parent[i])
        while True:
            if selected.get(c, False):
                labels[i] = label_of[c]
                break
            if c == n:
                break
            c = cluster_parent[c]
    return labels


def hdbscan_noise(x: np.ndarray, min_cluster_size: int = 5,
                  min_samples: int | None = None) -> np.ndarray:
    """Boolean noise flags — the reference ensemble's fifth vote
    (loader.py:4112-4115: ``hdbscan_labels == -1``)."""
    return hdbscan_labels(x, min_cluster_size, min_samples) == -1
