"""Exact DBSCAN on scipy's ``cKDTree``.

The JAX package clusters with ``sklearn.cluster.DBSCAN``, which the card's
machine does not have. This is the same algorithm with the same labels,
label for label:

  * the neighbourhood of a point is every point (itself included) within
    Euclidean distance ``<= eps``; a point is a core point when its
    neighbourhood holds at least ``min_samples`` points;
  * clusters are the connected components of the core points under that
    neighbourhood, numbered 0, 1, ... in the order of each component's
    lowest core index (sklearn expands clusters depth-first from the lowest
    unlabelled core index, one cluster at a time);
  * a non-core point within ``eps`` of core points takes the lowest label
    among them (the cluster expanded first reaches it first); every other
    point is noise, -1.

Distances are computed from float64 coordinates.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree


def dbscan_labels(x: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """[N] int64 cluster labels of the rows of ``x`` ([N, D]); -1 = noise."""
    x = np.asarray(x, np.float64)
    n = len(x)
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    pairs = cKDTree(x).query_pairs(eps, output_type="ndarray").reshape(-1, 2)
    deg = np.ones(n, np.int64) + np.bincount(pairs.ravel(), minlength=n)
    core = deg >= min_samples
    if not core.any():
        return labels
    cc = pairs[core[pairs[:, 0]] & core[pairs[:, 1]]]
    graph = coo_matrix((np.ones(len(cc), np.int8), (cc[:, 0], cc[:, 1])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    core_idx = np.nonzero(core)[0]
    # number the components by their lowest core index
    uniq, first = np.unique(comp[core_idx], return_index=True)
    rank = np.empty(comp.max() + 1, np.int64)
    rank[uniq[np.argsort(first)]] = np.arange(len(uniq))
    labels[core_idx] = rank[comp[core_idx]]
    # border points: the lowest label among their core neighbours
    both = np.concatenate([pairs, pairs[:, ::-1]])
    edge = both[core[both[:, 0]] & ~core[both[:, 1]]]
    if len(edge):
        border = np.full(n, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(border, edge[:, 1], labels[edge[:, 0]])
        hit = border < np.iinfo(np.int64).max
        labels[hit] = border[hit]
    return labels
