"""Similarity-graph construction + community clustering.

Port of ``openobj_tpu.perception.graph`` (numpy). Parity with the
reference ``MaskGraph`` (maskclustering/mask_graph.py:31-122) and
``filter_id`` (:140-147):

  * weighted mode (the shipped configs, config/room_0.yaml): edge (i, j)
    exists iff w_geo*geo + w_cap*cap + w_clip*clip + w_color*color
    + w_geo2d*geo2d >= 1.0, with the weighted sum as edge weight;
  * threshold mode: all four cues above their thresholds;
  * Louvain community detection over the weighted graph, in the native
    C++ implementation (``native/louvain.cc``); the reference's Greedy
    (greedy_modularity_communities) and GNewman (first girvan_newman
    level, mask_graph.py:109-121) alternatives run on networkx, which only
    those two methods import;
  * clusters observed <= frame_count/50 times across the sequence are
    junked to id 999.
"""

from __future__ import annotations

import numpy as np

JUNK_ID = 999


def build_adjacency(
    geo: np.ndarray,
    cap: np.ndarray,
    clip: np.ndarray,
    color: np.ndarray,
    geo2d: np.ndarray | None = None,
    method: str = "weighted",
    weights: dict | None = None,
):
    """Returns (adjacency [M, M] bool, weighted [M, M] float)."""
    w = {
        "geo": 0.30, "cap": 0.20, "clip": 0.30, "color": 0.20, "geo2d": 0.60,
    }
    if weights:
        w.update(weights)
    if geo2d is None:
        geo2d = np.zeros_like(geo)
    if method == "weighted":
        weighted = (
            geo * w["geo"] + cap * w["cap"] + clip * w["clip"]
            + color * w["color"] + geo2d * w["geo2d"]
        )
        adj = weighted >= 1.0
    elif method == "threshold":
        adj = (
            (geo > w["geo"]) & (cap > w["cap"]) & (clip > w["clip"])
            & (color > w["color"])
        )
        weighted = adj.astype(np.float64)
    else:
        raise ValueError(f"unknown graph method {method}")
    np.fill_diagonal(adj, False)
    return adj, weighted


def louvain_cluster(
    adj: np.ndarray, weighted: np.ndarray, seed: int = 0,
    method: str = "Louvain", use_native: bool = True,
) -> list[int]:
    """Cluster ids per node (mask), from weighted community detection.

    Louvain runs in the native C++ implementation (native/louvain.cc);
    the port has no networkx Louvain, so ``use_native=False`` raises.
    Greedy and GNewman need networkx."""
    m = adj.shape[0]
    ii, jj = np.nonzero(np.triu(adj, 1))
    if method == "Louvain":
        if not use_native:
            raise ValueError("the port runs Louvain natively only (use_native=True)")
        from openobj_torch import native

        labels = native.louvain_labels(ii, jj, weighted[ii, jj], m, seed=seed + 1)
        return _skip_junk_id([int(x) for x in labels])
    if method in ("Greedy", "GNewman"):
        try:
            import networkx as nx
        except ImportError as e:
            raise ImportError(
                f"graph method {method!r} needs networkx, which is not "
                "installed; the default method 'Louvain' does not") from e
        g = nx.Graph()
        g.add_nodes_from(range(m))
        g.add_weighted_edges_from(
            (int(a), int(b), float(weighted[a, b])) for a, b in zip(ii, jj)
        )
        if method == "Greedy":
            comms = nx.community.greedy_modularity_communities(g, weight="weight")
        else:
            # reference mask_cluster(method="GNewman") takes the FIRST level
            # of the girvan_newman hierarchy (mask_graph.py:109-121)
            comms = next(nx.community.girvan_newman(g))
    else:
        raise ValueError(f"unknown clustering method {method}")
    ids = [0] * m
    for cid, comm in enumerate(comms):
        for node in comm:
            ids[node] = cid
    return _skip_junk_id(ids)


def _skip_junk_id(ids: list[int]) -> list[int]:
    """Community labels are dense 0..k-1; on scenes with >= 1000
    communities a REAL cluster would land on the junk sentinel 999 and be
    silently erased downstream — shift labels >= JUNK_ID up by one."""
    return [i + 1 if i >= JUNK_ID else i for i in ids]


def filter_rare_ids(cluster_ids: list[int], max_count: int) -> list[int]:
    """Clusters observed <= max_count times -> JUNK_ID (reference
    filter_id, mask_graph.py:140-147; called with frame_count/50 at :1093)."""
    counts = {}
    for c in cluster_ids:
        counts[c] = counts.get(c, 0) + 1
    return [JUNK_ID if counts[c] <= max_count else c for c in cluster_ids]
