"""Streaming pose-graph partitioning across robots.

The port's own copy of ``d2slam_tpu/pgo/partitioning.py`` (numpy host
code; the results are the JAX package's, bit for bit).

The reference studies how to divide a collaborative pose graph among
agents so each solves a balanced piece with few cross-agent edges
(reference: d2pgo/scripts/pose_graph_partitioning/graph_partitioning.py
— streaming greedy vertex assignment with the FENNEL and LDG
heuristics, re-partitioned adaptively as keyframes arrive). Cross-agent
edges are exactly the consensus variables of the distributed solver
(``pgo.distributed``), so a low edge cut means fewer shared poses and
less dual traffic per ADMM round.

Array-based single-pass implementation:

  * ``stream_partition`` — FENNEL (cut-vs-balance penalty
    ``|N(v) ∩ P| − α·γ·|P|^(γ−1)`` with ν-capped part sizes) or LDG
    (``|N(v) ∩ P|·(1 − |P|/C)``) over any vertex order.
  * ``repartition`` — re-streams with stickiness toward an existing
    assignment (the adaptive re-partition of the reference, which
    scores against the OLD partitioning while filling the new one).
  * ``partition_stats`` — edge cut, balance, boundary (communication)
    volume.
  * ``partition_to_masks`` — est/own/edge masks for
    ``distributed_pgo_solve``: each robot owns its vertices, also
    estimates boundary neighbors, and is assigned each cut edge exactly
    once (lower-robot-id rule).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def build_adjacency(n: int, edges: Sequence[Tuple[int, int]]) -> List[List[int]]:
    adj: List[List[int]] = [[] for _ in range(n)]
    for i, j in edges:
        if i == j:
            continue
        adj[i].append(j)
        adj[j].append(i)
    return adj


def stream_partition(
    n: int,
    edges: Sequence[Tuple[int, int]],
    k: int,
    method: str = "fennel",
    gamma: float = 1.5,
    nu: float = 1.1,
    order: Optional[Sequence[int]] = None,
    sticky: Optional[np.ndarray] = None,
    sticky_bonus: float = 0.0,
) -> np.ndarray:
    """Assign each vertex to one of ``k`` parts in one streaming pass.

    order defaults to 0..n-1 (keyframes arrive in time order — the
    natural stream for a SLAM graph). ``sticky``/``sticky_bonus`` bias
    vertices toward a previous assignment (see ``repartition``).
    Returns parts: [n] int array in [0, k).
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    adj = build_adjacency(n, edges)
    m = max(len(edges), 1)
    alpha = m * (k ** (gamma - 1)) / (n ** gamma) if n else 0.0
    cap = nu * n / k
    C = n / k

    parts = np.full(n, -1, np.int64)
    sizes = np.zeros(k, np.float64)
    for v in (range(n) if order is None else order):
        # neighbors already placed, counted per part
        nb = np.zeros(k, np.float64)
        for u in adj[v]:
            if parts[u] >= 0:
                nb[parts[u]] += 1.0
        if method == "fennel":
            score = nb - alpha * gamma * sizes ** (gamma - 1)
            score = np.where(sizes >= cap, -np.inf, score)
        elif method == "ldg":
            # LDG breaks ties toward the least-loaded part — without it,
            # a vertex with no placed neighbors scores 0 for EVERY part
            # and argmax dumps the whole stream into part 0
            score = nb * (1.0 - sizes / C) - 1e-9 * sizes
        else:
            raise ValueError(f"unknown partition method {method!r}")
        if sticky is not None and sticky[v] >= 0:
            score[sticky[v]] += sticky_bonus
        best = int(np.argmax(score))
        parts[v] = best
        sizes[best] += 1.0
    return parts


def repartition(
    n: int,
    edges: Sequence[Tuple[int, int]],
    k: int,
    old_parts: np.ndarray,
    method: str = "fennel",
    sticky_bonus: float = 1.0,
    **kw,
) -> np.ndarray:
    """Re-stream an existing assignment (graph grew, or k changed).

    Vertices prefer their old part by ``sticky_bonus`` (in units of
    neighbor count) so only vertices whose locality genuinely moved —
    e.g. onto a new loop closure — migrate. New vertices
    (old_parts[v] < 0 or beyond its length) are placed fresh.
    """
    sticky = np.full(n, -1, np.int64)
    old = np.asarray(old_parts)
    sticky[: min(n, old.shape[0])] = np.where(
        old[: min(n, old.shape[0])] < k, old[: min(n, old.shape[0])], -1
    )
    return stream_partition(
        n, edges, k, method=method, sticky=sticky,
        sticky_bonus=sticky_bonus, **kw,
    )


def partition_stats(parts: np.ndarray,
                    edges: Sequence[Tuple[int, int]],
                    k: Optional[int] = None) -> Dict[str, object]:
    """Edge cut / balance / per-part communication volume."""
    parts = np.asarray(parts)
    k = int(parts.max()) + 1 if k is None else k
    sizes = np.bincount(parts, minlength=k).astype(float)
    cut = 0
    boundary: List[set] = [set() for _ in range(k)]
    for i, j in edges:
        a, b = parts[i], parts[j]
        if a != b:
            cut += 1
            boundary[a].add(i)
            boundary[b].add(j)
    n_e = max(len(edges), 1)
    return {
        "k": k,
        "sizes": sizes.astype(int).tolist(),
        "edge_cut": cut,
        "cut_ratio": cut / n_e,
        # max part size over ideal size (1.0 = perfectly balanced)
        "imbalance": float(sizes.max() / max(sizes.mean(), 1e-12)),
        # poses each robot must exchange duals for
        "comm_volume": [len(b) for b in boundary],
    }


def partition_to_masks(
    parts: np.ndarray,
    edge_index: np.ndarray,   # [E, 2] int (i, j) vertex ids
    n_pad: int,
    k: Optional[int] = None,
    est_mode: str = "full",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Masks for ``distributed_pgo_solve`` from a vertex partition.

    Returns (est [k, n_pad], own [k, n_pad], edge_mask [k, E]):
    own = the robot's vertices; each edge is assigned to exactly one
    robot — the lower part id of its endpoints — so no residual is
    double-counted in the consensus objective.

    est_mode:
      * ``"full"`` (reference semantics): every robot estimates the
        whole graph it knows about — the reference's drones hold the
        complete merged keyframe graph and contribute their own edges
        (d2pgo addFrame/addLoop over all received frames). Information
        from any edge reaches every pose in one round through the
        consensus average; bandwidth scales with the graph.
      * ``"boundary"``: a robot estimates only its own vertices plus
        the endpoints of its edges. Minimal dual traffic (the
        ``comm_volume`` of partition_stats), but corrections diffuse
        one partition hop per round — use many more rounds.
    """
    parts = np.asarray(parts)
    n = parts.shape[0]
    k = int(parts.max()) + 1 if k is None else k
    E = edge_index.shape[0]
    own = np.zeros((k, n_pad), bool)
    own[parts, np.arange(n)] = True
    edge_mask = np.zeros((k, E), bool)
    est = own.copy()
    for e, (i, j) in enumerate(np.asarray(edge_index)):
        a, b = int(parts[i]), int(parts[j])
        r = min(a, b)
        edge_mask[r, e] = True
        est[a, i] = est[a, j] = True
        est[b, i] = est[b, j] = True
    if est_mode == "full":
        est[:, :n] = True
    elif est_mode != "boundary":
        raise ValueError(f"unknown est_mode {est_mode!r}")
    return est, own, edge_mask
