"""g2o pose-graph file I/O (the port's own copy of
``d2slam_tpu/pgo/g2o_io.py``, numpy only).

Parses/writes the ``VERTEX_SE3:QUAT`` / ``EDGE_SE3:QUAT`` format used by
the reference's multi-agent DPGO test driver
(reference: d2pgo/test/posegraph_g2o.cpp read_g2o_agent /
write_result_to_g2o). Quaternions on disk are (qx qy qz qw), matching
our internal xyzw convention. Edge information matrices are stored as
the upper triangle of the 6x6 information matrix.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def read_g2o(path: str):
    """Returns (vertices: {id: pose[7]}, edges: [(i, j, rel[7], info[6,6])])."""
    vertices: Dict[int, np.ndarray] = {}
    edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "VERTEX_SE3:QUAT":
                vid = int(parts[1])
                vals = np.array([float(x) for x in parts[2:9]])
                vertices[vid] = vals
            elif tag == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                vals = [float(x) for x in parts[3:]]
                rel = np.array(vals[:7])
                triu = vals[7:28]
                info = np.zeros((6, 6))
                k = 0
                for r in range(6):
                    for c in range(r, 6):
                        info[r, c] = info[c, r] = triu[k]
                        k += 1
                edges.append((i, j, rel, info))
    return vertices, edges


def write_g2o(path: str, vertices: Dict[int, np.ndarray], edges=None) -> None:
    with open(path, "w") as f:
        for vid in sorted(vertices):
            p = vertices[vid]
            f.write(
                "VERTEX_SE3:QUAT %d %.9f %.9f %.9f %.9f %.9f %.9f %.9f\n"
                % (vid, *p)
            )
        for (i, j, rel, info) in edges or []:
            triu = [info[r, c] for r in range(6) for c in range(r, 6)]
            f.write(
                "EDGE_SE3:QUAT %d %d " % (i, j)
                + " ".join("%.9f" % x for x in rel)
                + " "
                + " ".join("%.9f" % x for x in triu)
                + "\n"
            )
