"""Edge-list preprocessing, mirroring the paper's Section 5.1 pipeline:

self-loop removal → (algorithm-specific) symmetrization for BFS, DAG
orientation for TC, bipartite construction for CF — plus a degree-randomizing
vertex shuffle used by the 2-D partitioner for load balance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def remove_self_loops(src: np.ndarray, dst: np.ndarray, *extras):
  keep = src != dst
  out = [src[keep], dst[keep]] + [e[keep] for e in extras]
  return tuple(out)


def dedupe_edges(src: np.ndarray, dst: np.ndarray,
                 w: Optional[np.ndarray] = None):
  """Remove duplicate (src, dst) pairs (first occurrence wins)."""
  n = int(max(src.max(initial=0), dst.max(initial=0))) + 1
  key = src.astype(np.int64) * n + dst.astype(np.int64)
  _, idx = np.unique(key, return_index=True)
  idx.sort()
  if w is None:
    return src[idx], dst[idx]
  return src[idx], dst[idx], w[idx]


def symmetrize(src: np.ndarray, dst: np.ndarray,
               w: Optional[np.ndarray] = None):
  """Replicate edges in both directions and dedupe (paper: BFS prep)."""
  s = np.concatenate([src, dst])
  d = np.concatenate([dst, src])
  if w is None:
    return dedupe_edges(s, d)
  return dedupe_edges(s, d, np.concatenate([w, w]))


def dag_orient(src: np.ndarray, dst: np.ndarray):
  """Symmetrize then keep upper-triangle edges (paper: TC prep —
  'discard the edges in the lower triangle of the adjacency matrix')."""
  s, d = symmetrize(src, dst)
  keep = s < d
  return s[keep], d[keep]


def shuffle_vertices(src: np.ndarray, dst: np.ndarray, n: int, seed: int = 0):
  """Random vertex relabeling — equalizes block populations for the 2-D
  partitioner (the static-shape analogue of the paper's over-partitioning)."""
  rng = np.random.default_rng(seed)
  perm = rng.permutation(n).astype(np.int32)
  return perm[src], perm[dst], perm
