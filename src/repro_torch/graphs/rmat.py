"""Synthetic graph generators (host-side numpy; this is the data pipeline).

* :func:`rmat_edges` — the Graph500 RMAT recursive-quadrant generator used by
  the paper (Section 5.1).  Paper parameter sets:
  ``A=0.57, B=C=0.19`` (PR/BFS/SSSP), ``A=0.45, B=C=0.15`` (TC),
  ``A=0.50, B=C=0.10`` (SSSP scale-24 match vs. [13, 24]).
* :func:`bipartite_ratings` — Netflix-like bipartite rating graphs for CF,
  following the synthetic generator description in [27].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Paper parameter presets.
RMAT_PRBFS = (0.57, 0.19, 0.19)
RMAT_TC = (0.45, 0.15, 0.15)
RMAT_SSSP24 = (0.50, 0.10, 0.10)


def rmat_edges(scale: int, edge_factor: int = 16,
               abc: Tuple[float, float, float] = RMAT_PRBFS,
               seed: int = 0, noise: float = 0.1
               ) -> Tuple[np.ndarray, np.ndarray]:
  """Vectorized RMAT: returns (src, dst) int32 arrays, length n*edge_factor.

  Each of ``scale`` bit levels picks a quadrant per edge from (A, B, C, D)
  with multiplicative noise per level (standard Graph500 smoothing).
  """
  a, b, c = abc
  n_edges = (1 << scale) * edge_factor
  rng = np.random.default_rng(seed)
  src = np.zeros(n_edges, np.int64)
  dst = np.zeros(n_edges, np.int64)
  for level in range(scale):
    # Jitter quadrant probabilities per level.
    f = 1.0 + noise * (2 * rng.random(4) - 1.0)
    pa, pb, pc, pd = a * f[0], b * f[1], c * f[2], (1 - a - b - c) * f[3]
    norm = pa + pb + pc + pd
    pa, pb, pc = pa / norm, pb / norm, pc / norm
    u = rng.random(n_edges)
    src_bit = (u >= pa + pb).astype(np.int64)
    # P(dst_bit=1 | src_bit) — quadrant decomposition.
    dst_bit = np.where(
        src_bit == 0,
        (u >= pa).astype(np.int64),                      # within top: B region
        (u >= pa + pb + pc).astype(np.int64))            # within bottom: D
    src |= src_bit << level
    dst |= dst_bit << level
  return src.astype(np.int32), dst.astype(np.int32)


def bipartite_ratings(num_users: int, num_items: int, ratings_per_user: int,
                      seed: int = 0, item_skew: float = 1.2
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Netflix-like bipartite rating graph.

  Returns (user_idx, item_idx, rating) with items drawn from a Zipf-ish
  popularity distribution and ratings in [1, 5].
  """
  rng = np.random.default_rng(seed)
  pop = (np.arange(1, num_items + 1, dtype=np.float64)) ** (-item_skew)
  pop /= pop.sum()
  users = np.repeat(np.arange(num_users, dtype=np.int32), ratings_per_user)
  items = rng.choice(num_items, size=users.shape[0], p=pop).astype(np.int32)
  # Dedupe (user, item) pairs.
  key = users.astype(np.int64) * num_items + items
  _, uniq = np.unique(key, return_index=True)
  users, items = users[uniq], items[uniq]
  ratings = rng.integers(1, 6, users.shape[0]).astype(np.float32)
  return users, items, ratings
