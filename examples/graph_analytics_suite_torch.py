"""All five paper algorithms end-to-end on RMAT + road-style graphs, on the
PyTorch port.

The port's counterpart of ``examples/graph_analytics_suite.py``: PageRank,
BFS, SSSP on a road-style grid, triangle counting and collaborative
filtering through ``repro_torch.algos``, on the card unless ``--device cpu``
is given.  Collaborative filtering draws its initial factors from a seeded
``torch.Generator``, whose draws are not ``jax.random``'s, so its RMSE is
not the reference's; :func:`collaborative_filtering_section` takes ``p0``
to start from a given draw instead.

  PYTHONPATH=src python examples/graph_analytics_suite_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.algos import (bfs, collaborative_filtering, pagerank, sssp,
                               triangle_count)
from repro_torch.algos.collab_filter import build_bipartite
from repro_torch.core import graph as G
from repro_torch.graphs import (bipartite_ratings, dag_orient, dedupe_edges,
                                remove_self_loops, rmat_edges, symmetrize)
from repro_torch.graphs.rmat import RMAT_PRBFS, RMAT_TC


def grid_road_graph(w_side=48, seed=0):
  """A USA-road-style mesh: 2-D grid with random weights (DIMACS flavor)."""
  n = w_side * w_side
  rng = np.random.default_rng(seed)
  src, dst = [], []
  for r in range(w_side):
    for c in range(w_side):
      v = r * w_side + c
      if c + 1 < w_side:
        src += [v, v + 1]; dst += [v + 1, v]
      if r + 1 < w_side:
        src += [v, v + w_side]; dst += [v + w_side, v]
  w = rng.uniform(1.0, 10.0, len(src)).astype(np.float32)
  return n, np.array(src, np.int32), np.array(dst, np.int32), w


def rmat_graph(scale: int):
  """The PageRank/BFS input: RMAT with the paper's PR/BFS parameters, edge
  factor 8, seed 1, self-loops and duplicates removed."""
  src, dst = rmat_edges(scale, 8, RMAT_PRBFS, seed=1)
  src, dst = remove_self_loops(src, dst)
  src, dst = dedupe_edges(src, dst)
  return src, dst, 1 << scale


def pagerank_section(scale: int = 11, device="cuda"):
  """20 PageRank sweeps on the RMAT graph (ELL): ``(ranks, top-5 ids)``."""
  src, dst, n = rmat_graph(scale)
  out_deg = torch.from_numpy(np.bincount(src, minlength=n).astype(np.float32))
  g = G.build_ell(src, dst, n=n, device=device)
  ranks = pagerank(g, out_deg, num_iters=20)
  top = np.argsort(-ranks.cpu().numpy())[:5]
  return ranks, top.tolist()


def bfs_section(scale: int = 11, device="cuda"):
  """BFS from vertex 0 on the symmetrized RMAT graph (ELL): ``(hops,
  eccentricity)``."""
  src, dst, n = rmat_graph(scale)
  ss, dd = symmetrize(src, dst)
  d = bfs(G.build_ell(ss, dd, n=n, device=device), 0, n)
  h = d.cpu().numpy()
  return d, int(np.max(h[h < 2**30]))


def road_sssp_section(w_side: int = 48, device="cuda"):
  """SSSP from vertex 0 on the road-style grid (COO): ``(distances, mean
  distance)``."""
  rn, rs, rd, rw = grid_road_graph(w_side)
  dist = sssp(G.build_coo(rs, rd, rw, n=rn, device=device), 0, rn)
  return dist, float(np.mean(dist.cpu().numpy()))


def triangle_section(scale: int = 10, device="cuda") -> int:
  """Triangles of the DAG-oriented RMAT graph with the paper's TC
  parameters (seed 2)."""
  ts, td = rmat_edges(scale, 8, RMAT_TC, seed=2)
  ts, td = remove_self_loops(ts, td)
  ts, td = dag_orient(ts, td)
  tn = 1 << scale
  tc = triangle_count(G.build_coo(ts, td, n=tn, device=device),
                      G.build_coo(td, ts, n=tn, device=device), tn)
  return int(tc)


def collaborative_filtering_section(num_iters: int = 20, device="cuda",
                                    p0=None):
  """Collaborative filtering (K = 16) on a Netflix-style bipartite graph of
  3000 users × 500 items, 12 ratings a user (seed 4): ``(factors, rmse,
  constant-predictor baseline)``.  The initial factors are ``p0`` when
  given, else drawn from ``torch.Generator`` seed 0."""
  users, items, ratings = bipartite_ratings(3000, 500, 12, seed=4)
  g2u, g2i, ncf = build_bipartite(users, items, ratings, 3000, 500,
                                  device=device)
  gen = (None if p0 is not None
         else torch.Generator(device=g2u.device).manual_seed(0))
  P = collaborative_filtering(g2u, g2i, ncf, k=16, num_iters=num_iters,
                              gamma=0.01, lam=0.05, p0=p0, generator=gen)
  p = P.cpu().numpy()
  pred = np.sum(p[users] * p[items + 3000], -1)
  rmse = float(np.sqrt(np.mean((pred - ratings) ** 2)))
  base = float(np.std(ratings))
  return P, rmse, base


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)
  device = resolve_device(args.device)
  scale = 11

  print("== PageRank (RMAT scale", scale, ") ==")
  _, top = pagerank_section(scale, device)
  print("top-5 vertices:", top)

  print("== BFS ==")
  _, ecc = bfs_section(scale, device)
  print("eccentricity from 0:", ecc)

  print("== SSSP on road-style grid ==")
  _, mean = road_sssp_section(48, device)
  print(f"mean shortest distance: {mean:.2f}")

  print("== Triangle counting ==")
  print("triangles:", triangle_section(scale - 1, device))

  print("== Collaborative filtering (Netflix-style bipartite) ==")
  _, rmse, base = collaborative_filtering_section(device=device)
  print(f"RMSE {rmse:.3f} (constant-predictor baseline {base:.3f})")


if __name__ == "__main__":
  main()
