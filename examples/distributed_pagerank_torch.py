"""Distributed GraphMat on the PyTorch port: PageRank on a 4×2 grid of
ranks.

The port's counterpart of ``examples/distributed_pagerank.py``: the 2-D
partitioned graph, the block generalized SpMV and the semiring-aware
cross-rank reduction of ``repro_torch.core.distributed``, one spawned
process per block over a ``torch.distributed`` group on ``localhost``.
Every rank puts its block on ``--device`` (default ``cuda``).  The eight
ranks share one card over a gloo group: NCCL takes one rank a card.

The reference asks for ``pagerank_program(tol=1e-6)``, which its
``pagerank_program`` does not take (it raises ``TypeError``).  Here PageRank
at a tolerance is what ``pagerank(..., tol=...)`` runs in both packages:
delta-PageRank, rank₀ = Δ₀ = r, a vertex active while |Δ| > tol.  The
printed top-5 are the shuffled ids, as the reference prints them under the
label "original ids".

The ranks import this module by name to find :func:`rank_pagerank`: run
it as a script, or import it as ``distributed_pagerank_torch`` with
``examples/`` on ``sys.path``.

  PYTHONPATH=src python examples/distributed_pagerank_torch.py [--device cpu]
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.algos.pagerank import delta_pagerank_program
from repro_torch.core import distributed as D
from repro_torch.graphs import (dedupe_edges, remove_self_loops, rmat_edges,
                                shuffle_vertices)

R_DAMP = 0.15
TOL = 1e-6
MAX_ITERS = 50
GRID = (4, 2)  # R × C ranks


def rank_pagerank(grid, graph_dir: str, out_deg: torch.Tensor,
                  device: str) -> dict:
  """One rank: delta-PageRank on its block; the global ranks (on the
  host), the supersteps, the final frontier and the run's seconds."""
  block = D.DistGraph.load(graph_dir).block(grid.i, grid.j, device=device)
  dev = block.device
  n_pad = out_deg.shape[0]
  prop = {"rank": torch.full((n_pad,), R_DAMP, device=dev),
          "delta": torch.full((n_pad,), R_DAMP, device=dev),
          "deg": out_deg.to(dev)}
  active = torch.ones((n_pad,), dtype=torch.bool, device=dev)
  t0 = time.perf_counter()
  final = D.run_graph_program_2d(block, delta_pagerank_program(R_DAMP, TOL),
                                 prop, active, grid, max_iters=MAX_ITERS)
  supersteps = int(final.iteration)
  seconds = time.perf_counter() - t0
  return {"rank": final.prop["rank"].cpu(), "supersteps": supersteps,
          "num_active": int(final.num_active), "seconds": seconds}


def pagerank_2d(scale: int = 12, device="cuda") -> dict:
  """RMAT (seed 21, edge factor 8) shuffled for load balance (seed 3),
  partitioned over the 4×2 grid and run by its 8 ranks at tolerance
  ``TOL`` for at most ``MAX_ITERS`` supersteps.  Returns rank 0's ranks
  over the ``n`` real vertices (shuffled ids), the top-5 shuffled ids, the
  permutation, the supersteps and the slowest rank's seconds."""
  dev = resolve_device(device)
  src, dst = rmat_edges(scale, 8, seed=21)
  src, dst = remove_self_loops(src, dst)
  src, dst = dedupe_edges(src, dst)
  n = 1 << scale
  # Load-balance shuffle (the paper's over-partitioning analogue).
  src, dst, perm = shuffle_vertices(src, dst, n, seed=3)
  dg = D.partition_2d(src, dst, None, n=n, R=GRID[0], C=GRID[1])
  out_deg = torch.from_numpy(
      np.bincount(src, minlength=dg.n_pad).astype(np.float32))
  with tempfile.TemporaryDirectory() as graph_dir:
    dg.save(graph_dir)
    ranks = D.launch(rank_pagerank, *GRID, graph_dir, out_deg, str(dev),
                     backend="gloo")
  rank = ranks[0]["rank"].numpy()[:n]
  return {"n": n, "n_pad": dg.n_pad, "capacity": int(dg.src.shape[-1]),
          "ranks": rank, "top": np.argsort(-rank)[:5].tolist(),
          "perm": perm, "supersteps": ranks[0]["supersteps"],
          "num_active": ranks[0]["num_active"],
          "every_rank_equal": all(torch.equal(r["rank"], ranks[0]["rank"])
                                  for r in ranks),
          "seconds": max(r["seconds"] for r in ranks)}


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)
  out = pagerank_2d(12, device=args.device)
  print(f"mesh 4×2, n={out['n']} padded to {out['n_pad']}, "
        f"block capacity {out['capacity']} edges")
  print(f"converged in {out['supersteps']} supersteps "
        f"(tolerance frontier emptied)")
  print("top-5 (original ids):", out["top"])
  return out


if __name__ == "__main__":
  main()
