"""Paper Fig. 4 / Table 2 analogue on the port: the five algorithms on RMAT
graphs.

The counterpart of ``benchmarks/bench_algorithms.py``: the GraphMat engine
(COO / ELL / the CUDA ELL kernel) against the native torch baselines of
``repro_torch.algos.native``, on the card unless ``device="cpu"`` is given.
Speedup columns report native_time / graphmat_time (higher = GraphMat
faster), as the reference's do.  The graphs are the reference's, edge for
edge (same generators, same seeds).  Edge arrays go to the device once,
before the native baselines are timed; the reference's ``jnp.asarray`` in
the timed call is a host copy on its CPU.  Collaborative filtering starts
both sides from one draw of ``torch.Generator`` seed 0 (the reference's
two sides share ``jax.random`` seed 0).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.common_torch import bench, row
from repro_torch._device import resolve_device
from repro_torch.algos import (bfs, collaborative_filtering, multi_bfs,
                               pagerank, sssp, triangle_count)
from repro_torch.algos.collab_filter import build_bipartite
from repro_torch.algos.multi import bfs_columns, multi_bfs_program
from repro_torch.algos.native import (native_bfs, native_cf, native_pagerank,
                                      native_sssp, native_tc)
from repro_torch.core import graph as G
from repro_torch.core.backends import Plan
from repro_torch.core.engine import init_batched_state, run_batched_rounds
from repro_torch.graphs import (bipartite_ratings, dag_orient, dedupe_edges,
                                remove_self_loops, rmat_edges, symmetrize)
from repro_torch.graphs.rmat import RMAT_PRBFS, RMAT_TC

COO, ELL, CUDA_ELL = Plan("coo"), Plan("ell"), Plan("cuda_ell")


def make_graphs(scale: int = 12, ef: int = 8, seed: int = 7):
  src, dst = rmat_edges(scale, ef, RMAT_PRBFS, seed=seed)
  src, dst = remove_self_loops(src, dst)
  src, dst = dedupe_edges(src, dst)
  n = 1 << scale
  w = np.random.default_rng(seed).uniform(0.1, 2.0, len(src)).astype(
      np.float32)
  return n, src, dst, w


def _ids(a: np.ndarray, dev: torch.device) -> torch.Tensor:
  """Edge ids as int64 on the device (the native baselines' best form)."""
  return torch.from_numpy(a.astype(np.int64)).to(dev)


def multi_query(scale: int = 12, device="cuda") -> list:
  """SpMV→SpMM serving sweep: Q batched queries vs Q sequential runs.

  Both paths execute the identical supersteps (results are bitwise equal),
  so edges-processed/sec differences are pure engine efficiency: one fused
  [n, Q] loop amortizes every gathered edge across all Q query lanes.
  """
  dev = resolve_device(device)
  rows = []
  n, src, dst, w = make_graphs(scale)
  ss, dd = symmetrize(src, dst)
  e = len(ss)
  rng = np.random.default_rng(13)
  prog = multi_bfs_program()
  for be in ("coo", "ell"):
    build = G.build_coo if be == "coo" else G.build_ell
    g = build(ss, dd, n=n, device=dev)
    plan = Plan(be)
    for q in (1, 8, 64):
      sources = rng.choice(n, size=q, replace=False).astype(np.int32)
      # Work accounting: every superstep sweeps all E edges (SpMM view);
      # a query converging in k supersteps therefore processes k·E edges.
      st0 = init_batched_state(*bfs_columns(
          torch.from_numpy(sources).to(dev), n))
      st, _ = run_batched_rounds(g, prog, st0, 64, backend=plan)
      edges_total = e * int(st.iters.sum())

      us_b, _ = bench(lambda: multi_bfs(g, sources, n, backend=plan))
      meps_b = edges_total / us_b  # edges/µs == M edges/s
      rows.append(row(f"multi_query/bfs_{be}_q{q}_batched", us_b,
                      f"agg_meps={meps_b:.1f}"))
      us_s, _ = bench(
          lambda: [bfs(g, int(s), n, backend=plan) for s in sources],
          iters=3)
      meps_s = edges_total / us_s
      rows.append(row(f"multi_query/bfs_{be}_q{q}_sequential", us_s,
                      f"agg_meps={meps_s:.1f} "
                      f"batched_speedup={us_s/us_b:.2f}x"))
  return rows


def main(scale: int = 12, device="cuda") -> list:
  dev = resolve_device(device)
  rows = []
  n, src, dst, w = make_graphs(scale)
  out_deg = torch.from_numpy(
      np.bincount(src, minlength=n).astype(np.float32)).to(dev)
  src_t, dst_t, w_t = _ids(src, dev), _ids(dst, dev), torch.from_numpy(w).to(
      dev)

  # --- PageRank (time per iteration, paper convention)
  coo = G.build_coo(src, dst, n=n, device=dev)
  ell = G.build_ell(src, dst, n=n, device=dev)
  iters = 10
  us, _ = bench(lambda: pagerank(coo, out_deg, num_iters=iters, backend=COO))
  rows.append(row("pagerank/graphmat_coo", us / iters, f"n={n} e={len(src)}"))
  us_e, _ = bench(lambda: pagerank(ell, out_deg, num_iters=iters,
                                   backend=ELL))
  rows.append(row("pagerank/graphmat_ell", us_e / iters, ""))
  us_p, _ = bench(lambda: pagerank(ell, out_deg, num_iters=iters,
                                   backend=CUDA_ELL))
  rows.append(row("pagerank/graphmat_cuda_ell", us_p / iters, "CUDA kernel"))
  us_n, _ = bench(lambda: native_pagerank(src_t, dst_t, out_deg, n, iters,
                                          device=dev))
  rows.append(row("pagerank/native", us_n / iters,
                  f"graphmat/native={us_e/us_n:.2f}x"))

  # --- BFS
  ss, dd = symmetrize(src, dst)
  ss_t, dd_t = _ids(ss, dev), _ids(dd, dev)
  gs_coo = G.build_coo(ss, dd, n=n, device=dev)
  gs_ell = G.build_ell(ss, dd, n=n, device=dev)
  us, _ = bench(lambda: bfs(gs_coo, 0, n, backend=COO))
  rows.append(row("bfs/graphmat_coo", us, f"e_sym={len(ss)}"))
  us_e, _ = bench(lambda: bfs(gs_ell, 0, n, backend=ELL))
  rows.append(row("bfs/graphmat_ell", us_e, ""))
  us_n, _ = bench(lambda: native_bfs(ss_t, dd_t, n, 0, device=dev))
  rows.append(row("bfs/native", us_n, f"graphmat/native={us_e/us_n:.2f}x"))

  # --- SSSP
  g_w = G.build_coo(src, dst, w, n=n, device=dev)
  g_we = G.build_ell(src, dst, w, n=n, device=dev)
  us, _ = bench(lambda: sssp(g_w, 0, n, backend=COO))
  rows.append(row("sssp/graphmat_coo", us, ""))
  us_e, _ = bench(lambda: sssp(g_we, 0, n, backend=ELL))
  rows.append(row("sssp/graphmat_ell", us_e, ""))
  us_n, _ = bench(lambda: native_sssp(src_t, dst_t, w_t, n, 0, device=dev))
  rows.append(row("sssp/native", us_n, f"graphmat/native={us_e/us_n:.2f}x"))

  # --- Triangle counting (TC-parameter RMAT, DAG-oriented)
  tsrc, tdst = rmat_edges(max(scale - 2, 8), 8, RMAT_TC, seed=11)
  tsrc, tdst = remove_self_loops(tsrc, tdst)
  tn = 1 << max(scale - 2, 8)
  ts, td = dag_orient(tsrc, tdst)
  ts_t, td_t = _ids(ts, dev), _ids(td, dev)
  fwd = G.build_coo(ts, td, n=tn, device=dev)
  rev = G.build_coo(td, ts, n=tn, device=dev)
  us, tc_val = bench(lambda: triangle_count(fwd, rev, tn, backend=COO))
  rows.append(row("tri_count/graphmat", us, f"triangles={int(tc_val)}"))
  us_n, tc_n = bench(lambda: native_tc(ts_t, td_t, tn, device=dev))
  assert int(tc_val) == int(tc_n)
  rows.append(row("tri_count/native", us_n,
                  f"graphmat/native={us/us_n:.2f}x"))

  # --- Collaborative filtering (time per GD iteration)
  users, items, ratings = bipartite_ratings(2000, 400, 16, seed=3)
  g2u, g2i, ncf = build_bipartite(users, items, ratings, 2000, 400,
                                  device=dev)
  k, cf_iters = 16, 5
  gen = torch.Generator(device=dev).manual_seed(0)
  p0 = torch.rand((ncf, k), generator=gen, device=dev) * 0.1
  users_t, items_t = _ids(users, dev), _ids(items + 2000, dev)
  ratings_t = torch.from_numpy(ratings).to(dev)
  us, _ = bench(lambda: collaborative_filtering(
      g2u, g2i, ncf, k=k, num_iters=cf_iters, p0=p0, backend=COO), iters=3)
  rows.append(row("collab_filter/graphmat", us / cf_iters,
                  f"ratings={len(users)} k={k}"))
  us_n, _ = bench(lambda: native_cf(
      users_t, items_t, ratings_t, ncf, k, cf_iters, p0=p0, device=dev),
      iters=3)
  rows.append(row("collab_filter/native", us_n / cf_iters,
                  f"graphmat/native={us/us_n:.2f}x"))
  return rows


if __name__ == "__main__":
  for r in main():
    print(r)
