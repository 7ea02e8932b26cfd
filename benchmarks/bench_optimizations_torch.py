"""Paper Fig. 7 analogue on the port: cumulative effect of backend
optimizations.

The counterpart of ``benchmarks/bench_optimizations.py``.  The paper's
ladder (naive → +bitvector → +ipo → +parallel → +load-balance) maps onto
this device as:

  1. naive        — COO backend, frontier ignored (all vertices active
                    every superstep = no bitvector annihilation)
  2. +frontier    — the bitvector: active-mask annihilation (paper §4.4.2)
  3. +ell         — degree-sorted ELL packing (DCSC → packed rows)
  4. +cuda_ell    — the fused generalized-SpMV CUDA kernel (the -ipo
                    analogue is the program's declared ``process_op``,
                    compiled into the kernel)
  5. +shuffle     — degree-randomizing vertex relabel before 2-D blocking
                    (the "many more partitions than threads" load balance),
                    measured as max/mean block-population ratio.

Wall-times are host-clock medians that end in a device sync; the
load-balance row reports the balance statistic that governs multi-device
scaling.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from benchmarks.common_torch import bench, row
from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.algos import sssp
from repro_torch.algos.pagerank import init_prop, pagerank_program
from repro_torch.algos.sssp import sssp_program
from repro_torch.core import graph as G
from repro_torch.core import spmv as spmv_mod
from repro_torch.core.backends import Plan, Planner
from repro_torch.core.distributed import partition_2d
from repro_torch.core.engine import run_fixed_iters
from repro_torch.core.vertex_program import GraphProgram
from repro_torch.graphs import (dedupe_edges, remove_self_loops, rmat_edges,
                                shuffle_vertices)
from repro_torch.graphs.rmat import RMAT_PRBFS
from repro_torch.service import (BfsFamily, Counters, FairSharePolicy,
                                 GraphQueryServer, QuerySpec)

COO, ELL, CUDA_ELL = Plan("coo"), Plan("ell"), Plan("cuda_ell")


def frontier_work_ratio(src, dst, w, n, device="cuda") -> float:
  """Fraction of edge work annihilated by the frontier over an SSSP run."""
  dev = resolve_device(device)
  g = G.build_coo(src, dst, w, n=n, device=dev)
  prog = sssp_program()
  dist = sssp_init(n, dev)
  active = torch.zeros((n,), dtype=torch.bool, device=dev)
  active[0] = True
  total_active = 0
  iters = 0
  while bool(active.any()) and iters < 200:
    msg = dist
    y, recv = spmv_mod.spmv_coo(g, msg, active, dist, prog)
    newd = torch.minimum(y, dist)
    changed = recv & (newd < dist)
    total_active += int(active.sum())
    dist, active = newd, changed
    iters += 1
  return total_active / float(n * iters) if iters else 1.0


def main(scale: int = 12, ef: int = 8, device="cuda") -> list:
  dev = resolve_device(device)
  rows = []
  src, dst = rmat_edges(scale, ef, RMAT_PRBFS, seed=5)
  src, dst = remove_self_loops(src, dst)
  src, dst = dedupe_edges(src, dst)
  n = 1 << scale
  w = np.random.default_rng(5).uniform(0.1, 2.0, len(src)).astype(np.float32)
  out_deg = torch.from_numpy(
      np.bincount(src, minlength=n).astype(np.float32)).to(dev)
  iters = 10
  all_active = torch.ones((n,), dtype=torch.bool, device=dev)

  coo = G.build_coo(src, dst, w, n=n, device=dev)
  ell = G.build_ell(src, dst, w, n=n, device=dev)

  # 1. naive: no frontier (all active), COO.
  prog = pagerank_program()
  prop = init_prop(out_deg)
  us1, _ = bench(lambda: run_fixed_iters(
      coo, prog, prop, all_active, iters, backend=COO))
  rows.append(row("opt_ladder/1_naive_coo", us1 / iters, "baseline=1.0x"))

  # 2. +frontier bitvector: SSSP with/without frontier (PR is all-active by
  #    definition, so the frontier win shows on traversal algorithms).
  us_nf, _ = bench(lambda: run_fixed_iters(  # frontier disabled: all active
      coo, sssp_prog_all_active(), sssp_init(n, dev), all_active, 20,
      backend=COO))
  us_f, _ = bench(lambda: sssp(coo, 0, n, backend=COO, max_iters=20))
  ratio = frontier_work_ratio(src, dst, w, n, dev)
  rows.append(row("opt_ladder/2_frontier", us_f,
                  f"vs_all_active={us_nf/us_f:.2f}x "
                  f"active_edge_frac={ratio:.3f}"))

  # 3. +ELL packing.
  us3, _ = bench(lambda: run_fixed_iters(
      ell, prog, prop, all_active, iters, backend=ELL))
  rows.append(row("opt_ladder/3_ell", us3 / iters,
                  f"vs_naive={us1/us3:.2f}x width={ell.width}"))

  # 4. +the CUDA kernel (its plain version on CPU tensors).
  us4, _ = bench(lambda: run_fixed_iters(
      ell, prog, prop, all_active, iters, backend=CUDA_ELL))
  rows.append(row("opt_ladder/4_cuda_ell", us4 / iters,
                  f"vs_naive={us1/us4:.2f}x"))

  # 5. +load-balance shuffle: 2-D block population balance.
  for tag, (s2, d2) in (("unshuffled", (src, dst)),
                        ("shuffled", shuffle_vertices(src, dst, n, 1)[:2])):
    dg = partition_2d(s2, d2, w if tag == "unshuffled" else None, n=n,
                      R=4, C=4)
    pop = np.sum(dg.emask, axis=-1)
    rows.append(row(f"opt_ladder/5_balance_{tag}", 0.0,
                    f"max/mean={pop.max()/max(pop.mean(),1):.2f}"))

  # 6. planner sweep: time every candidate plan per container and report
  #    which plan the heuristics vs measurement pick (JSON comment row).
  rows.extend(planner_sweep(coo, ell, prog, prop, n))

  # 7. admission sweep: FIFO vs weighted fair share under tenant saturation
  #    (JSON comment row with per-tenant p50/p95 latency).
  rows.extend(admission_sweep(ell, n))
  return rows


def _plan_tag(plan) -> str:
  tag = plan.backend
  if plan.num_tiles is not None:
    tag += f"_t{plan.num_tiles}"
  for f in ("block_rows", "block_queries"):
    v = getattr(plan, f)
    if v is not None:
      tag += f"_{f.split('_')[1][0]}{v}"
  return tag


def planner_sweep(coo, ell, prog, prop, n, iters: int = 2) -> list:
  """Sweep :meth:`Planner.candidates` on each container; emit per-candidate
  timings plus a ``# plan_report`` JSON row mapping graph → picked plans."""
  rows = []
  planner = Planner()
  active = torch.ones((n,), dtype=torch.bool, device=coo.device)
  picks = {}
  for gname, g in (("coo", coo), ("ell", ell)):
    stats = planner.stats(g)
    timed = {}
    for cand in planner.candidates(g, prog):
      fn = lambda c=cand: run_fixed_iters(g, prog, prop, active, iters,
                                          backend=c)
      try:
        us, _ = bench(fn)
      except Exception:
        continue  # a candidate that cannot execute this program
      timed[_plan_tag(cand)] = us / iters
      rows.append(row(f"planner/{gname}_{_plan_tag(cand)}", us / iters,
                      f"nnz={stats.nnz} hub_ratio={stats.hub_ratio:.1f}"))
    tuned = planner.autotune(g, prog, prop, active, num_iters=iters)
    picks[gname] = {
        "heuristic": _plan_tag(planner.plan(g, prog)),
        "autotuned": _plan_tag(tuned),
        "plan": {k: v for k, v in dataclasses.asdict(tuned).items()
                 if v is not None},
        "candidate_us": {k: round(v, 1) for k, v in timed.items()},
    }
  rows.append("# plan_report " + json.dumps(picks, sort_keys=True))
  return rows


def admission_sweep(graph, n, per_tenant: int = 16) -> list:
  """Saturate a 2-tenant server under FIFO vs weighted fair share and
  report the per-tenant completed split plus p50/p95 submit→result latency
  as a ``# admission_report`` JSON row.

  Under FIFO a burst-first heavy tenant starves the light one; fair share
  (weights gold=3, free=1) holds the completed split near 3:1 while both
  stay backlogged.
  """
  rows = []
  weights = {"gold": 3.0, "free": 1.0}
  report = {}
  for policy_name, policy in (("fifo", "fifo"),
                              ("fair", FairSharePolicy(weights=weights))):
    server = GraphQueryServer(graph, BfsFamily(n), num_slots=4,
                              steps_per_round=4, admission=policy)
    for i in range(per_tenant):  # interleaved arrivals, disjoint sources
      server.submit(QuerySpec("bfs", i, tenant="gold"))
      server.submit(QuerySpec("bfs", per_tenant + i, tenant="free"))
    while min(server.debug_snapshot()["tenant_depth"].get(t, 0)
              for t in weights) > 2:
      server.step_round()
    mid = {t: int(server.counters.get_labeled("queries.completed", tenant=t))
           for t in weights}
    server.drain()
    tenants = {}
    for t in weights:
      h = server.counters.hist(
          Counters.label_name("query.latency_ms", tenant=t))
      tenants[t] = {
          "completed_at_saturation": mid[t],
          "p50_ms": round(h.percentile(0.5), 2),
          "p95_ms": round(h.percentile(0.95), 2),
      }
    report[policy_name] = {"weights": weights, "tenants": tenants}
    rows.append(row(
        f"admission/{policy_name}", 0.0,
        " ".join(f"{t}:done={v['completed_at_saturation']}"
                 f",p95={v['p95_ms']}ms" for t, v in tenants.items())))
  rows.append("# admission_report " + json.dumps(report, sort_keys=True))
  return rows


def sssp_init(n, device="cuda"):
  dist = torch.full((n,), float("inf"), dtype=torch.float32,
                    device=resolve_device(device))
  dist[0] = 0.0
  return dist


def sssp_prog_all_active():
  return GraphProgram(
      process_message=lambda m, e, d: m + e,
      reduce_kind="min",
      apply=lambda red, old: torch.minimum(red, old),
      activate=lambda old, new: torch.ones(
          tree_leaves(new)[0].shape[:1], dtype=torch.bool,
          device=tree_leaves(new)[0].device),
      process_reads_dst=False, name="sssp_all_active")


if __name__ == "__main__":
  for r in main():
    print(r)
