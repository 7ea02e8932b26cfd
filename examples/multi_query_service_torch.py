"""Multi-query serving demo on the PyTorch port: continuous-batched vertex
programs.

The port's counterpart of ``examples/multi_query_service.py``, on
``repro_torch.service``, on the card unless ``--device cpu`` is given.  It
builds an RMAT graph, stands up a :class:`GraphQueryServer`, and pushes a
burst of BFS and personalized-PageRank traffic through it — slot-pool
continuous batching (converged queries retire mid-flight and queued ones
swap in), request coalescing, the result cache, and the metrics surface —
then re-runs the BFS traffic from 8 concurrent client threads against a
:class:`ServerDriver` with deadlines and shed-oldest backpressure.  A final
section saturates a server shared by two tenants under weighted fair
queuing (:class:`FairSharePolicy`) and shows the per-tenant throughput
split and wait-time percentiles.

Each section takes the graphs of :func:`build_graphs` and returns what it
prints, with the seconds its traffic took (host clock; the results are on
the host when it stops).

  PYTHONPATH=src python examples/multi_query_service_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.algos import bfs
from repro_torch.core import graph as G
from repro_torch.graphs import (dedupe_edges, remove_self_loops, rmat_edges,
                                symmetrize)
from repro_torch.service import (BfsFamily, Counters, DeadlineExpired,
                                 FairSharePolicy, GraphQueryServer, PprFamily,
                                 QueryShed, QuerySpec, ServerDriver)


def build_graphs(scale: int = 10, device="cuda") -> dict:
  """RMAT (seed 7, edge factor 8): the symmetrized graph as ELL for BFS,
  the directed one as COO for PageRank, the out-degrees, and the query
  sources (one ``default_rng(0)`` stream: 18 BFS sources plus repeats, then
  10 PPR sources)."""
  n = 1 << scale
  src, dst = rmat_edges(scale, 8, seed=7)
  src, dst = remove_self_loops(src, dst)
  src, dst = dedupe_edges(src, dst)
  ss, dd = symmetrize(src, dst)
  rng = np.random.default_rng(0)
  bfs_sources = rng.integers(0, n, 18).tolist() + [5, 5, 9, 9, 5, 9]
  ppr_sources = rng.integers(0, n, 10).tolist()
  return {
      "n": n, "edges": len(ss),
      "graph": G.build_ell(ss, dd, n=n, device=device),
      "pgraph": G.build_coo(src, dst, n=n, device=device),
      "out_deg": torch.from_numpy(
          np.bincount(src, minlength=n).astype(np.float32)).to(device),
      "bfs_sources": bfs_sources, "ppr_sources": ppr_sources}


def serve_bfs(graphs: dict) -> dict:
  """BFS traffic: 24 queries (some repeated) over 8 slots, with three
  tickets spot-checked against the single-query engine."""
  graph, n = graphs["graph"], graphs["n"]
  server = GraphQueryServer(graph, BfsFamily(n), num_slots=8,
                            steps_per_round=2)
  t0 = time.perf_counter()
  tickets = {server.submit(QuerySpec("bfs", int(s))): int(s)
             for s in graphs["bfs_sources"]}
  results = server.drain()
  seconds = time.perf_counter() - t0
  for qid in list(tickets)[:3]:
    expect = bfs(graph, tickets[qid], n).cpu().numpy()
    np.testing.assert_array_equal(results[qid], expect)
  return {"results": results, "tickets": tickets, "stats": server.stats(),
          "plan": server.plan, "seconds": seconds}


def serve_ppr(graphs: dict) -> dict:
  """Personalized PageRank traffic on the directed graph (COO): 10 queries
  over 4 slots at tol 1e-6."""
  ppr_server = GraphQueryServer(graphs["pgraph"],
                                PprFamily(graphs["out_deg"], tol=1e-6),
                                num_slots=4, steps_per_round=4)
  t0 = time.perf_counter()
  qids = [ppr_server.submit(QuerySpec("ppr", int(s)))
          for s in graphs["ppr_sources"]]
  results = ppr_server.drain()
  seconds = time.perf_counter() - t0
  top = np.argsort(-results[qids[0]])[:5]
  s2c = ppr_server.stats()["histograms"]["query.supersteps_to_converge"]
  return {"results": results, "qids": qids, "top": top.tolist(),
          "supersteps_to_converge": s2c, "plan": ppr_server.plan,
          "seconds": seconds}


def serve_concurrent(graphs: dict) -> dict:
  """Concurrent clients: 8 threads × 8 queries against a driver thread,
  with per-query deadlines of 30 s and shed-oldest backpressure."""
  graph, n = graphs["graph"], graphs["n"]
  cserver = GraphQueryServer(graph, BfsFamily(n), num_slots=8,
                             steps_per_round=2, max_queue=32,
                             backpressure="shed-oldest")
  tally = {"ok": 0, "shed": 0, "expired": 0}
  tally_lock = threading.Lock()

  def client(tid: int):
    crng = np.random.default_rng(100 + tid)
    for s in crng.integers(0, n, 8):
      qid = cserver.submit(QuerySpec("bfs", int(s)), deadline=30.0)
      try:
        got = cserver.result(qid, timeout=60.0)
        outcome = "ok" if got is not None else "expired"
      except QueryShed:
        outcome = "shed"
      except DeadlineExpired:
        outcome = "expired"
      with tally_lock:
        tally[outcome] += 1

  t0 = time.perf_counter()
  with ServerDriver(cserver, idle_wait=0.005) as driver:
    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for t in threads:
      t.start()
    for t in threads:
      t.join()
  seconds = time.perf_counter() - t0
  if driver.error is not None:
    raise driver.error
  stats = cserver.stats()
  return {"tally": tally, "latency_ms": stats["histograms"]["query.latency_ms"],
          "high_water": stats["gauges"].get("queue.depth.high_water", 0),
          "shed": cserver.counters.get("queries.shed"),
          "coalesced": cserver.counters.get("queries.coalesced"),
          "cache_hits": cserver.counters.get("cache.hits"),
          "seconds": seconds}


def serve_fair_share(graphs: dict) -> dict:
  """Mixed-tenant traffic under weighted fair queuing: a "gold" tenant
  paying for 3x the share of a "free" tenant, both saturating the queue."""
  graph, n = graphs["graph"], graphs["n"]
  weights = {"gold": 3.0, "free": 1.0}
  fserver = GraphQueryServer(graph, BfsFamily(n), num_slots=4,
                             steps_per_round=4,
                             admission=FairSharePolicy(weights=weights))
  per_tenant = 20
  t0 = time.perf_counter()
  for i in range(per_tenant):
    fserver.submit(QuerySpec("bfs", i, tenant="gold"))
    fserver.submit(QuerySpec("bfs", per_tenant + i, tenant="free"))
  # Step only while both tenants stay backlogged, so the split reflects
  # the fair-queuing discipline rather than queue-drain order.
  while min(fserver.debug_snapshot()["tenant_depth"].get(t, 0)
            for t in weights) > 2:
    fserver.step_round()
  mid = {t: int(fserver.counters.get_labeled("queries.completed", tenant=t))
         for t in weights}
  fserver.drain()
  seconds = time.perf_counter() - t0
  waits = {}
  for t in weights:
    h = fserver.counters.hist(Counters.label_name("queue.wait_ms", tenant=t))
    waits[t] = {"p50": h.percentile(0.5), "p95": h.percentile(0.95),
                "completed": fserver.counters.get_labeled(
                    "queries.completed", tenant=t)}
  return {"weights": weights, "mid": mid, "waits": waits,
          "seconds": seconds}


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  graphs = build_graphs(10, device)
  n = graphs["n"]
  print(f"graph: n={n} edges={graphs['edges']} (symmetrized RMAT)")

  # --- BFS traffic: 24 queries (some repeated), 8 slots.
  out = serve_bfs(graphs)
  first = next(iter(out["tickets"]))
  print(f"bfs: served {len(out['results'])} queries; "
        f"sample hops from v{out['tickets'][first]}: "
        f"{out['results'][first][:8].tolist()}")
  print("bfs service stats:")
  print(json.dumps(out["stats"], indent=2, default=str)[:1200])

  # --- Personalized PageRank traffic on the directed graph.
  out = serve_ppr(graphs)
  s2c = out["supersteps_to_converge"]
  print(f"ppr: served {len(out['results'])} queries; "
        f"top-5 vertices for query 0: {out['top']}")
  print(f"ppr supersteps-to-converge: mean={s2c['mean']:.1f} "
        f"min={s2c['min']:.0f} max={s2c['max']:.0f}")

  # --- Concurrent clients: 8 threads × 8 queries against a driver thread,
  # with per-query deadlines and shed-oldest backpressure.
  out = serve_concurrent(graphs)
  lat = out["latency_ms"]
  print(f"concurrent bfs: {out['tally']} across {lat['count']} tickets; "
        f"submit→result latency mean={lat['mean']:.1f}ms max={lat['max']:.0f}ms")
  print(f"queue high-water={out['high_water']:.0f} "
        f"shed={out['shed']:.0f} "
        f"coalesced={out['coalesced']:.0f} "
        f"cache hits={out['cache_hits']:.0f}")

  # --- Mixed-tenant traffic under weighted fair queuing.
  out = serve_fair_share(graphs)
  mid = out["mid"]
  print(f"fair-share bfs (weights {out['weights']}): completed under "
        f"saturation {mid} — {mid['gold']}:{mid['free']} vs configured 3:1")
  for t, w in out["waits"].items():
    print(f"  tenant {t}: queue wait p50={w['p50']:.1f}ms "
          f"p95={w['p95']:.1f}ms completed={w['completed']:.0f}")


if __name__ == "__main__":
  main()
