"""The reference's ``tests/test_service.py``, run against the port
(``repro.`` -> ``repro_torch.``, ``device="cpu"`` on the graph builders,
``jnp.asarray`` -> ``torch.as_tensor``).

Service-layer tests: continuous batching, cache, coalescing, metrics."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.algos import bfs, personalized_pagerank, sssp
from repro_torch.core import graph as G
from repro_torch.service import (BfsFamily, Counters, GraphQueryServer, PprFamily,
                                 QuerySpec, ResultCache, SsspFamily,
                                 graph_fingerprint)


@pytest.fixture(scope="module")
def small_graph():
  rng = np.random.default_rng(11)
  n, e = 96, 500
  src = rng.integers(0, n, e).astype(np.int32)
  dst = rng.integers(0, n, e).astype(np.int32)
  keep = src != dst
  src, dst = src[keep], dst[keep]
  w = rng.uniform(0.1, 2.0, src.size).astype(np.float32)
  return n, src, dst, w


def test_bfs_server_matches_single_query(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  # More queries than slots forces mid-flight retire + swap-in.
  server = GraphQueryServer(g, BfsFamily(n), num_slots=3, steps_per_round=2,
                            backend="coo")
  sources = [0, 5, 9, 17, 33, 64, 80]
  qids = {server.submit(QuerySpec("bfs", s)): s for s in sources}
  results = server.drain()
  assert len(results) == len(sources)
  for qid, s in qids.items():
    np.testing.assert_array_equal(results[qid],
                                  np.asarray(bfs(g, s, n, backend="coo")))
  stats = server.stats()
  assert stats["counters"]["queries.completed"] == len(sources)
  assert stats["counters"]["supersteps"] > 0
  assert stats["histograms"]["query.supersteps_to_converge"]["count"] == \
      len(sources)
  assert stats["histograms"]["round.slot_utilization"]["max"] <= 1.0


def test_sssp_server_matches_single_query(small_graph):
  n, src, dst, w = small_graph
  g = G.build_ell(src, dst, w, n=n, device="cpu")
  server = GraphQueryServer(g, SsspFamily(n), num_slots=4,
                            steps_per_round=3)
  sources = [1, 12, 40, 71, 90]
  qids = {server.submit(QuerySpec("sssp", s)): s for s in sources}
  results = server.drain()
  for qid, s in qids.items():
    np.testing.assert_array_equal(results[qid],
                                  np.asarray(sssp(g, s, n)))


def test_ppr_server_matches_single_query(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  out_deg = torch.as_tensor(np.bincount(src, minlength=n).astype(np.float32))
  server = GraphQueryServer(g, PprFamily(out_deg, tol=1e-7), num_slots=2,
                            steps_per_round=4, backend="coo")
  sources = [3, 8, 21, 55]
  qids = {server.submit(QuerySpec("ppr", s)): s for s in sources}
  results = server.drain()
  for qid, s in qids.items():
    expect = np.asarray(personalized_pagerank(
        g, out_deg, np.array([s]), tol=1e-7, backend="coo"))[:, 0]
    np.testing.assert_array_equal(results[qid], expect)


def test_cache_hits_and_coalescing(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=2,
                            backend="coo")
  a = server.submit(QuerySpec("bfs", 4))
  b = server.submit(QuerySpec("bfs", 4))   # coalesces onto a
  server.drain()
  assert server.counters.get("queries.coalesced") == 1
  np.testing.assert_array_equal(server.result(a), server.result(b))
  # Post-drain resubmission is a pure cache hit: no new engine work.
  rounds_before = server.counters.get("rounds")
  c = server.submit(QuerySpec("bfs", 4))
  assert server.result(c) is not None
  assert server.counters.get("cache.hits") == 1
  assert server.counters.get("rounds") == rounds_before


def test_midflight_swap_in_preserves_neighbors(small_graph):
  """A query admitted into a freed slot must not disturb unconverged ones."""
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=1,
                            backend="coo")
  sources = [0, 7, 23, 42, 61, 88]
  qids = {server.submit(QuerySpec("bfs", s)): s for s in sources}
  # Step manually so admissions interleave with half-finished neighbors.
  while server.num_queued or server.num_in_flight:
    server.step_round()
  for qid, s in qids.items():
    np.testing.assert_array_equal(server.result(qid),
                                  np.asarray(bfs(g, s, n, backend="coo")))
  # With 6 queries × ~5 supersteps each through 2 slots and 1-step rounds,
  # swap-ins necessarily happened while a neighbor was live.
  assert server.counters.get("rounds") > 6


def test_result_cache_lru_and_fingerprint(small_graph):
  n, src, dst, w = small_graph
  c = Counters()
  cache = ResultCache(capacity=2, counters=c)
  cache.put(("f", "p", 1), "one")
  cache.put(("f", "p", 2), "two")
  assert cache.get(("f", "p", 1)) == "one"
  cache.put(("f", "p", 3), "three")   # evicts key 2 (LRU)
  assert cache.get(("f", "p", 2)) is None
  assert c.get("cache.evictions") == 1

  g1 = G.build_coo(src, dst, n=n, device="cpu")
  g2 = G.build_coo(src, dst, n=n, device="cpu")
  g3 = G.build_coo(src, dst + 0, w, n=n, device="cpu")  # different weights
  assert graph_fingerprint(g1) == graph_fingerprint(g2)
  assert graph_fingerprint(g1) != graph_fingerprint(g3)


def test_counters_histogram():
  c = Counters()
  for v in [1, 2, 3, 100, 2000]:
    c.observe("h", v)
  snap = c.snapshot()["histograms"]["h"]
  assert snap["count"] == 5 and snap["max"] == 2000 and snap["min"] == 1
  assert sum(snap["le"].values()) == 5


def test_empty_server_is_idle(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2)
  assert server.step_round() is False
  assert server.drain() == {}
