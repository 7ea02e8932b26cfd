"""The reference's ``tests/test_scheduler_regressions.py``, run against the port
(``repro.`` -> ``repro_torch.``, ``device="cpu"`` on the graph builders,
``jnp.asarray`` -> ``torch.as_tensor``).  Each test also runs with the graph on
the card where one is present (decided inside the test), where the engine's
launches are asynchronous to the scheduler's threads; results are compared
on the host.

Regression tests for the four scheduler bugs fixed alongside the
admission-policy layer:

1. force-retired (``max_steps_per_query``) partial columns were cached,
   poisoning the shared :class:`ResultCache` for every future identical
   query;
2. a submitter blocked for queue space under ``block`` backpressure never
   re-checked its own ticket after waking, so a ticket settled while
   blocked (deadline expiry, cancel) was still enqueued — burning an
   engine column and double-counting ``queries.completed``;
3. the blocked-submit cache re-check was a TOCTOU (``in`` + separate
   ``get``) that an LRU eviction could race into settling a ticket with
   ``value=None``;
4. ``_tickets`` / ``_results`` grew without bound — settled tickets were
   never garbage-collected.

Each test fails on the pre-fix scheduler.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.algos import bfs
from repro_torch.core import graph as G
from repro_torch.service import (BfsFamily, DeadlineExpired, GraphQueryServer,
                                 QuerySpec, ResultCache)

pytestmark = pytest.mark.concurrency


@pytest.fixture(scope="module")
def small_graph():
  rng = np.random.default_rng(11)
  n, e = 96, 500
  src = rng.integers(0, n, e).astype(np.int32)
  dst = rng.integers(0, n, e).astype(np.int32)
  keep = src != dst
  return n, src[keep], dst[keep]


@pytest.fixture(params=["cpu", "cuda"])
def device(request):
  if request.param == "cuda" and not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (run on the card)")
  return request.param


def _host(x):
  return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _busy_sources(src, n, k):
  """Sources with the most out-edges — cannot converge in one superstep."""
  return [int(v) for v in np.argsort(-np.bincount(src, minlength=n))[:k]]


# -- bug 1: forced-retire cache poisoning -------------------------------------


def test_forced_retire_partial_result_is_never_cached(small_graph, device):
  """A query force-retired at max_steps_per_query delivers its partial
  column to waiters but must NOT cache it: a second server sharing the
  cache must recompute and serve the converged answer (bitwise vs the
  unconstrained run)."""
  n, src, dst = small_graph
  g = G.build_coo(src, dst, n=n, device=device)
  source = _busy_sources(src, n, 1)[0]
  cache = ResultCache()

  capped = GraphQueryServer(g, BfsFamily(n), num_slots=1, steps_per_round=1,
                            backend="coo", cache=cache,
                            max_steps_per_query=1)
  qid = capped.submit(QuerySpec("bfs", source))
  capped.drain()
  partial = capped.result(qid)
  assert capped.counters.get("queries.force_retired") == 1

  full = GraphQueryServer(g, BfsFamily(n), num_slots=1, steps_per_round=4,
                          backend="coo", cache=cache)
  ref_qid = full.submit(QuerySpec("bfs", source))
  full.drain()
  converged = full.result(ref_qid)

  # Guard: the forced retire genuinely truncated the traversal, so a cache
  # hit on the partial result would have been observably wrong.
  assert not np.array_equal(_host(partial), _host(converged))
  np.testing.assert_array_equal(
      _host(converged), _host(bfs(g, source, n, backend="coo")))
  # The second server must have missed (computed), not hit the poison.
  assert full.counters.get("queries.force_retired") == 0
  assert full.counters.get("slots.retired") == 1


# -- bug 2: ticket settled while blocked for queue space ----------------------


def test_deadline_expiry_while_blocked_for_queue_space(small_graph, device):
  """A submitter blocked under `block` backpressure whose deadline expires
  while it waits must not enqueue its settled ticket (no burned column, no
  double-counted completion)."""
  n, src, dst = small_graph
  g = G.build_coo(src, dst, n=n, device=device)
  t = [0.0]
  server = GraphQueryServer(g, BfsFamily(n), num_slots=1, steps_per_round=4,
                            backend="coo", max_queue=1,
                            backpressure="block", clock=lambda: t[0])
  filler_src, blocked_src = _busy_sources(src, n, 2)
  filler = server.submit(QuerySpec("bfs", filler_src))   # fills the queue

  outcome = {}

  def blocked_submit():
    try:
      outcome["qid"] = server.submit(QuerySpec("bfs", blocked_src),
                                     deadline=1.0)
    except DeadlineExpired as e:
      outcome["error"] = e

  th = threading.Thread(target=blocked_submit)
  th.start()
  # Wait until the submitter registered its ticket (it blocks right after).
  while server.counters.get("queries.submitted") < 2:
    time.sleep(0.001)
  t[0] = 5.0                       # past the blocked submitter's deadline
  server.expire_deadlines()        # settles the blocked ticket
  server.step_round()              # admits the filler -> queue space frees
  th.join(60)
  assert not th.is_alive(), "submitter stuck after its ticket settled"
  assert "error" in outcome or "qid" in outcome
  server.drain()

  counts = server.stats()["counters"]
  # Pre-fix: the dead ticket was enqueued anyway (enqueued == 2) and its
  # column retired as a completion (completed == 2).
  assert counts["queue.enqueued"] == 1
  assert counts["queries.completed"] == 1
  assert counts["queries.deadline_expired"] == 1
  assert server.result(filler) is not None
  assert not server.debug_snapshot()["pending_qids"]


# -- bug 3: TOCTOU on the blocked-submit cache re-check -----------------------


class _StalePositiveCache(ResultCache):
  """Simulates the eviction race deterministically: membership tests claim
  the key is present, but by the time `get` runs the entry is gone.  The
  pre-fix scheduler (`if key in cache: settle(value=cache.get(key))`)
  settles the blocked ticket with None; the fixed single-sentinel `get`
  never consults `__contains__`."""

  def __contains__(self, key):
    return True


def test_blocked_submit_survives_cache_eviction_race(small_graph, device):
  n, src, dst = small_graph
  g = G.build_coo(src, dst, n=n, device=device)
  server = GraphQueryServer(g, BfsFamily(n), num_slots=1, steps_per_round=4,
                            backend="coo", max_queue=1,
                            backpressure="block",
                            cache=_StalePositiveCache(capacity=1))
  filler_src, blocked_src = _busy_sources(src, n, 2)
  server.submit(QuerySpec("bfs", filler_src))

  outcome = {}

  def blocked_submit():
    outcome["qid"] = server.submit(QuerySpec("bfs", blocked_src))

  th = threading.Thread(target=blocked_submit)
  th.start()
  while server.counters.get("queries.submitted") < 2:
    time.sleep(0.001)
  server.step_round()              # frees queue space, wakes the submitter
  th.join(60)
  assert not th.is_alive()
  server.drain()
  got = server.result(outcome["qid"])
  assert got is not None, "ticket settled with a phantom cache value"
  np.testing.assert_array_equal(_host(got),
                                _host(bfs(g, blocked_src, n,
                                          backend="coo")))


# -- bug 4: unbounded ticket/result retention ---------------------------------


def test_settled_tickets_are_garbage_collected(small_graph, device):
  n, src, dst = small_graph
  g = G.build_coo(src, dst, n=n, device=device)
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=4,
                            backend="coo", retain_delivered=4)
  qids = []
  for s in range(24):
    qids.append(server.submit(QuerySpec("bfs", s)))
    server.drain()
    server.result(qids[-1])        # delivered -> GC-eligible
  snap = server.debug_snapshot()
  assert snap["num_tickets"] <= 4 + 1, \
      f"delivered tickets leaked: {snap['num_tickets']}"
  # The freshest deliveries are still readable; ancient qids are gone.
  assert server.result(qids[-1]) is not None
  with pytest.raises(KeyError):
    server.result(qids[0])


def test_uncollected_settled_tickets_bounded(small_graph, device):
  """Tickets nobody ever calls result() on still cannot grow without
  bound — retain_settled caps them, oldest first."""
  n, src, dst = small_graph
  g = G.build_coo(src, dst, n=n, device=device)
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=4,
                            backend="coo", retain_settled=8)
  for s in range(30):
    server.submit(QuerySpec("bfs", s))
  server.drain()
  snap = server.debug_snapshot()
  assert snap["num_tickets"] <= 8
  assert not snap["pending_qids"]
