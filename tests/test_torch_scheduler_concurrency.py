"""The reference's ``tests/test_service_concurrency.py``, run against the port
(``repro.`` -> ``repro_torch.``, ``device="cpu"`` on the graph builders,
``jnp.asarray`` -> ``torch.as_tensor``).

Concurrency/conformance tests for the service frontend.

Covers the threading contract of :class:`GraphQueryServer` +
:class:`ServerDriver`: a 16-thread mixed-family stress test (zero
lost/duplicated results), backpressure policies under contention
(shed-oldest must not deadlock), deadline expiry that is bitwise-invisible
to surviving columns, cancellation, deterministic shutdown, thread-safe
cache eviction, and a seeded random-interleaving conformance check of the
scheduler's accounting identities.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.algos import bfs, personalized_pagerank, sssp
from repro_torch.core import graph as G
from repro_torch.service import (BfsFamily, Counters, DeadlineExpired,
                                 GraphQueryServer, PprFamily, QueryCancelled,
                                 QueryError, QueryRejected, QueryShed, QuerySpec,
                                 ResultCache, ServerClosed, ServerDriver,
                                 SsspFamily)

pytestmark = pytest.mark.concurrency


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


def _join_all(threads, timeout=300.0):
  for t in threads:
    t.join(timeout)
  stuck = [t.name for t in threads if t.is_alive()]
  assert not stuck, f"deadlocked client threads: {stuck}"


# -- 16-thread mixed-family stress (acceptance criterion) --------------------


def test_stress_16_threads_mixed_families(small_graph):
  """16 client threads × mixed BFS/SSSP/PPR traffic through one driver:
  every result matches the single-query engine, zero lost/duplicated."""
  n, src, dst, w = small_graph
  g_bfs = G.build_coo(src, dst, n=n, device="cpu")
  g_sssp = G.build_ell(src, dst, w, n=n, device="cpu")
  g_ppr = G.build_coo(src, dst, n=n, device="cpu")
  out_deg = torch.as_tensor(np.bincount(src, minlength=n).astype(np.float32))

  sources = [0, 7, 23, 42, 61, 88]
  refs = {
      "bfs": {s: np.asarray(bfs(g_bfs, s, n, backend="coo"))
              for s in sources},
      "sssp": {s: np.asarray(sssp(g_sssp, s, n)) for s in sources},
      "ppr": {s: np.asarray(personalized_pagerank(
          g_ppr, out_deg, np.array([s]), tol=1e-6, backend="coo"))[:, 0]
              for s in sources},
  }
  servers = {
      "bfs": GraphQueryServer(g_bfs, BfsFamily(n), num_slots=3,
                              steps_per_round=2, backend="coo"),
      "sssp": GraphQueryServer(g_sssp, SsspFamily(n), num_slots=3,
                               steps_per_round=2),
      "ppr": GraphQueryServer(g_ppr, PprFamily(out_deg, tol=1e-6),
                              num_slots=2, steps_per_round=2, backend="coo"),
  }

  kinds = list(servers)
  num_threads, per_thread = 16, 6
  barrier = threading.Barrier(num_threads)
  matched = [0] * num_threads
  errors = []

  def client(tid):
    try:
      barrier.wait(timeout=60)
      for i in range(per_thread):
        kind = kinds[(tid + i) % len(kinds)]
        source = sources[(tid * 5 + i) % len(sources)]
        qid = servers[kind].submit(QuerySpec(kind, source))
        got = servers[kind].result(qid, timeout=240.0)
        assert got is not None, f"lost query {kind}/{source} (qid {qid})"
        np.testing.assert_array_equal(got, refs[kind][source])
        matched[tid] += 1
    except BaseException as e:  # noqa: BLE001 — surface to the main thread
      errors.append((tid, repr(e)))

  with ServerDriver(*servers.values(), idle_wait=0.002):
    threads = [threading.Thread(target=client, args=(tid,),
                                name=f"client-{tid}")
               for tid in range(num_threads)]
    for t in threads:
      t.start()
    _join_all(threads)

  assert not errors, errors
  assert sum(matched) == num_threads * per_thread   # zero lost/duplicated
  for kind, server in servers.items():
    assert server.num_queued == 0 and server.num_in_flight == 0
    counts = server.stats()["counters"]
    # Every submission settled successfully (completed covers coalesced
    # and cache-hit tickets too).
    assert counts["queries.submitted"] == counts["queries.completed"], kind
    assert not server.debug_snapshot()["pending_qids"]


# -- backpressure ------------------------------------------------------------


def test_shed_oldest_backpressure_no_deadlock(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=1,
                            backend="coo", max_queue=2,
                            backpressure="shed-oldest")
  # Deterministic pre-driver burst: queue holds 2, each further unique
  # submission sheds the oldest.
  qids = [server.submit(QuerySpec("bfs", s)) for s in range(10)]
  assert server.num_queued == 2
  assert server.counters.get("queries.shed") == 8

  outcomes = []
  errors = []

  def client(tid):
    try:
      for i in range(4):
        qid = server.submit(QuerySpec("bfs", 10 + tid * 4 + i))
        try:
          got = server.result(qid, timeout=120.0)
          assert got is not None
          outcomes.append("ok")
        except QueryShed:
          outcomes.append("shed")
    except BaseException as e:  # noqa: BLE001
      errors.append((tid, repr(e)))

  with ServerDriver(server, idle_wait=0.002):
    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for t in threads:
      t.start()
    _join_all(threads)
    # Pre-burst tickets also all settled: completed or shed, none lost.
    settled = 0
    for qid in qids:
      try:
        if server.result(qid, timeout=120.0) is not None:
          settled += 1
      except QueryShed:
        settled += 1
    assert settled == len(qids)
  assert not errors, errors
  assert len(outcomes) == 32            # no deadlock: every ticket resolved
  counts = server.stats()["counters"]
  assert counts["queries.submitted"] == \
      counts["queries.completed"] + counts["queries.shed"]
  assert server.stats()["gauges"]["queue.depth.high_water"] <= 2


def test_reject_policy_and_block_timeout(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=1, steps_per_round=1,
                            backend="coo", max_queue=1,
                            backpressure="reject")
  a = server.submit(QuerySpec("bfs", 1))      # fills the queue
  with pytest.raises(QueryRejected):
    server.submit(QuerySpec("bfs", 2))
  assert server.counters.get("queries.rejected") == 1
  # Coalescing and cache hits bypass admission entirely.
  a2 = server.submit(QuerySpec("bfs", 1))
  assert server.counters.get("queries.coalesced") == 1
  server.drain()
  np.testing.assert_array_equal(server.result(a), server.result(a2))

  blocking = GraphQueryServer(g, BfsFamily(n), num_slots=1,
                              steps_per_round=1, backend="coo", max_queue=1,
                              backpressure="block")
  blocking.submit(QuerySpec("bfs", 3))
  with pytest.raises(QueryRejected, match="timed out"):
    blocking.submit(QuerySpec("bfs", 4), timeout=0.05)


def test_blocked_submitter_unblocks_on_admission(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=2,
                            backend="coo", max_queue=1,
                            backpressure="block")
  server.submit(QuerySpec("bfs", 0))
  got = {}

  def blocked_client():
    qid = server.submit(QuerySpec("bfs", 1))   # blocks: queue is full
    got["qid"] = qid

  t = threading.Thread(target=blocked_client)
  t.start()
  with ServerDriver(server, idle_wait=0.002) as driver:
    t.join(120)
    assert not t.is_alive(), "submitter deadlocked on full queue"
    driver.wait_idle(timeout=120)
  np.testing.assert_array_equal(
      server.result(got["qid"]),
      np.asarray(bfs(g, 1, n, backend="coo")))


# -- cache under concurrency -------------------------------------------------


def test_cache_hit_bypasses_slots_under_concurrency(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=2,
                            backend="coo")
  warm = server.submit(QuerySpec("bfs", 5))
  server.drain()
  rounds = server.counters.get("rounds")
  admitted = server.counters.get("queries.admitted")

  results, errors = [], []

  def client():
    try:
      qid = server.submit(QuerySpec("bfs", 5))
      # Cache hit: settled at submit time, no driver needed.
      results.append(server.result(qid, timeout=0.0))
    except BaseException as e:  # noqa: BLE001
      errors.append(repr(e))

  threads = [threading.Thread(target=client) for _ in range(8)]
  for t in threads:
    t.start()
  _join_all(threads)
  assert not errors, errors
  assert len(results) == 8 and all(r is not None for r in results)
  for r in results:
    np.testing.assert_array_equal(r, server.result(warm))
  # No slot was occupied and no engine work ran for the hits.
  assert server.counters.get("rounds") == rounds
  assert server.counters.get("queries.admitted") == admitted
  assert server.num_in_flight == 0
  assert server.counters.get("cache.hits") == 8


def test_result_cache_eviction_under_contention():
  """Regression: pre-PR-8 ResultCache had no lock — concurrent get (LRU
  move_to_end) and put (evicting insert) corrupted the OrderedDict."""
  counters = Counters()
  cache = ResultCache(capacity=8, counters=counters)
  errors = []
  gets = 512

  def worker(tid):
    rng = np.random.default_rng(tid)
    try:
      for i in range(gets):
        key = ("f", "p", int(rng.integers(0, 64)))
        if i % 2:
          cache.put(key, tid)
        else:
          cache.get(key)
    except BaseException as e:  # noqa: BLE001
      errors.append(repr(e))

  threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
  for t in threads:
    t.start()
  _join_all(threads, timeout=120)
  assert not errors, errors
  assert len(cache) <= 8
  hits = counters.get("cache.hits")
  misses = counters.get("cache.misses")
  assert hits + misses == 8 * gets / 2


# -- deadlines and cancellation ----------------------------------------------


def test_deadline_expired_midflight_preserves_survivors(small_graph):
  """Acceptance: an in-flight query retired at its deadline is masked out
  without perturbing surviving columns — survivors are bitwise-equal to a
  no-deadline run."""
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  # Sources need out-edges so no BFS converges in one superstep
  # (guaranteeing the victim is still in flight when the clock jumps).
  out_deg = np.bincount(src, minlength=n)
  victim = int(np.argmax(out_deg))
  survivors = [int(v) for v in np.argsort(-out_deg)[1:4]]
  assert out_deg[victim] > 0 and victim not in survivors

  baseline = GraphQueryServer(g, BfsFamily(n), num_slots=4,
                              steps_per_round=1, backend="coo")
  ref_qids = {s: baseline.submit(QuerySpec("bfs", s)) for s in survivors}
  baseline.drain()
  refs = {s: baseline.result(ref_qids[s]) for s in survivors}

  t = [0.0]
  server = GraphQueryServer(g, BfsFamily(n), num_slots=4, steps_per_round=1,
                            backend="coo", clock=lambda: t[0])
  qids = {s: server.submit(QuerySpec("bfs", s)) for s in survivors}
  victim_qid = server.submit(QuerySpec("bfs", victim), deadline=5.0)
  server.step_round()                 # all four admitted, one superstep
  assert server.num_in_flight == 4
  t[0] = 10.0                         # past the victim's deadline
  server.step_round()                 # expiry sweep masks the victim
  with pytest.raises(DeadlineExpired):
    server.result(victim_qid)
  assert server.counters.get("queries.deadline_expired") == 1
  assert server.counters.get("slots.early_retired") == 1
  server.drain()
  for s in survivors:
    np.testing.assert_array_equal(server.result(qids[s]), refs[s])
  # An expired query's partial column must never be cached.
  requery = server.submit(QuerySpec("bfs", victim))
  server.drain()
  np.testing.assert_array_equal(server.result(requery),
                                np.asarray(bfs(g, victim, n, backend="coo")))


def test_deadline_expired_while_queued(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  t = [0.0]
  server = GraphQueryServer(g, BfsFamily(n), num_slots=1, steps_per_round=1,
                            backend="coo", clock=lambda: t[0])
  keep = server.submit(QuerySpec("bfs",
                                 int(np.argmax(np.bincount(src, minlength=n)))))
  server.step_round()                 # `keep` occupies the only slot
  doomed = server.submit(QuerySpec("bfs", 1), deadline=1.0)  # stuck in queue
  assert server.num_queued == 1
  t[0] = 2.0
  server.expire_deadlines()
  with pytest.raises(DeadlineExpired):
    server.result(doomed)
  assert server.num_queued == 0       # dropped without ever taking a slot
  server.drain()
  assert server.result(keep) is not None


def test_cancel_queued_and_inflight(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=1, steps_per_round=1,
                            backend="coo")
  # High-degree sources cannot converge in one superstep, so `running` is
  # still in flight after the single round below.
  s0, s1 = (int(v) for v in np.argsort(-np.bincount(src, minlength=n))[:2])
  running = server.submit(QuerySpec("bfs", s0))
  queued = server.submit(QuerySpec("bfs", s1))
  server.step_round()
  assert server.cancel(queued) is True
  with pytest.raises(QueryCancelled):
    server.result(queued)
  assert server.num_queued == 0
  assert server.cancel(running) is True      # in flight → column masked
  assert server.num_in_flight == 0
  assert server.counters.get("slots.early_retired") == 1
  # Coalesced sibling keeps the column alive.
  a = server.submit(QuerySpec("bfs", 2))
  b = server.submit(QuerySpec("bfs", 2))
  assert server.cancel(a) is True
  server.drain()
  with pytest.raises(QueryCancelled):
    server.result(a)
  np.testing.assert_array_equal(server.result(b),
                                np.asarray(bfs(g, 2, n, backend="coo")))
  assert server.cancel(b) is False           # already settled


# -- shutdown ----------------------------------------------------------------


def test_close_abort_settles_everything(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=1,
                            backend="coo")
  busy = [int(v) for v in np.argsort(-np.bincount(src, minlength=n))[:5]]
  qids = [server.submit(QuerySpec("bfs", s)) for s in busy]
  server.step_round()                 # two in flight, three queued
  assert server.num_in_flight == 2 and server.num_queued == 3
  server.close("abort")
  assert server.num_in_flight == 0 and server.num_queued == 0
  for qid in qids:
    with pytest.raises(ServerClosed):
      server.result(qid)
  with pytest.raises(ServerClosed):
    server.submit(QuerySpec("bfs", 7))
  assert not server.debug_snapshot()["pending_qids"]


def test_server_context_manager_drains(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  with GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=2,
                        backend="coo") as server:
    qids = {s: server.submit(QuerySpec("bfs", s)) for s in (3, 9)}
  for s, qid in qids.items():
    np.testing.assert_array_equal(server.result(qid),
                                  np.asarray(bfs(g, s, n, backend="coo")))
  with pytest.raises(ServerClosed):
    server.submit(QuerySpec("bfs", 1))


def test_driver_close_abort_unblocks_waiters(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=1, steps_per_round=1,
                            backend="coo")
  qids = server.submit_many([QuerySpec("bfs", s) for s in range(4)])
  failures = []

  def waiter(qid):
    try:
      server.result(qid, timeout=120.0)
    except QueryError:
      failures.append(qid)

  driver = ServerDriver(server, idle_wait=0.002).start()
  threads = [threading.Thread(target=waiter, args=(q,)) for q in qids]
  for t in threads:
    t.start()
  driver.close("abort")
  _join_all(threads, timeout=60)     # nobody left blocked
  assert not driver.running


# -- random-interleaving conformance (seeded; hypothesis twin in
#    tests/test_scheduler_property.py) ---------------------------------------


def _check_accounting(server):
  """The scheduler's conservation laws, valid at any quiescent point."""
  counts = server.stats()["counters"]
  snap = server.debug_snapshot()
  live_slots = [k for k in snap["slot_keys"] if k is not None]
  assert len(live_slots) == len(set(live_slots)), "slot double-assignment"
  assert not set(snap["queued_keys"]) & set(live_slots), \
      "key simultaneously queued and in flight"
  enqueued = counts.get("queue.enqueued", 0)
  removed = counts.get("queue.removed", 0)
  admitted = counts.get("queries.admitted", 0)
  retired = counts.get("slots.retired", 0)
  early = counts.get("slots.early_retired", 0)
  assert len(snap["queued_keys"]) == enqueued - admitted - removed
  assert len(live_slots) == admitted - retired - early
  # Invariant: in_flight + queued + retired == submitted (keys).
  assert (len(live_slots) + len(snap["queued_keys"])
          + retired + early + removed) == enqueued


def test_invariants_random_interleaving(small_graph):
  n, src, dst, w = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  t = [0.0]
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=1,
                            backend="coo", max_queue=3,
                            backpressure="shed-oldest", clock=lambda: t[0])
  rng = np.random.default_rng(1234)
  qids = []
  for step in range(150):
    op = rng.choice(["submit", "step", "tick", "cancel"],
                    p=[0.45, 0.25, 0.15, 0.15])
    if op == "submit":
      deadline = [None, 1.0, 4.0][rng.integers(0, 3)]
      qids.append(server.submit(QuerySpec("bfs", int(rng.integers(0, 8))),
                                deadline=deadline))
    elif op == "step":
      server.step_round()
    elif op == "tick":
      t[0] += float(rng.uniform(0.2, 2.0))
    elif op == "cancel" and qids:
      server.cancel(int(rng.choice(qids)))
    if step % 10 == 0:
      _check_accounting(server)

  while server.step_round():
    pass
  assert server.num_queued == 0 and server.num_in_flight == 0
  _check_accounting(server)
  # Never lose a query: every ticket settled with a value or a QueryError.
  lost = 0
  for qid in qids:
    try:
      if server.result(qid, timeout=0.0) is None:
        lost += 1
    except QueryError:
      pass
  assert lost == 0
  assert not server.debug_snapshot()["pending_qids"]
