"""The reference's ``tests/test_admission.py``, run against the port
(``repro.`` -> ``repro_torch.``, ``device="cpu"`` on the graph builders).

Admission-policy layer tests: FIFO conformance with the pre-policy
deque, strict-priority ordering (no priority inversion, EDF within class,
escalation on coalesce), fair-share deficit-round-robin weighted shares and
per-tenant bounds, and the per-tenant metrics surface.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.algos import bfs  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.service import (  # noqa: E402
    AdmissionRequest, BfsFamily, Counters, FairSharePolicy, FifoPolicy,
    GraphQueryServer, PriorityPolicy, QueryRejected, QuerySpec, make_policy)

pytestmark = pytest.mark.concurrency


@pytest.fixture(scope="module")
def small_graph():
  rng = np.random.default_rng(11)
  n, e = 96, 500
  src = rng.integers(0, n, e).astype(np.int32)
  dst = rng.integers(0, n, e).astype(np.int32)
  keep = src != dst
  return n, src[keep], dst[keep]


def _req(i, tenant="default", priority=0, deadline=None):
  return AdmissionRequest(key=f"k{i}", spec=f"s{i}", tenant=tenant,
                          priority=priority, deadline=deadline, seq=i)


# -- policy construction ------------------------------------------------------


def test_make_policy_names_and_validation():
  assert isinstance(make_policy(None), FifoPolicy)
  assert isinstance(make_policy("fifo"), FifoPolicy)
  assert isinstance(make_policy("priority"), PriorityPolicy)
  assert make_policy("priority-edf").edf is True
  assert isinstance(make_policy("fair"), FairSharePolicy)
  p = FifoPolicy()
  assert make_policy(p) is p
  with pytest.raises(ValueError):
    make_policy("lifo")
  with pytest.raises(TypeError):
    make_policy(42)
  with pytest.raises(ValueError):
    FairSharePolicy(weights={"a": 0.0})


# -- FIFO conformance (the seed deque behavior) -------------------------------


def test_fifo_policy_matches_deque_semantics():
  p = FifoPolicy()
  for i in range(5):
    p.offer(_req(i))
  assert p.depth() == 5
  assert p.keys() == [f"k{i}" for i in range(5)]
  assert p.pick_victim().key == "k0"          # shed-oldest
  assert p.remove("k2").key == "k2"
  assert p.remove("k2") is None
  assert [p.pop_next().key for _ in range(3)] == ["k1", "k3", "k4"]
  assert p.pop_next() is None and p.pick_victim() is None
  assert p.depth() == 0 and p.max_urgency() is None


def test_default_server_policy_is_fifo(small_graph):
  n, src, dst = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=1, steps_per_round=2,
                            backend="coo")
  assert server.debug_snapshot()["admission_policy"] == "fifo"
  # Arrival order is admission order (slots=1 serializes admissions).
  qids = [server.submit(QuerySpec("bfs", s)) for s in (3, 1, 4, 1, 5)]
  server.drain()
  for s, qid in zip((3, 1, 4, 1, 5), qids):
    np.testing.assert_array_equal(server.result(qid),
                                  np.asarray(bfs(g, s, n, backend="coo")))


# -- priority ----------------------------------------------------------------


def test_priority_policy_strict_classes_fifo_within():
  p = PriorityPolicy()
  p.offer(_req(0, priority=0))
  p.offer(_req(1, priority=5))
  p.offer(_req(2, priority=5))
  p.offer(_req(3, priority=1))
  order = [p.pop_next().key for _ in range(4)]
  assert order == ["k1", "k2", "k3", "k0"]    # classes desc, FIFO within
  assert p.pop_next() is None


def test_priority_policy_edf_within_class():
  p = PriorityPolicy(edf=True)
  p.offer(_req(0, priority=1, deadline=9.0))
  p.offer(_req(1, priority=1))                # no deadline: after EDF ones
  p.offer(_req(2, priority=1, deadline=3.0))
  assert [p.pop_next().key for _ in range(3)] == ["k2", "k0", "k1"]


def test_priority_victim_is_least_urgent():
  p = PriorityPolicy()
  p.offer(_req(0, priority=5))
  p.offer(_req(1, priority=0))
  p.offer(_req(2, priority=0))
  assert p.pick_victim().key == "k2"          # lowest class, last-to-run
  assert p.pick_victim().key == "k1"
  assert p.pick_victim().key == "k0"
  assert p.max_urgency() is None


def test_priority_escalation_on_coalesced_duplicate():
  p = PriorityPolicy()
  p.offer(_req(0, priority=0))
  p.offer(_req(1, priority=1))
  assert p.escalate("k0", 7) is True
  assert p.pop_next().key == "k0"             # escalated past k1
  assert p.escalate("missing", 7) is False


def test_no_priority_inversion_on_server(small_graph):
  """With the slot pool busy, a later high-priority submission is admitted
  ahead of the earlier low-priority backlog."""
  n, src, dst = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=1, steps_per_round=8,
                            backend="coo", admission="priority")
  lo_sources = (1, 2, 3)
  lo = [server.submit(QuerySpec("bfs", s, priority=0)) for s in lo_sources]
  hi = server.submit(QuerySpec("bfs", 50, priority=9))
  hi_key = server.debug_snapshot()["queued_keys"][0]
  server.step_round()                         # one free slot -> admits hi
  snap = server.debug_snapshot()
  assert snap["slot_keys"][0] == hi_key or server.result(hi) is not None
  assert len(snap["queued_keys"]) >= 2        # low backlog still queued
  server.drain()
  np.testing.assert_array_equal(server.result(hi),
                                np.asarray(bfs(g, 50, n, backend="coo")))
  for s, qid in zip(lo_sources, lo):
    np.testing.assert_array_equal(server.result(qid),
                                  np.asarray(bfs(g, s, n, backend="coo")))


# -- fair share ---------------------------------------------------------------


def test_fair_share_drr_proportions():
  p = FairSharePolicy(weights={"a": 3.0, "b": 1.0})
  for i in range(40):
    p.offer(_req(i, tenant="a"))
    p.offer(_req(100 + i, tenant="b"))
  pops = [p.pop_next().tenant for _ in range(32)]
  assert pops.count("a") == 24 and pops.count("b") == 8  # exactly 3:1
  # Within a tenant, FIFO order.
  p2 = FairSharePolicy()
  for i in range(3):
    p2.offer(_req(i, tenant="t"))
  assert [p2.pop_next().key for _ in range(3)] == ["k0", "k1", "k2"]


def test_fair_share_idle_tenant_does_not_bank_credit():
  p = FairSharePolicy(weights={"a": 4.0, "b": 1.0})
  p.offer(_req(0, tenant="a"))
  assert p.pop_next().tenant == "a"           # queue empties -> deficit reset
  for i in range(1, 5):
    p.offer(_req(i, tenant="a"))
  p.offer(_req(10, tenant="b"))
  pops = [p.pop_next().tenant for _ in range(5)]
  assert pops.count("b") == 1                 # b still gets its turn


def test_fair_share_per_tenant_bound_and_victim():
  p = FairSharePolicy(max_per_tenant=2)
  p.offer(_req(0, tenant="spam"))
  p.offer(_req(1, tenant="spam"))
  p.offer(_req(2, tenant="quiet"))
  over = _req(3, tenant="spam")
  assert p.full_for(over) is True
  assert p.full_for(_req(4, tenant="quiet")) is False
  # Victim for an over-bound tenant comes from that tenant (oldest first).
  assert p.pick_victim(over).key == "k0"
  assert p.full_for(over) is False
  # Without an offender, the most over-share tenant sheds.
  p.offer(_req(5, tenant="spam"))
  assert p.pick_victim().tenant == "spam"


def test_fair_share_server_rejects_over_bound_tenant(small_graph):
  n, src, dst = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(
      g, BfsFamily(n), num_slots=1, steps_per_round=2, backend="coo",
      backpressure="reject",
      admission=FairSharePolicy(max_per_tenant=2))
  for s in range(2):
    server.submit(QuerySpec("bfs", s, tenant="spam"))
  with pytest.raises(QueryRejected):
    server.submit(QuerySpec("bfs", 7, tenant="spam"))
  # Other tenants are unaffected by spam's bound.
  ok = server.submit(QuerySpec("bfs", 8, tenant="quiet"))
  assert server.debug_snapshot()["tenant_depth"] == {"spam": 2, "quiet": 1}
  server.drain()
  assert server.result(ok) is not None
  counts = server.stats()["counters"]
  assert counts["queries.rejected"] == 1
  assert server.counters.get_labeled("queries.rejected", tenant="spam") == 1


def test_fair_share_completed_shares_under_saturation(small_graph):
  """Acceptance: under a saturated queue each tenant's completed share
  stays within 20% of its configured weight share."""
  n, src, dst = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  weights = {"gold": 3.0, "free": 1.0}
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=16,
                            backend="coo",
                            admission=FairSharePolicy(weights=weights))
  # Disjoint source sets: no coalescing or cache hits across tenants.
  per_tenant = 24
  for i in range(per_tenant):
    server.submit(QuerySpec("bfs", i, tenant="gold"))
    server.submit(QuerySpec("bfs", per_tenant + i, tenant="free"))
  # Step while BOTH tenants stay backlogged (the saturation window).
  while min(server.debug_snapshot()["tenant_depth"].get(t, 0)
            for t in weights) > 2:
    server.step_round()
  done = {t: server.counters.get_labeled("queries.completed", tenant=t)
          for t in weights}
  total = sum(done.values())
  assert total >= 16, f"not enough completions to measure shares: {done}"
  for tenant, weight in weights.items():
    expected = weight / sum(weights.values())
    share = done[tenant] / total
    assert abs(share - expected) <= 0.2 * max(expected, 1 - expected), \
        f"{tenant}: completed share {share:.2f} vs weight share {expected:.2f}"
  server.drain()


# -- metrics surface ----------------------------------------------------------


def test_labeled_counters_and_wait_histograms(small_graph):
  n, src, dst = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=4,
                            backend="coo", admission="fair")
  for i in range(4):
    server.submit(QuerySpec("bfs", i, tenant="a"))
  server.submit(QuerySpec("bfs", 10, tenant="b"))
  # Per-tenant queue depth is visible while queued.
  gauges = server.stats()["gauges"]
  assert gauges[Counters.label_name("queue.depth", tenant="a")] == 4
  assert gauges[Counters.label_name("queue.depth", tenant="b")] == 1
  server.drain()
  assert server.counters.get_labeled("queries.submitted", tenant="a") == 4
  assert server.counters.get_labeled("queries.completed", tenant="b") == 1
  hists = server.stats()["histograms"]
  assert hists["queue.wait_ms"]["count"] == 5
  assert Counters.label_name("queue.wait_ms", tenant="a") in hists
  assert Counters.label_name("query.latency_ms", tenant="b") in hists
  # Histogram percentile helper (powers Benchmark admission_report).
  h = server.counters.hist("query.latency_ms")
  assert h.percentile(0.5) <= h.percentile(0.95) or h.count == 0


def test_priority_class_labels(small_graph):
  n, src, dst = small_graph
  g = G.build_coo(src, dst, n=n, device="cpu")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=2, steps_per_round=4,
                            backend="coo", admission="priority")
  server.submit(QuerySpec("bfs", 0, priority=2))
  server.submit(QuerySpec("bfs", 1))
  server.drain()
  assert server.counters.get_labeled("queries.submitted",
                                     **{"class": 2}) == 1
  assert server.counters.get_labeled("queries.completed",
                                     **{"class": 2}) == 1
