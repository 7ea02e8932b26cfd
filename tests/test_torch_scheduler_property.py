"""The reference's ``tests/test_scheduler_property.py``, run against the port
(``repro.`` -> ``repro_torch.``, ``device="cpu"`` on the graph builders,
``jnp.asarray`` -> ``torch.as_tensor``).

Property-based scheduler conformance: random interleavings of
submit/step/deadline/cancel never lose a query, never double-assign a slot,
and always satisfy the accounting identity
``in_flight + queued + retired == enqueued``.

Skips cleanly without hypothesis (same pattern as tests/test_property.py);
a seeded non-hypothesis twin lives in tests/test_torch_scheduler_concurrency.py so
the invariants stay covered in minimal environments.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

from repro_torch.core import graph as G
from repro_torch.service import (BfsFamily, GraphQueryServer, QueryError,
                                 QuerySpec)

pytestmark = pytest.mark.concurrency

_N = 24


@pytest.fixture(scope="module")
def tiny_graph():
  rng = np.random.default_rng(5)
  e = 90
  src = rng.integers(0, _N, e).astype(np.int32)
  dst = rng.integers(0, _N, e).astype(np.int32)
  keep = src != dst
  return G.build_coo(src[keep], dst[keep], n=_N, device="cpu")


def ops_strategy():
  submit = st.tuples(st.just("submit"), st.integers(0, _N - 1),
                     st.sampled_from([None, 1.0, 3.0]))
  step = st.tuples(st.just("step"), st.just(0), st.just(None))
  tick = st.tuples(st.just("tick"), st.integers(1, 4), st.just(None))
  cancel = st.tuples(st.just("cancel"), st.integers(0, 63), st.just(None))
  return st.lists(st.one_of(submit, step, tick, cancel),
                  min_size=1, max_size=40)


def _check_invariants(server):
  counts = server.stats()["counters"]
  snap = server.debug_snapshot()
  live = [k for k in snap["slot_keys"] if k is not None]
  # Never double-assign a slot; a key is never queued and in flight at once.
  assert len(live) == len(set(live))
  assert not set(snap["queued_keys"]) & set(live)
  enqueued = counts.get("queue.enqueued", 0)
  removed = counts.get("queue.removed", 0)
  admitted = counts.get("queries.admitted", 0)
  retired = counts.get("slots.retired", 0)
  early = counts.get("slots.early_retired", 0)
  assert len(snap["queued_keys"]) == enqueued - admitted - removed
  assert len(live) == admitted - retired - early
  # in_flight + queued + retired(all terminal paths) == enqueued
  assert (len(live) + len(snap["queued_keys"])
          + retired + early + removed) == enqueued


@settings(max_examples=10, deadline=None)
@given(ops_strategy(), st.integers(1, 3), st.integers(1, 4))
def test_random_interleavings_conserve_queries(tiny_graph, ops, num_slots,
                                               max_queue):
  t = [0.0]
  server = GraphQueryServer(tiny_graph, BfsFamily(_N), num_slots=num_slots,
                            steps_per_round=1, backend="coo",
                            max_queue=max_queue, backpressure="shed-oldest",
                            clock=lambda: t[0])
  qids = []
  for op, arg, extra in ops:
    if op == "submit":
      qids.append(server.submit(QuerySpec("bfs", arg), deadline=extra))
    elif op == "step":
      server.step_round()
    elif op == "tick":
      t[0] += float(arg)
    elif op == "cancel" and qids:
      server.cancel(qids[arg % len(qids)])
    _check_invariants(server)

  rounds = 0
  while server.step_round():
    rounds += 1
    assert rounds < 10_000, "drain failed to converge"
  assert server.num_queued == 0 and server.num_in_flight == 0
  _check_invariants(server)
  # Never lose a query: every ticket settles with a value or a QueryError.
  for qid in qids:
    try:
      assert server.result(qid, timeout=0.0) is not None
    except QueryError:
      pass
  assert not server.debug_snapshot()["pending_qids"]
