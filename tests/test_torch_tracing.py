"""The port's spans (``repro_torch.tracing``) and the service's per-query
counters, on the CPU.

A span is the one shared null context while no profiler records, and a
``graphmat.*`` profiler range, nested as the layers call each other, while
one does: the engine's supersteps and host reads, the backend that runs
each SpMV, the spill merge and the ELL wrapper, and the server's rounds
with their admission, read and retirement, on a driver thread too under a
session that records every thread.  The scheduler observes
``query.in_slot_ms`` once per retired slot, on its own clock, and keeps no
per-superstep frontier histograms."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._C._profiler import _ExperimentalConfig  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.algos import bfs, sssp  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.service import (BfsFamily, GraphQueryServer,  # noqa: E402
                                 QuerySpec, ServerDriver, SsspFamily)

NAMES = [tracing.ROUND, tracing.ADMIT, tracing.ROUND_READ, tracing.RETIRE,
         tracing.SUPERSTEP, tracing.HOST_READ, tracing.SPILL,
         tracing.ELL_SPMV]


@pytest.fixture(scope="module")
def edges():
  rng = np.random.default_rng(28)
  n, e = 80, 640
  src = rng.integers(0, n, e).astype(np.int32)
  dst = rng.integers(0, n, e).astype(np.int32)
  dst[: e // 4] = 3                        # a hub, whose row spills
  keep = src != dst
  w = rng.uniform(0.1, 2.0, e).astype(np.float32)
  return n, src[keep], dst[keep], w[keep]


def build(edges, plan):
  n, src, dst, w = edges
  if plan == "coo":
    return G.build_coo(src, dst, w, n=n, device="cpu")
  g = G.build_ell(src, dst, w, n=n, width=8, device="cpu")
  assert g.spill is not None
  return g


def recorded(prof):
  """The ``graphmat.`` spans: (name, start, end, thread), by start."""
  out = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
          ev.start_thread_id())
         for ev in prof.profiler.kineto_results.events()
         if ev.name().startswith("graphmat.")]
  return sorted(out, key=lambda s: (s[1], -s[2]))


def parents(spans):
  """Each span's parent: the innermost span on its thread holding it."""
  out = []
  for k, (name, lo, hi, tid) in enumerate(spans):
    holders = [s for j, s in enumerate(spans) if j != k and s[3] == tid
               and s[1] <= lo and hi <= s[2]]
    out.append((name, max(holders, key=lambda s: (s[1], -s[2]))[0]
                if holders else None))
  return out


def count(pairs, name, parent):
  return sum(1 for p in pairs if p == (name, parent))


@pytest.mark.parametrize("name", NAMES + [tracing.SPMV + "coo"])
def test_span_is_the_shared_null_context_when_no_profiler_records(name):
  assert tracing.span(name) is tracing.NULL


def test_span_is_a_range_only_while_a_profiler_records():
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    with tracing.span(tracing.SPILL) as rng:
      torch.ones(4).sum()
    assert tracing.span(tracing.SPILL) is not tracing.NULL
  assert rng is not tracing.NULL
  assert tracing.span(tracing.SPILL) is tracing.NULL
  assert [s[0] for s in recorded(prof)] == [tracing.SPILL]


@pytest.mark.parametrize("plan", ["coo", "ell", "cuda_ell"])
def test_run_graph_program_records_engine_and_spmv_spans(edges, plan):
  n = edges[0]
  g = build(edges, plan)
  want = sssp(g, 0, n, backend=plan)
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    got = sssp(g, 0, n, backend=plan)
  torch.testing.assert_close(got, want, rtol=0, atol=0)
  pairs = parents(recorded(prof))
  steps = count(pairs, tracing.SUPERSTEP, None)
  assert steps > 2
  # One read a superstep, and the last finds the frontier empty.
  assert count(pairs, tracing.HOST_READ, None) == steps + 1
  backend = tracing.SPMV + plan
  assert count(pairs, backend, tracing.SUPERSTEP) == steps
  assert count(pairs, tracing.SPILL, backend) == (0 if plan == "coo"
                                                  else steps)
  assert count(pairs, tracing.ELL_SPMV, backend) == (
      steps if plan == "cuda_ell" else 0)
  assert len(pairs) == (steps * (2 + (plan != "coo") + (plan == "cuda_ell"))
                        + steps + 1)


@pytest.mark.parametrize("plan", ["coo", "cuda_ell"])
def test_a_served_query_records_the_service_spans(edges, plan):
  n = edges[0]
  g = build(edges, plan)
  server = GraphQueryServer(g, SsspFamily(n), num_slots=2, steps_per_round=2,
                            backend=plan)
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    qid = server.submit(QuerySpec("sssp", 0))
    results = server.drain()
  np.testing.assert_array_equal(results[qid],
                                np.asarray(sssp(g, 0, n, backend=plan)))
  pairs = parents(recorded(prof))
  rounds = count(pairs, tracing.ROUND, None)
  assert rounds == server.stats()["counters"]["rounds"] >= 2
  for part in (tracing.ADMIT, tracing.ROUND_READ, tracing.RETIRE):
    assert count(pairs, part, tracing.ROUND) == rounds
  backend = tracing.SPMV + plan
  assert count(pairs, tracing.SUPERSTEP, tracing.ROUND) == 2 * rounds
  assert count(pairs, backend, tracing.SUPERSTEP) == 2 * rounds
  if plan == "cuda_ell":
    assert count(pairs, tracing.ELL_SPMV, backend) == 2 * rounds
    assert count(pairs, tracing.SPILL, backend) == 2 * rounds
  assert {name for name, _ in pairs} <= set(NAMES) | {backend}


def test_spans_on_a_driver_thread_under_an_all_threads_session(edges):
  n = edges[0]
  g = build(edges, "coo")
  server = GraphQueryServer(g, SsspFamily(n), num_slots=2, steps_per_round=2,
                            backend="coo")
  with ServerDriver(server) as driver:
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
      with torch.profiler.record_function("graphmat.test.main"):
        qid = server.submit(QuerySpec("sssp", 5))
      got = server.result(qid, timeout=60)
    driver.close("drain")
  np.testing.assert_array_equal(got, np.asarray(sssp(g, 5, n,
                                                     backend="coo")))
  spans = recorded(prof)
  main = {s[3] for s in spans if s[0] == "graphmat.test.main"}
  rounds = [s for s in spans if s[0] == tracing.ROUND]
  assert rounds and all(s[3] not in main for s in rounds)
  pairs = parents(spans)
  assert count(pairs, tracing.SUPERSTEP, tracing.ROUND) >= 2


def test_in_slot_ms_once_per_retired_slot(edges):
  n = edges[0]
  g = build(edges, "coo")
  server = GraphQueryServer(g, BfsFamily(n), num_slots=3, steps_per_round=2,
                            backend="coo")
  sources = [0, 5, 9, 17, 33, 64, 79]
  for s in sources:
    server.submit(QuerySpec("bfs", s))
  server.drain()
  stats = server.stats()
  in_slot = stats["histograms"]["query.in_slot_ms"]
  assert in_slot["count"] == stats["counters"]["slots.retired"] == len(
      sources)
  assert in_slot["min"] >= 0.0
  assert stats["histograms"]["queue.wait_ms"]["count"] == len(sources)
  assert not [k for k in stats["histograms"]
              if k.startswith("superstep.frontier")]


def test_queue_wait_and_in_slot_on_the_schedulers_clock():
  """A path 0 -> 1 -> ... -> 5, one superstep a round, the clock set by
  hand: admitted at the first round (t = 10), retired at the last."""
  n = 6
  src = np.arange(n - 1, dtype=np.int32)
  g = G.build_coo(src, src + 1, n=n, device="cpu")
  now = [0.0]
  server = GraphQueryServer(g, BfsFamily(n), num_slots=1, steps_per_round=1,
                            backend="coo", clock=lambda: now[0])
  qid = server.submit(QuerySpec("bfs", 0))
  rounds = 0
  while server.num_queued or server.num_in_flight:
    rounds += 1
    now[0] = 10.0 * rounds
    server.step_round()
  assert rounds > 3
  np.testing.assert_array_equal(server.result(qid),
                                np.asarray(bfs(g, 0, n, backend="coo")))
  h = server.stats()["histograms"]
  assert h["queue.wait_ms"]["sum"] == pytest.approx(10_000.0)
  assert h["query.in_slot_ms"]["count"] == 1
  assert h["query.in_slot_ms"]["sum"] == pytest.approx(
      (10.0 * rounds - 10.0) * 1000.0)
