"""The port's GraphQueryServer against the JAX package's, and its lifecycle.

The same queries through both servers give the same results: BFS and SSSP
bitwise, personalized PageRank with rtol 1e-5, atol 1e-7 (float add in
another order).  Cache hits, cancellation, deadlines and a ServerDriver run
are exercised on the port alone.
"""

import gc
import pathlib
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.backends import Plan as JPlan  # noqa: E402
import repro.service as jsvc  # noqa: E402
from repro_torch.algos import bfs  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core.backends import Plan  # noqa: E402
from repro_torch.service import (BfsFamily, DeadlineExpired,  # noqa: E402
                                 GraphQueryServer, PprFamily, QueryCancelled,
                                 QuerySpec, ServerDriver, SsspFamily,
                                 graph_fingerprint)

SOURCES = [0, 3, 9, 17, 40, 77, 128, 200, 255]


def _graphs(rmat_small):
  n, src, dst, w = rmat_small
  return (JG.build_ell(src, dst, w, n=n),
          TG.build_ell(src, dst, w, n=n, device="cpu"))


def _families(kind, rmat_small):
  n, src = rmat_small[0], rmat_small[1]
  if kind == "bfs":
    return jsvc.BfsFamily(n), BfsFamily(n)
  if kind == "sssp":
    return jsvc.SsspFamily(n), SsspFamily(n)
  out_deg = np.bincount(src, minlength=n).astype(np.float32)
  return (jsvc.PprFamily(jnp.asarray(out_deg)),
          PprFamily(torch.from_numpy(out_deg)))


@pytest.mark.parametrize("kind", ["bfs", "sssp", "ppr"])
def test_server_matches_jax_server(rmat_small, kind):
  jg, tg = _graphs(rmat_small)
  jfam, tfam = _families(kind, rmat_small)
  # More queries than slots: mid-flight retire and swap-in on both sides.
  js = jsvc.GraphQueryServer(jg, jfam, num_slots=3, steps_per_round=2,
                             backend=JPlan("ell"))
  ts = GraphQueryServer(tg, tfam, num_slots=3, steps_per_round=2,
                        backend=Plan("cuda_ell"))
  jq = js.submit_many([jsvc.QuerySpec(kind, s) for s in SOURCES])
  tq = ts.submit_many([QuerySpec(kind, s) for s in SOURCES])
  jr, tr = js.drain(), ts.drain()
  for a, b in zip(jq, tq):
    if kind == "ppr":
      np.testing.assert_allclose(tr[b], jr[a], rtol=1e-5, atol=1e-7)
    else:
      np.testing.assert_array_equal(tr[b], jr[a])
  jc, tc = js.stats()["counters"], ts.stats()["counters"]
  for key in ("queries.completed", "rounds", "supersteps", "slots.retired"):
    assert tc[key] == jc[key], key


@pytest.mark.parametrize("backend", ["ell", "cuda_ell"])
def test_rounds_hold_no_tensor_in_a_reference_cycle(rmat_small, backend):
  """A tensor that only a reference cycle keeps alive waits for the garbage
  collector, and on the card whole superstep intermediates then pile up
  across rounds; serving must leave no such tensor behind."""
  _, tg = _graphs(rmat_small)
  server = GraphQueryServer(tg, BfsFamily(rmat_small[0]), num_slots=3,
                            steps_per_round=2, backend=Plan(backend))
  server.submit_many([QuerySpec("bfs", s) for s in SOURCES])
  gc.collect()
  flags = gc.get_debug()
  gc.disable()
  gc.set_debug(gc.DEBUG_SAVEALL)
  try:
    server.drain()
    gc.collect()
    cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
  finally:
    gc.garbage.clear()
    gc.set_debug(flags)
    gc.enable()
  server.close()
  assert not cyclic, f"{len(cyclic)} tensors held by reference cycles"


def test_auto_plan_and_fingerprint(rmat_small):
  n, src, dst, w = rmat_small
  _, tg = _graphs(rmat_small)
  again = TG.build_ell(src, dst, w, n=n, device="cpu")
  assert graph_fingerprint(tg) == graph_fingerprint(again)
  other = TG.build_ell(src, dst, w * 2, n=n, device="cpu")
  assert graph_fingerprint(tg) != graph_fingerprint(other)
  server = GraphQueryServer(tg, BfsFamily(n), num_slots=2)
  jserver = jsvc.GraphQueryServer(_graphs(rmat_small)[0], jsvc.BfsFamily(n),
                                  num_slots=2)
  want = "cuda_ell" if jserver.plan.backend == "pallas" else \
      jserver.plan.backend
  assert server.plan.backend == want
  # swap_graph re-fingerprints and re-plans an idle server.
  coo = TG.build_coo(src, dst, w, n=n, device="cpu")
  assert server.swap_graph(coo).backend in ("coo", "coo_tiled")
  assert server.fingerprint == graph_fingerprint(coo)
  qid = server.submit(QuerySpec("bfs", 4))
  np.testing.assert_array_equal(server.drain()[qid], bfs(tg, 4, n).numpy())


@pytest.mark.parametrize("module", ["service/admission.py",
                                    "service/metrics.py", "graphs/rmat.py",
                                    "graphs/preprocess.py"])
def test_pure_python_modules_are_copies(module):
  """The port keeps its own copies of the reference's pure-Python modules
  (it imports nothing of ``repro``); they must not drift."""
  root = pathlib.Path(__file__).resolve().parents[1] / "src"
  assert ((root / "repro_torch" / module).read_text()
          == (root / "repro" / module).read_text())


def test_cache_hits_and_coalescing(rmat_small):
  n = rmat_small[0]
  _, tg = _graphs(rmat_small)
  server = GraphQueryServer(tg, BfsFamily(n), num_slots=2,
                            backend=Plan("cuda_ell"))
  q0, q1 = server.submit_many([QuerySpec("bfs", 5), QuerySpec("bfs", 5)])
  results = server.drain()
  np.testing.assert_array_equal(results[q0], results[q1])
  np.testing.assert_array_equal(results[q0], bfs(tg, 5, n).numpy())
  q2 = server.submit(QuerySpec("bfs", 5))
  np.testing.assert_array_equal(server.result(q2), results[q0])
  counters = server.stats()["counters"]
  assert counters["cache.hits"] == 1 and counters["queries.coalesced"] == 1
  # A column swapped in later must not disturb the cached result.
  server.submit_many([QuerySpec("bfs", s) for s in (7, 8, 9)])
  server.drain()
  np.testing.assert_array_equal(server.result(q2), results[q0])


def test_cancel_and_deadline(rmat_small):
  n = rmat_small[0]
  _, tg = _graphs(rmat_small)
  now = [0.0]
  server = GraphQueryServer(tg, SsspFamily(n), num_slots=1,
                            steps_per_round=1, clock=lambda: now[0])
  running = server.submit(QuerySpec("sssp", 0))
  queued = server.submit(QuerySpec("sssp", 1))
  late = server.submit(QuerySpec("sssp", 2), deadline=5.0)
  assert server.step_round()  # admits `running` only (one slot)
  assert server.cancel(queued) and not server.cancel(queued)
  with pytest.raises(QueryCancelled):
    server.result(queued)
  assert server.cancel(running)  # in flight: its column is masked
  now[0] = 10.0
  assert server.expire_deadlines() == 1
  with pytest.raises(DeadlineExpired):
    server.result(late)
  assert server.num_in_flight == 0 and server.num_queued == 0
  assert server.stats()["counters"]["slots.early_retired"] == 1


def test_driver_serves_concurrent_clients(rmat_small):
  n = rmat_small[0]
  _, tg = _graphs(rmat_small)
  server = GraphQueryServer(tg, BfsFamily(n), num_slots=3,
                            backend=Plan("cuda_ell"))
  got, errors = {}, []

  def client(sources):
    try:
      for s in sources:
        qid = server.submit(QuerySpec("bfs", s))
        got[s] = server.result(qid, timeout=60.0)
    except BaseException as e:  # noqa: BLE001 — surfaced by the assert
      errors.append(e)

  with ServerDriver(server) as driver:
    threads = [threading.Thread(target=client, args=(SOURCES[i::3],))
               for i in range(3)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(60.0)
      assert not t.is_alive()
  assert not errors and driver.error is None
  for s in SOURCES:
    np.testing.assert_array_equal(got[s], bfs(tg, s, n).numpy())
  assert server.closed


def test_concurrent_submitters_stress(rmat_small):
  """More client threads than cores, a short switch interval, and cancels
  racing the driver's in-place column installs: every answered query must
  still equal its single-query run (a lost or torn column update would
  break that)."""
  n = rmat_small[0]
  _, tg = _graphs(rmat_small)
  want = {s: bfs(tg, s, n).numpy() for s in range(0, n, 7)}
  server = GraphQueryServer(tg, BfsFamily(n), num_slots=4, steps_per_round=1,
                            backend=Plan("cuda_ell"))
  errors = []

  def client(k):
    try:
      for i, s in enumerate(sorted(want)[k::16]):
        qid = server.submit(QuerySpec("bfs", s))
        if i % 3 == 2 and server.cancel(qid):
          continue
        got = server.result(qid, timeout=60.0)
        if got is not None:
          np.testing.assert_array_equal(got, want[s])
    except BaseException as e:  # noqa: BLE001 — surfaced by the assert
      errors.append(e)

  old = sys.getswitchinterval()
  sys.setswitchinterval(1e-5)
  try:
    with ServerDriver(server) as driver:
      threads = [threading.Thread(target=client, args=(k,))
                 for k in range(16)]
      for t in threads:
        t.start()
      for t in threads:
        t.join(120.0)
        assert not t.is_alive()
  finally:
    sys.setswitchinterval(old)
  assert not errors and driver.error is None
  assert server.num_in_flight == 0 and server.num_queued == 0
