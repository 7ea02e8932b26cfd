"""``examples/multi_query_service_torch.py`` against
``examples/multi_query_service.py``.

The port's sections run on the CPU at the reference's sizes (RMAT-10) and
are held against the reference's server on the same numpy inputs: every
BFS ticket bitwise; personalized PageRank at rtol 1e-5 with the same top-5
(float sums in another order); the fair-share split under saturation
exactly the reference's (the scheduler is deterministic).  The concurrent
section depends on thread timing, so only its invariants are checked.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.concurrency


def _load(name):
  spec = importlib.util.spec_from_file_location(
      f"_example_{name}", ROOT / "examples" / f"{name}.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.fixture(scope="module")
def port():
  return _load("multi_query_service_torch")


@pytest.fixture(scope="module")
def ref():
  return _load("multi_query_service")


@pytest.fixture(scope="module")
def graphs(port):
  return port.build_graphs(10, "cpu")


@pytest.fixture(scope="module")
def ref_graphs(ref):
  n = 1 << 10
  src, dst = ref.rmat_edges(10, 8, seed=7)
  src, dst = ref.remove_self_loops(src, dst)
  src, dst = ref.dedupe_edges(src, dst)
  ss, dd = ref.symmetrize(src, dst)
  out_deg = jnp.asarray(np.bincount(src, minlength=n).astype(np.float32))
  return {"n": n, "graph": ref.G.build_ell(ss, dd, n=n),
          "pgraph": ref.G.build_coo(src, dst, n=n), "out_deg": out_deg}


def test_sources_are_the_references(graphs):
  rng = np.random.default_rng(0)
  assert graphs["bfs_sources"] == (rng.integers(0, 1024, 18).tolist()
                                   + [5, 5, 9, 9, 5, 9])
  assert graphs["ppr_sources"] == rng.integers(0, 1024, 10).tolist()


def test_bfs_section_matches_reference(port, ref, graphs, ref_graphs):
  out = port.serve_bfs(graphs)
  n = ref_graphs["n"]
  server = ref.GraphQueryServer(ref_graphs["graph"], ref.BfsFamily(n),
                                num_slots=8, steps_per_round=2)
  qids = [server.submit(ref.QuerySpec("bfs", s))
          for s in graphs["bfs_sources"]]
  want = server.drain()
  assert len(out["results"]) == len(want) == 24
  assert list(out["tickets"].values()) == graphs["bfs_sources"]
  for got_q, want_q in zip(out["tickets"], qids):
    assert out["results"][got_q].dtype == want[want_q].dtype
    np.testing.assert_array_equal(out["results"][got_q], want[want_q])
  assert out["stats"]["counters"]["queries.completed"] == \
      server.stats()["counters"]["queries.completed"]


def test_ppr_section_matches_reference(port, ref, graphs, ref_graphs):
  out = port.serve_ppr(graphs)
  server = ref.GraphQueryServer(ref_graphs["pgraph"],
                                ref.PprFamily(ref_graphs["out_deg"], tol=1e-6),
                                num_slots=4, steps_per_round=4)
  qids = [server.submit(ref.QuerySpec("ppr", s))
          for s in graphs["ppr_sources"]]
  want = server.drain()
  for got_q, want_q in zip(out["qids"], qids):
    np.testing.assert_allclose(out["results"][got_q], want[want_q],
                               rtol=1e-5)
  assert out["top"] == np.argsort(-want[qids[0]])[:5].tolist()
  s2c = server.stats()["histograms"]["query.supersteps_to_converge"]
  got = out["supersteps_to_converge"]
  assert (got["count"], got["min"], got["max"]) == (s2c["count"], s2c["min"],
                                                    s2c["max"])


def test_fair_share_split_is_the_references(port, ref, graphs, ref_graphs):
  out = port.serve_fair_share(graphs)
  n = ref_graphs["n"]
  weights = {"gold": 3.0, "free": 1.0}
  server = ref.GraphQueryServer(ref_graphs["graph"], ref.BfsFamily(n),
                                num_slots=4, steps_per_round=4,
                                admission=ref.FairSharePolicy(weights=weights))
  for i in range(20):
    server.submit(ref.QuerySpec("bfs", i, tenant="gold"))
    server.submit(ref.QuerySpec("bfs", 20 + i, tenant="free"))
  while min(server.debug_snapshot()["tenant_depth"].get(t, 0)
            for t in weights) > 2:
    server.step_round()
  mid = {t: int(server.counters.get_labeled("queries.completed", tenant=t))
         for t in weights}
  assert out["mid"] == mid == {"gold": 15, "free": 5}
  assert all(w["completed"] == 20 for w in out["waits"].values())


def test_concurrent_section_invariants(port, graphs):
  out = port.serve_concurrent(graphs)
  tally = out["tally"]
  assert sorted(tally) == ["expired", "ok", "shed"]
  assert tally["ok"] + tally["shed"] + tally["expired"] == 64
  assert out["shed"] == tally["shed"]


def test_main_prints_the_reference_lines(port, ref, capsys):
  """The lines that do not carry times or thread interleavings."""
  ref.main()
  want = capsys.readouterr().out.splitlines()
  port.main(["--device", "cpu"])
  got = capsys.readouterr().out.splitlines()
  stable = ("graph:", "bfs: served", "ppr", "fair-share")
  pick = lambda lines: [l for l in lines if l.startswith(stable)]  # noqa: E731
  assert len(pick(want)) == 5 and pick(got) == pick(want)
  assert any(l.startswith("concurrent bfs: ") and "across 64 tickets" in l
             for l in got)
