"""The port's superstep engines against the JAX package.

BFS and SSSP states (int32 / min-plus) match bitwise; delta-PageRank states
(float add) match with rtol 1e-5, atol 1e-7, because the two frameworks sum
in different orders.  Frontiers and counters match exactly in every case.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.algos import multi as jmulti  # noqa: E402
from repro.algos.pagerank import (  # noqa: E402
    delta_pagerank_program as j_delta_pr)
from repro.core import backends as jbe  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.algos import multi as tmulti  # noqa: E402
from repro_torch.algos.pagerank import delta_pagerank_program  # noqa: E402
from repro_torch.core import backends as tbe  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402

SOURCES = np.array([0, 5, 17, 42, 99, 200], np.int32)


def _graphs(rmat_small, backend):
  n, src, dst, w = rmat_small
  if backend == "ell":
    return JG.build_ell(src, dst, w, n=n), TG.build_ell(src, dst, w, n=n,
                                                        device="cpu")
  return JG.build_coo(src, dst, w, n=n), TG.build_coo(src, dst, w, n=n,
                                                      device="cpu")


def _init(kind, n, out_deg):
  """(JAX program, init prop, init active), (port ...) for one family."""
  if kind == "bfs":
    jp, ja = jmulti.bfs_columns(jnp.asarray(SOURCES), n)
    tp, ta = tmulti.bfs_columns(torch.from_numpy(SOURCES), n)
    return ((jmulti.multi_bfs_program(), jp, ja),
            (tmulti.multi_bfs_program(), tp, ta))
  if kind == "sssp":
    jp, ja = jmulti.sssp_columns(jnp.asarray(SOURCES), n)
    tp, ta = tmulti.sssp_columns(torch.from_numpy(SOURCES), n)
    return ((jmulti.multi_sssp_program(), jp, ja),
            (tmulti.multi_sssp_program(), tp, ta))
  jp, ja = jmulti.ppr_columns(jnp.asarray(SOURCES), jnp.asarray(out_deg), 0.15)
  tp, ta = tmulti.ppr_columns(torch.from_numpy(SOURCES),
                              torch.from_numpy(out_deg), 0.15)
  return ((j_delta_pr(tol=1e-6), jp, ja),
          (delta_pagerank_program(tol=1e-6), tp, ta))


def assert_state(t, j, kind):
  for tl, jl in zip(_tree.tree_leaves(t.prop),
                    [j.prop[k] for k in sorted(j.prop)]
                    if isinstance(j.prop, dict) else [j.prop]):
    if kind == "ppr":
      np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                 atol=1e-7)
    else:
      np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
  for f in ("active", "done", "num_active", "iters", "iteration"):
    got, want = getattr(t, f).numpy(), np.asarray(getattr(j, f))
    assert got.dtype == want.dtype, f
    np.testing.assert_array_equal(got, want, err_msg=f)


def _out_deg(rmat_small):
  n, src = rmat_small[0], rmat_small[1]
  return np.bincount(src, minlength=n).astype(np.float32)


@pytest.mark.parametrize("backend", ["coo", "ell"])
@pytest.mark.parametrize("kind", ["bfs", "sssp", "ppr"])
def test_run_batched_matches_jax(rmat_small, backend, kind):
  jg, tg = _graphs(rmat_small, backend)
  (jprog, jp, ja), (tprog, tp, ta) = _init(kind, rmat_small[0],
                                           _out_deg(rmat_small))
  js = jeng.run_batched(jg, jprog, jp, ja, backend=jbe.Plan(backend))
  ts = teng.run_batched(tg, tprog, tp, ta, backend=tbe.Plan(backend))
  assert_state(ts, js, kind)
  assert bool(ts.done.all())


@pytest.mark.parametrize("kind", ["bfs", "ppr"])
def test_run_batched_rounds_matches_jax(rmat_small, kind):
  jg, tg = _graphs(rmat_small, "ell")
  (jprog, jp, ja), (tprog, tp, ta) = _init(kind, rmat_small[0],
                                           _out_deg(rmat_small))
  js, ts = jeng.init_batched_state(jp, ja), teng.init_batched_state(tp, ta)
  for steps in (3, 4, 40):  # the last round ends in no-op steps (-1 trace)
    js, jtrace = jeng.run_batched_rounds(jg, jprog, js, steps,
                                         backend=jbe.Plan("ell"))
    ts, ttrace = teng.run_batched_rounds(tg, tprog, ts, steps,
                                         backend=tbe.Plan("cuda_ell"))
    assert ttrace.dtype == torch.int32
    np.testing.assert_array_equal(ttrace.numpy(), np.asarray(jtrace))
    assert_state(ts, js, kind)
  assert (ttrace == -1).any()


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_mask_columns_keeps_survivors_bitwise(rmat_small, kind):
  """Lane independence: retiring columns mid-flight leaves every other
  column's trajectory bitwise unchanged, in the port as in JAX."""
  jg, tg = _graphs(rmat_small, "coo")
  (jprog, jp, ja), (tprog, tp, ta) = _init(kind, rmat_small[0], None)
  plan = tbe.Plan("coo")
  full = teng.init_batched_state(tp, ta)
  full, _ = teng.run_batched_rounds(tg, tprog, full, 30, backend=plan)

  ts = teng.init_batched_state(tp, ta)
  ts, _ = teng.run_batched_rounds(tg, tprog, ts, 1, backend=plan)
  ts = teng.mask_columns(ts, [1, 4])
  assert bool(ts.done[1]) and not bool(ts.active[:, 4].any())
  ts, _ = teng.run_batched_rounds(tg, tprog, ts, 29, backend=plan)
  keep = [0, 2, 3, 5]
  assert torch.equal(ts.prop[:, keep], full.prop[:, keep])
  assert torch.equal(ts.iters[keep], full.iters[keep])

  js = jeng.init_batched_state(jp, ja)
  js, _ = jeng.run_batched_rounds(jg, jprog, js, 1, backend=jbe.Plan("coo"))
  js = jeng.mask_columns(js, jnp.asarray([1, 4], jnp.int32))
  js, _ = jeng.run_batched_rounds(jg, jprog, js, 29, backend=jbe.Plan("coo"))
  assert_state(ts, js, kind)


@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_single_query_engines_match_jax(rmat_small, backend):
  jg, tg = _graphs(rmat_small, backend)
  n = rmat_small[0]
  out_deg = _out_deg(rmat_small)
  (jprog, jp, ja), (tprog, tp, ta) = _init("bfs", n, out_deg)
  js = jeng.run_graph_program(jg, jprog, jp[:, 0], ja[:, 0],
                              backend=jbe.Plan(backend))
  ts = teng.run_graph_program(tg, tprog, tp[:, 0], ta[:, 0],
                              backend=tbe.Plan(backend))
  np.testing.assert_array_equal(ts.prop.numpy(), np.asarray(js.prop))
  assert int(ts.iteration) == int(js.iteration) and int(ts.num_active) == 0
  assert ts.iteration.dtype == ts.num_active.dtype == torch.int32

  from repro.algos.pagerank import init_prop as j_init
  from repro.algos.pagerank import pagerank_program as j_pr
  from repro_torch.algos.pagerank import init_prop, pagerank_program
  act = np.ones(n, bool)
  js = jeng.run_fixed_iters(jg, j_pr(), j_init(jnp.asarray(out_deg)),
                            jnp.asarray(act), 5, backend=jbe.Plan(backend))
  ts = teng.run_fixed_iters(tg, pagerank_program(),
                            init_prop(torch.from_numpy(out_deg)),
                            torch.from_numpy(act), 5,
                            backend=tbe.Plan(backend))
  np.testing.assert_allclose(ts.prop["rank"].numpy(),
                             np.asarray(js.prop["rank"]), rtol=1e-5)
  assert int(ts.iteration) == 5 and int(ts.num_active) == n


def test_core_exports_the_references_public_names():
  """``repro_torch.core`` offers every public name of ``repro.core`` that
  the examples import (``run_graph_program`` in the quickstart); the
  reference's ``popcount`` is the port's ``algos.triangle_count.popcount32``
  (int32 words, ROADMAP Queue 3 item 4), not re-exported."""
  import repro.core as jcore
  import repro_torch.core as tcore
  want = {k for k in dir(jcore) if not k.startswith("_")} - {"popcount"}
  missing = sorted(k for k in want if not hasattr(tcore, k))
  assert not missing, missing
  assert tcore.run_graph_program is teng.run_graph_program
  assert tcore.run_fixed_iters is teng.run_fixed_iters
  assert tcore.EngineState is teng.EngineState
  assert tcore.dense_adjacency is TG.dense_adjacency


# --- The level sweep (Brandes' backward pass, repro_torch.algos.bc) ---------

# A tree (each vertex's parent), made undirected for the sweep.
TREE = [-1, 0, 0, 1, 1, 2, 3, 3, 5, 5, 5, 8, 11, 11]


def _tree_graph(plan):
  n = len(TREE)
  pairs = [(v, p) for v, p in enumerate(TREE) if p >= 0]
  src = np.array([a for a, b in pairs] + [b for a, b in pairs], np.int32)
  dst = np.array([b for a, b in pairs] + [a for a, b in pairs], np.int32)
  if plan == "coo":
    return n, TG.build_coo(src, dst, None, n=n, device="cpu")
  return n, TG.build_ell(src, dst, None, n=n, width=2, device="cpu")


def _depths(g, n, roots):
  """int32 [n, Q] BFS levels from ``roots`` (-1 unreached; none here)."""
  d = tmulti.multi_bfs(g, roots, n, backend=tbe.Plan("coo"))
  return torch.where(d == tmulti.UNREACHED, -1, d)


def _below_program():
  """A vertex's count of the vertices below it: a level sends each
  vertex's count plus one, summed into the level above."""
  from repro_torch.core.vertex_program import GraphProgram, lanewise_activate
  return GraphProgram(process_op="msg", reduce_kind="add",
                      send_message=lambda p: p + 1,
                      apply=lambda red, old: red,
                      activate=lanewise_activate, needs_recv=False,
                      inert_message=0, lanewise=True)


def _below(n, roots):
  """The same counts in Python: a vertex's descendants away from a root."""
  adj = {v: set() for v in range(n)}
  for v, p in enumerate(TREE):
    if p >= 0:
      adj[v].add(p)
      adj[p].add(v)
  out = np.zeros((n, len(roots)), np.int32)
  for lane, r in enumerate(roots):
    def count(v, up):
      return sum(1 + count(w, v) for w in adj[v] if w != up)
    for v in range(n):
      # v's parent away from r: the neighbour on v's path to r.
      path, seen, todo = {r: None}, {r}, [r]
      while todo:
        u = todo.pop()
        for w in adj[u]:
          if w not in seen:
            seen.add(w)
            path[w] = u
            todo.append(w)
      out[v, lane] = count(v, path[v])
  return out


@pytest.mark.parametrize("plan", ["coo", "ell", "cuda_ell"])
def test_level_sweep_sums_each_level_into_the_one_above(plan):
  """Two lanes rooted at different vertices sweep their own levels, each
  level's sum landing on the level above: every vertex ends with the count
  of the vertices below it from that lane's root, and each lane equals its
  sweep alone."""
  n, g = _tree_graph(plan)
  roots = [0, 11]
  depth = _depths(g, n, roots)
  deepest = int(depth.max())
  zero = torch.zeros((n, 2), dtype=torch.int32)
  got = teng.run_level_sweep(g, _below_program(), zero, depth, deepest,
                             backend=tbe.Plan(plan))
  np.testing.assert_array_equal(got.numpy(), _below(n, roots))
  for lane in range(2):
    alone = teng.run_level_sweep(
        g, _below_program(), zero[:, lane:lane + 1],
        depth[:, lane:lane + 1].contiguous(), int(depth[:, lane].max()),
        backend=tbe.Plan(plan))
    assert torch.equal(alone[:, 0], got[:, lane])


def test_level_sweep_frontiers_are_the_levels(monkeypatch):
  """One batched superstep a level, deepest first, whose frontier is lane
  by lane ``depth == d`` with every lane live, and whose result is kept
  only one level up."""
  n, g = _tree_graph("coo")
  depth = _depths(g, n, [0, 11])
  deepest = int(depth.max())
  seen = []
  real = teng._batched_superstep

  def spy(graph, program, state, plan):
    seen.append((state.active.clone(), state.done.clone()))
    out = real(graph, program, state, plan)
    return out._replace(prop=torch.full_like(out.prop, 100 + len(seen)))
  monkeypatch.setattr(teng, "_batched_superstep", spy)
  got = teng.run_level_sweep(g, _below_program(),
                             torch.zeros((n, 2), dtype=torch.int32), depth,
                             deepest, backend=tbe.Plan("coo"))
  assert len(seen) == deepest
  for k, (active, done) in enumerate(seen):
    assert torch.equal(active, depth == deepest - k)
    assert not bool(done.any())
  want = torch.where(depth < deepest, 100 + deepest - depth, 0)
  assert torch.equal(got, want.to(torch.int32))


def test_level_sweep_of_no_level_runs_nothing(monkeypatch):
  n, g = _tree_graph("coo")
  depth = _depths(g, n, [0])
  monkeypatch.setattr(teng, "_batched_superstep", None)
  prop = torch.arange(n, dtype=torch.int32)[:, None]
  assert teng.run_level_sweep(g, _below_program(), prop, depth, 0,
                              backend=tbe.Plan("coo")) is prop


def test_level_sweep_reads_nothing_back(monkeypatch):
  """No host read inside the sweep: a tensor's value read on the host
  raises there."""
  n, g = _tree_graph("coo")
  depth = _depths(g, n, [0, 11])
  deepest = int(depth.max())

  def refuse(*args, **kwargs):
    raise AssertionError("a host read inside the level sweep")
  for name in ("item", "tolist", "__bool__", "__int__", "__float__",
               "numpy", "cpu"):
    monkeypatch.setattr(torch.Tensor, name, refuse)
  got = teng.run_level_sweep(g, _below_program(),
                             torch.zeros((n, 2), dtype=torch.int32), depth,
                             deepest, backend=tbe.Plan("coo"))
  monkeypatch.undo()
  np.testing.assert_array_equal(got.numpy(), _below(n, [0, 11]))
