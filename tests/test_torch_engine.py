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
