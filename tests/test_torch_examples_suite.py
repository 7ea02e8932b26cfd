"""``examples/graph_analytics_suite_torch.py`` against
``examples/graph_analytics_suite.py``.

Each section of the port's example runs on the CPU at the reference's
sizes and is held against the reference's functions on the same numpy
inputs: the road grid's arrays equal; PageRank at rtol 1e-5 with the same
top-5 (float sums in another order); BFS hops and the road grid's SSSP
bitwise (min over the same candidates); the same triangle count;
collaborative filtering, given the reference's initial factors, at rtol
1e-4 / atol 1e-5 (the tolerance of ``test_torch_suite.py::
test_cf_matches_jax``).

The reference's CF at the example's settings (γ = 0.01, 20 sweeps)
diverges: its RMSE is nan.  The port keeps that, from the reference's draw
and from its own (``ROADMAP.md``, Queue 3 item 16).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CF_TOL = dict(rtol=1e-4, atol=1e-5)


def _load(name):
  spec = importlib.util.spec_from_file_location(
      f"_example_{name}", ROOT / "examples" / f"{name}.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.fixture(scope="module")
def port():
  return _load("graph_analytics_suite_torch")


@pytest.fixture(scope="module")
def ref():
  return _load("graph_analytics_suite")


def _rmat(ref, scale=11):
  src, dst = ref.rmat_edges(scale, 8, ref.RMAT_PRBFS, seed=1)
  src, dst = ref.remove_self_loops(src, dst)
  return ref.dedupe_edges(src, dst) + (1 << scale,)


@pytest.mark.parametrize("w_side", [48, 5])
def test_grid_road_graph_matches_reference(port, ref, w_side):
  got, want = port.grid_road_graph(w_side), ref.grid_road_graph(w_side)
  assert got[0] == want[0] == w_side * w_side
  for a, b in zip(got[1:], want[1:]):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_pagerank_matches_reference(port, ref):
  src, dst, n = _rmat(ref)
  out_deg = jnp.asarray(np.bincount(src, minlength=n).astype(np.float32))
  want = np.asarray(ref.pagerank(ref.G.build_ell(src, dst, n=n), out_deg,
                                 num_iters=20))
  ranks, top = port.pagerank_section(11, "cpu")
  np.testing.assert_allclose(ranks.numpy(), want, rtol=1e-5)
  assert top == np.argsort(-want)[:5].tolist() == [0, 1, 64, 16, 512]


def test_bfs_matches_reference(port, ref):
  src, dst, n = _rmat(ref)
  ss, dd = ref.symmetrize(src, dst)
  want = np.asarray(ref.bfs(ref.G.build_ell(ss, dd, n=n), 0, n))
  hops, ecc = port.bfs_section(11, "cpu")
  np.testing.assert_array_equal(hops.numpy(), want)
  assert ecc == int(np.max(want[want < 2**30])) == 3


def test_road_sssp_matches_reference(port, ref):
  rn, rs, rd, rw = ref.grid_road_graph()
  want = np.asarray(ref.sssp(ref.G.build_coo(rs, rd, rw, n=rn), 0, rn))
  dist, mean = port.road_sssp_section(48, "cpu")
  np.testing.assert_array_equal(dist.numpy(), want)
  assert mean == float(np.mean(want))


def test_triangles_match_reference(port, ref):
  ts, td = ref.rmat_edges(10, 8, ref.RMAT_TC, seed=2)
  ts, td = ref.remove_self_loops(ts, td)
  ts, td = ref.dag_orient(ts, td)
  tn = 1 << 10
  want = int(ref.triangle_count(ref.G.build_coo(ts, td, n=tn),
                                ref.G.build_coo(td, ts, n=tn), tn))
  assert port.triangle_section(10, "cpu") == want == 2921


def _reference_cf(ref, num_iters):
  users, items, ratings = ref.bipartite_ratings(3000, 500, 12, seed=4)
  g2u, g2i, ncf = ref.build_bipartite(users, items, ratings, 3000, 500)
  return np.asarray(ref.collaborative_filtering(
      g2u, g2i, ncf, k=16, num_iters=num_iters, gamma=0.01, lam=0.05))


@pytest.mark.parametrize("num_iters", [1, 20])
def test_cf_matches_reference_given_its_draw(port, ref, num_iters):
  want = _reference_cf(ref, num_iters)
  p0 = np.array(jax.random.uniform(jax.random.PRNGKey(0), (3500, 16),
                                   jnp.float32, 0.0, 0.1))
  P, rmse, base = port.collaborative_filtering_section(
      num_iters=num_iters, device="cpu", p0=p0)
  # NaN where the reference is NaN, and the finite entries within CF_TOL.
  np.testing.assert_allclose(P.numpy(), want, **CF_TOL)
  assert base == pytest.approx(1.4168, abs=1e-4)
  if num_iters == 1:
    assert np.isfinite(want).all() and np.isfinite(rmse)
  else:
    # The reference's example diverges at its own settings (RMSE nan).
    assert not np.isfinite(want).all() and np.isnan(rmse)


def test_cf_with_the_ports_own_draw_diverges_as_the_reference_does(port):
  P1, rmse1, base = port.collaborative_filtering_section(num_iters=1,
                                                         device="cpu")
  assert torch.isfinite(P1).all() and np.isfinite(rmse1)
  P, rmse, base = port.collaborative_filtering_section(device="cpu")
  assert P.shape == (3500, 16) and np.isnan(rmse)
  assert base == pytest.approx(1.4168, abs=1e-4)


def test_main_prints_the_reference_lines(port, ref, capsys):
  ref.main()
  want = capsys.readouterr().out
  port.main(["--device", "cpu"])
  got = capsys.readouterr().out
  assert got == want
  assert "RMSE nan (constant-predictor baseline 1.417)" in got
