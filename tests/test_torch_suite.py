"""Triangle counting, collaborative filtering and the native baselines of
the port against the JAX package, on the CPU.

The same numpy graph goes through the JAX function and its port.
Tolerances: triangle counts, bitmaps, BFS hops and SSSP distances (a min
over the same float sums) match exactly; PageRank at rtol 1e-5, atol 1e-7
(the sums run in other orders); CF at rtol 1e-4, atol 1e-5, the
reference's own CF tolerance.  The JAX package draws CF's initial factors
from ``jax.random``; the port is fed that draw as ``p0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.algos import native as jnative  # noqa: E402
from repro.algos.triangle_count import (  # noqa: E402
    bitmap_build_program as j_bitmap_build_program,
    onehot_bitmap as j_onehot_bitmap, triangle_count as j_triangle_count)
from repro.algos.bfs import bfs as j_bfs  # noqa: E402
from repro.algos.collab_filter import (  # noqa: E402
    build_bipartite as j_build_bipartite,
    collaborative_filtering as j_collaborative_filtering)
from repro.core import graph as JG  # noqa: E402
from repro.core.engine import run_fixed_iters as j_run_fixed_iters  # noqa: E402
from repro.graphs import bipartite_ratings, dag_orient, symmetrize  # noqa: E402
import repro_torch.algos as talgos  # noqa: E402
from repro_torch.algos import native as tnative  # noqa: E402
from repro_torch.algos.triangle_count import (  # noqa: E402
    bitmap_build_program, n_words, onehot_bitmap, popcount32)
from repro_torch.algos.collab_filter import build_bipartite, cf_program  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core.backends import Plan  # noqa: E402
from repro_torch.core.engine import run_fixed_iters  # noqa: E402
from repro_torch.core.vertex_program import PROCESS_FORMS  # noqa: E402

TC_BACKENDS = ["dense", "coo", "ell"]
BUILD = {"dense": TG.build_dense, "coo": TG.build_coo, "ell": TG.build_ell}


@pytest.fixture(scope="module")
def dag(rmat_small):
  n, src, dst, _ = rmat_small
  ts, td = dag_orient(src, dst)
  a = np.zeros((n, n), np.int64)
  a[ts, td] = 1
  asym = a + a.T
  return n, ts, td, int(np.trace(asym @ asym @ asym) // 6)


@pytest.fixture(scope="module")
def jax_tc(dag):
  n, ts, td, _ = dag
  fwd, rev = JG.build_coo(ts, td, n=n), JG.build_coo(td, ts, n=n)
  return int(j_triangle_count(fwd, rev, n, backend="coo"))


@pytest.mark.parametrize("backend", TC_BACKENDS)
def test_triangle_count_matches_jax(dag, jax_tc, backend):
  n, ts, td, oracle = dag
  build = BUILD[backend]
  got = talgos.triangle_count(build(ts, td, n=n, device="cpu"),
                              build(td, ts, n=n, device="cpu"), n,
                              backend=Plan(backend))
  assert got.dtype == torch.int64 and got.ndim == 0
  assert int(got) == jax_tc == oracle > 0


@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_bitmaps_match_jax(dag, backend):
  """Phase 1's out-neighbour bitmaps (the generic bitwise-or program) equal
  the reference's uint32 bitmaps viewed as int32."""
  n, ts, td, _ = dag
  jrev = (JG.build_coo if backend == "coo" else JG.build_ell)(td, ts, n=n)
  trev = BUILD[backend](td, ts, n=n, device="cpu")
  joh = j_onehot_bitmap(n)
  jstate = j_run_fixed_iters(jrev, j_bitmap_build_program(), joh,
                             jnp.ones((n,), bool), 1, backend=backend)
  want = np.asarray(jnp.bitwise_and(jstate.prop, ~joh)).view(np.int32)
  toh = onehot_bitmap(n)
  np.testing.assert_array_equal(toh.numpy(), np.asarray(joh).view(np.int32))
  tstate = run_fixed_iters(trev, bitmap_build_program(), toh,
                           torch.ones((n,), dtype=torch.bool), 1,
                           backend=Plan(backend))
  got = (tstate.prop & ~toh).numpy()
  np.testing.assert_array_equal(got, want)
  # Each row's bits are the vertex's out-neighbours.
  rows = np.zeros((n, n_words(n) * 32), bool)
  rows[ts, td] = True
  np.testing.assert_array_equal(
      np.unpackbits(got.view(np.uint8), axis=1, bitorder="little"), rows)


def test_popcount32_matches_numpy():
  words = np.random.default_rng(0).integers(-2**31, 2**31, 4096,
                                             dtype=np.int64).astype(np.int32)
  words[:4] = [-2**31, -1, 0, 2**31 - 1]
  got = popcount32(torch.from_numpy(words))
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(),
                                np.bitwise_count(words.view(np.uint32)))


@pytest.fixture(scope="module")
def ratings():
  users, items, r = bipartite_ratings(60, 30, 8, seed=1)
  return users, items, r, 60, 30


CF_ARGS = dict(k=8, num_iters=25, gamma=0.01, lam=0.05)


def _p0(n, k, seed=0):
  return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (n, k),
                                     jnp.float32, 0.0, 0.1))


@pytest.fixture(scope="module")
def jax_cf(ratings):
  users, items, r, nu, ni = ratings
  g2u, g2i, n = j_build_bipartite(users, items, r, nu, ni)
  return np.asarray(j_collaborative_filtering(g2u, g2i, n, backend="coo",
                                              **CF_ARGS))


@pytest.mark.parametrize("fmt", ["coo", "ell"])
def test_cf_matches_jax(ratings, jax_cf, fmt):
  users, items, r, nu, ni = ratings
  g2u, g2i, n = build_bipartite(users, items, r, nu, ni, fmt=fmt,
                                device="cpu")
  args = dict(CF_ARGS)
  k = args.pop("k")
  got = talgos.collaborative_filtering(g2u, g2i, n, k, p0=_p0(n, k),
                                       backend=Plan(fmt), **args).numpy()
  np.testing.assert_allclose(got, jax_cf, rtol=1e-4, atol=1e-5)
  pred = np.sum(got[users] * got[items + nu], axis=-1)
  rmse = np.sqrt(np.mean((pred - r) ** 2))
  assert rmse < 0.9 * np.sqrt(np.mean((r - r.mean()) ** 2))


def test_cf_initial_factors(ratings):
  users, items, r, nu, ni = ratings
  g2u, g2i, n = build_bipartite(users, items, r, nu, ni, device="cpu")
  with pytest.raises(ValueError, match="p0"):
    talgos.collaborative_filtering(g2u, g2i, n, 4)
  with pytest.raises(ValueError, match="shape"):
    talgos.collaborative_filtering(g2u, g2i, n, 4, p0=np.zeros((n, 3)))
  gen = torch.Generator().manual_seed(0)
  p = talgos.collaborative_filtering(g2u, g2i, n, 4, num_iters=0,
                                     generator=gen)
  assert p.shape == (n, 4) and p.dtype == torch.float32
  assert float(p.min()) >= 0.0 and float(p.max()) < 0.1


@pytest.mark.parametrize("k", [1, 4])
def test_cf_update_is_the_kernel_form_only_at_k1(k):
  """The kernel's ``edge_minus_msg_dst_times_msg`` acts lane by lane; CF's
  error is a dot product over K, so the two agree only at K = 1."""
  rng = np.random.default_rng(k)
  m = torch.from_numpy(rng.uniform(0, 1, (50, k)).astype(np.float32))
  d = torch.from_numpy(rng.uniform(0, 1, (50, k)).astype(np.float32))
  e = torch.from_numpy(rng.uniform(1, 5, (50, 1)).astype(np.float32))
  cf = cf_program(0.1, 0.05).process_message(
      m, e, {"p": d, "side": torch.zeros(50, dtype=torch.int8)})
  lane = PROCESS_FORMS["edge_minus_msg_dst_times_msg"](m, e, d)
  assert torch.allclose(cf, lane) == (k == 1)


# -- the native baselines ------------------------------------------------------


def _native_pair(algo, rmat_small, dag, ratings):
  """(port result, JAX result, exact?) of one native baseline."""
  n, src, dst, w = rmat_small
  if algo == "pagerank":
    deg = np.bincount(src, minlength=n).astype(np.float32)
    return (tnative.native_pagerank(src, dst, deg, n, 10, device="cpu"),
            jnative.native_pagerank(jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(deg), n, 10), False)
  if algo == "bfs":
    ss, dd = symmetrize(src, dst)
    return (tnative.native_bfs(ss, dd, n, 5, device="cpu"),
            jnative.native_bfs(jnp.asarray(ss), jnp.asarray(dd), n, 5), True)
  if algo == "sssp":
    return (tnative.native_sssp(src, dst, w, n, 7, device="cpu"),
            jnative.native_sssp(jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(w), n, 7), True)
  if algo == "tc":
    _, ts, td, _ = dag
    return (tnative.native_tc(ts, td, n, device="cpu"),
            jnative.native_tc(jnp.asarray(ts), jnp.asarray(td), n), True)
  users, items, r, nu, ni = ratings
  ncf = nu + ni
  p0 = _p0(ncf, 8)
  return (tnative.native_cf(users, items + nu, r, ncf, 8, 25, 0.01, 0.05,
                            p0=p0, device="cpu"),
          jnative.native_cf(jnp.asarray(users), jnp.asarray(items + nu),
                            jnp.asarray(r), ncf, 8, 25, 0.01, 0.05), False)


NATIVE = ["pagerank", "bfs", "sssp", "tc", "cf"]


@pytest.mark.parametrize("algo", NATIVE)
def test_native_matches_jax(rmat_small, dag, ratings, algo):
  got, want, exact = _native_pair(algo, rmat_small, dag, ratings)
  want = np.asarray(want)
  assert got.shape == want.shape
  if algo == "tc":
    assert got.dtype == torch.int64 and int(got) == int(want) == dag[3]
  elif exact:
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_array_equal(got.numpy(), want)
  elif algo == "cf":
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
  else:
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("algo", NATIVE)
def test_graphmat_matches_native(rmat_small, dag, ratings, algo):
  """The comparison the chip phase makes at full size, here small: each
  GraphMat entry point of the port against the port's native baseline."""
  n, src, dst, w = rmat_small
  native, _, _ = _native_pair(algo, rmat_small, dag, ratings)
  if algo == "pagerank":
    g = TG.build_ell(src, dst, w, n=n, device="cpu")
    deg = torch.from_numpy(np.bincount(src, minlength=n).astype(np.float32))
    got = talgos.pagerank(g, deg, num_iters=10, backend=Plan("cuda_ell"))
    torch.testing.assert_close(got, native, rtol=1e-5, atol=1e-7)
  elif algo == "bfs":
    ss, dd = symmetrize(src, dst)
    g = TG.build_ell(ss, dd, n=n, device="cpu")
    assert torch.equal(talgos.bfs(g, 5, n, backend=Plan("cuda_ell")), native)
  elif algo == "sssp":
    g = TG.build_ell(src, dst, w, n=n, device="cpu")
    assert torch.equal(talgos.sssp(g, 7, n, backend=Plan("cuda_ell")),
                       native)
  elif algo == "tc":
    _, ts, td, _ = dag
    got = talgos.triangle_count(TG.build_coo(ts, td, n=n, device="cpu"),
                                TG.build_coo(td, ts, n=n, device="cpu"), n,
                                backend=Plan("coo"))
    assert int(got) == int(native)
  else:
    users, items, r, nu, ni = ratings
    g2u, g2i, ncf = build_bipartite(users, items, r, nu, ni, device="cpu")
    got = talgos.collaborative_filtering(
        g2u, g2i, ncf, 8, num_iters=25, gamma=0.01, lam=0.05,
        p0=_p0(ncf, 8), backend=Plan("coo"))
    torch.testing.assert_close(got, native, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("algo", NATIVE)
def test_native_default_device_is_the_card(algo):
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is valid")
  e = np.array([0, 1], np.int32), np.array([1, 0], np.int32)
  calls = {
      "pagerank": lambda: tnative.native_pagerank(*e, np.ones(2), 2),
      "bfs": lambda: tnative.native_bfs(*e, 2, 0),
      "sssp": lambda: tnative.native_sssp(*e, np.ones(2, np.float32), 2, 0),
      "tc": lambda: tnative.native_tc(*e, 2),
      "cf": lambda: tnative.native_cf(*e, np.ones(2, np.float32), 2, 1,
                                      p0=np.zeros((2, 1), np.float32)),
  }
  with pytest.raises(RuntimeError, match="device='cpu'"):
    calls[algo]()


def test_bfs_reference_on_symmetrized_graph(rmat_small):
  """The JAX GraphMat BFS and the port's native BFS agree (the JAX
  package's own graphmat-vs-native check, carried across)."""
  n, src, dst, _ = rmat_small
  ss, dd = symmetrize(src, dst)
  want = np.asarray(j_bfs(JG.build_coo(ss, dd, n=n), 5, n, backend="coo"))
  got = tnative.native_bfs(ss, dd, n, 5, device="cpu")
  np.testing.assert_array_equal(got.numpy(), want)
