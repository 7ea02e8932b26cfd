"""The six algorithm entry points, on every port backend, against JAX.

The JAX reference runs once per algorithm (COO backend).  BFS and SSSP
(int32 hops, min-plus) match bitwise on every backend; the PageRank family
(float add) matches with rtol 1e-5, atol 1e-7, since the backends sum in
different orders.  ``cuda_ell`` runs its kernel's plain version here.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.algos as jalgos  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.backends import Plan as JPlan  # noqa: E402
import repro_torch.algos as talgos  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core.backends import Plan  # noqa: E402

BACKENDS = ["dense", "coo", "coo_tiled", "ell", "cuda_ell"]
ALGOS = ["bfs", "sssp", "pagerank", "delta_pagerank", "multi_bfs",
         "multi_sssp", "personalized_pagerank"]
SOURCES = [0, 3, 17, 128]


def _run(lib, g, plan, algo, n, out_deg):
  if algo == "bfs":
    return lib.bfs(g, 3, n, backend=plan)
  if algo == "sssp":
    return lib.sssp(g, 3, n, backend=plan)
  if algo == "pagerank":
    return lib.pagerank(g, out_deg, num_iters=10, backend=plan)
  if algo == "delta_pagerank":
    return lib.pagerank(g, out_deg, num_iters=60, tol=1e-6, backend=plan)
  if algo == "multi_bfs":
    return lib.multi_bfs(g, SOURCES, n, backend=plan)
  if algo == "multi_sssp":
    return lib.multi_sssp(g, SOURCES, n, backend=plan)
  return lib.personalized_pagerank(g, out_deg, SOURCES, tol=1e-6,
                                   backend=plan)


@pytest.fixture(scope="module")
def jax_results(rmat_small):
  n, src, dst, w = rmat_small
  g = JG.build_coo(src, dst, w, n=n)
  out_deg = jnp.asarray(np.bincount(src, minlength=n).astype(np.float32))
  return {a: np.asarray(_run(jalgos, g, JPlan("coo"), a, n, out_deg))
          for a in ALGOS}


@pytest.fixture(scope="module")
def torch_graphs(rmat_small):
  n, src, dst, w = rmat_small
  coo = TG.build_coo(src, dst, w, n=n, device="cpu")
  ell = TG.build_ell(src, dst, w, n=n, width=16, device="cpu")  # spills
  return {"dense": TG.build_dense(src, dst, w, n=n, device="cpu"),
          "coo": coo, "coo_tiled": coo, "ell": ell, "cuda_ell": ell}


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_entry_point_matches_jax(rmat_small, jax_results, torch_graphs,
                                 algo, backend):
  n, src = rmat_small[0], rmat_small[1]
  out_deg = torch.from_numpy(np.bincount(src, minlength=n).astype(np.float32))
  plan = Plan(backend=backend,
              num_tiles=4 if backend == "coo_tiled" else None)
  got = _run(talgos, torch_graphs[backend], plan, algo, n, out_deg)
  want = jax_results[algo]
  assert isinstance(got, torch.Tensor) and got.shape == want.shape
  if "pagerank" in algo:
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
  else:
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_array_equal(got.numpy(), want)
