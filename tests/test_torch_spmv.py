"""The port's SpMV backends, registry and planner against the JAX package.

The same numpy graph, messages, frontier and properties go through the JAX
backend and its port.  Tolerances: int32 results and min/max reductions
match bitwise (the same values are reduced); float add reductions match
with rtol 1e-5 (atol 1e-6 for values near zero), because the two
frameworks sum in different orders.  ``recv`` matches exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.algos.bfs import bfs_program as j_bfs_program  # noqa: E402
from repro.algos.pagerank import (  # noqa: E402
    pagerank_program as j_pagerank_program)
from repro.algos.sssp import sssp_program as j_sssp_program  # noqa: E402
from repro.core import backends as jbe  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import spmv as jspmv  # noqa: E402
from repro.core.vertex_program import GraphProgram as JProgram  # noqa: E402
from repro_torch.algos.bfs import bfs_program  # noqa: E402
from repro_torch.algos.pagerank import pagerank_program  # noqa: E402
from repro_torch.algos.sssp import sssp_program  # noqa: E402
from repro_torch.core import backends as tbe  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import spmv as tspmv  # noqa: E402
from repro_torch.core.vertex_program import GraphProgram  # noqa: E402

PROGRAMS = {
    "bfs": (j_bfs_program, bfs_program, np.int32),
    "sssp": (j_sssp_program, sssp_program, np.float32),
    "pagerank": (j_pagerank_program, pagerank_program, np.float32),
}
BACKENDS = ("dense", "coo", "coo_tiled", "ell")


def _graphs(rmat_small, backend, width=None):
  n, src, dst, w = rmat_small
  if backend == "dense":
    return (JG.build_dense(src, dst, w, n=n),
            TG.build_dense(src, dst, w, n=n, device="cpu"))
  if backend in ("ell", "cuda_ell"):
    return (JG.build_ell(src, dst, w, n=n, width=width),
            TG.build_ell(src, dst, w, n=n, width=width, device="cpu"))
  return (JG.build_coo(src, dst, w, n=n),
          TG.build_coo(src, dst, w, n=n, device="cpu"))


def _inputs(n, q, dtype, seed=0):
  """msg, active, prop as numpy; q=0 means scalar payloads."""
  rng = np.random.default_rng(seed)
  shape = (n,) if q == 0 else (n, q)
  if dtype == np.int32:
    msg = rng.integers(0, 20, shape).astype(np.int32)
  else:
    msg = rng.uniform(0.0, 3.0, shape).astype(np.float32)
  active = rng.uniform(size=n) < 0.6
  return msg, active, msg.copy()


def assert_match(got, want, reduce_kind, what=""):
  got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want)
  if reduce_kind != "add" or want.dtype.kind in "iub":
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=what)


def _plan_pair(backend):
  if backend == "coo_tiled":
    return (jbe.Plan(backend="coo_tiled", num_tiles=5),
            tbe.Plan(backend="coo_tiled", num_tiles=5))
  if backend == "cuda_ell":
    return jbe.Plan(backend="ell"), tbe.Plan(backend="cuda_ell")
  return jbe.Plan(backend=backend), tbe.Plan(backend=backend)


def run_both(rmat_small, backend, prog_name, q, width=None, seed=0):
  jmake, tmake, dtype = PROGRAMS[prog_name]
  jg, tg = _graphs(rmat_small, backend, width)
  n = rmat_small[0]
  msg, active, prop = _inputs(n, q, dtype, seed)
  jplan, tplan = _plan_pair(backend)
  jy, jr = jspmv.spmv(jg, jnp.asarray(msg), jnp.asarray(active),
                      jnp.asarray(prop), jmake(), backend=jplan)
  ty, tr = tspmv.spmv(tg, torch.from_numpy(msg), torch.from_numpy(active),
                      torch.from_numpy(prop), tmake(), backend=tplan)
  return jy, jr, ty, tr, tmake().reduce_kind


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("prog", sorted(PROGRAMS))
@pytest.mark.parametrize("q", [0, 3])
def test_spmv_backend_matches_jax(rmat_small, backend, prog, q):
  jy, jr, ty, tr, kind = run_both(rmat_small, backend, prog, q)
  assert ty.shape == jy.shape and tr.dtype == torch.bool
  assert_match(ty, jy, kind, f"{backend}/{prog}/q={q}")
  np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("prog", sorted(PROGRAMS))
def test_ell_spill_matches_jax(rmat_small, prog):
  # width=8 spills the hub rows' excess edges into the COO tail.
  jy, jr, ty, tr, kind = run_both(rmat_small, "ell", prog, 3, width=8)
  assert_match(ty, jy, kind)
  np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("kind", ["min", "max", "add", "any"])
@pytest.mark.parametrize("num_tiles", [1, 3, 64])
def test_coo_tiled_equals_coo(rmat_small, kind, num_tiles):
  """min/max/any: bitwise.  add: allclose, because on the card the add
  scatter uses atomics (bitwise here on the CPU, not guaranteed there)."""
  _, tg = _graphs(rmat_small, "coo")
  n = rmat_small[0]
  if kind == "any":
    prog = GraphProgram(process_message=lambda m, e, d: m > 1.0,
                        reduce_kind="any", process_reads_dst=False)
  else:
    prog = GraphProgram(process_message=lambda m, e, d: m * e,
                        reduce_kind=kind, process_reads_dst=False)
  msg, active, prop = _inputs(n, 2, np.float32, seed=4)
  args = (torch.from_numpy(msg), torch.from_numpy(active),
          torch.from_numpy(prop), prog)
  y0, r0 = tspmv.spmv_coo(tg, *args)
  y1, r1 = tspmv.spmv_coo_tiled(tg, *args, num_tiles=num_tiles)
  assert torch.equal(r0, r1)
  if kind == "add":
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-6)
  else:
    assert torch.equal(y0, y1)


def test_mask_inert_matches_jax(rmat_small):
  n = rmat_small[0]
  msg, _, _ = _inputs(n, 4, np.float32)
  lanes = np.random.default_rng(1).uniform(size=(n, 4)) < 0.5
  want = jspmv.mask_inert(jnp.asarray(msg), jnp.asarray(lanes),
                          j_sssp_program())
  got = tspmv.mask_inert(torch.from_numpy(msg), torch.from_numpy(lanes),
                         sssp_program())
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  with pytest.raises(ValueError):
    tspmv.mask_inert(torch.from_numpy(msg), torch.from_numpy(lanes),
                     GraphProgram(process_message=lambda m, e, d: m))


def test_dst_reading_program_matches_jax(rmat_small):
  """The torch ELL and COO paths also run programs that read the
  destination property; structural auto puts this one on the kernel (its
  process traced), as the reference's puts it on ``pallas``."""
  n = rmat_small[0]
  msg, active, prop = _inputs(n, 0, np.float32, seed=2)
  jp = JProgram(process_message=lambda m, e, d: (e - m * d) * m,
                reduce_kind="add")
  tp = GraphProgram(process_message=lambda m, e, d: (e - m * d) * m,
                    reduce_kind="add")
  for backend in ("dense", "coo", "ell"):
    jg, tg = _graphs(rmat_small, backend, width=8)
    jy, _ = jspmv.spmv(jg, jnp.asarray(msg), jnp.asarray(active),
                       jnp.asarray(prop), jp, backend=jbe.Plan(backend))
    ty, _ = tspmv.spmv(tg, torch.from_numpy(msg), torch.from_numpy(active),
                       torch.from_numpy(prop), tp, backend=tbe.Plan(backend))
    assert_match(ty, jy, "add", backend)
    impl = tbe.resolve(tbe.AUTO_PLAN, tg, torch.from_numpy(msg),
                       torch.from_numpy(prop), tp)
    assert (impl.name == "cuda_ell") == (backend == "ell")


def test_registry_and_plans():
  assert tbe.registered_backends() == (
      "dense", "cuda_ell", "ell", "coo_tiled", "coo")
  assert tbe.as_plan(None) == tbe.AUTO_PLAN
  assert tbe.as_plan(tbe.Plan("ell")).backend == "ell"
  with pytest.raises(ValueError):
    tbe.Plan.from_string("pallas")
  with pytest.raises(ValueError):
    tbe.Plan(num_tiles=0)


@pytest.mark.parametrize("backend", ["dense", "coo", "ell"])
@pytest.mark.parametrize("prog", sorted(PROGRAMS))
def test_planner_matches_jax(rmat_small, backend, prog):
  """Heuristics unchanged: the port plans ``cuda_ell`` where JAX plans
  ``pallas``, and the graph statistics are equal."""
  jg, tg = _graphs(rmat_small, backend)
  jmake, tmake, _ = PROGRAMS[prog]
  js, ts = jbe.compute_stats(jg), tbe.compute_stats(tg)
  for field in ("container", "n", "nnz", "max_degree", "ell_width"):
    assert getattr(ts, field) == getattr(js, field)
  for field in ("avg_degree", "degree_cv", "hub_ratio", "density",
                "ell_efficiency", "spill_frac"):
    assert getattr(ts, field) == pytest.approx(getattr(js, field), rel=1e-9)
  jplan = jbe.Planner().plan(jg, jmake(), q=4)
  tplan = tbe.Planner().plan(tg, tmake(), q=4)
  want = "cuda_ell" if jplan.backend == "pallas" else jplan.backend
  assert (tplan.backend, tplan.num_tiles) == (want, jplan.num_tiles)
  # A low efficiency floor lets an ELL graph reach the kernel.
  if backend == "ell":
    assert tbe.Planner(ell_efficiency_floor=0.0).plan(
        tg, tmake()).backend == "cuda_ell"
