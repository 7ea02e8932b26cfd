"""The generic reduce (an arbitrary monoid) on the port's dense, COO and ELL
backends, against the JAX package and against the port's own fast paths.

The same numpy graph, messages, frontier and properties go through the JAX
``spmv`` and the port's with one program whose reduce is a pytree function
(``reduce_kind="generic"``).  Tolerances: int32 bitwise-or and the max
monoid match bitwise; float add matches at rtol 1e-5 (atol 1e-6 for values
near zero), since the reductions sum in other orders.  ``recv`` matches
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import backends as jbe  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import spmv as jspmv  # noqa: E402
from repro.core.vertex_program import GraphProgram as JProgram  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.core import backends as tbe  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import spmv as tspmv  # noqa: E402
from repro_torch.core.vertex_program import GraphProgram  # noqa: E402

# name -> (message dtype, JAX leaf op, torch leaf op, identity, the fast
# reduce it equals or None, whether process reads the edge value)
MONOIDS = {
    "bitwise_or": (np.int32, jnp.bitwise_or, torch.bitwise_or, 0, None,
                   False),
    "max": (np.float32, jnp.maximum, torch.maximum, float("-inf"), "max",
            True),
    "add": (np.float32, jnp.add, torch.add, 0.0, "add", True),
}
BACKENDS = ("dense", "coo", "ell", "ell_spill")


def _programs(monoid):
  _, jop, top, ident, _, edge = MONOIDS[monoid]
  jproc = (lambda m, e, d: m * e) if edge else (lambda m, e, d: m)
  jp = JProgram(process_message=jproc, reduce_kind="generic",
                reduce=lambda a, b: jax.tree_util.tree_map(jop, a, b),
                reduce_identity=ident, process_reads_dst=False,
                name=f"generic_{monoid}")
  tp = GraphProgram(process_message=jproc, reduce_kind="generic",
                    reduce=lambda a, b: _tree.tree_map(top, a, b),
                    reduce_identity=ident, process_reads_dst=False,
                    name=f"generic_{monoid}")
  return jp, tp


def _graphs(rmat_small, backend):
  n, src, dst, w = rmat_small
  if backend == "dense":
    return (JG.build_dense(src, dst, w, n=n),
            TG.build_dense(src, dst, w, n=n, device="cpu"))
  if backend.startswith("ell"):
    width = 8 if backend == "ell_spill" else None  # width 8 spills the hubs
    return (JG.build_ell(src, dst, w, n=n, width=width),
            TG.build_ell(src, dst, w, n=n, width=width, device="cpu"))
  return (JG.build_coo(src, dst, w, n=n),
          TG.build_coo(src, dst, w, n=n, device="cpu"))


def _inputs(n, q, dtype, seed=0):
  rng = np.random.default_rng(seed)
  shape = (n,) if q == 0 else (n, q)
  if dtype == np.int32:
    msg = rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(
        np.int32)
  else:
    msg = rng.uniform(-3.0, 3.0, shape).astype(np.float32)
  return msg, rng.uniform(size=n) < 0.6


def _plan(backend):
  name = "ell" if backend == "ell_spill" else backend
  return jbe.Plan(backend=name), tbe.Plan(backend=name)


def _assert_match(got, want, monoid, what):
  got = got.numpy()
  want = np.asarray(want)
  if monoid == "add":
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=what)
  else:
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("monoid", sorted(MONOIDS))
@pytest.mark.parametrize("q", [0, 3])
def test_generic_reduce_matches_jax(rmat_small, backend, monoid, q):
  n = rmat_small[0]
  jg, tg = _graphs(rmat_small, backend)
  jp, tp = _programs(monoid)
  msg, active = _inputs(n, q, MONOIDS[monoid][0], seed=q + 1)
  jplan, tplan = _plan(backend)
  # Jitted: the JAX package's eager associative scan takes seconds a call.
  jy, jr = jax.jit(lambda g, m, a: jspmv.spmv(g, m, a, m, jp, backend=jplan))(
      jg, jnp.asarray(msg), jnp.asarray(active))
  ty, tr = tspmv.spmv(tg, torch.from_numpy(msg), torch.from_numpy(active),
                      torch.from_numpy(msg), tp, backend=tplan)
  assert ty.shape == jy.shape and str(ty.dtype) == f"torch.{jy.dtype}"
  _assert_match(ty, jy, monoid, f"{backend}/{monoid}/q={q}")
  np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))

  fast = MONOIDS[monoid][4]
  if fast is not None:  # the same monoid through the port's fast path
    fp = GraphProgram(process_message=tp.process_message, reduce_kind=fast,
                      process_reads_dst=False)
    fy, fr = tspmv.spmv(tg, torch.from_numpy(msg), torch.from_numpy(active),
                        torch.from_numpy(msg), fp, backend=tplan)
    _assert_match(ty, fy.numpy(), monoid, f"{backend}/{monoid} vs fast")
    assert torch.equal(tr, fr)


def test_segment_scan_matches_sequential_fold():
  """The COO scan on long runs of one destination (a segment longer than
  every scan stride) and on single-edge segments, against a host fold."""
  rng = np.random.default_rng(5)
  n = 40
  dst = np.sort(np.concatenate([np.zeros(300, np.int32),
                                rng.integers(1, n, 200).astype(np.int32)]))
  src = rng.integers(0, n, dst.size).astype(np.int32)
  g = TG.build_coo(src, dst, n=n, device="cpu", capacity=dst.size + 7)
  _, tp = _programs("bitwise_or")
  msg, active = _inputs(n, 2, np.int32, seed=9)
  y, recv = tspmv.spmv_coo(g, torch.from_numpy(msg), torch.from_numpy(active),
                           torch.from_numpy(msg), tp)
  want = np.zeros((n, 2), np.int32)
  for s, d in zip(src, dst):
    if active[s]:
      want[d] |= msg[s]
  np.testing.assert_array_equal(y.numpy(), want)
  np.testing.assert_array_equal(
      recv.numpy(), np.bincount(dst[active[src]], minlength=n) > 0)


def _skewed_coo():
  rng = np.random.default_rng(0)
  n = 128
  src = np.concatenate([rng.integers(1, n, 400), rng.integers(0, n, 100)])
  dst = np.concatenate([np.zeros(400, np.int64), rng.integers(0, n, 100)])
  keep = src != dst
  return n, src[keep].astype(np.int32), dst[keep].astype(np.int32)


def test_generic_auto_resolves_to_coo():
  """On a skewed COO graph a generic program plans and resolves to ``coo``
  (``coo_tiled`` is scatter-fast only), as in the reference."""
  n, src, dst = _skewed_coo()
  tg = TG.build_coo(src, dst, n=n, device="cpu")
  jg = JG.build_coo(src, dst, n=n)
  jp, tp = _programs("bitwise_or")
  msg, active = _inputs(n, 2, np.int32)
  m, a = torch.from_numpy(msg), torch.from_numpy(active)
  assert tbe.compute_stats(tg).hub_ratio >= tbe.Planner().skew_threshold
  for plan in (tbe.AUTO_PLAN, tbe.Plan("coo_tiled", num_tiles=4)):
    assert tbe.resolve(plan, tg, m, m, tp).name == "coo"
  assert tbe.Planner().plan(tg, tp).backend == "coo"
  assert jbe.Planner().plan(jg, jp).backend == "coo"
  y_auto, _ = tspmv.spmv(tg, m, a, m, tp)
  y_coo, _ = tspmv.spmv(tg, m, a, m, tp, backend=tbe.Plan("coo"))
  assert torch.equal(y_auto, y_coo)


def test_generic_refused_by_the_kernel(rmat_small):
  """Structural auto keeps a generic program off ``cuda_ell``; naming the
  kernel explicitly raises rather than falling back."""
  n = rmat_small[0]
  _, tg = _graphs(rmat_small, "ell")
  _, tp = _programs("bitwise_or")
  msg, active = _inputs(n, 0, np.int32)
  m, a = torch.from_numpy(msg), torch.from_numpy(active)
  assert tbe.resolve(tbe.AUTO_PLAN, tg, m, m, tp).name == "ell"
  with pytest.raises(ValueError, match="reduce_kind is 'generic'"):
    tspmv.spmv(tg, m, a, m, tp, backend=tbe.Plan("cuda_ell"))
