"""Processes that mix the lane axis, and processes over mixed or bfloat16
dtypes, on the CUDA ELL kernel's path, held against the JAX package.

The reference's ``ell_spmv_pallas`` traces any ``process`` into its body and
probes the result's width and dtype (``src/repro/kernels/ell_spmv.py:138``);
the port traces the program's ``process_message`` into a functor with its
own operand dtypes and, for a lane-mixing process, an ``apply`` over the
whole K-vector.  Here, on the CPU, on the same numpy inputs:

* R1: each program (collaborative filtering's one-leaf process, a lane dot
  score with ``K_out = 1``, a lane softmax weight in float32 and bfloat16,
  a bfloat16 PageRank, SSSP on float16 edges with a float32 result, int32
  messages times float32 edges) through ``spmv_ell_cuda`` (the kernel's
  plain version), the port's ``ell`` and its ``coo``, against the
  reference's ``spmv_ell_pallas`` in interpret mode and its ``spmv_coo``,
  at K = 1, 4 and 16 where the program has a lane axis;
* R2: two sweeps of collaborative filtering with the one-leaf process on
  ``Plan("cuda_ell")`` against the reference's ``collaborative_filtering``
  from the reference's own initial factors;
* R3: what the reference's interpret-mode kernel computes (int8, int16,
  uint8 messages) the port takes, bitwise; what it refuses (bool messages
  and results, a captured [K, K] matrix) the port refuses, by reason;
* R4: the traced expression against the callable for every newly taken op
  and dtype pair;
* R5: the port's planner sends these programs where the reference's sends
  them (``cuda_ell`` for ``pallas``);
* a hub of 4,999 bfloat16 in-edges through each path of the port, held to
  the float64 sum, and through the reference, whose scatter adds bfloat16
  terms in bfloat16 and stalls.

Tolerances: bitwise for min and max without a float lane sum and for
integers; float32 sums rtol 1e-5 (the sums run in different orders),
float16 rtol 1e-2, bfloat16 rtol 2e-2, each with atol rtol times the
largest magnitude of the reference's result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.algos import collab_filter as j_cf  # noqa: E402
from repro.core import backends as jbe  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import spmv as jspmv  # noqa: E402
from repro.core.vertex_program import GraphProgram as JProgram  # noqa: E402
from repro.kernels.ell_spmv import ell_spmv_pallas  # noqa: E402
from repro.kernels.ops import spmv_ell_pallas  # noqa: E402
from repro_torch.core import backends as tbe  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import spmv as tspmv  # noqa: E402
from repro_torch.core.engine import run_fixed_iters  # noqa: E402
from repro_torch.core.vertex_program import GraphProgram  # noqa: E402
from repro_torch.kernels import ell_spmv as kmod  # noqa: E402
from repro_torch.kernels import process_expr as pe  # noqa: E402
from repro_torch.kernels.ops import spmv_ell_cuda  # noqa: E402

F, H, B, I = torch.float32, torch.float16, torch.bfloat16, torch.int32
_JNP = {F: jnp.float32, H: jnp.float16, B: jnp.bfloat16, I: jnp.int32,
        torch.int8: jnp.int8, torch.int16: jnp.int16, torch.uint8: jnp.uint8}
RTOL = {F: 1e-5, H: 1e-2, B: 2e-2}


def _cf_ref(m, e, d):
  # The reference CF's process with its latent matrix as the one leaf.
  err = e - jnp.sum(m * d, axis=-1)
  return err[..., None] * m


# name -> (reference lambda, port lambda, reduce, message / edge / dst
# dtypes (dst None: not read), lane widths K (None: a scalar program),
# bitwise)
PROGRAMS = {
    "cf_one_leaf": (
        _cf_ref,
        lambda m, e, d: (e - (m * d).sum(-1, keepdim=True)) * m,
        "add", (F, F, F), (1, 4, 16), False),
    "dot_score": (
        lambda m, e, d: jnp.sum(m * d, axis=-1),
        lambda m, e, d: (m * d).sum(-1), "max", (F, F, F), (1, 4, 16),
        False),
    "lane_softmax_weight": (
        lambda m, e, d: jnp.exp(m - jnp.max(m, axis=-1, keepdims=True))
        * jnp.asarray(e)[..., None],
        lambda m, e, d: torch.exp(m - m.amax(-1, keepdim=True)) * e,
        "add", (F, F, None), (1, 4, 16), False),
    "lane_softmax_weight_bf16": (
        lambda m, e, d: jnp.exp(m - jnp.max(m, axis=-1, keepdims=True))
        * jnp.asarray(e)[..., None],
        lambda m, e, d: torch.exp(m - m.amax(-1, keepdim=True)) * e,
        "add", (B, B, None), (4, 16), False),
    "pr_bf16": (lambda m, e, d: 0.85 * m, lambda m, e, d: 0.85 * m, "add",
                (B, B, None), None, False),
    "sssp_half_edges": (lambda m, e, d: m + e, lambda m, e, d: m + e, "min",
                        (F, H, None), None, True),
    "int_times_float": (lambda m, e, d: m * e, lambda m, e, d: m * e, "min",
                        (I, F, None), None, True),
}
CASES = [(name, k) for name, spec in PROGRAMS.items()
         for k in (spec[4] or (None,))]


def _cast_edges(g, dtype, jax_side: bool):
  """The graph with its edge values (and its spill's) in ``dtype``."""
  if jax_side:
    cast = lambda x: x.astype(_JNP[dtype])  # noqa: E731
  else:
    cast = lambda x: x.to(dtype)  # noqa: E731
  if not hasattr(g, "spill"):  # a COO graph
    return dataclasses.replace(g, w=cast(g.w))
  spill = None if g.spill is None else _cast_edges(g.spill, dtype, jax_side)
  return dataclasses.replace(g, vals=cast(g.vals), spill=spill)


@pytest.fixture(scope="module")
def graphs(rmat_small):
  n, src, dst, w = rmat_small
  # Width 8 spills the hub rows to COO, so the merge is on the path too.
  return {"n": n,
          "j_ell": JG.build_ell(src, dst, w, n=n, width=8),
          "j_coo": JG.build_coo(src, dst, w, n=n),
          "t_ell": TG.build_ell(src, dst, w, n=n, width=8, device="cpu"),
          "t_coo": TG.build_coo(src, dst, w, n=n, device="cpu")}


def _data(n, k, dtypes, seed):
  """Messages, active flags and destination properties as numpy (float32
  before the cast to bfloat16 or float16, int32 for integer messages)."""
  rng = np.random.default_rng(seed)
  shape = (n,) if k is None else (n, k)
  if dtypes[0] == I:
    msg = rng.integers(-50, 1000, shape).astype(np.int32)
  else:
    msg = rng.uniform(-1, 2, shape).astype(np.float32)
  act = rng.uniform(size=n) < 0.7
  dprop = rng.uniform(-1, 1, shape).astype(np.float32)
  return msg, act, dprop


def _to_t(x, dtype):
  return torch.from_numpy(x).to(dtype)


def _to_j(x, dtype):
  return jnp.asarray(x).astype(_JNP[dtype])


def _close(got: torch.Tensor, want, dtype, bitwise: bool, what: str):
  got = got.float().numpy() if got.dtype == B else got.numpy()
  want = np.asarray(want.astype(jnp.float32) if want.dtype == jnp.bfloat16
                    else want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if bitwise or dtype not in RTOL:
    np.testing.assert_array_equal(got, want, err_msg=what)
    return
  rtol = RTOL[dtype]
  scale = float(np.nanmax(np.abs(np.where(np.isfinite(want), want, 0))))
  np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                             rtol=rtol, atol=rtol * scale, err_msg=what)


def _programs(name):
  jfn, tfn, red, (mt, et, dt), _, _ = PROGRAMS[name]
  reads_dst = dt is not None
  jprog = JProgram(process_message=jfn, reduce_kind=red,
                   process_reads_dst=reads_dst, name=name)
  tprog = GraphProgram(process_message=tfn, reduce_kind=red,
                       process_reads_dst=reads_dst, name=name)
  return jprog, tprog


@pytest.mark.parametrize("name,k", CASES,
                         ids=[f"{n}-K{k}" for n, k in CASES])
def test_spmv_matches_reference(graphs, name, k):
  """R1: the kernel's path (plain version), ``ell`` and ``coo`` against
  the reference's Pallas kernel (interpret mode) and ``spmv_coo``."""
  _, _, red, (mt, et, dt), _, bitwise = PROGRAMS[name]
  n = graphs["n"]
  jprog, tprog = _programs(name)
  msg, act, dprop = _data(n, k, (mt, et, dt), seed=len(name) + (k or 0))
  dtype_d = dt or mt
  jm, jd = _to_j(msg, mt), _to_j(dprop, dtype_d)
  tm, td = _to_t(msg, mt), _to_t(dprop, dtype_d)
  ja, ta = jnp.asarray(act), torch.from_numpy(act)
  j_ell = _cast_edges(graphs["j_ell"], et, True)
  j_coo = _cast_edges(graphs["j_coo"], et, True)
  t_ell = _cast_edges(graphs["t_ell"], et, False)
  t_coo = _cast_edges(graphs["t_coo"], et, False)
  want, want_r = spmv_ell_pallas(j_ell, jm, ja, jd, jprog)
  want_coo, want_coo_r = jspmv.spmv_coo(j_coo, jm, ja, jd, jprog)
  got = {"cuda_ell": spmv_ell_cuda(t_ell, tm, ta, td, tprog),
         "ell": tspmv.spmv(t_ell, tm, ta, td, tprog, backend=tbe.Plan("ell")),
         "coo": tspmv.spmv(t_coo, tm, ta, td, tprog, backend=tbe.Plan("coo"))}
  out_dtype = {"pr_bf16": B, "lane_softmax_weight_bf16": B}.get(name, F)
  assert tbe.resolve(tbe.AUTO_PLAN, t_ell, tm, td, tprog).name == "cuda_ell"
  for path, (y, r) in got.items():
    assert y.dtype == out_dtype, (path, y.dtype)
    np.testing.assert_array_equal(r.numpy(), np.asarray(want_r))
    _close(y, want, out_dtype, bitwise, f"{name} K={k} {path} vs pallas")
    _close(y, want_coo, out_dtype, bitwise, f"{name} K={k} {path} vs coo")
  np.testing.assert_array_equal(np.asarray(want_coo_r), np.asarray(want_r))


def _bipartite(nu, ni, per_user, seed):
  rng = np.random.default_rng(seed)
  users = np.repeat(np.arange(nu), per_user)
  items = rng.integers(0, ni, users.shape[0])
  pairs = np.unique(users.astype(np.int64) * ni + items)
  users, items = (pairs // ni).astype(np.int32), (pairs % ni).astype(np.int32)
  ratings = rng.integers(1, 6, users.shape[0]).astype(np.float32)
  return users, items, ratings


def test_cf_one_leaf_matches_reference_cf():
  """R2: two sweeps of collaborative filtering with the one-leaf process on
  ``Plan("cuda_ell")`` (CPU: the kernel's plain version) against the
  reference's ``collaborative_filtering``, from its own initial factors."""
  nu, ni, k, sweeps, gamma, lam, seed = 60, 25, 16, 2, 5e-3, 0.05, 3
  users, items, ratings = _bipartite(nu, ni, 6, seed)
  jg_u, jg_i, n = j_cf.build_bipartite(users, items, ratings, nu, ni,
                                       fmt="ell")
  want = np.asarray(j_cf.collaborative_filtering(
      jg_u, jg_i, n, k, num_iters=sweeps, gamma=gamma, lam=lam, seed=seed))
  # The reference's p0 (jax.random in _cf_jit), taken as numpy.
  p0 = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n, k),
                                     jnp.float32, 0.0, 0.1))
  item_ids = items + nu
  tg_u = TG.build_ell(item_ids, users, ratings, n=n, width=4, device="cpu")
  tg_i = TG.build_ell(users, item_ids, ratings, n=n, width=4, device="cpu")
  prog = GraphProgram(
      process_message=PROGRAMS["cf_one_leaf"][1], reduce_kind="add",
      apply=lambda red, old: old + gamma * (red - lam * old),
      process_reads_dst=True, name="cf_one_leaf")
  p = torch.from_numpy(p0)
  every = torch.ones(n, dtype=torch.bool)
  kernel = tbe.Plan("cuda_ell")
  assert tbe.resolve(tbe.AUTO_PLAN, tg_u, p, p, prog).name == "cuda_ell"
  for _ in range(sweeps):
    p = run_fixed_iters(tg_u, prog, p, every, 1, backend=kernel).prop
    p = run_fixed_iters(tg_i, prog, p, every, 1, backend=kernel).prop
  np.testing.assert_allclose(p.numpy(), want, rtol=1e-5, atol=1e-7)
  assert float(np.abs(want - p0).max()) > 1e-3  # the sweeps moved p


def _block(seed=0, n=24, w=8, k=1):
  rng = np.random.default_rng(seed)
  cols = rng.integers(0, n, (n, w)).astype(np.int32)
  mask = rng.uniform(size=(n, w)) < 0.7
  act = np.ones(n, bool)
  act[::5] = False
  return cols, mask, act


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.uint8],
                         ids=["i8", "i16", "u8"])
@pytest.mark.parametrize("reduce_kind", ["add", "min", "max"])
def test_narrow_integers_match_reference(dtype, reduce_kind):
  """R3: the reference's interpret-mode kernel computes int8, int16 and
  uint8 (wrapping sums); the port takes them, bitwise."""
  cols, mask, act = _block()
  rng = np.random.default_rng(1)
  info = np.iinfo(np.dtype(str(dtype).split(".")[1]))
  msg = rng.integers(info.min, info.max, (24, 1), endpoint=True)
  vals = rng.integers(0, 3, cols.shape)
  want, want_r = ell_spmv_pallas(
      jnp.asarray(cols), _to_j(vals, dtype), jnp.asarray(mask),
      _to_j(msg, dtype), jnp.asarray(act), jnp.zeros((24, 1), _JNP[dtype]),
      process=lambda m, e, d: m * 3 + e[..., None], reduce_kind=reduce_kind,
      interpret=True)
  expr = pe.trace(lambda m, e, d: m * 3 + e, dtype, lane=False,
                  reads_dst=False)
  assert isinstance(expr, pe.ProcessExpr) and expr.out_dtype == dtype
  y, r = kmod.ell_spmv(torch.from_numpy(cols), _to_t(vals, dtype),
                       torch.from_numpy(mask), _to_t(msg, dtype),
                       torch.from_numpy(act), process=expr,
                       reduce_kind=reduce_kind)
  assert y.dtype == dtype
  np.testing.assert_array_equal(y.numpy(), np.asarray(want))
  np.testing.assert_array_equal(r.numpy(), np.asarray(want_r))


REFERENCE_REFUSES = {  # name -> (JAX process, message dtype, port refusal)
    "bool_messages": (lambda m, e, d: m, np.bool_, "torch.bool"),
    "bool_result": (lambda m, e, d: m > 1, np.float32, "returns torch.bool"),
    "captured_matrix": (None, np.float32, "captures a tensor of shape [4, 4]"),
}
CAPTURED = np.random.default_rng(2).standard_normal((4, 4)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(REFERENCE_REFUSES))
def test_what_the_reference_refuses_the_port_refuses(name):
  """R3: bool messages and results and a captured [K, K] matrix: the
  reference's kernel raises on each, and the port's trace refuses each,
  naming why (so no K15: a captured matrix is not taken by either)."""
  jfn, np_dtype, reason = REFERENCE_REFUSES[name]
  k = 4 if name == "captured_matrix" else 1
  if jfn is None:
    w = jnp.asarray(CAPTURED)
    jfn = lambda m, e, d: m @ w  # noqa: E731
  cols, mask, act = _block()
  msg = np.ones((24, k), np_dtype)
  with pytest.raises(Exception):
    ell_spmv_pallas(jnp.asarray(cols), jnp.ones(cols.shape, np_dtype),
                    jnp.asarray(mask), jnp.asarray(msg), jnp.asarray(act),
                    jnp.zeros((24, 1), np_dtype), process=jfn,
                    reduce_kind="max", interpret=True)
  captured = torch.from_numpy(CAPTURED)
  tfn = {"bool_messages": lambda m, e, d: m,
         "bool_result": lambda m, e, d: m > 1,
         "captured_matrix": lambda m, e, d: m @ captured}[name]
  dtype = torch.bool if np_dtype == np.bool_ else F
  got = pe.trace(tfn, dtype, lane=k > 1, k=k if k > 1 else None,
                 reads_dst=False)
  assert isinstance(got, pe.Refused) and reason in got.reason, got


def _r4_inputs(dtypes, k, seed=0, n=64):
  rng = np.random.default_rng(seed)
  out = []
  for role, dtype in zip("med", dtypes):
    shape = ((n, k) if role != "e" else (n, 1)) if k else (n,)
    if dtype.is_floating_point:
      x = torch.from_numpy((rng.standard_normal(shape) * 3).astype(
          np.float32)).to(dtype)
      flat = x.view(-1)
      flat[:4] = torch.tensor([0.0, -0.0, 1.0, 1000.0]).to(dtype)
    else:
      info = torch.iinfo(dtype)
      x = torch.from_numpy(rng.integers(max(info.min, -300),
                                        min(info.max, 300) + 1,
                                        shape)).to(dtype)
    out.append(x)
  return out


# name -> (callable, (message, edge, dst dtypes), K or None)
NEW_OPS = {
    "lane_sum": (lambda m, e, d: m * m.sum(-1, keepdim=True), (F, F, F), 5),
    "lane_sum_f16": (lambda m, e, d: m.sum(-1) * e[..., 0], (H, H, H), 5),
    "lane_mean": (lambda m, e, d: m - m.mean(-1, keepdim=True), (F, F, F),
                  6),
    "lane_amax_bf16": (lambda m, e, d: m.amax(-1, keepdim=True) + e,
                       (B, B, B), 3),
    "lane_amin": (lambda m, e, d: torch.minimum(m, m.amin(-1)[:, None]),
                  (F, F, F), 4),
    "lane_max_dim": (lambda m, e, d: m.max(-1).values * 2, (F, F, F), 4),
    "lane_min_dim_int": (lambda m, e, d: m.min(dim=-1, keepdim=True).values
                         - e, (I, I, I), 4),
    "select": (lambda m, e, d: m * m[..., 2:3] + m[:, -1][:, None],
               (F, F, F), 5),
    "expand": (lambda m, e, d: e.expand(-1, 5) * d + m, (F, F, F), 5),
    "dot_dst": (lambda m, e, d: (m * d).sum(-1, keepdim=True), (F, F, F), 4),
    "bf16_pagerank": (lambda m, e, d: 0.85 * m + e, (B, B, B), None),
    "bf16_unary": (lambda m, e, d: torch.exp(-torch.abs(m)) / (e * e + 1)
                   + torch.sqrt(torch.abs(d)), (B, B, B), None),
    "f32_plus_f16": (lambda m, e, d: m + e, (F, H, F), None),
    "f16_plus_bf16": (lambda m, e, d: m * e + d, (H, B, F), None),
    "int_times_float": (lambda m, e, d: m * e, (I, F, I), None),
    "int_div": (lambda m, e, d: m / 3 + e / m.abs().clamp(min=1),
                (I, I, I), None),
    "int_lt_float": (lambda m, e, d: torch.where(m < e, m, d), (I, F, I),
                     None),
    "int_half_min": (lambda m, e, d: torch.minimum(m, e), (I, H, I), None),
    "int8_wrap": (lambda m, e, d: m * 3 + e - d, (torch.int8, torch.int8,
                                                 torch.int8), None),
    "uint8_int16": (lambda m, e, d: m + e, (torch.uint8, torch.int16, I),
                    None),
    "cast_int_to_bf16": (lambda m, e, d: m.to(torch.bfloat16) * e,
                         (I, B, I), None),
    "cast_to_bool": (lambda m, e, d: torch.where(m.bool(), e, 0.5),
                     (F, F, F), None),
    "mixed_lanes": (lambda m, e, d: (m * e).sum(-1, dtype=torch.float32)
                    + d[..., 0].float(), (B, H, I), 4),
}


@pytest.mark.parametrize("name", sorted(NEW_OPS))
def test_expression_equals_the_callable(name):
  """R4: the trace of every newly taken op and dtype pair, evaluated in
  torch, equals the callable bitwise."""
  fn, (mt, et, dt), k = NEW_OPS[name]
  expr = pe.trace(fn, mt, lane=k is not None, k=k, edge_dtype=et,
                  dst_dtype=dt, kd=k or 1)
  assert isinstance(expr, pe.ProcessExpr), expr
  m, e, d = _r4_inputs((mt, et, dt), k)
  want = fn(m, e, d)
  got = expr.evaluate(m, e, d)
  assert got.dtype == want.dtype and got.shape == want.shape
  nan = torch.isnan(want) if want.is_floating_point() else None
  if nan is not None:
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])
  else:
    assert torch.equal(got, want)
  # The plain adapter gives the kernel's [..., K_out] from its operands.
  if k is not None:
    plain = expr.plain(m, e[:, 0], d)
    assert plain.shape == (m.shape[0], expr.k_out or k)
  assert "TracedProcess" in kmod.generated_source(expr, "add")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_planner_sends_these_where_the_reference_sends_them(graphs, name):
  """R5: Planner.plan at Q = 1 (the reference's planner does not look at
  the process) and at the program's lane widths."""
  jprog, tprog = _programs(name)
  k = (PROGRAMS[name][4] or (1,))[-1]
  planners = (jbe.Planner(ell_efficiency_floor=0.0),
              tbe.Planner(ell_efficiency_floor=0.0))
  for q in sorted({1, k}):
    jplan = planners[0].plan(graphs["j_ell"], jprog, q=q)
    tplan = planners[1].plan(graphs["t_ell"], tprog, q=q)
    want = "cuda_ell" if jplan.backend == "pallas" else jplan.backend
    assert tplan.backend == want == "cuda_ell", (name, q)
    assert jbe.Planner().plan(graphs["j_ell"], jprog, q=q).backend == (
        "pallas" if tbe.Planner().plan(graphs["t_ell"], tprog, q=q).backend
        == "cuda_ell" else "ell")


def _hub_graph(n=5000, others=2000, seed=0):
  """Vertex 0 takes an edge from each of the other n - 1 vertices; besides,
  ``others`` random edges into the rest.  At width 8 all but 8 of the
  hub's edges spill to COO."""
  rng = np.random.default_rng(seed)
  src = np.concatenate([np.arange(1, n), rng.integers(0, n, others)])
  dst = np.concatenate([np.zeros(n - 1, np.int64),
                        rng.integers(1, n, others)])
  w = np.ones(src.shape, np.float32)
  msg = rng.uniform(0.5, 1.5, n).astype(np.float32)
  return n, src.astype(np.int32), dst.astype(np.int32), w, msg


def _hub_exact(n, src, dst, msg):
  """Each vertex's sum of the bfloat16 terms ``0.85 * m`` in float64."""
  terms = (0.85 * torch.from_numpy(msg).to(B)).double().numpy()
  return np.bincount(dst, weights=terms[src], minlength=n)


HUB_PATHS = ("cuda_ell", "ell", "coo", "coo_tiled")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("path", HUB_PATHS)
def test_bf16_hub_sum_holds(path, device):
  """A hub of 4,999 bfloat16 in-edges: every path of the port sums them in
  float32 and rounds once (the kernel, ``torch.sum`` over an ELL row, and
  the COO scatter that folds in a spill), so the hub's sum holds within
  bfloat16's rtol of the float64 sum of the same terms."""
  if device == "cuda" and not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
  n, src, dst, w, msg = _hub_graph()
  want = _hub_exact(n, src, dst, msg)
  prog = GraphProgram(process_message=PROGRAMS["pr_bf16"][1],
                      reduce_kind="add", process_reads_dst=False,
                      name="pr_bf16")
  tm = torch.from_numpy(msg).to(B).to(device)
  ta = torch.ones(n, dtype=torch.bool, device=device)
  if path in ("coo", "coo_tiled"):
    g = _cast_edges(TG.build_coo(src, dst, w, n=n, device=device), B, False)
  else:
    g = _cast_edges(TG.build_ell(src, dst, w, n=n, width=8, device=device),
                    B, False)
    assert int(g.spill.emask.sum()) == n - 1 - 8
  if path == "cuda_ell":
    y, _ = spmv_ell_cuda(g, tm, ta, tm, prog)
  else:
    y, _ = tspmv.spmv(g, tm, ta, tm, prog, backend=tbe.Plan(path))
  assert y.dtype == B
  got = y.double().cpu().numpy()
  np.testing.assert_allclose(got, want, rtol=RTOL[B], atol=0, err_msg=path)


@pytest.mark.parametrize("path,holds", [("spmv_coo", False),
                                        ("pallas_spilled", False),
                                        ("pallas_whole_row", True)])
def test_bf16_hub_sum_in_the_reference(path, holds):
  """The same hub through the reference: its ``spmv_coo`` scatter adds
  each bfloat16 term in bfloat16, so the hub's sum stalls below half of
  itself, and so does its Pallas path where the hub's edges spill to that
  scatter; its Pallas kernel with the whole row in one tile sums in float
  (``jnp.sum`` of bfloat16) and holds it.  The port follows the last rule
  on every path (above)."""
  n, src, dst, w, msg = _hub_graph()
  want = _hub_exact(n, src, dst, msg)[0]
  prog = JProgram(process_message=PROGRAMS["pr_bf16"][0], reduce_kind="add",
                  process_reads_dst=False, name="pr_bf16")
  jm = _to_j(msg, B)
  ja = jnp.ones((n,), bool)
  if path == "spmv_coo":
    g = _cast_edges(JG.build_coo(src, dst, w, n=n), B, True)
    y, _ = jspmv.spmv_coo(g, jm, ja, jm, prog)
  else:
    width = 8 if path == "pallas_spilled" else n
    g = _cast_edges(JG.build_ell(src, dst, w, n=n, width=width), B, True)
    assert (g.spill is not None) == (path == "pallas_spilled")
    y, _ = spmv_ell_pallas(g, jm, ja, jm, prog)
  hub = float(y[0].astype(jnp.float32))
  if holds:
    np.testing.assert_allclose(hub, want, rtol=RTOL[B])
  else:
    assert hub < 0.5 * want, (path, hub, want)
