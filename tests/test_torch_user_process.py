"""A program's own ``process_message`` on the CUDA ELL kernel's path.

The reference's kernel takes the program's per-edge callable, traced inline
(``src/repro/kernels/ell_spmv.py:127``); the port traces it into a per-lane
expression (``kernels/process_expr.py``) and compiles that into the kernel.
Here, on the CPU:

* the expression, evaluated in torch, equals the callable bitwise for
  float32, float16 and int32, scalar and ``[n, Q]``;
* the refusals, each with its reason (int64 values, float64 values other
  than a message passed through unchanged, a float64 message under min or
  max, a bool result, a destination property of a width other than 1 or
  K, a lane slice of another width, control flow, captured tensors,
  unknown ops, a generic reduce): structural auto resolves them to ``ell``
  and an explicit ``Plan("cuda_ell")`` raises; the processes refused
  before the kernel took lane mixing, ``K_out = 1``, mixed dtypes and the
  float64 pass-through, now taken and run;
* the five shipped forms' reference lambdas map onto their forms, and
  ``e + m`` does not;
* parity with the reference: the same numpy inputs through the reference's
  ``spmv_ell_pallas`` (interpret mode, as ``tests/test_kernels.py`` runs it)
  with the JAX lambda and through ``spmv_ell_cuda`` on CPU tensors (the
  plain version, running the torch lambda); a whole widest-path run with
  ``Plan("cuda_ell")`` against the reference engine with ``Plan("pallas")``;
* the generated CUDA functors for float32 and int32 and for processes that
  mix the two, compiled for the host with a small shim where a C++ compiler
  is found, against the expression.

Tolerances: min, max and int32 bitwise; float add rtol 1e-5 (the sums run
in different orders).  The host shim: bitwise, except ``exp``, ``log`` and
``rsqrt`` (the host's libm against torch's CPU kernels, within 2 ulp; the
card's own, held to eager CUDA by ``chip_smoke.py``), ``sqrt`` (correctly
rounded, held to numpy's bitwise; torch's CPU sqrt is within 1 ulp) and a
division
by a constant, which the functor computes as a product with the float32
reciprocal, as eager CUDA does (held to numpy's product).
"""

import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import backends as jbe  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.engine import run_graph_program as j_run  # noqa: E402
from repro.core.vertex_program import GraphProgram as JProgram  # noqa: E402
from repro.kernels.ops import spmv_ell_pallas  # noqa: E402
from repro_torch.core import backends as tbe  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import spmv as tspmv  # noqa: E402
from repro_torch.core.backends import planner as tplanner  # noqa: E402
from repro_torch.core.engine import run_graph_program  # noqa: E402
from repro_torch.core.vertex_program import (  # noqa: E402
    PROCESS_FORMS, GraphProgram)
from repro_torch.kernels import ell_spmv as kmod  # noqa: E402
from repro_torch.kernels import process_expr as pe  # noqa: E402
from repro_torch.kernels.ops import spmv_ell_cuda  # noqa: E402

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")

# Per-lane processes over the ops the kernel takes (name -> callable, the
# dtypes it is written for).
F, H, I, D = torch.float32, torch.float16, torch.int32, torch.float64
EXPRS = {
    "widest": (lambda m, e, d: torch.minimum(m, e), (F, H, I)),
    "where_gt": (lambda m, e, d: torch.where(e > 1, m, m + e), (F, H, I)),
    "damped": (lambda m, e, d: 0.85 * m / 2, (F, H)),
    "int_where": (lambda m, e, d: torch.where(m < 1000, m * 2 + 1, m),
                  (F, H, I)),
    "dst": (lambda m, e, d: (e - m * d) * m, (F, H, I)),
    "rsub_max": (lambda m, e, d: torch.maximum(1 - m, d), (F, H, I)),
    "clamp": (lambda m, e, d: torch.clamp(m * e, 0.5, 4), (F, H)),
    "clamp_int": (lambda m, e, d: torch.clamp(m - e, min=-3), (I,)),
    "logic": (lambda m, e, d: torch.where((m > 0) & ~(e < d) | (m == e),
                                          m, d), (F, H, I)),
    "cast": (lambda m, e, d: (m >= e).to(m.dtype) * d + m.abs(), (F, H, I)),
    "neg_ne": (lambda m, e, d: torch.where(m != d, -m, e), (F, H, I)),
    "unary": (lambda m, e, d: torch.sqrt(torch.abs(m)) + torch.exp(-e)
              - torch.log(torch.abs(d) + 1) * torch.rsqrt(e * e + 1),
              (F, H)),
    "recip": (lambda m, e, d: 2 / (m * m + 1) - torch.reciprocal(e), (F, H)),
    "const_where": (lambda m, e, d: torch.where(m > e, m, 0.1), (F, H)),
    "tensor_const": (lambda m, e, d: m * torch.tensor(0.3) - e, (F, H)),
    "div3": (lambda m, e, d: m / 3 + e, (F, H)),
    "exp": (lambda m, e, d: torch.exp(-m), (F, H)),
    "log": (lambda m, e, d: torch.log(torch.abs(d) + 1), (F, H)),
    "sqrt": (lambda m, e, d: torch.sqrt(torch.abs(m)), (F, H)),
    "rsqrt": (lambda m, e, d: torch.rsqrt(m * m + 1), (F, H)),
}


def _inputs(dtype, lane: bool, seed: int = 0, n: int = 512):
  rng = np.random.default_rng(seed)
  q = 8 if lane else None
  shapes = ((n, q), (n, 1), (n, q)) if lane else ((n,), (n,), (n,))
  if dtype == I:
    out = [rng.integers(-2**31, 2**31, s, dtype=np.int64).astype(np.int32)
           if k == 0 else rng.integers(-2000, 2000, s).astype(np.int32)
           for k, s in enumerate(shapes)]
    out[0][: n // 2] = (out[0][: n // 2] % 2000).astype(np.int32)
  else:
    out = [(rng.standard_normal(s) * 3).astype(np.float32) for s in shapes]
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, 1000.0],
                       np.float32)
    for x in out:
      flat = x.reshape(-1)
      flat[:special.size] = special
  return [torch.from_numpy(x).to(dtype) for x in out]


def _same(got: torch.Tensor, want: torch.Tensor) -> None:
  """Equal values, NaN where the other is NaN (the repo's bitwise)."""
  assert got.dtype == want.dtype and got.shape == want.shape
  if got.is_floating_point():
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])
  else:
    assert torch.equal(got, want)


CASES = [(name, dt, lane) for name, (_, dts) in EXPRS.items()
         for dt in dts for lane in (False, True)]


@pytest.mark.parametrize("name,dtype,lane", CASES,
                         ids=[f"{n}-{str(d)[6:]}-{'lane' if l else 'scalar'}"
                              for n, d, l in CASES])
def test_expression_equals_the_callable(name, dtype, lane):
  fn = EXPRS[name][0]
  expr = pe.trace(fn, dtype, lane=lane, kd=8)
  assert isinstance(expr, pe.ProcessExpr), expr
  m, e, d = _inputs(dtype, lane)
  with np.errstate(all="ignore"):
    want = fn(m, e, d)
  _same(expr.evaluate(m, e, d), want)
  # The plain path's adapter runs the callable at the traced ranks, from
  # the kernel's operands (msg [.., Q], edge values [..], dprop [.., Kd]).
  got = (expr.plain(m, e[:, 0], d) if lane
         else expr.plain(m[:, None], e, d[:, None])[:, 0])
  _same(got, want)
  assert pe.trace(fn, dtype, lane=lane, kd=8) is expr  # cached


def test_reads_and_dst_zero_when_not_read():
  expr = pe.trace(lambda m, e, d: m * d + e, F, lane=False, reads_dst=False)
  assert expr.reads_edge and not expr.reads_dst
  m, e, d = _inputs(F, False)
  _same(expr.evaluate(m, e, d), m * 0 + e)
  full = pe.trace(lambda m, e, d: m * d + e, F, lane=False)
  assert full.reads_dst and full != expr


REFUSALS = {  # name -> (callable, message dtype, lane, reason fragment
    #          [, trace keywords: default kd = 8, so K = Kd = 8])
    "int64": (lambda m, e, d: m.to(torch.int64) + 1, F, False,
              "torch.int64"),
    "slice_width": (lambda m, e, d: m[..., :2] + e, F, True,
                    "slices the lane axis to width 2"),
    "bool_result": (lambda m, e, d: m > e, F, True, "returns torch.bool"),
    "mixed_dtypes": (lambda m, e, d: m + e.to(torch.float64), F, False,
                     "torch.float64"),
    "kd_other": (lambda m, e, d: m * d.sum(-1, keepdim=True), F, True,
                 "width 2 with K = 3", {"k": 3, "kd": 2}),
    "int_lane_sum": (lambda m, e, d: m * m.sum(-1, keepdim=True), I, True,
                     "torch.int64"),
    "control_flow": (lambda m, e, d: m if bool((m > 0).all()) else e, F,
                     False, "data-dependent control flow"),
    "captured": (lambda m, e, d: m * CAPTURED, F, True,
                 "captures a tensor of shape [1]"),
    "unknown_op": (lambda m, e, d: m ** 2, F, False, "aten.pow"),
    "two_leaves": (lambda m, e, d: (m, e), F, False, "not one tensor"),
    "alpha": (lambda m, e, d: torch.add(m, e, alpha=2), F, False, "alpha=2"),
    # float64 passes through unchanged and nothing computes in it.
    "f64_arith": (lambda m, e, d: m * 2, D, False,
                  "computes aten.mul in torch.float64"),
    "f64_lane_sum": (lambda m, e, d: m.sum(-1, keepdim=True), D, True,
                     "computes aten.sum in torch.float64"),
    "f64_cast": (lambda m, e, d: m.float(), D, False,
                 "computes with values of torch.float64"),
    "f64_edge": (lambda m, e, d: m + e, D, False,
                 "computes aten.add in torch.float64"),
}
CAPTURED = torch.tensor([0.5])


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_name_their_reason(name):
  fn, dtype, lane, reason, *kw = REFUSALS[name]
  got = pe.trace(fn, dtype, lane=lane, **(kw[0] if kw else {"kd": 8}))
  assert isinstance(got, pe.Refused) and reason in got.reason, got


# What the refusals above held before the kernel took lane mixing, K_out = 1
# and mixed dtypes: each now traced, and its expression equal to the
# callable.  name -> (callable, message dtype, lane, result dtype, K_out).
FORMERLY_REFUSED = {
    "lane_mixing": (lambda m, e, d: m * m.sum(-1, keepdim=True), F, True,
                    F, 8),
    "k_out": (lambda m, e, d: m[..., :1] + e, F, True, F, 1),
    "k_out_shape": (lambda m, e, d: e * 2, F, True, F, 1),
    "int_float_const": (lambda m, e, d: m * 0.5, I, False, F, None),
    "int_float_compare": (lambda m, e, d: torch.where(m < 2.5, m, e), I,
                          False, I, None),
    # The float64 pass-through (GAP's path counts, algos/bc.py).
    "f64_pass_through": (lambda m, e, d: m, D, False, D, None),
}


@pytest.mark.parametrize("name", sorted(FORMERLY_REFUSED))
def test_formerly_refused_processes_are_taken(name):
  fn, dtype, lane, out_dtype, k_out = FORMERLY_REFUSED[name]
  expr = pe.trace(fn, dtype, lane=lane, kd=8)
  assert isinstance(expr, pe.ProcessExpr), expr
  assert expr.out_dtype == out_dtype and expr.k_out == k_out
  assert expr.lane_mixing == (k_out is not None)
  m, e, d = _inputs(dtype, lane)
  with np.errstate(all="ignore"):
    want = fn(m, e, d)
  _same(expr.evaluate(m, e, d), want)


def test_mixed_input_dtypes_refused():
  # Operands of different dtypes are taken, promoted as torch promotes
  # them; an operand the kernel has no type for is refused when read.
  mixed = pe.trace(lambda m, e, d: m + e, F, lane=False, edge_dtype=I)
  assert isinstance(mixed, pe.ProcessExpr) and mixed.edge_dtype == I
  got = pe.trace(lambda m, e, d: m + e, F, lane=False,
                 edge_dtype=torch.int64)
  assert isinstance(got, pe.Refused)
  assert "reads the edge value as torch.int64" in got.reason
  # An edge value the process never reads may have any dtype.
  assert isinstance(pe.trace(lambda m, e, d: m * 2, F, lane=False,
                             edge_dtype=torch.int64), pe.ProcessExpr)


@pytest.fixture(scope="module")
def graphs(rmat_small):
  n, src, dst, w = rmat_small
  return (n, JG.build_ell(src, dst, w, n=n, width=8),
          TG.build_ell(src, dst, w, n=n, width=8, device="cpu"))


REFUSED_PROGRAMS = {  # name -> (program, message [n] or [n, 4], reason)
    "int64": (GraphProgram(
        process_message=lambda m, e, d: m.long() + 1, reduce_kind="add",
        process_reads_dst=False), 4, "torch.int64"),
    "bool_result": (GraphProgram(process_message=lambda m, e, d: m > e,
                                 reduce_kind="max", process_reads_dst=False),
                    0, "returns torch.bool"),
    "mixed_dtypes": (GraphProgram(
        process_message=lambda m, e, d: m.double() + e, reduce_kind="min",
        process_reads_dst=False), 0, "torch.float64"),
    "control_flow": (GraphProgram(
        process_message=lambda m, e, d: m if bool((m > 0).any()) else e,
        reduce_kind="max", process_reads_dst=False), 0,
                     "data-dependent control flow"),
    "captured": (GraphProgram(process_message=lambda m, e, d: m * CAPTURED,
                              reduce_kind="add", process_reads_dst=False), 0,
                 "captures a tensor"),
    "unknown_op": (GraphProgram(process_message=lambda m, e, d: m % 3 + e,
                                reduce_kind="min", process_reads_dst=False),
                   0, "aten.remainder"),
    "generic_reduce": (GraphProgram(
        process_message=lambda m, e, d: m + e, reduce_kind="generic",
        reduce=torch.minimum, reduce_identity=float("inf"),
        process_reads_dst=False), 0, "reduce_kind is 'generic'"),
}


@pytest.mark.parametrize("name", sorted(REFUSED_PROGRAMS))
def test_refused_programs_plan_onto_ell_and_raise_on_cuda_ell(graphs, name):
  n, _, tg = graphs
  prog, q, reason = REFUSED_PROGRAMS[name]
  msg = torch.rand((n, q) if q else (n,))
  act = torch.ones(n, dtype=torch.bool)
  assert tbe.resolve(tbe.AUTO_PLAN, tg, msg, msg, prog).name == "ell"
  with pytest.raises(ValueError, match=reason):
    tspmv.spmv(tg, msg, act, msg, prog, backend=tbe.Plan("cuda_ell"))
  assert not tplanner._kernel_shape_ok(prog, max(q, 1))


def test_float64_messages_take_the_add_reduce_alone(graphs):
  """A float64 message passed through unchanged (``process_op="msg"``:
  GAP's path counts) is taken for the add reduce: structural auto plans
  ``cuda_ell``, whose path (its plain version here) equals ``Plan("ell")``
  in float64.  Under min or max it is refused by reason: auto resolves to
  ``ell``, ``Plan("cuda_ell")`` raises, and so does the kernel's wrapper."""
  n, _, tg = graphs
  msg = torch.rand((n, 4), dtype=torch.float64) * 2**40
  act = torch.rand(n) < 0.7
  add = GraphProgram(process_op="msg", reduce_kind="add")
  assert tbe.resolve(tbe.AUTO_PLAN, tg, msg, msg, add).name == "cuda_ell"
  got, got_r = tspmv.spmv(tg, msg, act, msg, add,
                          backend=tbe.Plan("cuda_ell"))
  want, want_r = tspmv.spmv(tg, msg, act, msg, add, backend=tbe.Plan("ell"))
  assert got.dtype == torch.float64 and torch.equal(got_r, want_r)
  torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
  for red in ("min", "max"):
    prog = GraphProgram(process_op="msg", reduce_kind=red)
    assert tbe.resolve(tbe.AUTO_PLAN, tg, msg, msg, prog).name == "ell"
    with pytest.raises(ValueError, match=f"float64 messages under the {red}"):
      tspmv.spmv(tg, msg, act, msg, prog, backend=tbe.Plan("cuda_ell"))
  expr = pe.for_program(add, msg, tg.vals, None)
  assert isinstance(expr, pe.ProcessExpr) and expr.name.startswith("traced_")
  with pytest.raises(ValueError, match="float64 messages take the add"):
    kmod.ell_spmv(tg.cols, tg.vals, tg.mask, msg, act, process=expr,
                  reduce_kind="min")


# The programs the refusals above held before the kernel took lane mixing
# and K_out = 1: structural auto now plans them onto cuda_ell, and the
# kernel's path (its plain version here) equals Plan("ell").
FORMERLY_REFUSED_PROGRAMS = {
    "lane_mixing": GraphProgram(
        process_message=lambda m, e, d: m * m.sum(-1, keepdim=True),
        reduce_kind="add", process_reads_dst=False),
    "k_out": GraphProgram(process_message=lambda m, e, d: m[..., :1] * 2,
                          reduce_kind="min", process_reads_dst=False),
}


@pytest.mark.parametrize("name", sorted(FORMERLY_REFUSED_PROGRAMS))
def test_formerly_refused_programs_plan_onto_cuda_ell(graphs, name):
  n, _, tg = graphs
  prog = FORMERLY_REFUSED_PROGRAMS[name]
  msg = torch.rand((n, 4))
  act = torch.rand(n) < 0.7
  assert tbe.resolve(tbe.AUTO_PLAN, tg, msg, msg, prog).name == "cuda_ell"
  got, got_r = tspmv.spmv(tg, msg, act, msg, prog,
                          backend=tbe.Plan("cuda_ell"))
  want, want_r = tspmv.spmv(tg, msg, act, msg, prog, backend=tbe.Plan("ell"))
  assert torch.equal(got_r, want_r)
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
  assert tplanner._kernel_shape_ok(prog, 4)


REFERENCE_FORMS = {  # the reference's lambdas of the five shipped forms
    "msg": lambda m, e, d: m,
    "msg_plus_one": lambda m, e, d: m + 1,
    "msg_plus_edge": lambda msg, edge, dst_prop: msg + edge,
    "msg_times_edge": lambda m, e, d: m * e,
    "edge_minus_msg_dst_times_msg": lambda m, e, d: (e - m * d) * m,
}


@pytest.mark.parametrize("dtype", [F, H, I], ids=["f32", "f16", "i32"])
@pytest.mark.parametrize("lane", [False, True], ids=["scalar", "lane"])
def test_reference_lambdas_map_onto_the_shipped_forms(dtype, lane):
  assert set(REFERENCE_FORMS) == set(PROCESS_FORMS)
  for form, fn in REFERENCE_FORMS.items():
    expr = pe.trace(fn, dtype, lane=lane,
                    reads_dst=form == "edge_minus_msg_dst_times_msg")
    assert expr.shipped == form and expr.name == form
    assert kmod.library_for(expr, "min") is kmod.LIBRARY
  swapped = pe.trace(lambda m, e, d: e + m, dtype, lane=lane,
                     reads_dst=False)
  assert swapped.shipped is None and swapped.name.startswith("traced_")
  assert swapped != pe.trace(REFERENCE_FORMS["msg_plus_edge"], dtype,
                             lane=lane, reads_dst=False)
  lib = kmod.library_for(swapped, "min")
  assert lib is not kmod.LIBRARY and lib is kmod.library_for(swapped, "min")
  source = kmod.generated_source(swapped, "min")
  assert "TracedProcess" in source and '#include "ell_spmv_body.cuh"' in source


PARITY = {  # name -> (JAX callable, torch callable, reduce, dtype, Q)
    "widest": (lambda m, e, d: jnp.minimum(m, e),
               lambda m, e, d: torch.minimum(m, e), "max", np.float32, 0),
    "damped_pagerank": (lambda m, e, d: 0.85 * m, lambda m, e, d: 0.85 * m,
                        "add", np.float32, 0),
    "int_where": (lambda m, e, d: jnp.where(m < 1000, m * 2 + 1, m),
                  lambda m, e, d: torch.where(m < 1000, m * 2 + 1, m),
                  "min", np.int32, 0),
    "widest_lanes": (lambda m, e, d: jnp.minimum(m, e),
                     lambda m, e, d: torch.minimum(m, e), "max", np.float32,
                     8),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_spmv_matches_reference_pallas(graphs, name):
  n, jg, tg = graphs
  jfn, tfn, kind, dtype, q = PARITY[name]
  rng = np.random.default_rng(len(name))
  shape = (n, q) if q else (n,)
  msg = (rng.integers(0, 1500, shape) if dtype == np.int32
         else rng.uniform(0, 2, shape)).astype(dtype)
  act = rng.uniform(size=n) < 0.6
  jprog = JProgram(process_message=jfn, reduce_kind=kind,
                   process_reads_dst=False, lanewise=bool(q))
  tprog = GraphProgram(process_message=tfn, reduce_kind=kind,
                       process_reads_dst=False, lanewise=bool(q))
  jy, jr = spmv_ell_pallas(jg, jnp.asarray(msg), jnp.asarray(act),
                           jnp.asarray(msg), jprog)
  before = kmod.launches.total
  ty, tr = spmv_ell_cuda(tg, torch.from_numpy(msg), torch.from_numpy(act),
                         torch.from_numpy(msg), tprog)
  assert kmod.launches.total == before  # the CPU path launches nothing
  assert tbe.resolve(tbe.AUTO_PLAN, tg, torch.from_numpy(msg),
                     torch.from_numpy(msg), tprog).name == "cuda_ell"
  np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
  if kind == "add":
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
  else:
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_widest_path_run_matches_reference_engine(graphs):
  n, jg, tg = graphs
  inf = float("inf")
  jprog = JProgram(process_message=lambda m, e, d: jnp.minimum(m, e),
                   reduce_kind="max", apply=jnp.maximum,
                   process_reads_dst=False, name="widest")
  tprog = GraphProgram(process_message=lambda m, e, d: torch.minimum(m, e),
                       reduce_kind="max", apply=torch.maximum,
                       process_reads_dst=False, name="widest")
  w0 = np.zeros(n, np.float32)
  w0[0] = inf
  a0 = np.zeros(n, bool)
  a0[0] = True
  jst = j_run(jg, jprog, jnp.asarray(w0), jnp.asarray(a0),
              backend=jbe.Plan("pallas"))
  tst = run_graph_program(tg, tprog, torch.from_numpy(w0),
                          torch.from_numpy(a0), backend=tbe.Plan("cuda_ell"))
  np.testing.assert_array_equal(tst.prop.numpy(), np.asarray(jst.prop))
  assert int(tst.iteration) == int(jst.iteration)
  assert int((tst.prop > 0).sum()) > 1


def test_planner_plans_traced_programs_onto_the_kernel(graphs):
  n, jg, tg = graphs
  prog = GraphProgram(process_message=lambda m, e, d: torch.minimum(m, e),
                      reduce_kind="max", process_reads_dst=False)
  jprog = JProgram(process_message=lambda m, e, d: jnp.minimum(m, e),
                   reduce_kind="max", process_reads_dst=False)
  planner = tbe.Planner(ell_efficiency_floor=0.0)
  assert planner.plan(tg, prog).backend == "cuda_ell"
  assert jbe.Planner(ell_efficiency_floor=0.0).plan(jg, jprog).backend == \
      "pallas"
  assert tbe.Plan("cuda_ell") in planner.candidates(tg, prog, 8)
  refused = REFUSED_PROGRAMS["unknown_op"][0]
  assert planner.plan(tg, refused).backend == "ell"


def test_wrapper_takes_a_traced_process_on_cpu():
  rng = np.random.default_rng(5)
  cols = torch.from_numpy(rng.integers(0, 40, (32, 8)).astype(np.int32))
  vals = torch.from_numpy(rng.uniform(0.1, 2, (32, 8)).astype(np.float32))
  mask = torch.from_numpy(rng.uniform(size=(32, 8)) > 0.3)
  msg = torch.from_numpy(rng.standard_normal((40, 1)).astype(np.float32))
  act = torch.ones(40, dtype=torch.bool)
  fn = EXPRS["where_gt"][0]
  expr = pe.trace(fn, F, lane=False)
  y, r = kmod.ell_spmv(cols, vals, mask, msg, act, process=expr,
                       reduce_kind="min")
  want = torch.where(mask, fn(msg[:, 0][cols.long()], vals, None),
                     torch.inf).amin(dim=1)
  _same(y[:, 0], want)
  assert kmod.takes(msg[:, 0], vals, expr, "min")
  assert not kmod.takes(msg[:, 0].double(), vals, expr, "min")
  assert not kmod.takes(msg[:, 0], vals.int(), expr, "min")
  with pytest.raises(ValueError, match="not both"):
    kmod.ell_spmv(cols, vals, mask, msg, act, process=expr,
                  process_op="msg", reduce_kind="min")
  with pytest.raises(ValueError, match="traced at"):
    kmod.ell_spmv(cols, vals, mask, msg.half(), act, process=expr,
                  reduce_kind="min")


# ---------------------------------------------------------------------------
# The generated functors, compiled for the host
# ---------------------------------------------------------------------------

_SHIM = r"""
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
static inline float __uint_as_float(unsigned u) {
  float f; std::memcpy(&f, &u, 4); return f;
}
static inline float __int_as_float(int u) {
  float f; std::memcpy(&f, &u, 4); return f;
}
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return std::sqrt(a); }
static inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
static inline int __float2int_rz(float a) { return static_cast<int>(a); }
#include "ell_process.cuh"
"""

_MAIN = r"""
int main() {
  uint32_t n = 0, k = 0;
  if (std::fread(&k, 4, 1, stdin) != 1 || std::fread(&n, 4, 1, stdin) != 1)
    return 1;
  std::vector<T> m(n), e(n), d(n), y(n);
  if (std::fread(m.data(), 4, n, stdin) != n ||
      std::fread(e.data(), 4, n, stdin) != n ||
      std::fread(d.data(), 4, n, stdin) != n) return 1;
  for (uint32_t i = 0; i < n; ++i) {
    switch (k) {
%s
    }
  }
  std::fwrite(y.data(), 4, n, stdout);
  return 0;
}
"""

HOST_NAMES = ["widest", "where_gt", "int_where", "dst", "rsub_max", "clamp",
              "clamp_int", "logic", "cast", "neg_ne", "recip", "const_where",
              "tensor_const", "damped", "sqrt", "exp", "log", "rsqrt",
              "div3"]


def _host_binary(tmp_path, dtype, names):
  cxx = shutil.which("g++") or shutil.which("c++")
  if cxx is None:
    pytest.skip("no host C++ compiler")
  structs, cases = [], []
  for k, name in enumerate(names):
    expr = pe.trace(EXPRS[name][0], dtype, lane=False)
    structs.append(expr.functor_source(f"P{k}"))
    cases.append(f"      case {k}: y[i] = P{k}::apply(m[i], e[i], d[i]); "
                 "break;")
  ctype = "float" if dtype == F else "int"
  src = (_SHIM + "namespace {\n" + "\n".join(structs) + "}\n"
         + f"using T = {ctype};\n" + _MAIN % "\n".join(cases))
  path = tmp_path / f"shim_{ctype}.cc"
  path.write_text(src)
  exe = tmp_path / f"shim_{ctype}"
  subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                  f"-I{CSRC}", "-o", str(exe), str(path)], check=True,
                 capture_output=True, text=True)
  return exe


def _run_host(exe, k, m, e, d):
  data = (np.array([k, m.numel()], np.uint32).tobytes()
          + b"".join(x.numpy().tobytes() for x in (m, e, d)))
  out = subprocess.run([str(exe)], input=data, capture_output=True,
                       check=True).stdout
  return torch.from_numpy(np.frombuffer(out, dtype=m.numpy().dtype).copy())


@pytest.mark.parametrize("dtype", [F, I], ids=["f32", "i32"])
def test_generated_functors_match_the_expression_on_the_host(tmp_path,
                                                             dtype):
  names = [nm for nm in HOST_NAMES if dtype in EXPRS[nm][1]]
  exe = _host_binary(tmp_path, dtype, names)
  m, e, d = _inputs(dtype, False, seed=3)
  for k, name in enumerate(names):
    expr = pe.trace(EXPRS[name][0], dtype, lane=False)
    got = _run_host(exe, k, m, e, d)
    want = expr.evaluate(m, e, d)
    if name in ("exp", "log", "rsqrt"):
      ok = ~torch.isnan(want)
      assert torch.equal(torch.isnan(got), ~ok)
      np.testing.assert_array_max_ulp(got[ok].numpy(), want[ok].numpy(),
                                      maxulp=2)
    elif name == "sqrt":
      # Correctly rounded, as the card's sqrt (torch's CPU sqrt is not
      # always; it is held to the expression within 1 ulp).
      _same(got, torch.from_numpy(np.sqrt(np.abs(m.numpy()))))
      np.testing.assert_array_max_ulp(got.numpy(), want.numpy(), maxulp=1)
    elif name == "div3":
      # A product with the float32 reciprocal, as eager CUDA divides by a
      # constant (the CPU's torch divides).
      inv = np.float32(1.0) / np.float32(3.0)
      with np.errstate(all="ignore"):
        cuda = torch.from_numpy(m.numpy() * inv + e.numpy())
      _same(got, cuda)
    else:
      _same(got, want)


# Processes over float32 and int32 operands mixed (name -> callable,
# message / edge / destination dtypes): their functors take and return each
# operand in its own type.
MIXED_HOST = {
    "int_times_float": (lambda m, e, d: m * e, (I, F, I)),
    "float_plus_int": (lambda m, e, d: m + e - d, (F, I, I)),
    "int_lt_float": (lambda m, e, d: torch.where(m < e, m, d), (I, F, I)),
    "int_float_compare": (lambda m, e, d: torch.where(m < 2.5, m, e),
                          (I, I, I)),
    "int_div": (lambda m, e, d: m / 3 + e / d, (I, I, F)),
    "int_min_float": (lambda m, e, d: torch.minimum(m, e) * 0.5, (I, F, F)),
    "float_to_int": (lambda m, e, d: (m * e).to(torch.int32) + d,
                     (F, F, I)),
    "bool_cast": (lambda m, e, d: (m > e).to(torch.int32) * d + m,
                  (I, F, I)),
}


def test_generated_mixed_functors_match_the_expression_on_the_host(
    tmp_path):
  cxx = shutil.which("g++") or shutil.which("c++")
  if cxx is None:
    pytest.skip("no host C++ compiler")
  ctype = {F: "float", I: "int"}
  rng = np.random.default_rng(4)
  n = 512
  structs, cases, exprs = [], [], []
  for k, (name, (fn, dts)) in enumerate(MIXED_HOST.items()):
    expr = pe.trace(fn, dts[0], lane=False, edge_dtype=dts[1],
                    dst_dtype=dts[2])
    assert isinstance(expr, pe.ProcessExpr), name
    exprs.append(expr)
    structs.append(expr.functor_source(f"P{k}"))
    types = [ctype[t] for t in (*dts, expr.out_dtype)]
    cases.append(
        f"      case {k}: reinterpret_cast<{types[3]}*>(y.data())[i] = "
        f"P{k}::apply(reinterpret_cast<const {types[0]}*>(m.data())[i], "
        f"reinterpret_cast<const {types[1]}*>(e.data())[i], "
        f"reinterpret_cast<const {types[2]}*>(d.data())[i]); break;")
  src = (_SHIM + "namespace {\n" + "\n".join(structs) + "}\n"
         + "using T = uint32_t;\n" + _MAIN % "\n".join(cases))
  path = tmp_path / "shim_mixed.cc"
  path.write_text(src)
  exe = tmp_path / "shim_mixed"
  subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                  f"-I{CSRC}", "-o", str(exe), str(path)], check=True,
                 capture_output=True, text=True)
  for k, ((name, (fn, dts)), expr) in enumerate(zip(MIXED_HOST.items(),
                                                    exprs)):
    ops = []
    for t in dts:  # in-range values: a float-to-int cast stays defined
      ops.append(torch.from_numpy(rng.integers(1, 2000, n).astype(np.int32))
                 if t == I else torch.from_numpy(
                     (rng.standard_normal(n) * 40).astype(np.float32)))
    data = (np.array([k, n], np.uint32).tobytes()
            + b"".join(x.numpy().tobytes() for x in ops))
    out = subprocess.run([str(exe)], input=data, capture_output=True,
                         check=True).stdout
    got = torch.from_numpy(np.frombuffer(
        out, dtype={F: np.float32, I: np.int32}[expr.out_dtype]).copy())
    want = expr.evaluate(*ops)
    if name == "int_div":
      # A product with the float32 reciprocal of 3, as eager CUDA divides
      # by a constant (the CPU's torch divides).
      inv = np.float32(1.0) / np.float32(3.0)
      m, e, d = (x.numpy() for x in ops)
      want = torch.from_numpy(m.astype(np.float32) * inv
                              + e.astype(np.float32) / d)
    _same(got, want)
