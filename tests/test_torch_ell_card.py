"""The CUDA ELL kernel on the card against its plain version, on the numpy
inputs that ``test_torch_half_sum.py`` and ``test_torch_lane_grid.py``
hold the plain version to the reference's ``ell_spmv_pallas`` with (in
interpret mode, on the CPU).  This file imports no JAX, so that it runs on
a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ell_card.py

Every test is marked ``cuda`` and skips without a card.

* Half sums: the shipped ``msg`` instance over float16 messages sums a
  row in float and rounds once, as the reference's kernel sums a tile in
  float32 (``jnp.sum`` of float16) and as the plain version sums it
  (``HALF_ROWS``): 4,000 terms of 1.0 give 4,000; 2,048 and then 3,999
  terms of 1.0 give 6,048, where a sum kept in float16 stalls at 2,048 on
  the thread that holds the first term; 500 terms in [0.5, 1.5] come
  within one float16 ulp of the float64 sum, at Q = 1 (the single-query
  grid) and Q = 8 (the query-tiled grid).
* The lane-vector grid (``LANE_PROCESSES`` at every K of ``LANE_KS`` and
  message dtype of ``LANE_DTYPES``): rows of 0, 1, 4, 5, 31, 32, 33 and
  152 slots, prefix and holed, in degree-sorted runs so that the row-class
  table has a class a warp, one of two teams a row and one of a team a
  row; add, min and max; K_out 1 and K; Kd 1 and K.  Tolerances as
  ``chip_smoke.py`` states them: rtol 1e-5 for float32 sums, 1e-2 for
  float16, 2e-2 for bfloat16 (with atol rtol times the largest magnitude),
  bitwise for min and max without a float lane sum.
* Float64 sums (GAP's path counts, ``algos/bc.py``): the pass-through
  ``m`` over float64 messages by add, at Q = 1 (the single-query grid:
  the cooperative launch, and the plain launch of a table of short rows),
  4 and 8 (the query-tiled grid), every source active and a part: whole
  numbers below 2**40 bitwise (their sums are exact in any order), uniform
  values at rtol 1e-12.
"""

from typing import Dict

import numpy as np
import pytest
import torch

from repro_torch.core.graph import ell_extent
from repro_torch.kernels import _build
from repro_torch.kernels import ell_spmv as kmod
from repro_torch.kernels import process_expr as pe
from repro_torch.kernels.ref import ell_spmv_ref

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float16: 1e-2, torch.bfloat16: 2e-2}

# --- Half sums ---------------------------------------------------------------

# name -> (terms of the one row, Q)
HALF_ROWS = ("ones_4000", "stall_6048", "uniform_500", "uniform_500_q8")
HALF_EXACT = {"ones_4000": 4000.0, "stall_6048": 6048.0}


def half_row(name: str) -> Dict[str, np.ndarray]:
  """One packed row whose slots name sources 0..W-1 in order, every slot
  set and every source active; ``msg`` float32 [W, Q] (exact in float16)
  and the float64 sum of its columns."""
  rng = np.random.default_rng(25)
  if name == "ones_4000":
    msg = np.ones((4000, 1), np.float32)
  elif name == "stall_6048":
    msg = np.ones((4000, 1), np.float32)
    msg[0] = 2048.0
  else:
    q = 8 if name.endswith("q8") else 1
    msg = rng.uniform(0.5, 1.5, (500, q)).astype(np.float16).astype(
        np.float32)
  w = msg.shape[0]
  return {"cols": np.arange(w, dtype=np.int32)[None],
          "vals": np.ones((1, w), np.float32),
          "mask": np.ones((1, w), bool),
          "msg": msg, "active": np.ones(w, bool),
          "sum": msg.astype(np.float64).sum(axis=0)}


def check_half_sum(name: str, y: np.ndarray) -> None:
  """``y`` [Q] of a float16 sum of ``half_row(name)``: the exact value, or
  within one float16 ulp of the float64 sum."""
  want = half_row(name)["sum"]
  y = np.asarray(y, np.float64).reshape(-1)
  if name in HALF_EXACT:
    assert y.tolist() == [HALF_EXACT[name]], (name, y)
    return
  ulp = np.spacing(want.astype(np.float16)).astype(np.float64)
  assert (np.abs(y - want) <= ulp).all(), (name, y, want, ulp)


def _card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (run on the card: README)")
  return torch.device("cuda")


@pytest.mark.parametrize("name", HALF_ROWS)
def test_shipped_half_sum_on_the_card(name):
  dev = _card()
  row = half_row(name)
  t = {k: torch.from_numpy(v).to(dev) for k, v in row.items() if k != "sum"}
  msg = t["msg"].half()
  y, recv = kmod.ell_spmv(t["cols"], t["vals"].half(), t["mask"], msg,
                          t["active"], process_op="msg", reduce_kind="add")
  torch.cuda.synchronize()
  assert y.dtype == torch.float16 and recv.tolist() == [1]
  check_half_sum(name, y.double().cpu().numpy())
  yr, _ = kmod.ell_spmv(*(x.cpu() for x in (t["cols"], t["vals"].half(),
                                             t["mask"], msg, t["active"])),
                        process_op="msg", reduce_kind="add")
  check_half_sum(name, yr.double().numpy())


# --- The lane-vector grid ----------------------------------------------------

LANE_KS = (3, 16, 33, 128, 256)
LANE_DTYPES = ("float32", "float16", "bfloat16")
# Extents of the test block's rows, in degree-sorted runs of 32 rows (the
# row-class table's chunk): a warp a row, then two teams a row, then one.
LANE_EXTENTS = ((152, 33, 32, 31), (5, 4), (1, 0))
LANE_WIDTH, LANE_SRC = 152, 300


# name -> (callable, reduce, the ``lane_block`` property it reads: Kd = K
# ("dprop_k"), Kd = 1 ("dprop_1") or none (None));
# ``test_torch_lane_grid.py`` gives each its reference twin.
LANE_PROCESSES = {
    # A lane dot score (K_out = 1, Kd = K) by max.
    "dot_max": (lambda m, e, d: (m * d).sum(-1), "max", "dprop_k"),
    # Collaborative filtering's process (K_out = K, Kd = K) by add.
    "cf_add": (lambda m, e, d: (e - (m * d).sum(-1, keepdim=True)) * m,
               "add", "dprop_k"),
    # A lane softmax weight (K_out = K, no dprop) by add.
    "softmax_add": (
        lambda m, e, d: torch.exp(m - m.amax(-1, keepdim=True)) * e, "add",
        None),
    # Centred messages scaled by a one-wide property (K_out = K, Kd = 1).
    "centred_add": (lambda m, e, d: m * d - m.mean(-1, keepdim=True), "add",
                    "dprop_1"),
    # A lane max against a select (K_out = 1, Kd = 1) by min.
    "select_min": (
        lambda m, e, d: torch.maximum(m.amax(-1, keepdim=True) - d,
                                      m[..., 2:3] * e), "min", "dprop_1"),
}
LANE_CASES = [(name, k, dt) for name in LANE_PROCESSES
              for k in LANE_KS for dt in LANE_DTYPES]
LANE_IDS = [f"{n}-K{k}-{dt}" for n, k, dt in LANE_CASES]


def lane_block(k: int, seed: int = 0, nan: bool = False
               ) -> Dict[str, np.ndarray]:
  """The test block as numpy: ``LANE_EXTENTS``' rows (even rows of a run
  prefix, odd ones holed with their last slot set), cols over
  ``LANE_SRC`` sources, 80% of them active, float32 messages [n, K],
  edge values and properties [n_pad, K] and [n_pad, 1] (exact in
  bfloat16, so every dtype sees the same values); with ``nan`` a NaN in
  one lane of every 50th message."""
  rng = np.random.default_rng(seed + k)
  extents = np.array([run[i % len(run)] for run in LANE_EXTENTS
                      for i in range(32)], np.int64)
  n_pad = extents.shape[0]
  slot = np.arange(LANE_WIDTH)[None]
  mask = slot < extents[:, None]
  holes = rng.uniform(size=mask.shape) < 0.3
  holes[::2] = False
  holes[np.arange(n_pad), np.maximum(extents - 1, 0)] = False
  mask &= ~holes

  def exact(x):
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()
  msg = exact(rng.uniform(-1.0, 2.0, (LANE_SRC, k)))
  if nan:
    msg[::50, k // 2] = np.nan
  return {"cols": rng.integers(0, LANE_SRC, mask.shape).astype(np.int32),
          "vals": exact(rng.uniform(0.1, 2.0, mask.shape)),
          "mask": mask, "active": rng.uniform(size=LANE_SRC) < 0.8,
          "msg": msg,
          "dprop_k": exact(rng.uniform(-1.0, 1.0, (n_pad, k))),
          "dprop_1": exact(rng.uniform(-1.0, 1.0, (n_pad, 1)))}


def lane_trace(name: str, k: int, dtype: torch.dtype):
  """The port's trace of process ``name`` at K and ``dtype`` (every operand
  in it) and the dprop key of ``lane_block`` it reads (None: none)."""
  fn, _, dkey = LANE_PROCESSES[name]
  expr = pe.trace(fn, dtype, lane=True, k=k, edge_dtype=dtype,
                  dst_dtype=dtype, kd=k if dkey == "dprop_k" else 1,
                  reads_dst=dkey is not None)
  assert isinstance(expr, pe.ProcessExpr) and expr.lane_mixing, expr
  return expr, dkey


def lane_tensors(block, dtype, dkey, device):
  t = {k: torch.from_numpy(v).to(device) for k, v in block.items()}
  return (t["cols"], t["vals"].to(dtype), t["mask"], t["msg"].to(dtype),
          t["active"], None if dkey is None else t[dkey].to(dtype))


def lane_sums(expr) -> bool:
  """Whether the process has a float lane sum (its result then rounds in
  another order than the plain version's)."""
  return any(op in ("lane_sum", "lane_mean") for op, *_ in expr.nodes)


def close(got: torch.Tensor, want: torch.Tensor, bitwise: bool,
          what: str) -> None:
  assert got.shape == want.shape and got.dtype == want.dtype, (
      what, got.shape, want.shape, got.dtype, want.dtype)
  if bitwise or got.dtype not in RTOL:
    assert torch.equal(got.isnan(), want.isnan()), what
    ok = ~want.isnan()
    assert torch.equal(got[ok], want[ok]), what
    return
  rtol = RTOL[got.dtype]
  w = want.double()
  scale = float(w[w.isfinite()].abs().max()) if w.isfinite().any() else 0.0
  torch.testing.assert_close(got.double(), w, rtol=rtol, atol=rtol * scale,
                             equal_nan=True, msg=lambda m: f"{what}: {m}")


@pytest.fixture(scope="module")
def lane_libraries():
  """Every lane case's instance, built up front, one ``nvcc`` a CPU."""
  _card()
  libs = [kmod.library_for(lane_trace(name, k, getattr(torch, dt))[0],
                           LANE_PROCESSES[name][1])
          for name, k, dt in LANE_CASES]
  _build.load_all(libs)
  return libs


@pytest.mark.parametrize("name,k,dt", LANE_CASES, ids=LANE_IDS)
def test_lane_grid_on_the_card(lane_libraries, name, k, dt):
  """The kernel against its plain version on the test block, and again
  with NaN among the messages (a min or max over a NaN is NaN)."""
  dev = _card()
  dtype = getattr(torch, dt)
  _, red, _ = LANE_PROCESSES[name]
  expr, dkey = lane_trace(name, k, dtype)
  for nan in (False, True):
    cols, vals, mask, msg, act, dprop = lane_tensors(
        lane_block(k, nan=nan), dtype, dkey, dev)
    kmod.launches.reset()
    y, recv = kmod.ell_spmv(cols, vals, mask, msg, act, process=expr,
                            reduce_kind=red, dprop=dprop)
    torch.cuda.synchronize()
    assert kmod.launches.by_config == {
        kmod.config_key(k, dtype, red, expr.name, True): 1}
    dp = (torch.zeros((cols.shape[0], 1), dtype=dtype, device=dev)
          if dprop is None else dprop)
    yr, rr = ell_spmv_ref(cols, vals, mask, msg, act, dp,
                          process=expr.plain, reduce_kind=red)
    assert torch.equal(recv, rr)
    assert not nan or bool(yr.isnan().any())
    close(y, yr, bitwise=red != "add" and not lane_sums(expr),
          what=f"{name} K={k} {dt} nan={nan}")


# --- Float64 sums ------------------------------------------------------------

F64_CASES = [(q, frac, kind, rows) for q in (1, 4, 8) for frac in (1.0, 0.8)
             for kind in ("counts", "uniform")
             for rows in (("mixed", "short") if q == 1 else ("mixed",))]
F64_IDS = [f"Q{q}-{frac}-{kind}-{rows}" for q, frac, kind, rows in F64_CASES]


def f64_block(q: int, frac: float, kind: str, rows: str, seed: int = 3):
  """The lane grid's test block (or, for ``short``, its rows cut to at most
  4 slots, so that every row is in the one-lane class) with float64
  messages [LANE_SRC, Q]: whole numbers below 2**40, or uniform in [0, 1)."""
  block = lane_block(3, seed=seed)
  if rows == "short":
    block["mask"] = block["mask"] & (np.arange(LANE_WIDTH)[None] < 4)
  rng = np.random.default_rng(seed)
  block["active"] = rng.uniform(size=LANE_SRC) < frac
  block["msg"] = (rng.integers(0, 2**40, (LANE_SRC, q)).astype(np.float64)
                  if kind == "counts" else rng.uniform(size=(LANE_SRC, q)))
  return block


@pytest.mark.parametrize("q,frac,kind,rows", F64_CASES, ids=F64_IDS)
def test_float64_sum_on_the_card(q, frac, kind, rows):
  """The float64 pass-through instance by add on both grids, against the
  plain version (``kernels/ref.py``), launched under its own key."""
  dev = _card()
  block = f64_block(q, frac, kind, rows)
  t = {k: torch.from_numpy(v).to(dev) for k, v in block.items()}
  expr = pe.trace(lambda m, e, d: m, torch.float64, lane=q > 1,
                  k=q if q > 1 else None, reads_dst=False)
  assert isinstance(expr, pe.ProcessExpr) and expr.shipped is None, expr
  kmod.launches.reset()
  y, recv = kmod.ell_spmv(t["cols"], t["vals"], t["mask"], t["msg"],
                          t["active"], process=expr, reduce_kind="add")
  torch.cuda.synchronize()
  assert kmod.launches.by_config == {
      kmod.config_key(q, torch.float64, "add", expr.name): 1}
  ends, _ = ell_extent(t["mask"])
  assert (rows == "short") == kmod.row_segments(
      torch.from_numpy(ends).to(dev)).short_rows
  yr, rr = ell_spmv_ref(*(x.cpu() for x in (
      t["cols"], t["vals"], t["mask"], t["msg"], t["active"])),
      torch.zeros((block["mask"].shape[0], 1), dtype=torch.float64),
      process=expr.plain, reduce_kind="add")
  assert y.dtype == torch.float64 and torch.equal(recv.cpu(), rr)
  if kind == "counts":
    assert torch.equal(y.cpu(), yr)
  else:
    torch.testing.assert_close(y.cpu(), yr, rtol=1e-12, atol=1e-12)
