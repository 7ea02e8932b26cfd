"""The CUDA ELL kernel's lane-vector grid, on the CPU: its row-class table,
and its plain version against the reference's ``ell_spmv_pallas``.

* The row-class table (``RowSegments.lane_table``, ``row_classes``): each
  packed row is served by exactly one run of threads of one warp, as the
  kernel maps warps to rows; a row that fits one team's step shares a warp
  with others, a longer one gets more teams, up to a warp; empty rows, a
  table of short rows only, and one long hub among short rows.
* Every lane case of ``test_torch_ell_card.py`` (``LANE_PROCESSES`` at K =
  3, 16, 33, 128 and 256, float32, float16 and bfloat16; rows of 0-152
  slots, prefix and holed): the port's ``ell_spmv`` on CPU tensors (the
  kernel's plain version, which the card test holds the kernel to) against
  the reference's kernel in interpret mode on the same numpy inputs.
  Tolerances: rtol 1e-5 (float32), 1e-2 (float16), 2e-2 (bfloat16) with
  atol rtol times the largest magnitude, for float sums and for any
  float16 or bfloat16 result (XLA may round a fused chain of half ops
  once); bitwise for float32 min and max without a lane sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ell_spmv import ell_spmv_pallas  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.kernels import ell_spmv as kmod  # noqa: E402
from test_torch_ell_card import (LANE_CASES, LANE_IDS,  # noqa: E402
                                 LANE_PROCESSES, RTOL, lane_block,
                                 lane_sums, lane_tensors, lane_trace)

# The reference's twin of each of LANE_PROCESSES (``e [..]``, a result of
# [.., K_out]).
REFERENCE = {
    "dot_max": lambda m, e, d: jnp.sum(m * d, -1, keepdims=True),
    "cf_add": lambda m, e, d: (e[..., None]
                               - jnp.sum(m * d, -1, keepdims=True)) * m,
    "softmax_add": lambda m, e, d: (jnp.exp(m - jnp.max(m, -1, keepdims=True))
                                    * e[..., None]),
    "centred_add": lambda m, e, d: m * d - jnp.mean(m, -1, keepdims=True),
    "select_min": lambda m, e, d: jnp.maximum(
        jnp.max(m, -1, keepdims=True) - d, m[..., 2:3] * e[..., None]),
}
_JNP = {torch.float32: jnp.float32, torch.float16: jnp.float16,
        torch.bfloat16: jnp.bfloat16}

# --- The row-class table -----------------------------------------------------

# (team threads, slots a team takes per step) of the layouts the grid uses.
TEAM_SHAPES = [(1, 4), (2, 4), (4, 4), (8, 4), (16, 4), (32, 4), (32, 2)]


@pytest.mark.parametrize("team,slots", TEAM_SHAPES)
@pytest.mark.parametrize("extent", [0, 1, 2, 4, 5, 8, 9, 16, 17, 31, 32, 33,
                                    64, 65, 128, 129, 152, 4000])
def test_row_classes(team, slots, extent):
  """The fewest teams (a power of two) whose step covers the row, at most
  a warp's worth."""
  threads = int(kmod.row_classes(extent, team, slots))
  teams = threads // team
  assert threads % team == 0 and teams & (teams - 1) == 0
  assert threads <= 32
  if threads < 32:
    assert teams * slots >= extent
  if teams > 1:
    assert (teams // 2) * slots < extent
  assert kmod.row_classes(np.array([extent] * 3), team, slots).tolist() == [
      threads] * 3


def _served(table: list, num_warps: int, n_pad: int) -> np.ndarray:
  """How many row-leading threads each packed row gets when the kernel maps
  warps to rows by ``table`` (first row, end row, threads, first warp)."""
  served = np.zeros(n_pad, np.int64)
  warps = 0
  for (r0, r1, g, w0), nxt in zip(table, table[1:] + [None]):
    assert w0 == warps and g in (1, 2, 4, 8, 16, 32)
    assert nxt is None or nxt[0] == r1
    span = -(-(r1 - r0) * g // 32)
    for warp in range(w0, w0 + span):
      lane = np.arange(32)
      rows = r0 + (warp - w0) * (32 // g) + lane // g
      first = lane % g == 0
      np.add.at(served, rows[first & (rows < r1)], 1)
    warps += span
  assert warps == num_warps
  return served


def _hub_ends(n_pad=200):
  ends = np.ones(n_pad, np.int32)
  ends[0] = 4000
  return ends


TABLE_ENDS = {
    "empty": lambda: np.zeros(100, np.int32),
    "all_short": lambda: np.random.default_rng(1).integers(
        0, 5, 300).astype(np.int32),
    "hub": _hub_ends,
    "sorted": lambda: np.sort(np.random.default_rng(2).integers(
        0, 153, 500))[::-1].astype(np.int32),
    "lane_block": lambda: np.array([r[i % len(r)] for r in (
        (152, 33, 32, 31), (5, 4), (1, 0)) for i in range(32)], np.int32),
}


@pytest.mark.parametrize("team,slots", TEAM_SHAPES)
@pytest.mark.parametrize("name", sorted(TABLE_ENDS))
def test_lane_table_covers_each_row_once(name, team, slots):
  ends = TABLE_ENDS[name]()
  n_pad = ends.shape[0]
  segments = kmod.row_segments(torch.from_numpy(ends))
  table, num_warps = segments.lane_table(team, slots)
  assert segments.lane_table(team, slots)[0] is table  # made once
  rows = table.tolist()
  assert rows[0][0] == 0 and rows[-1][1] == n_pad
  assert _served(rows, num_warps, n_pad).tolist() == [1] * n_pad
  for r0, r1, g, _ in rows:
    assert g >= team
    # A class of fewer than 32 threads covers each of its rows in a step.
    assert g == 32 or int(ends[r0:r1].max()) <= (g // team) * slots
  classes = [g for _, _, g, _ in rows]
  if name in ("empty", "all_short") and slots >= 4:
    # Every row fits one team's step: 32 / team rows a warp.
    assert classes == [team]
    assert num_warps == -(-n_pad * team // 32)
  if name == "hub":
    # The hub's run of 32 rows takes a warp a row; the rest a team a row.
    assert rows[0][:3] == [0, n_pad if team == 32 else kmod.SEGMENT_CHUNK,
                           32]
    assert classes[-1] == team and len(rows) == (1 if team == 32 else 2)
  if name == "sorted":
    assert classes == sorted(classes, reverse=True)


def test_lane_table_of_a_built_graph(rmat_small):
  """The builder's degree-sorted rows: classes never rise along the rows,
  and the tail of short rows shares warps."""
  n, src, dst, w = rmat_small
  g = TG.build_ell(src, dst, w, n=n, device="cpu")
  segments = kmod.row_segments(g.row_end)
  table, num_warps = segments.lane_table(4, 4)
  rows = table.tolist()
  assert _served(rows, num_warps, g.n_pad).tolist() == [1] * g.n_pad
  classes = [r[2] for r in rows]
  assert classes == sorted(classes, reverse=True)
  assert classes[0] == 32 and classes[-1] == 4


# --- The plain version against the reference ---------------------------------


@pytest.mark.parametrize("name,k,dt", LANE_CASES, ids=LANE_IDS)
def test_lane_plain_matches_reference(name, k, dt):
  dtype = getattr(torch, dt)
  _, red, _ = LANE_PROCESSES[name]
  expr, dkey = lane_trace(name, k, dtype)
  block = lane_block(k)
  cols, vals, mask, msg, act, dprop = lane_tensors(block, dtype, dkey, "cpu")
  y, recv = kmod.ell_spmv(cols, vals, mask, msg, act, process=expr,
                          reduce_kind=red, dprop=dprop)
  jd = (jnp.zeros((cols.shape[0], 1), _JNP[dtype]) if dkey is None
        else jnp.asarray(block[dkey]).astype(_JNP[dtype]))
  jy, jr = ell_spmv_pallas(
      jnp.asarray(block["cols"]), jnp.asarray(block["vals"]).astype(
          _JNP[dtype]), jnp.asarray(block["mask"]),
      jnp.asarray(block["msg"]).astype(_JNP[dtype]),
      jnp.asarray(block["active"]), jd, process=REFERENCE[name],
      reduce_kind=red, interpret=True)
  assert y.dtype == dtype and jy.dtype == _JNP[dtype]
  assert y.shape == jy.shape == (cols.shape[0], expr.k_out)
  np.testing.assert_array_equal(recv.numpy(), np.asarray(jr))
  got = y.double().numpy()
  want = np.asarray(jy.astype(jnp.float32)).astype(np.float64)
  if dtype == torch.float32 and red != "add" and not lane_sums(expr):
    np.testing.assert_array_equal(got, want)
    return
  rtol = RTOL[dtype]
  scale = float(np.abs(want[np.isfinite(want)]).max())
  np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)
