"""The CUDA ELL kernel's plain version, wrapper and backend against the JAX
package.

* ``ell_spmv_ref`` against the JAX ``ell_spmv_pallas`` in interpret mode,
  as ``tests/test_kernels.py`` runs it, over a subset of its sweep.
* The ``ell_spmv`` wrapper on CPU tensors (its plain version) for the four
  ``process_op`` forms, against the JAX kernel at Q = 1 and with
  ``block_queries``.
* The ``cuda_ell`` backend on CPU, spill and un-permute included, against
  the JAX ``pallas`` backend.
* The graph's row extents and prefix flag, and the kernel's lane segments
  (kept once per graph by the ``cuda_ell`` backend).
* The destination-reading form ``edge_minus_msg_dst_times_msg`` through the
  wrapper against the JAX kernel's ``plus_dst``, and through
  ``run_fixed_iters`` with ``Plan("cuda_ell")`` against the JAX engine
  with ``Plan("pallas")``; the wrapper's refusals of a bad ``dprop``.
* On a card only: the kernel against its plain version.

Tolerances: min/max and int32 bitwise; float add rtol 1e-5 (atol 1e-5 as
in ``tests/test_kernels.py``), since the sums run in different orders.
"""

import gc
import importlib.util
import pathlib

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
from repro.core.engine import run_fixed_iters as j_run_fixed_iters  # noqa: E402
from repro.core.vertex_program import (  # noqa: E402
    GraphProgram as JGraphProgram)
from repro.kernels.ell_spmv import ell_spmv_pallas  # noqa: E402
from repro_torch.algos.bfs import bfs_program  # noqa: E402
from repro_torch.algos.pagerank import pagerank_program  # noqa: E402
from repro_torch.algos.sssp import sssp_program  # noqa: E402
from repro_torch.core import backends as tbe  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import spmv as tspmv  # noqa: E402
from repro_torch.core.engine import run_fixed_iters  # noqa: E402
from repro_torch.core.vertex_program import (  # noqa: E402
    PROCESS_FORMS, GraphProgram)
from repro_torch.kernels import ell_spmv as kmod  # noqa: E402
from repro_torch.kernels.ref import ell_spmv_ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The reference sweep's semirings; the callables work on both frameworks.
PROCS = {
    "min_plus": (lambda m, e, d: m + e[..., None], "min"),
    "plus_times": (lambda m, e, d: m * e[..., None], "add"),
    "max_times": (lambda m, e, d: m * e[..., None], "max"),
    "plus_dst": (lambda m, e, d: (e[..., None] - m * d) * m, "add"),
}


def make_ell(rng, n_pad, width, n_src, dtype):
  cols = rng.integers(0, n_src, (n_pad, width)).astype(np.int32)
  vals = rng.uniform(0.1, 2.0, (n_pad, width)).astype(dtype)
  mask = rng.uniform(size=(n_pad, width)) > 0.3
  return cols, vals, mask


def _assert(got, want, kind):
  got = got.cpu().numpy()
  want = np.asarray(want)
  if kind == "add" and want.dtype.kind == "f":
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
  else:
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(8, 8, 8, 1), (64, 16, 100, 1),
                                   (128, 24, 50, 4)])
@pytest.mark.parametrize("sem", sorted(PROCS))
def test_ref_matches_jax_kernel(shape, sem):
  n_pad, width, n_src, k = shape
  rng = np.random.default_rng(sum(shape) + len(sem))
  cols, vals, mask = make_ell(rng, n_pad, width, n_src, np.float32)
  msg = rng.standard_normal((n_src, k)).astype(np.float32)
  act = rng.uniform(size=n_src) > 0.2
  dprop = rng.standard_normal((n_pad, k)).astype(np.float32)
  proc, kind = PROCS[sem]
  yj, rj = ell_spmv_pallas(*map(jnp.asarray, (cols, vals, mask, msg, act,
                                              dprop)),
                           process=proc, reduce_kind=kind)
  yt, rt = ell_spmv_ref(*map(torch.from_numpy, (cols, vals, mask, msg, act,
                                                dprop)),
                        process=proc, reduce_kind=kind)
  np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
  _assert(yt, yj, kind)


FORMS = [  # process_op, reduce, dtype, JAX callable
    ("msg", "add", np.float32, lambda m, e, d: m),
    ("msg_plus_one", "min", np.int32, lambda m, e, d: m + 1),
    ("msg_plus_edge", "min", np.float32, lambda m, e, d: m + e[..., None]),
    ("msg_times_edge", "max", np.float32, lambda m, e, d: m * e[..., None]),
]


@pytest.mark.parametrize("form", FORMS, ids=[f[0] for f in FORMS])
@pytest.mark.parametrize("q", [1, 4])
def test_wrapper_forms_match_jax_kernel(form, q):
  op, kind, dtype, jproc = form
  rng = np.random.default_rng(q)
  cols, vals, mask = make_ell(rng, 32, 16, 40, np.float32)
  vals = vals.astype(dtype)
  msg = (rng.integers(0, 50, (40, q)) if dtype == np.int32
         else rng.standard_normal((40, q))).astype(dtype)
  act = rng.uniform(size=40) > 0.3
  kw = {"block_queries": 2} if q > 1 else {}
  yj, rj = ell_spmv_pallas(
      *map(jnp.asarray, (cols, vals, mask, msg, act)),
      jnp.zeros((32, 1), dtype), process=jproc, reduce_kind=kind, **kw)
  before = kmod.launches.total
  yt, rt = kmod.ell_spmv(*map(torch.from_numpy, (cols, vals, mask, msg, act)),
                         process_op=op, reduce_kind=kind, **kw)
  assert kmod.launches.total == before  # the CPU path launches nothing
  assert yt.dtype == torch.from_numpy(msg).dtype
  np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
  _assert(yt, yj, kind)


PROGRAMS = {
    "bfs": (j_bfs_program, bfs_program, np.int32),
    "sssp": (j_sssp_program, sssp_program, np.float32),
    "pagerank": (j_pagerank_program, pagerank_program, np.float32),
}


@pytest.mark.parametrize("prog", sorted(PROGRAMS))
@pytest.mark.parametrize("q", [0, 4])
def test_cuda_ell_backend_matches_jax_pallas(rmat_small, prog, q):
  """Spill (width 8) and un-permute included; q=0 is a scalar payload."""
  n, src, dst, w = rmat_small
  jmake, tmake, dtype = PROGRAMS[prog]
  jg = JG.build_ell(src, dst, w, n=n, width=8)
  tg = TG.build_ell(src, dst, w, n=n, width=8, device="cpu")
  rng = np.random.default_rng(7)
  shape = (n,) if q == 0 else (n, q)
  msg = (rng.integers(0, 30, shape) if dtype == np.int32
         else rng.uniform(0, 2, shape)).astype(dtype)
  act = rng.uniform(size=n) < 0.5
  jy, jr = jspmv.spmv(jg, jnp.asarray(msg), jnp.asarray(act),
                      jnp.asarray(msg), jmake(),
                      backend=jbe.Plan(backend="pallas"))
  prog_t = tmake()
  impl = tbe.resolve(tbe.AUTO_PLAN, tg, torch.from_numpy(msg),
                     torch.from_numpy(msg), prog_t)
  assert impl.name == "cuda_ell"
  ty, tr = tspmv.spmv(tg, torch.from_numpy(msg), torch.from_numpy(act),
                      torch.from_numpy(msg), prog_t,
                      backend=tbe.Plan(backend="cuda_ell"))
  np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
  _assert(ty, jy, prog_t.reduce_kind)


def test_cuda_ell_rejects_what_the_kernel_does_not_take(rmat_small):
  n, src, dst, w = rmat_small
  g = TG.build_ell(src, dst, w, n=n, device="cpu")
  msg = torch.rand(n)
  act = torch.ones(n, dtype=torch.bool)
  plan = tbe.Plan(backend="cuda_ell")
  # A process_message of its own (no process_op) is traced into the
  # kernel, as the reference's reaches ell_spmv_pallas, the destination-
  # reading m * d too; m * e is the shipped form msg_times_edge.
  no_op = GraphProgram(process_message=lambda m, e, d: m * e,
                       reduce_kind="add", process_reads_dst=False)
  assert tbe.resolve(tbe.AUTO_PLAN, g, msg, msg, no_op).name == "cuda_ell"
  y, _ = tspmv.spmv(g, msg, act, msg, no_op, backend=plan)
  y_ell, _ = tspmv.spmv(g, msg, act, msg, no_op, backend=tbe.Plan("ell"))
  torch.testing.assert_close(y, y_ell, rtol=1e-5, atol=1e-5)
  reads_dst = GraphProgram(process_message=lambda m, e, d: m * d,
                           reduce_kind="add")
  assert tbe.resolve(tbe.AUTO_PLAN, g, msg, msg, reads_dst).name == \
      "cuda_ell"
  # A process that mixes the lanes of a [n, K] message runs on the
  # kernel's lane-vector grid, as the reference's reaches Pallas.
  lanes = torch.rand(n, 4)
  mixing = GraphProgram(
      process_message=lambda m, e, d: m * m.sum(-1, keepdim=True),
      reduce_kind="add", process_reads_dst=False)
  assert tbe.resolve(tbe.AUTO_PLAN, g, lanes, lanes, mixing).name == \
      "cuda_ell"
  y, _ = tspmv.spmv(g, lanes, act, lanes, mixing, backend=plan)
  y_ell, _ = tspmv.spmv(g, lanes, act, lanes, mixing,
                        backend=tbe.Plan("ell"))
  torch.testing.assert_close(y, y_ell, rtol=1e-5, atol=1e-5)
  # What it refuses, by reason: lanes of a message wider than that grid
  # takes, and a destination property of two leaves.
  wide = torch.rand(n, 300)
  with pytest.raises(ValueError, match="K up to 256"):
    tspmv.spmv(g, wide, act, wide, mixing, backend=plan)
  assert tbe.resolve(tbe.AUTO_PLAN, g, wide, wide, mixing).name == "ell"
  two_leaves = {"a": msg, "b": msg}
  with pytest.raises(ValueError, match="single-leaf destination property"):
    tspmv.spmv(g, msg, act, two_leaves, reads_dst, backend=plan)
  assert tbe.resolve(tbe.AUTO_PLAN, g, msg, two_leaves,
                     reads_dst).name == "ell"
  with pytest.raises(ValueError, match="not both"):
    GraphProgram(process_message=lambda m, e, d: m * d, process_op="msg")
  with pytest.raises(ValueError, match="process_message or process_op"):
    GraphProgram(reduce_kind="add")
  with pytest.raises(ValueError, match="block_slots"):
    tspmv.spmv(g, msg, act, msg, pagerank_program(),
               backend=tbe.Plan(backend="cuda_ell", block_slots=8))
  with pytest.raises(ValueError):
    GraphProgram(process_message=lambda m, e, d: m, process_op="msg_squared")
  # An edge form over mixed dtypes (int32 messages on float edges) is no
  # shipped instance: its form is traced into one of its own, whose float32
  # result is torch's promotion, as on the torch ELL path.
  int_edge = GraphProgram(reduce_kind="min", process_op="msg_plus_edge")
  assert int_edge.process_message is PROCESS_FORMS["msg_plus_edge"]
  assert not int_edge.process_reads_dst
  imsg = (msg * 100).int()
  assert tbe.resolve(tbe.AUTO_PLAN, g, imsg, imsg, int_edge).name == \
      "cuda_ell"
  y, _ = tspmv.spmv(g, imsg, act, imsg, int_edge, backend=plan)
  y_ell, _ = tspmv.spmv(g, imsg, act, imsg, int_edge,
                        backend=tbe.Plan("ell"))
  assert y.dtype == torch.float32 and torch.equal(y, y_ell)


def test_wrapper_rejects_bad_launch_arguments():
  cols = torch.zeros((8, 8), dtype=torch.int32)
  mask = torch.ones((8, 8), dtype=torch.bool)
  with pytest.raises(ValueError, match="process_op"):
    kmod.ell_spmv(cols, cols.float(), mask, torch.ones(4, 1),
                  torch.ones(4, dtype=torch.bool), process_op="nope",
                  reduce_kind="min")
  with pytest.raises(ValueError, match="n_src"):
    kmod.ell_spmv(cols, cols.float(), mask, torch.ones(4, 1),
                  torch.ones(5, dtype=torch.bool), process_op="msg",
                  reduce_kind="min")


LAYOUT_MASKS = {
    # name -> (mask rows, expected row_end, expected prefix flag)
    "prefix": ([[1, 1, 1, 0], [1, 0, 0, 0], [0, 0, 0, 0]], [3, 1, 0], True),
    "holes": ([[1, 0, 1, 0], [1, 1, 0, 0]], [3, 2], False),
    "empty_row": ([[0, 0, 0, 0], [1, 1, 1, 1]], [0, 4], True),
    "last_slot_only": ([[0, 0, 0, 1], [1, 1, 0, 0]], [4, 2], False),
}


@pytest.mark.parametrize("name", sorted(LAYOUT_MASKS))
def test_layout_row_end_and_prefix(name):
  rows, row_end, prefix = LAYOUT_MASKS[name]
  ends, mask_prefix = TG.ell_extent(np.array(rows, bool))
  assert ends.dtype == np.int32 and ends.tolist() == row_end
  assert mask_prefix is prefix
  # One segment covers the rows, with the lanes of the longest row.
  segs = kmod.row_segments(torch.from_numpy(ends))
  assert segs.table.tolist() == [
      [0, len(rows), int(kmod.row_lanes(max(row_end))), 0]]


def _check_segments(row_end, n_pad, tiled=False):
  segments = kmod.row_segments(row_end)
  table = segments.tiled_table if tiled else segments.table
  segs = table.tolist()
  assert segs[0][0] == 0 and segs[-1][1] == n_pad
  warp = 0
  for (r0, r1, lanes, w0), nxt in zip(segs, segs[1:] + [None]):
    assert w0 == warp and lanes in (1, 2, 4, 8, 16, 32)
    assert not tiled or lanes >= kmod.TILED_MIN_LANES
    assert nxt is None or nxt[0] == r1
    # Every row of the segment fits its lanes at 4 slots a lane.
    assert int(row_end[r0:r1].max()) <= kmod.SLOTS_PER_LANE * lanes
    warp += -(-(r1 - r0) * lanes // 32)
  assert (segments.tiled_num_warps if tiled else segments.num_warps) == warp
  return segs


def test_layout_of_builder_and_random_graphs(rmat_small):
  n, src, dst, w = rmat_small
  g = TG.build_ell(src, dst, w, n=n, device="cpu")
  mask = g.mask.numpy()
  assert g.mask_prefix  # build_ell fills each row from slot 0
  assert g.row_end.dtype == torch.int32
  assert g.row_end.tolist() == mask.sum(axis=1).tolist()
  # Degree-sorted rows: the lanes never rise along the rows.
  lanes = [s[2] for s in _check_segments(g.row_end, g.n_pad)]
  assert lanes == sorted(lanes, reverse=True)
  # The same graph carried across from the JAX builder's arrays.
  jg = JG.build_ell(src, dst, w, n=n)
  tg = TG.from_arrays("ell", n, {f: np.asarray(getattr(jg, f)) for f in (
      "cols", "vals", "mask", "row_of", "packed_of")}, device="cpu")
  assert torch.equal(tg.row_end, g.row_end) and tg.mask_prefix
  # A random mask (rows unsorted, holes): segments still cover every row.
  rmask = np.random.default_rng(3).uniform(size=(300, 40)) > 0.6
  rmask[7] = False
  rmask[9, :] = False
  rmask[9, -1] = True
  ends, prefix = TG.ell_extent(torch.from_numpy(rmask))
  assert not prefix and ends[7] == 0 and ends[9] == 40
  _check_segments(torch.from_numpy(ends), 300)


def test_backend_keeps_segments_per_graph(rmat_small):
  """The cuda_ell backend makes a graph's row segments once and lets them
  go with the graph."""
  n, src, dst, w = rmat_small
  g = TG.build_ell(src, dst, w, n=n, device="cpu")
  backend = tbe.get_backend("cuda_ell")
  first = backend.segments(g)
  assert backend.segments(g) is first
  assert torch.equal(first.table, kmod.row_segments(g.row_end).table)
  key = id(g)
  del g
  gc.collect()
  assert key not in backend._segments


def _old_row_lanes(length: int) -> int:
  """The lanes of a row before the one-lane class: at least 2."""
  need = -(-length // kmod.SLOTS_PER_LANE)
  return next(g for g in (2, 4, 8, 16, 32) if need <= g or g == 32)


@pytest.mark.parametrize("extent", [0, 1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 33,
                                    64, 65, 128, 129, 152, 300])
def test_row_lanes_one_lane_up_to_four_slots(extent):
  lanes = int(kmod.row_lanes(extent))
  if extent <= kmod.SLOTS_PER_LANE:
    assert lanes == 1
  else:
    assert lanes == _old_row_lanes(extent)
  assert kmod.row_lanes(np.array([extent, extent])).tolist() == [lanes] * 2


def _grid_edges(side: int):
  """The examples' road grid (``grid_road_graph``, seed 0)."""
  spec = importlib.util.spec_from_file_location(
      "_example_graph_analytics_suite_torch",
      ROOT / "examples" / "graph_analytics_suite_torch.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.grid_road_graph(side, seed=0)


def _boundary_edges():
  """In-degrees 6 for vertices 0-39 and 3 for 40-95: packed rows 32-63 form
  one SEGMENT_CHUNK whose rows need 2 lanes (rows 32-39) and 1 lane (rows
  40-63), so the chunk takes 2; rows 64-95 take 1."""
  rng = np.random.default_rng(5)
  n, src, dst = 96, [], []
  for v in range(n):
    k = 6 if v < 40 else 3
    srcs = rng.choice(np.setdiff1d(np.arange(n), [v]), k, replace=False)
    src += srcs.tolist()
    dst += [v] * k
  w = rng.uniform(0.1, 2.0, len(src)).astype(np.float32)
  return n, np.array(src, np.int32), np.array(dst, np.int32), w


SHORT_GRAPHS = {
    "road32": lambda rmat: _grid_edges(32),
    "rmat_small": lambda rmat: rmat,
    "lane_boundary": lambda rmat: _boundary_edges(),
}


@pytest.mark.parametrize("name", sorted(SHORT_GRAPHS))
@pytest.mark.parametrize("tiled", [False, True], ids=["q1", "qtiled"])
def test_row_segments_cover_each_row_once(rmat_small, name, tiled):
  """Each packed row is served by exactly one lane group of one warp, as
  the kernel maps warps to rows, and the warp count is the table's; the
  query-tiled grid's table keeps two lanes where the other has one."""
  n, src, dst, w = SHORT_GRAPHS[name](rmat_small)
  g = TG.build_ell(src, dst, w, n=n, device="cpu")
  segments = kmod.row_segments(g.row_end)
  segs = _check_segments(g.row_end, g.n_pad, tiled)
  served = np.zeros(g.n_pad, np.int64)
  for r0, r1, lanes, w0 in segs:
    for warp in range(w0, w0 + -(-(r1 - r0) * lanes // 32)):
      lane = np.arange(32)
      rows = r0 + (warp - w0) * (32 // lanes) + lane // lanes
      first = lane % lanes == 0
      np.add.at(served, rows[first & (rows < r1)], 1)
  assert served.tolist() == [1] * g.n_pad
  ends = g.row_end.numpy()
  lanes_of = {r: s[2] for s in segs for r in range(s[0], s[1])}
  one = 2 if tiled else 1  # the lanes of a row of at most 4 slots
  assert segments.filled_rows == g.n_pad - int((ends == 0).sum())
  if name == "road32":
    # Rows of 2-4 slots: one segment of one lane a row, 32 rows a warp.
    assert ends.max() == 4 and segs == [[0, g.n_pad, one, 0]]
    assert segments.short_rows
    assert warp_count(segments, tiled) == g.n_pad * one // 32
  if name == "lane_boundary":
    assert ends[:40].tolist() == [6] * 40 and ends[40:].tolist() == [3] * 56
    assert [lanes_of[r] for r in (0, 39, 40, 63, 64, 95)] == [
        2, 2, 2, 2, one, one]
    assert segs == ([[0, 96, 2, 0]] if tiled
                    else [[0, 64, 2, 0], [64, 96, 1, 4]])
    assert not segments.short_rows
  if name == "rmat_small":
    # The degree-sorted tail of short rows gets the one-lane class.
    assert lanes_of[g.n_pad - 1] == one and segs[0][2] > 2
    assert not segments.short_rows


def warp_count(segments, tiled: bool) -> int:
  return segments.tiled_num_warps if tiled else segments.num_warps


@pytest.mark.parametrize("name", sorted(SHORT_GRAPHS))
@pytest.mark.parametrize("form", FORMS, ids=[f[0] for f in FORMS])
@pytest.mark.parametrize("q", [1, 4])
def test_short_rows_wrapper_matches_jax_kernel(rmat_small, name, form, q):
  """The wrapper's plain path on the short-row graphs' ELL arrays, given
  their extents and the backend's table, against the JAX kernel."""
  op, kind, dtype, jproc = form
  n, src, dst, w = SHORT_GRAPHS[name](rmat_small)
  g = TG.build_ell(src, dst, w, n=n, device="cpu")
  rng = np.random.default_rng(q + len(name))
  cols, mask = g.cols.numpy(), g.mask.numpy()
  vals = g.vals.numpy().astype(dtype)
  msg = (rng.integers(0, 50, (n, q)) if dtype == np.int32
         else rng.standard_normal((n, q))).astype(dtype)
  act = rng.uniform(size=n) > 0.3
  kw = {"block_queries": 2} if q > 1 else {}
  yj, rj = ell_spmv_pallas(
      *map(jnp.asarray, (cols, vals, mask, msg, act)),
      jnp.zeros((g.n_pad, 1), dtype), process=jproc, reduce_kind=kind, **kw)
  before = kmod.launches.total
  yt, rt = kmod.ell_spmv(
      *map(torch.from_numpy, (cols, vals, mask, msg, act)), process_op=op,
      reduce_kind=kind, row_end=g.row_end, mask_prefix=g.mask_prefix,
      segments=tbe.get_backend("cuda_ell").segments(g), **kw)
  assert kmod.launches.total == before
  np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
  _assert(yt, yj, kind)


@pytest.mark.parametrize("name", sorted(SHORT_GRAPHS))
@pytest.mark.parametrize("prog", sorted(PROGRAMS))
def test_short_rows_cuda_ell_backend_matches_jax_pallas(rmat_small, name,
                                                         prog):
  """BFS, SSSP and PageRank supersteps through the backends, spill and
  un-permute included, on the short-row graphs."""
  n, src, dst, w = SHORT_GRAPHS[name](rmat_small)
  jmake, tmake, dtype = PROGRAMS[prog]
  jg = JG.build_ell(src, dst, w, n=n)
  tg = TG.build_ell(src, dst, w, n=n, device="cpu")
  rng = np.random.default_rng(len(name) + len(prog))
  msg = (rng.integers(0, 30, n) if dtype == np.int32
         else rng.uniform(0, 2, n)).astype(dtype)
  act = rng.uniform(size=n) < 0.5
  jy, jr = jspmv.spmv(jg, jnp.asarray(msg), jnp.asarray(act),
                      jnp.asarray(msg), jmake(),
                      backend=jbe.Plan(backend="pallas"))
  prog_t = tmake()
  ty, tr = tspmv.spmv(tg, torch.from_numpy(msg), torch.from_numpy(act),
                      torch.from_numpy(msg), prog_t,
                      backend=tbe.Plan(backend="cuda_ell"))
  np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
  _assert(ty, jy, prog_t.reduce_kind)


PLUS_DST, _ = PROCS["plus_dst"]


@pytest.mark.parametrize("shape", [(8, 8, 8, 1), (64, 16, 100, 1),
                                   (128, 24, 50, 4), (256, 8, 256, 8)])
@pytest.mark.parametrize("kd", ["one", "k"])
def test_wrapper_dst_form_matches_jax_plus_dst(shape, kd):
  n_pad, width, n_src, k = shape
  kd = 1 if kd == "one" else k
  rng = np.random.default_rng(n_pad + width + kd)
  cols, vals, mask = make_ell(rng, n_pad, width, n_src, np.float32)
  msg = rng.standard_normal((n_src, k)).astype(np.float32)
  act = rng.uniform(size=n_src) > 0.2
  dprop = rng.standard_normal((n_pad, kd)).astype(np.float32)
  yj, rj = ell_spmv_pallas(*map(jnp.asarray, (cols, vals, mask, msg, act,
                                              dprop)),
                           process=PLUS_DST, reduce_kind="add")
  before = kmod.launches.total
  yt, rt = kmod.ell_spmv(*map(torch.from_numpy, (cols, vals, mask, msg, act)),
                         process_op="edge_minus_msg_dst_times_msg",
                         reduce_kind="add", dprop=torch.from_numpy(dprop))
  assert kmod.launches.total == before
  np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
  _assert(yt, yj, "add")


def _cf_like_programs(lanewise: bool):
  """One GD-style sweep program on a single-leaf property: each edge sends
  ``(w - p_u * p_v) * p_u`` (the reference's ``plus_dst``)."""
  gamma, lam = 0.05, 0.1
  apply = lambda red, old: old + gamma * (red - lam * old)  # noqa: E731
  jprog = JGraphProgram(process_message=lambda m, e, d: (e - m * d) * m,
                        reduce_kind="add", apply=apply,
                        process_reads_dst=True, lanewise=lanewise,
                        name="cf_like")
  tprog = GraphProgram(process_op="edge_minus_msg_dst_times_msg",
                       reduce_kind="add", apply=apply, lanewise=lanewise,
                       name="cf_like")
  return jprog, tprog


@pytest.mark.parametrize("q", [0, 4])
def test_dst_program_run_fixed_iters_matches_jax(rmat_small, q):
  """Spill (width 8), un-permute and the destination property included;
  q=0 is a scalar property, q=4 four lanes each reading their own d."""
  n, src, dst, w = rmat_small
  jg = JG.build_ell(src, dst, w, n=n, width=8)
  tg = TG.build_ell(src, dst, w, n=n, width=8, device="cpu")
  rng = np.random.default_rng(11)
  p0 = rng.uniform(0.0, 0.5, (n,) if q == 0 else (n, q)).astype(np.float32)
  act = np.ones(n, bool)
  jprog, tprog = _cf_like_programs(lanewise=q > 0)
  assert tprog.process_reads_dst
  assert tbe.resolve(tbe.AUTO_PLAN, tg, torch.from_numpy(p0),
                     torch.from_numpy(p0), tprog).name == "cuda_ell"
  js = j_run_fixed_iters(jg, jprog, jnp.asarray(p0), jnp.asarray(act), 3,
                         backend=jbe.Plan(backend="pallas"))
  ts = run_fixed_iters(tg, tprog, torch.from_numpy(p0), torch.from_numpy(act),
                       3, backend=tbe.Plan(backend="cuda_ell"))
  np.testing.assert_allclose(ts.prop.numpy(), np.asarray(js.prop),
                             rtol=1e-5, atol=1e-5)


DPROP_REFUSALS = {
    # name -> (dprop for msg float32[40, 4] on a [32, 16] block, message)
    "missing": (None, "needs dprop"),
    "kd_not_1_or_q": (torch.zeros(32, 3), "needs dprop"),
    "rows_not_n_pad": (torch.zeros(40, 1), "needs dprop"),
    "one_dimensional": (torch.zeros(32), "needs dprop"),
    "dtype": (torch.zeros(32, 4, dtype=torch.float64), "dtype"),
}


@pytest.mark.parametrize("name", sorted(DPROP_REFUSALS))
def test_wrapper_rejects_bad_dprop(name):
  dprop, match = DPROP_REFUSALS[name]
  cols = torch.zeros((32, 16), dtype=torch.int32)
  mask = torch.ones((32, 16), dtype=torch.bool)
  msg, act = torch.ones(40, 4), torch.ones(40, dtype=torch.bool)
  with pytest.raises(ValueError, match=match):
    kmod.ell_spmv(cols, cols.float(), mask, msg, act,
                  process_op="edge_minus_msg_dst_times_msg",
                  reduce_kind="add", dprop=dprop)


def test_dprop_only_for_forms_that_read_it(rmat_small):
  cols = torch.zeros((32, 16), dtype=torch.int32)
  mask = torch.ones((32, 16), dtype=torch.bool)
  with pytest.raises(ValueError, match="reads no dprop"):
    kmod.ell_spmv(cols, cols.float(), mask, torch.ones(40, 1),
                  torch.ones(40, dtype=torch.bool), process_op="msg",
                  reduce_kind="add", dprop=torch.zeros(32, 1))
  # The backend takes a destination property shaped as the message only.
  n, src, dst, w = rmat_small
  g = TG.build_ell(src, dst, w, n=n, device="cpu")
  _, tprog = _cf_like_programs(lanewise=True)
  msg = torch.rand(n, 4)
  assert tbe.resolve(tbe.AUTO_PLAN, g, msg, msg[:, :1], tprog).name == (
      "cuda_ell")
  for bad in (msg[:, 0], msg[:, :3], msg.double(), {"p": msg, "q": msg}):
    assert tbe.resolve(tbe.AUTO_PLAN, g, msg, bad, tprog).name == "ell"
  with pytest.raises(ValueError, match="destination property"):
    tspmv.spmv(g, msg, torch.ones(n, dtype=torch.bool), msg[:, 0], tprog,
               backend=tbe.Plan(backend="cuda_ell"))


def test_kernel_matches_plain_on_card(rmat_small):
  """The CUDA kernel itself; runs only where a card is present."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
  gen = torch.Generator(device="cuda").manual_seed(0)
  # The short-row graphs with their own extents and table: the one-lane
  # class (the road grid's plain launch, rmat_small's tail, the lane
  # boundary inside a chunk), every form, Q = 1 and 8, every source active
  # and 10% active.
  for name in sorted(SHORT_GRAPHS):
    n, src, dst, w = SHORT_GRAPHS[name](rmat_small)
    g = TG.build_ell(src, dst, w, n=n, device="cuda")
    ext = {"row_end": g.row_end, "mask_prefix": g.mask_prefix,
           "segments": kmod.row_segments(g.row_end)}
    for q, (op, kind, dtype, _) in [(q, f) for q in (1, 8) for f in FORMS]:
      tdt = torch.int32 if dtype == np.int32 else torch.float32
      vals = g.vals.to(tdt)
      msg = (torch.rand((n, q), generator=gen, device="cuda") * 50).to(tdt)
      for p_act in (2.0, 0.1):
        act = torch.rand((n,), generator=gen, device="cuda") < p_act
        y, r = kmod.ell_spmv(g.cols, vals, g.mask, msg, act, process_op=op,
                             reduce_kind=kind, **ext)
        yr, rr = ell_spmv_ref(
            g.cols, vals, g.mask, msg, act,
            torch.zeros((g.n_pad, 1), dtype=tdt, device="cuda"),
            process=kmod.plain_process(op), reduce_kind=kind)
        assert torch.equal(r, rr), (name, op, q, p_act)
        if kind == "add" and tdt.is_floating_point:
          torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
        else:
          assert torch.equal(y, yr), (name, op, q, p_act)
  for q, (op, kind, dtype, _) in [(q, f) for q in (1, 8) for f in FORMS]:
    tdt = torch.int32 if dtype == np.int32 else torch.float32
    cols = torch.randint(0, 300, (256, 40), generator=gen, device="cuda",
                         dtype=torch.int32)
    vals = (torch.rand((256, 40), generator=gen, device="cuda") + 0.5
            ).to(tdt)
    mask = torch.rand((256, 40), generator=gen, device="cuda") < 0.7
    msg = (torch.rand((300, q), generator=gen, device="cuda") * 50).to(tdt)
    act = torch.rand((300,), generator=gen, device="cuda") < 0.8
    y, r = kmod.ell_spmv(cols, vals, mask, msg, act, process_op=op,
                         reduce_kind=kind)
    yr, rr = ell_spmv_ref(cols, vals, mask, msg, act,
                          torch.zeros((256, 1), dtype=tdt, device="cuda"),
                          process=kmod.plain_process(op), reduce_kind=kind)
    assert torch.equal(r, rr)
    if kind == "add" and tdt.is_floating_point:
      torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
    else:
      assert torch.equal(y, yr)
    if tdt.is_floating_point and kind != "add":
      # A NaN message makes the row's min or max NaN, as torch.amin does.
      msg[::7] = float("nan")
      y, r = kmod.ell_spmv(cols, vals, mask, msg, act, process_op=op,
                           reduce_kind=kind)
      yr, rr = ell_spmv_ref(cols, vals, mask, msg, act,
                            torch.zeros((256, 1), dtype=tdt, device="cuda"),
                            process=kmod.plain_process(op), reduce_kind=kind)
      assert torch.isnan(yr).any()
      torch.testing.assert_close(y, yr, rtol=0, atol=0, equal_nan=True)
  # The destination-reading form, Kd = 1 and Q, on degree-sorted prefix rows
  # (several lane segments, no mask read).
  lens = torch.randint(0, 41, (256,), generator=gen, device="cuda")
  mask = torch.arange(40, device="cuda") < lens.sort(descending=True).values[:, None]
  row_end = torch.from_numpy(TG.ell_extent(mask)[0]).cuda()
  segments = kmod.row_segments(row_end)
  assert segments.table.shape[0] > 1
  for q in (1, 8):
    msg = torch.randn((300, q), generator=gen, device="cuda")
    for kd in sorted({1, q}):
      dprop = torch.randn((256, kd), generator=gen, device="cuda")
      y, r = kmod.ell_spmv(cols, vals.float(), mask, msg, act,
                           process_op="edge_minus_msg_dst_times_msg",
                           reduce_kind="add", dprop=dprop, row_end=row_end,
                           mask_prefix=True, segments=segments)
      yr, rr = ell_spmv_ref(cols, vals.float(), mask, msg, act, dprop,
                            process=PLUS_DST, reduce_kind="add")
      assert torch.equal(r, rr)
      torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
