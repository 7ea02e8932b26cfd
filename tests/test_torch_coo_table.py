"""The COO kernel's per-graph table and its routing, on the CPU.

``kernels/coo_spmv.py`` keeps one :class:`CooTable` per COO graph (whether
``dst`` is sorted, the int32 sources with the mask folded in, the heads
bitmap, the runs that cross tiles) and decides which COO calls the kernel
takes; the kernel itself runs only on the card
(``tests/test_torch_coo_card.py``).  Here the table is held to a numpy
reading of the same graph, and :func:`decide` to the reasons it gives, on
CPU tensors; :func:`route` sends no CPU call to the kernel and counts none.
"""

import gc

import numpy as np
import pytest
import torch

from repro_torch.core import graph as G
from repro_torch.core import spmv as S
from repro_torch.core.vertex_program import GraphProgram
from repro_torch.kernels import coo_spmv as K
from repro_torch.kernels import ell_spmv as E
from repro_torch.kernels import process_expr as pe

N = 300


def graph(runs, n=N, pad=0, masked=0.0, seed=0, tile_edges=K.TILE_EDGES):
  """A dst-sorted graph of ``runs`` [(dst, edges)], built by build_coo."""
  rng = np.random.default_rng(seed)
  dst = (np.concatenate([np.full(k, v) for v, k in runs]) if runs
         else np.zeros(0, np.int64))
  src = rng.integers(0, n, dst.shape[0])
  g = G.build_coo(src, dst, None, n=n, capacity=max(dst.shape[0] + pad, 1),
                  device="cpu")
  if masked:
    keep = torch.from_numpy(rng.uniform(size=g.capacity) >= masked)
    g = G.CooGraph(g.n, g.src, g.dst, g.w, g.emask & keep, g.out_deg,
                   g.in_deg)
  return g


def numpy_table(g, tile_edges):
  """heads (bool per edge) and the split runs (t0, t1, slot, dst), from
  the graph's dst read on the host."""
  dst = g.dst.numpy()
  cap = dst.shape[0]
  head = np.ones(cap, bool)
  head[1:] = dst[1:] != dst[:-1]
  starts = np.flatnonzero(head)
  ends = np.append(starts[1:], cap)
  splits = []
  for s, e in zip(starts, ends):
    t0, t1 = s // tile_edges, (e - 1) // tile_edges
    if t1 > t0:
      splits.append((t0, t1, int(s != t0 * tile_edges), dst[s]))
  return head, np.asarray(splits, np.int64).reshape(-1, 4)


def unpack(heads, cap):
  words = heads.numpy().view(np.uint32)
  bits = (words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
  return bits.reshape(-1)[:cap].astype(bool)


LAYOUTS = {
    "hub_3_tiles": ([(3, 3000), (5, 1), (9, 40)], 0, 0.0, 1024),
    "padded_masked": ([(2, 2100), (7, 900), (8, 1)] +
                      [(v, v % 5) for v in range(10, 290)], 500, 0.2, 1024),
    "tiles_of_32": ([(v, (v * 7) % 45) for v in range(N - 1)], 64, 0.0, 32),
    "run_at_tile_start": ([(1, 64), (2, 64), (4, 10)], 0, 0.0, 32),
    "one_edge": ([(0, 1)], 0, 0.0, 1024),
    "empty": ([], 0, 0.0, 1024),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_table_matches_numpy(layout):
  """Tile count, heads bitmap, split runs (first and last tile, the first
  tile's carry slot, dst), the int32 sources with -1 where emask is off."""
  runs, pad, masked, tile_edges = LAYOUTS[layout]
  g = graph(runs, pad=pad, masked=masked)
  t = K.build_table(g, tile_edges=tile_edges)
  cap = g.capacity
  assert t.sorted and t.tile_edges == tile_edges
  assert t.num_tiles == -(-cap // tile_edges)
  head, splits = numpy_table(g, tile_edges)
  assert t.heads.dtype == torch.int32 and t.heads.numel() == -(-cap // 32)
  np.testing.assert_array_equal(unpack(t.heads, cap), head)
  np.testing.assert_array_equal(t.splits.numpy(), splits)
  assert t.num_splits == splits.shape[0]
  want_src = np.where(g.emask.numpy(), g.src.numpy(), -1)
  assert t.src.dtype == torch.int32
  np.testing.assert_array_equal(t.src.numpy(), want_src)
  assert t.dst.dtype == torch.int64 and torch.equal(t.dst, g.dst)


def test_split_slots_follow_the_tile_start():
  """A run that begins a tile carries in slot 0 of it, one that begins
  inside a tile in slot 1; a run that ends exactly at a tile's end and
  begins at its start is no split."""
  g = graph([(1, 32), (2, 48), (3, 16), (4, 64), (5, 1)])
  t = K.build_table(g, tile_edges=32)
  # Runs: [0, 32) whole tile 0; [32, 80) tiles 1-2 from tile 1's start;
  # [80, 96) in tile 2; [96, 160) tiles 3-4 from tile 3's start; 160 alone.
  assert t.splits.tolist() == [[1, 2, 0, 2], [3, 4, 0, 4]]
  g = graph([(1, 40), (2, 40)])
  t = K.build_table(g, tile_edges=32)
  assert t.splits.tolist() == [[0, 1, 0, 1], [1, 2, 1, 2]]


def test_unsorted_graph_is_found():
  rng = np.random.default_rng(2)
  src, dst = rng.integers(0, N, 500), rng.integers(0, N, 500)
  g = G.build_coo(src, dst, None, n=N, sort=False, device="cpu")
  t = K.build_table(g)
  assert not t.sorted and t.src is None and t.num_splits == 0
  assert K.build_table(G.build_coo(src, dst, None, n=N,
                                   device="cpu")).sorted


def test_table_is_kept_while_the_graph_lives():
  g = graph([(3, 10)])
  key = id(g)
  t = K.table(g)
  assert K.table(g) is t and key in K._tables
  del g
  gc.collect()
  assert key not in K._tables


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def sssp():
  return GraphProgram(process_op="msg_plus_edge", reduce_kind="min")


def cf_program():
  return GraphProgram(
      process_message=lambda m, e, d: (e - (m * d).sum(-1, keepdim=True)) * m,
      reduce_kind="add", process_reads_dst=True)


def taken_cases():
  """name -> (program, msg, dprop): calls the kernel takes."""
  f = torch.rand(N)
  return {
      "sssp_q1": (sssp(), f, f),
      "sssp_q8": (sssp(), torch.rand(N, 8), torch.rand(N, 8)),
      "pagerank_add": (GraphProgram(process_op="msg", reduce_kind="add"), f,
                       f),
      "bfs_int32": (GraphProgram(process_op="msg_plus_one",
                                 reduce_kind="min"),
                    torch.zeros(N, dtype=torch.int32), f),
      "cf_k16": (cf_program(), torch.rand(N, 16), torch.rand(N, 16)),
      "traced_lanewise": (GraphProgram(process_message=lambda m, e, d: e + m,
                                       reduce_kind="max",
                                       process_reads_dst=False), f, f),
      "dst_form_q8_kd1": (GraphProgram(process_op="edge_minus_msg_dst_times_msg",
                                       reduce_kind="add"),
                          torch.rand(N, 8), torch.rand(N, 1)),
  }


@pytest.mark.parametrize("name", sorted(taken_cases()))
def test_decide_takes(name):
  prog, msg, dp = taken_cases()[name]
  g = graph([(3, 50), (8, 2)])
  call = K.decide(g, msg, torch.ones(N, dtype=torch.bool), dp, prog)
  assert isinstance(call, K.Call), call
  assert call.msg is msg and call.table is K.table(g)
  assert call.reduce_kind == prog.reduce_kind


def refused_cases():
  """name -> (reason, program, msg, active, dprop, graph kwargs)."""
  f = torch.rand(N)
  ones = torch.ones(N, dtype=torch.bool)
  generic = GraphProgram(process_message=lambda m, e, d: m,
                         reduce_kind="generic",
                         reduce=lambda a, b: a | b, reduce_identity=0,
                         process_reads_dst=False)
  return {
      "generic": ("reduce", generic, f.int(), ones, f),
      "any": ("reduce", GraphProgram(process_message=lambda m, e, d: m > 1,
                                     reduce_kind="any",
                                     process_reads_dst=False), f, ones, f),
      "identity": ("reduce", GraphProgram(process_op="msg", reduce_kind="min",
                                          reduce_identity=1e9), f, ones, f),
      "custom_combine": ("reduce", GraphProgram(process_op="msg",
                                                reduce_kind="min",
                                                reduce=torch.minimum),
                         f, ones, f),
      "two_leaves": ("message", sssp(), {"a": f, "b": f}, ones, f),
      "rank_3": ("message", sssp(), torch.rand(N, 2, 2), ones, f),
      "lane_active": ("active", sssp(), torch.rand(N, 4),
                      torch.ones(N, 4, dtype=torch.bool), f),
      "two_props": ("dst_prop", cf_program(), torch.rand(N, 16), ones,
                    (torch.rand(N, 16), torch.rand(N, 16))),
      "float64": ("process", sssp(), f.double(), ones, f),
      "control_flow": ("process", GraphProgram(
          process_message=lambda m, e, d: m if bool((m > 0).all()) else e,
          reduce_kind="min", process_reads_dst=False), f, ones, f),
      "prop_width": ("process", cf_program(), torch.rand(N, 16), ones,
                     torch.rand(N, 5)),
  }


@pytest.mark.parametrize("name", sorted(refused_cases()))
def test_decide_gives_the_reason(name):
  reason, prog, msg, active, dp = refused_cases()[name]
  assert reason in K.REASONS
  g = graph([(3, 50), (8, 2)])
  assert K.decide(g, msg, active, dp, prog) == reason


def test_decide_finds_an_unsorted_graph():
  rng = np.random.default_rng(5)
  g = G.build_coo(rng.integers(0, N, 400), rng.integers(0, N, 400), None,
                  n=N, sort=False, device="cpu")
  f = torch.rand(N)
  assert K.decide(g, f, torch.ones(N, dtype=torch.bool), f,
                  sssp()) == "unsorted"


def test_decide_takes_the_callers_process(monkeypatch):
  """A process the caller resolved is not resolved again, and is held to
  the graph's edge dtype."""
  def no_trace(*args, **kwargs):
    raise AssertionError("for_program called")
  monkeypatch.setattr(pe, "for_program", no_trace)
  g = graph([(3, 50)])
  f = torch.rand(N)
  ones = torch.ones(N, dtype=torch.bool)
  call = K.decide(g, f, ones, f, sssp(), process="msg_plus_edge")
  assert isinstance(call, K.Call) and call.process == "msg_plus_edge"
  half = G.CooGraph(g.n, g.src, g.dst, g.w.half(), g.emask, g.out_deg,
                    g.in_deg)
  assert K.decide(half, f, ones, f, sssp(),
                  process="msg_plus_edge") == "process"


def test_route_leaves_cpu_calls_alone():
  """On CPU tensors nothing is routed, counted or built."""
  g = graph([(3, 50)])
  f = torch.rand(N)
  before, launched = dict(K.torch_path), K.launches.total
  assert K.route(g, f, torch.ones(N, dtype=torch.bool), f, sssp()) is None
  assert K.torch_path == before and K.launches.total == launched
  assert id(g) not in K._tables


def test_cpu_spmv_coo_is_the_plain_version():
  """spmv_coo and merge_spill on CPU tensors are the PyTorch path, and no
  counter moves."""
  g = graph([(3, 2000), (5, 3)], pad=10)
  msg = torch.rand(N)
  active = torch.rand(N) < 0.5
  before, ell = dict(K.torch_path), E.launches.total
  got = S.spmv_coo(g, msg, active, msg, sssp())
  want = S._spmv_coo_torch(g, msg, active, msg, sssp())
  assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
  assert K.torch_path == before and E.launches.total == ell


def test_generated_source_runs_the_coo_body():
  """A traced process's COO instance includes the COO body and checks the
  dtypes and widths it was traced at, as the ELL instance does."""
  msg = torch.rand(N, 16)
  proc = pe.for_program(cf_program(), msg, torch.rand(4), msg)
  src = K.generated_source(proc, "add")
  assert '#include "coo_spmv_body.cuh"' in src
  assert "run_coo<Operands<float, float, float, float, float>, 0, " \
         "TracedProcess, true>" in src
  assert "k_out != 16" in src and "graphmat_coo_spmv(" in src
  lib = K.library_for(proc, "add")
  assert lib is K.library_for(proc, "add")
  assert lib.source.name == f"coo_spmv_{proc.digest}_add"
