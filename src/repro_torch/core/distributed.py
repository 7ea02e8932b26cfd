"""The 2-D distributed runner over ``torch.distributed`` (port of
:mod:`repro.core.distributed`).

The reference cuts the adjacency into an ``R × C`` grid of edge blocks (the
CombBLAS-style layout, with GraphMat's semiring-aware reduce) and runs one
``shard_map`` program over a device mesh whose axes ("pod", "data") carry
row blocks and "model" carries column blocks.  Here each block belongs to
one process, a rank of ``torch.distributed``: rank r holds block
``(i, j) = divmod(r, C)``, and the two mesh directions become two families
of process groups (:class:`Grid`):

* the **reduce group** of rank (i, j) is the ranks (i, ·), the reference's
  ``col_axis`` ("model"): the partial outputs of row block i are combined
  over it with the program's monoid (:func:`_semiring_axis_reduce`);
* the **gather group** is the ranks (·, j), which hold the other row
  blocks.  The superstep-boundary reshard, which XLA inserts in the
  reference for ``with_sharding_constraint``, is written out here: an
  ``all_gather`` of the row blocks over the gather group, then a slice of
  column block j.

The reference's ``row_axes=("pod", "data")`` collapses into R = pods ×
data.  Vertex properties live row-sharded: rank (i, j) holds row block i,
replicated over its reduce group, so a global count is a sum over the
gather group, which counts each row block once.

The runners take and return the global padded vertex arrays, as the
reference's do; inside, each rank works on its row block.  They are host
loops that read the global count once a superstep, as
:func:`repro_torch.core.engine.run_graph_program` does.  Collectives never
see a bool tensor: bools travel as int8, which gloo and NCCL both reduce
and gather.

:func:`launch` starts the ranks (``spawn`` processes, one per block) for
the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import socket
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _tree
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import graph as graphlib
from repro_torch.core import spmv as spmv_lib
from repro_torch.core.backends.plan import AUTO_PLAN, PlanLike, as_plan
from repro_torch.core.engine import (BatchedEngineState, EngineState,
                                     init_batched_state)
from repro_torch.core.vertex_program import GraphProgram

PyTree = Any

_FIELDS = ("src", "dst", "w", "emask")


@dataclasses.dataclass(frozen=True)
class DistGraph:
  """``R × C`` block-partitioned edge list with static per-block capacity,
  on the host.

  Block ``(i, j)`` holds the edges whose destination falls in row range i
  and source in column range j, with *local* indices.  All blocks are
  padded to the same capacity; ``emask`` marks the real edges.
  """

  n: int            # true vertex count
  n_pad: int        # padded vertex count (divisible by R and C)
  R: int            # row blocks
  C: int            # column blocks
  src: np.ndarray   # int32[R, C, Eb] local column index (0..n_pad/C)
  dst: np.ndarray   # int32[R, C, Eb] local row index, sorted in a block
  w: np.ndarray     # [R, C, Eb]
  emask: np.ndarray  # bool[R, C, Eb]

  @property
  def rows_per_block(self) -> int:
    return self.n_pad // self.R

  @property
  def cols_per_block(self) -> int:
    return self.n_pad // self.C

  def block(self, i: int, j: int, device: DeviceLike = "cuda"
            ) -> graphlib.CooGraph:
    """Block (i, j) as a :class:`CooGraph` of ``n = rows_per_block`` on
    ``device``: the ``[Eb]`` slices that ``shard_map`` hands each device in
    the reference.  Its sources index the ``cols_per_block``-long column
    block of the message."""
    dev = resolve_device(device)
    nr = self.rows_per_block
    idx = lambda a: torch.from_numpy(np.array(a[i, j])).to(dev)
    zeros = torch.zeros((nr,), dtype=torch.int32, device=dev)
    return graphlib.CooGraph(
        n=nr, src=idx(self.src).long(), dst=idx(self.dst).long(),
        w=idx(self.w), emask=idx(self.emask), out_deg=zeros,
        in_deg=zeros.clone())

  def save(self, path) -> None:
    """Write the blocks to directory ``path`` (one ``.npy`` per field), so
    that each rank maps only its own block (:meth:`load`)."""
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    for f in _FIELDS:
      np.save(p / f"{f}.npy", getattr(self, f))
    (p / "meta.json").write_text(json.dumps(
        {"n": self.n, "n_pad": self.n_pad, "R": self.R, "C": self.C}))

  @classmethod
  def load(cls, path) -> "DistGraph":
    """The graph :meth:`save` wrote, its arrays memory-mapped."""
    p = pathlib.Path(path)
    meta = json.loads((p / "meta.json").read_text())
    return cls(**meta, **{f: np.load(p / f"{f}.npy", mmap_mode="r")
                          for f in _FIELDS})


def partition_2d(src, dst, w=None, *, n: int, R: int, C: int,
                 edge_dtype=np.float32) -> DistGraph:
  """Host-side 2-D partitioner (numpy; the reference's arrays, element for
  element)."""
  dt = np.dtype(edge_dtype)
  src, dst, w = graphlib._as_np_edges(src, dst, w, n, dt)
  n_pad = int(np.ceil(n / (R * C))) * (R * C)  # divisible by both R and C
  nr, nc = n_pad // R, n_pad // C
  bi = dst // nr          # row block
  bj = src // nc          # col block
  ldst = dst % nr
  lsrc = src % nc
  # Sort by (block_i, block_j, local dst) so each block is dst-sorted.
  order = np.lexsort((ldst, bj, bi))
  bi, bj, ldst, lsrc, w = (bi[order], bj[order], ldst[order], lsrc[order],
                           w[order])
  counts = np.zeros((R, C), np.int64)
  np.add.at(counts, (bi, bj), 1)
  cap = max(int(counts.max()), 1)
  bsrc = np.zeros((R, C, cap), np.int32)
  bdst = np.full((R, C, cap), max(nr - 1, 0), np.int32)  # keep dst sorted
  bw = np.zeros((R, C, cap), dt)
  bmask = np.zeros((R, C, cap), bool)
  # Edges are sorted by (bi, bj): position = index - first index of block.
  flat = bi * C + bj
  first = np.searchsorted(flat, flat)
  pos = np.arange(flat.shape[0]) - first
  bsrc[bi, bj, pos] = lsrc
  bdst[bi, bj, pos] = ldst
  bw[bi, bj, pos] = w
  bmask[bi, bj, pos] = True
  return DistGraph(n=n, n_pad=n_pad, R=R, C=C, src=bsrc, dst=bdst, w=bw,
                   emask=bmask)


def pad_vertex_tree(tree: PyTree, n: int, n_pad: int, fill=0) -> PyTree:
  """Pad the leading vertex axis from n to n_pad with ``fill``."""
  if n_pad == n:
    return tree
  return _tree.tree_map(
      lambda x: torch.cat([x, torch.full((n_pad - n,) + tuple(x.shape[1:]),
                                         fill, dtype=x.dtype,
                                         device=x.device)]), tree)


# ---------------------------------------------------------------------------
# The grid of process groups, and the collectives over it
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Grid:
  """This rank's place in the ``R × C`` grid and its two process groups.

  Build it with :meth:`create` after ``torch.distributed.
  init_process_group``; every rank creates every group, in one order.
  """

  R: int
  C: int
  rank: int
  reduce_group: Any   # ranks (i, ·): the reference's col_axis
  gather_group: Any   # ranks (·, j): the other row blocks

  @property
  def i(self) -> int:
    return self.rank // self.C

  @property
  def j(self) -> int:
    return self.rank % self.C

  @classmethod
  def create(cls, R: int, C: int) -> "Grid":
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != R * C:
      raise ValueError(f"world size {world} != R*C = {R * C}")
    reduce_group = gather_group = None
    for i in range(R):
      g = dist.new_group([i * C + k for k in range(C)])
      if rank // C == i:
        reduce_group = g
    for j in range(C):
      g = dist.new_group([k * C + j for k in range(R)])
      if rank % C == j:
        gather_group = g
    return cls(R=R, C=C, rank=rank, reduce_group=reduce_group,
               gather_group=gather_group)

  def rows(self, x: torch.Tensor) -> torch.Tensor:
    """Row block i of a global ``[n_pad, ...]`` tensor."""
    nr = x.shape[0] // self.R
    return x[self.i * nr:(self.i + 1) * nr]


def _wire(x: torch.Tensor) -> torch.Tensor:
  return (x.to(torch.int8) if x.dtype == torch.bool else x).contiguous()


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
  """The group's copies of ``x``, in group rank order."""
  w = _wire(x)
  parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
  dist.all_gather(parts, w, group=group)
  return [p.to(x.dtype) for p in parts]


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
  w = _wire(x)
  if w is x:
    w = w.clone()
  dist.all_reduce(w, op=op, group=group)
  return w.to(x.dtype)


def _gather_rows(tree: PyTree, grid: Grid) -> PyTree:
  """Row blocks ``[nr, ...]`` -> the global ``[n_pad, ...]`` tensors."""
  return _tree.tree_map(
      lambda x: torch.cat(_all_gather(x, grid.gather_group)), tree)


def _rows_to_cols(tree: PyTree, grid: Grid) -> PyTree:
  """The superstep-boundary reshard: this rank's row block -> column block
  j, by an all_gather of the row blocks over the gather group."""
  def leaf(x):
    full = torch.cat(_all_gather(x, grid.gather_group))
    nc = full.shape[0] // grid.C
    return full[grid.j * nc:(grid.j + 1) * nc]
  return _tree.tree_map(leaf, tree)


_REDUCE_OPS = {"add": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}


def _semiring_axis_reduce(y: PyTree, recv: torch.Tensor, group,
                          program: GraphProgram
                          ) -> Tuple[PyTree, torch.Tensor]:
  """Combine the partial outputs of one row block over the reduce group:
  all_reduce for add/min/max, int8 MAX/MIN for any/all, and for a generic
  monoid an all_gather folded in group order k = 0 … C−1."""
  kind = program.reduce_kind
  if kind in _REDUCE_OPS:
    y = _tree.tree_map(lambda x: _all_reduce(x, _REDUCE_OPS[kind], group), y)
  elif kind in ("any", "all"):
    op = dist.ReduceOp.MAX if kind == "any" else dist.ReduceOp.MIN
    y = _tree.tree_map(lambda x: _all_reduce(x.to(torch.int8), op, group
                                             ).to(x.dtype), y)
  else:
    red = program.reduce_fn()
    leaves, treedef = _tree.tree_flatten(y)
    parts = [_all_gather(x, group) for x in leaves]
    acc = _tree.tree_unflatten(treedef, [p[0] for p in parts])
    for k in range(1, len(parts[0]) if parts else 0):
      acc = red(acc, _tree.tree_unflatten(treedef, [p[k] for p in parts]))
    y = acc
  recv = _all_reduce(recv.to(torch.int8), dist.ReduceOp.MAX, group) > 0
  return y, recv


def spmv_2d(block: graphlib.CooGraph, msg: PyTree, active: torch.Tensor,
            dst_prop: PyTree, program: GraphProgram, grid: Grid,
            backend: PlanLike = AUTO_PLAN) -> Tuple[PyTree, torch.Tensor]:
  """One rank's share of the distributed generalized SpMV.

  ``msg``/``active`` are column block j (``nc`` long), ``dst_prop`` and
  the outputs row block i (``nr`` long; ``nr != nc`` when R != C).  The
  block SpMV runs through :func:`repro_torch.core.spmv.spmv` (blocks are
  COO: plans ``coo``, the default under auto, or ``coo_tiled``); its
  partial result is combined over the reduce group.
  """
  return _spmv_2d(block, msg, active, dst_prop, program, grid,
                  as_plan(backend), _Split(None, active.device))


def _spmv_2d(block, msg, active, dst_prop, program, grid, plan, split):
  y, recv = spmv_lib.spmv(block, msg, active, dst_prop, program,
                          backend=plan)
  split.lap("spmv")
  y, recv = _semiring_axis_reduce(y, recv, grid.reduce_group, program)
  split.lap("reduce")
  return y, recv


# ---------------------------------------------------------------------------
# The superstep loops
# ---------------------------------------------------------------------------


class _Split:
  """Seconds by section of a superstep, when the caller asks for them
  (``timings``): each lap waits for the device, so the split costs time."""

  def __init__(self, out: Optional[Dict[str, float]], device: torch.device):
    self.out, self.device = out, device
    self.t = time.perf_counter()

  def lap(self, name: str) -> None:
    if self.out is None:
      return
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)
    t = time.perf_counter()
    self.out[name] = self.out.get(name, 0.0) + t - self.t
    self.t = t


def _group_sum(x: torch.Tensor, grid: Grid) -> torch.Tensor:
  """The global sum of a per-row-block count (each row block once)."""
  return _all_reduce(x, dist.ReduceOp.SUM, grid.gather_group)


def run_graph_program_2d(
    block: graphlib.CooGraph, program: GraphProgram, init_prop: PyTree,
    init_active: torch.Tensor, grid: Grid, *,
    max_iters: int = 0x7FFFFFF0, backend: PlanLike = AUTO_PLAN,
    timings: Optional[Dict[str, float]] = None) -> EngineState:
  """Distributed Algorithm 2, run by every rank of ``grid`` on its block.

  ``init_prop``/``init_active`` are the global arrays padded to
  ``n_pad``, the same on every rank.  Every superstep masks with ``recv``,
  as the reference's does.  Returns the final global (prop, active,
  iteration, num_active) on every rank.  ``timings``, when given, gathers
  seconds by section: ``reshard``, ``spmv`` (the block SpMV), ``reduce``
  and ``count`` (apply, activate and the global count read to the host).
  """
  plan = as_plan(backend)
  dev = init_active.device
  split = _Split(timings, dev)
  prop = _tree.tree_map(grid.rows, init_prop)
  active = grid.rows(init_active)
  num = int(init_active.sum())
  it = 0
  while it < max_iters and num > 0:
    msg = _rows_to_cols(program.send_message(prop), grid)
    act = _rows_to_cols(active, grid)
    split.lap("reshard")
    y, recv = _spmv_2d(block, msg, act, prop, program, grid, plan, split)
    new_prop = spmv_lib._tree_where(recv, program.apply(y, prop), prop)
    active = recv & program.activate(prop, new_prop)
    prop = new_prop
    it += 1
    num = int(_group_sum(active.sum(dtype=torch.int32), grid))
    split.lap("count")
  return EngineState(
      _gather_rows(prop, grid), _gather_rows(active, grid),
      torch.tensor(it, dtype=torch.int32, device=dev),
      torch.tensor(num, dtype=torch.int32, device=dev))


def run_graph_program_2d_batched(
    block: graphlib.CooGraph, program: GraphProgram, init_prop: PyTree,
    init_active: torch.Tensor, grid: Grid, *,
    max_iters: int = 0x7FFFFFF0, backend: PlanLike = AUTO_PLAN,
    timings: Optional[Dict[str, float]] = None) -> BatchedEngineState:
  """Distributed batched multi-query loop (SpMM over the grid).

  The query axis (dim 1 of every leaf, ``[n_pad, Q, ...]``) travels whole
  through the 2-D partitioning: each block SpMV grows a payload axis.
  Needs a batched-ready program (``inert_message``, per-lane
  ``activate``).  Returns the final global :class:`BatchedEngineState` on
  every rank; ``timings`` as in :func:`run_graph_program_2d`.
  """
  plan = as_plan(backend)
  dev = init_active.device
  split = _Split(timings, dev)
  state = init_batched_state(init_prop, init_active)
  prop = _tree.tree_map(grid.rows, state.prop)
  active, done = grid.rows(state.active), state.done
  num_active, iters = state.num_active, state.iters
  it = 0
  while it < max_iters and not bool(done.all()):
    live = ~done
    lane_mask = active & live[None, :]
    msg = spmv_lib.mask_inert(program.send_message(prop), lane_mask, program)
    msg = _rows_to_cols(msg, grid)
    vert_active = _rows_to_cols(lane_mask.any(dim=1), grid)
    split.lap("reshard")
    y, recv = _spmv_2d(block, msg, vert_active, prop, program, grid, plan,
                       split)
    new_prop = program.apply(y, prop)
    if program.needs_recv:
      new_prop = spmv_lib._tree_where(recv, new_prop, prop)
      changed = recv[:, None] & program.activate(prop, new_prop)
    else:
      changed = program.activate(prop, new_prop)
    active = changed & live[None, :]
    prop = new_prop
    num_active = _group_sum(active.sum(dim=0, dtype=torch.int32), grid)
    done = done | (num_active == 0)
    iters = iters + live.to(torch.int32)
    it += 1
    split.lap("count")
  return BatchedEngineState(
      prop=_gather_rows(prop, grid), active=_gather_rows(active, grid),
      iteration=torch.tensor(it, dtype=torch.int32, device=dev), done=done,
      num_active=num_active, iters=iters)


# ---------------------------------------------------------------------------
# Launching the ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, R: int, C: int, backend: str,
               port: int, out_dir: str, args: tuple) -> None:
  dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                          world_size=R * C, rank=rank)
  try:
    result = fn(Grid.create(R, C), *args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
  finally:
    dist.destroy_process_group()


def launch(fn: Callable, R: int, C: int, *args, backend: str = "gloo"
           ) -> List[Any]:
  """Run ``fn(grid, *args)`` in ``R·C`` spawned ranks over a process group
  of ``backend`` on ``localhost``; return each rank's result (tensors,
  numbers, containers of them), in rank order.

  ``fn`` and ``args`` are pickled: pass ``fn`` by import path and large
  inputs as files (:meth:`DistGraph.save`).  A rank that raises makes this
  call raise; the other ranks are stopped.
  """
  port = _free_port()
  with tempfile.TemporaryDirectory() as out_dir:
    torch.multiprocessing.start_processes(
        _rank_main, args=(fn, R, C, backend, port, out_dir, args),
        nprocs=R * C, join=True, start_method="spawn")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=True) for r in range(R * C)]
