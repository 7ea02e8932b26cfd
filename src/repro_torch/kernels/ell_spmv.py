"""Generalized ELL SpMV / multi-query SpMM: the CUDA kernel's wrapper.

Replaces ``src/repro/kernels/ell_spmv.py::ell_spmv_pallas``, both grids: the
single-query grid (Q = 1) and the ``block_queries`` multi-query SpMM (Q > 1),
and its destination-property operand ``dprop``.  The kernel is
``csrc/ell_spmv.cu``; its header says what it computes, what bounds it
(the bytes the graph needs: 4 bytes of cols and, for the forms that read
the edge, 4 of vals per valid slot, 4 bytes of row extent per row, the
messages and outputs once; on the card, the random gathers) and how its
design answers that (rows get lanes matched to their extent from a table
of :class:`RowSegments`, which this module owns, one lane for a row of at
most 4 slots; a table with a longer row gets a cooperative launch that
skips the per-slot active flags when every source is active, a table of
short rows only a plain launch).

The per-edge process is the functor the kernel is templated on: a
``process_op`` names one of the five shipped forms, and a
:class:`~repro_torch.kernels.process_expr.ProcessExpr` is a program's own
``process_message``, traced (as ``ell_spmv_pallas`` traces it into its
body).  A traced process that equals a shipped form node for node runs the
shipped instance; any other gets an instance of its own, for its operand
dtypes and reduce (:func:`library_for`).  The result has the trace's dtype
and width: ``[n_pad, K_out]``, K_out = Q for a lanewise process, 1 or K for
one that mixes the lanes of a ``[n_src, K]`` message, which runs on the
kernel's lane-vector grid (K up to ``process_expr.MAX_LANES``): teams of
threads a message, rows spread over warps by a row-class table that
:meth:`RowSegments.lane_table` makes once per graph and team shape.

The shipped library is built with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at its first launch, into ``build/`` at
the repository root, and loaded with ``ctypes``
(:mod:`repro_torch.kernels._build`); a generated instance is built the same
way at its first launch (a few seconds; ``CudaLibrary.info`` keeps the
seconds and the compiler's register and spill lines) and found there by
later runs.

:func:`ell_spmv` runs the kernel on CUDA tensors and the plain version
(:func:`repro_torch.kernels.ref.ell_spmv_ref`, with the program's callable
itself for a traced process) on CPU tensors; on a CUDA tensor it launches
or raises, a failed build or launch included.  :data:`launches` counts the
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.graph import ell_extent
from repro_torch.core.vertex_program import (DST_FORMS, PROCESS_FORMS,
                                             PROCESS_OPS)
from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.process_expr import (CTYPES, KINDS, MAX_LANES,
                                              SHIPPED_DTYPES, ProcessExpr)
from repro_torch.kernels.ref import ell_spmv_ref

# The forms that read vals.
EDGE_OPS = ("msg_plus_edge", "msg_times_edge", "edge_minus_msg_dst_times_msg")
# Codes passed to the C function; the orders match the enums in the source.
_OP_CODE = {op: i for i, op in enumerate(PROCESS_OPS)}
_REDUCE_CODE = {"add": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.int32: 2,
               torch.bfloat16: 3, torch.int8: 4, torch.int16: 5,
               torch.uint8: 6}
# Launch flags, as the source's Flags enum.
_MASK_IS_PREFIX, _VEC_SLOTS, _VEC_MSG, _VEC_ACTIVE = 1, 2, 4, 8
_SHORT_ROWS = 16
MAX_QUERY_TILE = 8
DEFAULT_BLOCK_ROWS = 8
# Lanes the kernel gives one packed row: a power of two in [1, 32], the
# least that covers the row's extent at SLOTS_PER_LANE slots a lane (the
# source's slots_per_lane<1>(): one 16-byte load of cols).  One lane takes a
# row of 0-4 slots, so a warp serves 32 such rows (the one-lane class: the
# road grid's rows of 2-4 slots, RMAT's tail of low-degree rows).  The
# query-tiled grid steps one slot a lane, and its rows keep at least
# TILED_MIN_LANES lanes: at one lane its 8-query rows of 4 slots ran 5-25%
# slower on the road grid (H100 80GB HBM3, 700 W; PERF.md).  Rows
# are grouped in runs of SEGMENT_CHUNK, each run taking the lanes of its
# longest row.
SLOTS_PER_LANE = 4
TILED_MIN_LANES = 2
SEGMENT_CHUNK = 32


@functools.lru_cache(maxsize=None)
def config_key(q: int, dtype: torch.dtype, reduce_kind: str,
               process_op: str, lanes: bool = False) -> str:
  """The launch counter's key for one kernel instance and grid: the grid
  (``q1``, ``qtiled``, or ``lanes`` for the lane-vector grid), the
  message dtype, the reduce and the instance's name (a traced instance's
  name hashes its every operand dtype and K_out)."""
  grid = "lanes" if lanes else ("q1" if q == 1 else "qtiled")
  return f"{grid}/{str(dtype).replace('torch.', '')}/{reduce_kind}/{process_op}"


class LaunchCounter:
  """Kernel launches, counted where the wrapper launches the kernel, by
  :func:`config_key`: ``single`` for the single-query grids (Q = 1 and the
  lane-vector grid), ``multi`` for the query-tiled grid."""

  def __init__(self):
    self.by_config: Dict[str, int] = {}

  def add(self, key: str) -> None:
    self.by_config[key] = self.by_config.get(key, 0) + 1

  @property
  def single(self) -> int:
    return sum(v for k, v in self.by_config.items()
               if k.startswith(("q1/", "lanes/")))

  @property
  def multi(self) -> int:
    return sum(v for k, v in self.by_config.items()
               if k.startswith("qtiled/"))

  @property
  def total(self) -> int:
    return sum(self.by_config.values())

  def reset(self) -> None:
    self.by_config.clear()


launches = LaunchCounter()


def _bind(lib: ctypes.CDLL) -> None:
  fn = lib.graphmat_ell_spmv
  fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 20
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("ell_spmv.cu", _bind)

# A generated instance: the body over one traced process, for its operand
# dtypes and one reduce, with the shipped library's C entry point (dtypes,
# K_out and reduce checked, op ignored).
_GENERATED_SOURCE = """\
// The ELL kernel of ell_spmv_body.cuh over one traced process_message, for
// {what} and the {reduce} reduce (written by kernels/ell_spmv.py).
#include "ell_spmv_body.cuh"

namespace {{
{functor}
}}  // namespace

extern "C" int graphmat_ell_spmv(const void* cols, const void* vals,
                                 const void* mask, const void* msg,
                                 const void* active, const void* dprop,
                                 const void* row_end, const void* segs,
                                 void* y, void* recv, void* sync,
                                 int n_src, int nseg,
                                 int num_warps, int width, int q, int q_tile,
                                 int kd, int flags, int warps_per_block,
                                 int n_filled, int n_rows, int tag,
                                 int dtype,
                                 int edge_dtype, int dst_dtype, int out_dtype,
                                 int k_out, int reduce, int op, int device,
                                 void* stream) {{
  (void)op;
  (void)edge_dtype;
  (void)dst_dtype;
  if ({checks}) {{
    return static_cast<int>(cudaErrorInvalidValue);
  }}
  return run_ell<Operands<{types}>, {reduce_code}, TracedProcess{lanes}>(
      cols, vals, mask, msg, active, dprop, row_end, segs, y, recv, sync,
      n_src, nseg, num_warps, width, q, q_tile, kd, flags, warps_per_block,
      n_filled, n_rows, tag, device, stream);
}}

extern "C" const char* graphmat_cuda_error_string(int code) {{
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}}
"""
_generated: Dict[Tuple[str, str], CudaLibrary] = {}
_generated_lock = threading.Lock()


def generated_source(process: ProcessExpr, reduce_kind: str) -> str:
  """The CUDA source of ``process``'s instance for ``reduce_kind``."""
  return _GENERATED_SOURCE.format(**instance_fields(process, reduce_kind))


def instance_fields(process: ProcessExpr, reduce_kind: str) -> Dict[str, str]:
  """What a generated source says of ``process``'s instance for
  ``reduce_kind`` (this kernel's, and the COO kernel's in
  :mod:`repro_torch.kernels.coo_spmv`): ``what`` it takes, the ``functor``,
  the C entry's ``checks`` of its dtypes and widths, the ``Operands``
  ``types``, the ``reduce_code`` and the ``lanes`` template argument."""
  m = process.dtype
  e, d = process.edge_dtype or m, process.dst_dtype or m
  r = process.out_dtype
  # A half or bfloat16 result is summed in float and rounded once.
  acc = "float" if r in (torch.float16, torch.bfloat16) else CTYPES[KINDS[r]]
  checks = [f"dtype != {_DTYPE_CODE[m]}", f"out_dtype != {_DTYPE_CODE[r]}",
            f"reduce != {_REDUCE_CODE[reduce_kind]}",
            (f"k_out != {process.k_out}" if process.lane_mixing
             else "k_out != q")]
  if process.edge_dtype is not None:
    checks.insert(1, f"edge_dtype != {_DTYPE_CODE[e]}")
  if process.dst_dtype is not None:
    checks.insert(2, f"dst_dtype != {_DTYPE_CODE[d]}")
  what = (KINDS[m] if process.uniform else
          " x ".join(KINDS[t] for t in (m, e, d)) + f" -> {KINDS[r]}")
  if process.lane_mixing:
    what += f", K = {process.lanes} lanes mixed, K_out = {process.k_out}"
  return dict(
      what=what, reduce=reduce_kind, functor=process.functor_source(),
      checks=" ||\n      ".join(checks),
      types=", ".join(CTYPES[KINDS[t]] for t in (m, e, d, r)) + f", {acc}",
      reduce_code=str(_REDUCE_CODE[reduce_kind]),
      lanes=", true" if process.lane_mixing else "")


def library_for(process: Union[str, ProcessExpr],
                reduce_kind: str) -> CudaLibrary:
  """The library that runs ``process`` (a form name or a traced process):
  the shipped one, or the traced process's own instance for ``reduce_kind``
  (made once, built at its first load)."""
  if isinstance(process, str) or process.shipped is not None:
    return LIBRARY
  key = (process.digest, reduce_kind)
  lib = _generated.get(key)
  if lib is None:
    with _generated_lock:
      lib = _generated.get(key)
      if lib is None:
        lib = _generated[key] = CudaLibrary(
            f"ell_spmv_{process.digest}_{reduce_kind}", _bind,
            text=generated_source(process, reduce_kind))
  return lib


# The kernel's grid barrier and all-active flags keep 5 words from launch
# to launch.  Launches on one stream run in order, so each stream has its
# own.  A launch that faults leaves the CUDA context unusable (the error is
# sticky), so no later launch meets words that a launch left half crossed.
_syncs: Dict[Tuple[int, int], torch.Tensor] = {}


def _sync_words(index: int, stream: int) -> torch.Tensor:
  key = (index, stream)
  words = _syncs.get(key)
  if words is None:
    words = _syncs[key] = torch.zeros(5, dtype=torch.int32,
                                      device=torch.device("cuda", index))
  return words


# The lane-vector grid's launch tags, one run a stream (the fifth sync
# word holds the tag of the last launch whose all-active pass saw an
# inactive source; a stale word only costs that launch the flag reads).
_tags: Dict[Tuple[int, int], int] = {}


def _lane_tag(index: int, stream: int) -> int:
  key = (index, stream)
  tag = _tags[key] = (_tags.get(key, 0) + 1) & 0x7fffffff
  return tag


@dataclasses.dataclass(frozen=True)
class RowSegments:
  """How the kernel spreads packed rows over warps.

  ``table[i] = (first row, end row, lanes per row, first warp)``: the rows
  ``[first, end)`` get that many lanes each, and a warp serves ``32 /
  lanes`` consecutive rows; ``num_warps`` is the total.  ``tiled_table``
  and ``tiled_num_warps`` are the same for the query-tiled grid (at least
  :data:`TILED_MIN_LANES` lanes a row).  Rows ``[0, filled_rows)`` each
  have a set slot; ``short_rows`` says that every row of ``table`` is in
  the one-lane class.  ``chunk_extent`` is the longest extent of each run
  of :data:`SEGMENT_CHUNK` rows, from which :meth:`lane_table` makes the
  lane-vector grid's row-class tables.
  """

  table: torch.Tensor  # int32[num_segments, 4]
  num_warps: int
  tiled_table: torch.Tensor  # int32[num_tiled_segments, 4]
  tiled_num_warps: int
  filled_rows: int
  short_rows: bool
  chunk_extent: np.ndarray  # int32[ceil(n_pad / SEGMENT_CHUNK)]
  n_pad: int
  _lane_tables: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = (
      dataclasses.field(default_factory=dict, compare=False, repr=False))

  def lane_table(self, team: int, slots: int) -> Tuple[torch.Tensor, int]:
    """The lane-vector grid's row-class table for teams of ``team``
    threads taking ``slots`` slots a step (:func:`row_classes`), made at
    its first use and kept: ``(table, num_warps)``, the table's rows
    ``(first row, end row, threads per row, first warp)``."""
    key = (team, slots)
    got = self._lane_tables.get(key)
    if got is None:
      got = self._lane_tables[key] = _table(
          row_classes(self.chunk_extent, team, slots), self.n_pad,
          self.table.device)
    return got


def row_lanes(length) -> np.ndarray:
  """Lanes for rows of extent ``length`` (see :data:`SLOTS_PER_LANE`)."""
  need = -(-np.asarray(length, np.int64) // SLOTS_PER_LANE)
  lanes = np.full(need.shape, 32, np.int32)
  for cand in (16, 8, 4, 2, 1):
    lanes[need <= cand] = cand
  return lanes


def row_classes(length, team: int, slots: int) -> np.ndarray:
  """The lane-vector grid's threads for rows of extent ``length``, for
  teams of ``team`` threads (a message each) that take ``slots`` slots of
  the row a step: the fewest teams (a power of two) whose step covers the
  row, at most a warp's ``32 / team``, times ``team``.  Rows that fit one
  team's step share a warp, ``32 / team`` of them; long rows take a warp
  each."""
  need = -(-np.asarray(length, np.int64) // slots)
  teams = np.full(need.shape, 32 // team, np.int32)
  cand = 32 // team
  while cand > 1:
    cand //= 2
    teams[need <= cand] = cand
  return teams * team


def _table(chunk_lanes: np.ndarray, n_pad: int, device):
  """Runs of equal lanes over the chunks as ``(table, num_warps)``."""
  chunks = chunk_lanes.shape[0]
  starts = np.flatnonzero(np.diff(chunk_lanes, prepend=-1))
  table, warp = [], 0
  for i, lo in enumerate(starts):
    hi = starts[i + 1] if i + 1 < len(starts) else chunks
    r0, r1 = int(lo) * SEGMENT_CHUNK, min(int(hi) * SEGMENT_CHUNK, n_pad)
    g = int(chunk_lanes[lo])
    table.append((r0, r1, g, warp))
    warp += -(-(r1 - r0) * g // 32)
  return (torch.tensor(table, dtype=torch.int32,
                       device=device).reshape(-1, 4), warp)


def row_segments(row_end: torch.Tensor) -> RowSegments:
  """The :class:`RowSegments` of packed rows whose extents are
  ``row_end`` (read back to the host once), on ``row_end``'s device.

  Runs of :data:`SEGMENT_CHUNK` rows take the lanes of their longest row,
  and runs of equal lanes merge into one segment, so a degree-sorted graph
  has a few.
  """
  ends = row_end.cpu().numpy()
  n_pad = ends.shape[0]
  chunks = -(-n_pad // SEGMENT_CHUNK)
  padded = np.zeros(chunks * SEGMENT_CHUNK, np.int32)
  padded[:n_pad] = ends
  extent = padded.reshape(chunks, SEGMENT_CHUNK).max(axis=1)
  lanes = row_lanes(extent)
  table, num_warps = _table(lanes, n_pad, row_end.device)
  tiled, tiled_warps = _table(np.maximum(lanes, TILED_MIN_LANES), n_pad,
                              row_end.device)
  empty = np.flatnonzero(ends == 0)
  return RowSegments(table, num_warps, tiled, tiled_warps,
                     filled_rows=int(empty[0]) if empty.size else n_pad,
                     short_rows=bool((lanes == 1).all()),
                     chunk_extent=extent, n_pad=n_pad)


def kernels_per_call(process: Union[str, ProcessExpr, None] = None) -> int:
  """The kernels one :func:`ell_spmv` call of ``process`` launches on the
  card: two for a lane-mixing process (the lane-vector grid's all-active
  pass, then the grid), else one."""
  return 2 if isinstance(process, ProcessExpr) and process.lane_mixing else 1


def plain_process(process_op: str):
  """The form :data:`PROCESS_FORMS` names, as :func:`ell_spmv_ref`'s
  ``process`` (whose edge values have no trailing query axis)."""
  form = PROCESS_FORMS[process_op]
  return lambda m, e, d: form(m, e[..., None], d)


def _reads(process: Union[str, ProcessExpr]) -> Tuple[bool, bool]:
  """``(reads the edge, reads the destination property)``."""
  if isinstance(process, ProcessExpr):
    return process.reads_edge, process.reads_dst
  return process in EDGE_OPS, process in DST_FORMS


def takes(msg: torch.Tensor, vals: torch.Tensor,
          process: Union[str, ProcessExpr], reduce_kind: str,
          dprop: Optional[torch.Tensor] = None,
          rows: Optional[int] = None) -> bool:
  """Whether the kernel takes messages ``msg`` ([n] or [n, Q]) with this
  process and reduce.  A form name takes one shipped dtype for the
  message, the edge values it reads and the destination property; a
  traced process takes the dtypes and widths it was traced at.  A process
  that reads the destination property needs ``dprop`` shaped as ``msg`` is:
  [n] with [n], [n, 1] or [n, Q] with [n, Q] (a lane-mixing one: the width
  it was traced at), with ``rows`` rows (default: the message's)."""
  if reduce_kind not in _REDUCE_CODE or msg.ndim > 2:
    return False
  reads_edge, reads_dst = _reads(process)
  if isinstance(process, ProcessExpr):
    edge_dtype, dst_dtype = process.edge_dtype, process.dst_dtype
    if process.dtype != msg.dtype or process.lane != (msg.ndim == 2):
      return False
    if process.lane_mixing and not (msg.shape[1] == process.lanes
                                    and process.lanes <= MAX_LANES):
      return False
  else:
    edge_dtype = dst_dtype = msg.dtype
    if process not in PROCESS_FORMS or msg.dtype not in SHIPPED_DTYPES:
      return False
  if reads_edge and vals.dtype != edge_dtype:
    return False
  if not reads_dst:
    return True
  q = msg.shape[1] if msg.ndim == 2 else 1
  widths = ((process.dst_lanes,) if isinstance(process, ProcessExpr)
            and process.lane_mixing else (1, q))
  return (dprop is not None and dprop.dtype == dst_dtype
          and dprop.ndim == msg.ndim
          and dprop.shape[0] == (msg.shape[0] if rows is None else rows)
          and (dprop.ndim == 1 or dprop.shape[1] in widths))


def _check(cond: bool, what: str, *args) -> None:
  """Raise unless ``cond``; ``what`` is formatted with ``args`` only then
  (the wrapper runs once a superstep, and its host time counts)."""
  if not cond:
    raise ValueError("ell_spmv: " + what.format(*args))


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
  return t.data_ptr() % nbytes == 0


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
             msg: torch.Tensor, active: torch.Tensor, *,
             process_op: Optional[str] = None,
             process: Optional[ProcessExpr] = None,
             reduce_kind: str, dprop: Optional[torch.Tensor] = None,
             row_end: Optional[torch.Tensor] = None,
             mask_prefix: Optional[bool] = None,
             segments: Optional[RowSegments] = None,
             block_rows: Optional[int] = None,
             block_queries: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(y [n_pad, K_out], recv int8[n_pad])`` for one ELL block.

  Args:
    cols: int32[n_pad, W] source ids; vals [n_pad, W]; mask bool[n_pad, W].
    msg: [n_src, Q] messages (Q = 1 for a single query).
    active: bool[n_src] source frontier.
    process_op: a key of :data:`PROCESS_FORMS` (a shipped form: the
      message, the edge values it reads, dprop and y all float32, float16
      or int32), or
    process: a program's ``process_message`` traced at the operands'
      dtypes and widths (:func:`repro_torch.kernels.process_expr.trace`);
      one of the two.  y has its result dtype and width K_out (Q for a
      lanewise process).
    reduce_kind: add | min | max.
    dprop: [n_pad, Kd] destination properties in packed-row order, Kd = 1
      or Q (a lane-mixing process: the Kd it was traced at): given for a
      process that reads it (:data:`DST_FORMS`, or a trace that reads
      ``d``) and only for one.
    row_end, mask_prefix: the mask's :func:`ell_extent` (an
      :class:`EllGraph` carries both); computed from the mask, with a read
      back to the host, unless both are given.
    segments: :func:`row_segments` of ``row_end`` (the ``cuda_ell`` backend
      keeps one per graph); computed, with a read back, when not given.
    block_rows: warps per thread block, 1..32 (the lane-vector grid takes
      at most 8).
    block_queries: query tile, 1..8 (default: the largest divisor of Q that
      is at most 8); a lane-mixing process takes the whole row.
  """
  if process is None:
    _check(process_op in PROCESS_FORMS, "unknown process_op {!r}",
           process_op)
    name, lanes = process_op, False
    edge_dtype = dst_dtype = out_dtype = msg.dtype
  else:
    _check(process_op is None, "give process_op or process, not both")
    _check(process.dtype == msg.dtype, "process traced at {}, msg is {}",
           process.dtype, msg.dtype)
    name, lanes = process.name, process.lane_mixing
    edge_dtype, dst_dtype = process.edge_dtype, process.dst_dtype
    out_dtype = process.out_dtype
  reads_edge, reads_dst = _reads(process_op if process is None else process)
  _check(reduce_kind in _REDUCE_CODE, "reduce_kind {!r}", reduce_kind)
  _check(cols.ndim == 2 and vals.shape == cols.shape
         and mask.shape == cols.shape, "cols, vals, mask must be [n_pad, W]")
  _check(msg.ndim == 2 and active.shape == (msg.shape[0],),
         "msg must be [n_src, Q] and active [n_src]")
  n_pad, width = cols.shape
  q = msg.shape[1]
  if lanes:
    _check(q == process.lanes and q <= MAX_LANES,
           "{} mixes the lanes of K = {} messages (at most {}); msg has {}",
           name, process.lanes, MAX_LANES, q)
  k_out = process.k_out if lanes else q
  if reads_dst:
    kds = (process.dst_lanes,) if lanes else (1, q)
    _check(dprop is not None and dprop.ndim == 2
           and dprop.shape[0] == n_pad and dprop.shape[1] in kds,
           "{} needs dprop [n_pad, Kd] with Kd in {}", name, kds)
    _check(dprop.dtype == dst_dtype, "{} needs dprop of dtype {}, not {}",
           name, dst_dtype, dprop.dtype)
  else:
    _check(dprop is None, "{} reads no dprop", name)
  _check(not reads_edge or vals.dtype == edge_dtype,
         "{} needs vals of dtype {}, not {}", name, edge_dtype, vals.dtype)
  tensors = (cols, vals, mask, msg, active) + (
      () if dprop is None else (dprop,))
  if not any(t.is_cuda for t in tensors):
    if dprop is None:
      dprop = torch.zeros((n_pad, 1), dtype=msg.dtype)
    return ell_spmv_ref(cols, vals, mask, msg, active, dprop,
                        process=(plain_process(process_op) if process is None
                                 else process.plain),
                        reduce_kind=reduce_kind)

  index = cols.get_device()
  _check(all(t.is_cuda and t.get_device() == index for t in tensors),
         "all tensors must lie on one CUDA device")
  _check(cols.dtype == torch.int32, "cols must be int32")
  _check(mask.dtype == torch.bool and active.dtype == torch.bool,
         "mask and active must be bool")
  _check(msg.dtype in _DTYPE_CODE and (process is not None
                                       or msg.dtype in SHIPPED_DTYPES),
         "msg dtype {} not supported", msg.dtype)
  _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
  warps = DEFAULT_BLOCK_ROWS if block_rows is None else int(block_rows)
  _check(1 <= warps <= 32, "block_rows={} must be in 1..32", warps)
  tile = 1 if q == 1 or lanes else min(
      int(block_queries or _pick_query_tile(q)), q)
  _check(1 <= tile <= MAX_QUERY_TILE, "block_queries={} must be in 1..{}",
         tile, MAX_QUERY_TILE)
  if row_end is None or mask_prefix is None:
    ends, mask_prefix = ell_extent(mask)
    row_end = torch.from_numpy(ends).to(cols.device)
  if segments is None:
    segments = row_segments(row_end)
  if lanes:
    team, _, load, slots = process.lane_layout
    table, num_warps = segments.lane_table(team, slots)
  elif tile == 1:
    table, num_warps = segments.table, segments.num_warps
  else:
    table, num_warps = segments.tiled_table, segments.tiled_num_warps
  _check(row_end.shape == (n_pad,) and row_end.dtype == torch.int32
         and row_end.get_device() == index and table.get_device() == index,
         "row_end must be int32[n_pad] and segments its table, on the "
         "mask's device")

  flags = _MASK_IS_PREFIX if mask_prefix else 0
  if (width % 4 == 0 and _aligned(cols, 16) and _aligned(mask, 4)
      and (not reads_edge or _aligned(vals, 4 * vals.element_size()))):
    flags |= _VEC_SLOTS
  if lanes:
    if _aligned(msg, load * msg.element_size()):
      flags |= _VEC_MSG
  elif q % 4 == 0 and tile % 4 == 0 and _aligned(msg, 16):
    flags |= _VEC_MSG
  if _aligned(active, 16):
    flags |= _VEC_ACTIVE
  if tile == 1 and segments.short_rows:
    flags |= _SHORT_ROWS
  library = LIBRARY if process is None else library_for(process, reduce_kind)
  lib = library.load()
  y = torch.empty((n_pad, k_out), dtype=out_dtype, device=cols.device)
  recv = cols.new_empty((n_pad,), dtype=torch.int8)
  stream = torch._C._cuda_getCurrentRawStream(index)
  rc = lib.graphmat_ell_spmv(
      cols.data_ptr(), vals.data_ptr(), mask.data_ptr(), msg.data_ptr(),
      active.data_ptr(), None if dprop is None else dprop.data_ptr(),
      row_end.data_ptr(), table.data_ptr(), y.data_ptr(), recv.data_ptr(),
      _sync_words(index, stream).data_ptr(), msg.shape[0], table.shape[0],
      num_warps, width, q, tile, 1 if dprop is None else dprop.shape[1],
      flags, warps, segments.filled_rows, n_pad,
      _lane_tag(index, stream) if lanes else 0, _DTYPE_CODE[msg.dtype],
      _DTYPE_CODE[vals.dtype] if reads_edge else -1,
      _DTYPE_CODE[dprop.dtype] if reads_dst else -1,
      _DTYPE_CODE[out_dtype], k_out, _REDUCE_CODE[reduce_kind],
      _OP_CODE.get(name, 0), index, stream)
  library.check(rc, "ell_spmv")
  launches.add(config_key(q, msg.dtype, reduce_kind, name, lanes))
  return y, recv


def _pick_query_tile(q: int, target: int = MAX_QUERY_TILE) -> int:
  """Largest divisor of ``q`` that is at most ``target`` (the query tile
  of the multi-query grid; ``kernels/ops.py::_pick_query_block`` in the
  reference, with the CUDA kernel's tile limit)."""
  return max(c for c in range(1, min(target, q) + 1) if q % c == 0)
