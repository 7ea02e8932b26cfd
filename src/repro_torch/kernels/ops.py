"""Wrappers bridging :mod:`repro_torch.core` to the CUDA kernels (port of
:mod:`repro.kernels.ops`)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import _tree, tracing
from repro_torch.core import graph as graphlib
from repro_torch.core.spmv import _unpermute, merge_spill
from repro_torch.core.vertex_program import DST_FORMS, GraphProgram
from repro_torch.kernels import process_expr
from repro_torch.kernels.ell_spmv import RowSegments, ell_spmv

PyTree = Any


def spmv_ell_cuda(g: graphlib.EllGraph, msg: PyTree, active: torch.Tensor,
                  dst_prop: PyTree, program: GraphProgram, *,
                  block_rows: Optional[int] = None,
                  block_slots: Optional[int] = None,
                  block_queries: Optional[int] = None,
                  segments: Optional[RowSegments] = None
                  ) -> Tuple[PyTree, torch.Tensor]:
  """:func:`repro_torch.core.spmv.spmv_ell` with the packed ELL rows run by
  the CUDA kernel (the spill still folds in through COO).

  Takes what the reference's ``spmv_ell_pallas`` takes
  (``src/repro/core/spmv.py::_pallas_eligible``): a single-leaf scalar
  (``[n]``) or vector (``[n, K]``) message, an add/min/max reduce and,
  when the program reads the destination property, one leaf of it.  The
  per-edge function is the program's ``process_op`` (a shipped form, where
  the shipped library has the call's dtypes) or its own
  ``process_message``, traced at the call's dtypes and widths
  (:func:`repro_torch.kernels.process_expr.for_program`): lanewise, or
  mixing the lanes of a ``[n, K]`` message (K up to 256), over float32,
  float16, bfloat16 and the integer types up to int32, mixed as torch
  promotes them.  A process that reads the destination property takes it
  shaped as the message is (``[n]``, or ``[n, Kd]`` with Kd = 1 or K), in
  its own dtype, un-permuted into packed-row order as the reference's
  ``spmv_ell_pallas`` does.  Raises otherwise, naming the reason, as the
  reference asserts.  A lanewise process on a ``[n, Q]`` message runs as
  the query-tiled SpMM, with the tile from ``block_queries`` or the
  kernel's default; a lane-mixing one on the lane-vector grid.  The result
  is squeezed by its own rank, as the reference's is (``ops.py:59-64``,
  ``:92``): a ``[n, K]`` message with an ``[E]`` result gives ``y [n]``,
  with an ``[E, 1]`` one ``y [n, 1]``.  ``segments`` is the graph's
  :func:`~repro_torch.kernels.ell_spmv.row_segments`, computed when not
  given.  The kernel's call (its checks, table choice and launch) is the
  profiler span ``graphmat.kernels.ell_spmv``.
  """
  if block_slots is not None:
    raise ValueError("cuda_ell: the kernel has no slot tiling (block_slots)")
  leaves, treedef = _tree.tree_flatten(msg)
  if len(leaves) != 1 or leaves[0].ndim > 2:
    raise ValueError("cuda_ell: single-leaf [n] or [n, Q] messages only")
  m = leaves[0]
  dp_leaves = (_tree.tree_leaves(dst_prop) if program.process_reads_dst
               else [])
  if len(dp_leaves) > 1:
    raise ValueError("cuda_ell: a single-leaf destination property only")
  process = process_expr.for_program(program, m, g.vals,
                                     dp_leaves[0] if dp_leaves else None)
  if isinstance(process, process_expr.Refused):
    raise ValueError(f"cuda_ell: program {program.name!r} {process.reason}")
  scalar_msg = m.ndim == 1
  m2 = (m[:, None] if scalar_msg else m).contiguous()
  dpp = None
  if (process in DST_FORMS if isinstance(process, str)
      else process.reads_dst):
    if not dp_leaves or dp_leaves[0].ndim != m.ndim:
      raise ValueError("cuda_ell: a single-leaf destination property shaped "
                       "as the message ([n], or [n, Kd]) only")
    dp = dp_leaves[0][g.row_of.clamp(max=g.n - 1)]
    dpp = (dp[:, None] if dp.ndim == 1 else dp).contiguous()
  form = ({"process_op": process} if isinstance(process, str)
          else {"process": process})
  with tracing.span(tracing.ELL_SPMV):
    y2, recv_i8 = ell_spmv(g.cols, g.vals, g.mask, m2, active.contiguous(),
                           **form, reduce_kind=program.reduce_kind,
                           dprop=dpp, row_end=g.row_end,
                           mask_prefix=g.mask_prefix, segments=segments,
                           block_rows=block_rows,
                           block_queries=block_queries)
  scalar_result = scalar_msg or (
      isinstance(process, process_expr.ProcessExpr) and process.squeezed)
  y_packed = _tree.tree_unflatten(treedef,
                                  [y2[:, 0] if scalar_result else y2])
  y, recv = _unpermute(g, y_packed, recv_i8 != 0)
  return merge_spill(g, y, recv, msg, active, dst_prop, program, process)
