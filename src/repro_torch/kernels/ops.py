"""Wrappers bridging :mod:`repro_torch.core` to the CUDA kernels (port of
:mod:`repro.kernels.ops`)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import _tree
from repro_torch.core import graph as graphlib
from repro_torch.core.spmv import _unpermute, merge_spill
from repro_torch.core.vertex_program import GraphProgram
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

  Takes a single-leaf scalar (``[n]``) or query-lane (``[n, Q]``) message,
  an add/min/max reduce and a program with a ``process_op``; a form that
  reads the destination property takes it as one leaf shaped as the
  message is (``[n]``, or ``[n, Kd]`` with Kd = 1 or Q), un-permuted into
  packed-row order as the reference's ``spmv_ell_pallas`` does.  Raises otherwise, as the
  reference asserts.  Every ``process_op`` acts lane by lane, so a
  ``[n, Q]`` message always runs as the query-tiled SpMM, with the tile
  from ``block_queries`` or the kernel's default.  ``segments`` is the
  graph's :func:`~repro_torch.kernels.ell_spmv.row_segments`, computed
  when not given.
  """
  if program.process_op is None:
    raise ValueError(
        f"cuda_ell: program {program.name!r} has no process_op; the kernel "
        "implements only the forms in vertex_program.PROCESS_FORMS")
  if program.reduce_kind not in ("add", "min", "max"):
    raise ValueError(
        f"cuda_ell: reduce_kind {program.reduce_kind!r} is not add/min/max")
  if block_slots is not None:
    raise ValueError("cuda_ell: the kernel has no slot tiling (block_slots)")
  leaves, treedef = _tree.tree_flatten(msg)
  if len(leaves) != 1 or leaves[0].ndim > 2:
    raise ValueError("cuda_ell: single-leaf [n] or [n, Q] messages only")
  m = leaves[0]
  scalar_msg = m.ndim == 1
  m2 = (m[:, None] if scalar_msg else m).contiguous()
  dpp = None
  if program.process_reads_dst:
    dp_leaves = _tree.tree_leaves(dst_prop)
    if len(dp_leaves) != 1 or dp_leaves[0].ndim != m.ndim:
      raise ValueError("cuda_ell: a single-leaf destination property shaped "
                       "as the message ([n], or [n, Kd]) only")
    dp = dp_leaves[0][g.row_of.clamp(max=g.n - 1)]
    dpp = (dp[:, None] if dp.ndim == 1 else dp).contiguous()

  y2, recv_i8 = ell_spmv(g.cols, g.vals, g.mask, m2, active.contiguous(),
                         process_op=program.process_op,
                         reduce_kind=program.reduce_kind, dprop=dpp,
                         row_end=g.row_end, mask_prefix=g.mask_prefix,
                         segments=segments, block_rows=block_rows,
                         block_queries=block_queries)
  y_packed = _tree.tree_unflatten(treedef, [y2[:, 0] if scalar_msg else y2])
  y, recv = _unpermute(g, y_packed, recv_i8 != 0)
  return merge_spill(g, y, recv, msg, active, dst_prop, program)
