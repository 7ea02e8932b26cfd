"""CUDA ELL backend: the hand-written Hopper kernel for the packed rows.

It takes the place of the JAX package's ``pallas`` backend, with the same
priority and semantics: it ``supports`` any :class:`EllGraph` (an explicit
plan always routes here, and the shape restrictions raise inside
:mod:`repro_torch.kernels.ops`), and structural auto picks it only where the
kernel can run the call.  The plan's ``block_rows`` / ``block_queries``
override the kernel's launch shape.  The kernel's table of row segments is
made once per graph and kept while the graph lives.
"""

from __future__ import annotations

import weakref
from typing import Dict

from repro_torch import _tree
from repro_torch.core import graph as graphlib
from repro_torch.core.backends import base
from repro_torch.kernels import ell_spmv as kernel
from repro_torch.kernels import process_expr


class CudaEllBackend(base.Backend):
  name = "cuda_ell"
  container = "ell"
  priority = 90  # preferred over torch-ELL when the program shape qualifies

  def __init__(self):
    self._segments: Dict[int, kernel.RowSegments] = {}

  def segments(self, graph: graphlib.EllGraph) -> kernel.RowSegments:
    """The kernel's row segments of ``graph``, made at its first call."""
    key = id(graph)
    if key not in self._segments:
      self._segments[key] = kernel.row_segments(graph.row_end)
      weakref.finalize(graph, self._segments.pop, key, None)
    return self._segments[key]

  def supports(self, graph, msg, dst_prop, program):
    return isinstance(graph, graphlib.EllGraph)

  def eligible(self, graph, msg, dst_prop, program):
    # What the reference's _pallas_eligible takes: one message leaf of rank
    # <= 2, at most one destination-property leaf, an add/min/max reduce;
    # and a process the kernel runs: the program's process_op, or its
    # process_message traced at the call's dtypes and widths.
    if not isinstance(graph, graphlib.EllGraph):
      return False
    leaves = _tree.tree_leaves(msg)
    dp_leaves = _tree.tree_leaves(dst_prop) if program.process_reads_dst else []
    if len(leaves) != 1 or leaves[0].ndim > 2 or len(dp_leaves) > 1:
      return False
    dp = dp_leaves[0] if dp_leaves else None
    process = process_expr.for_program(program, leaves[0], graph.vals, dp)
    return (not isinstance(process, process_expr.Refused)
            and kernel.takes(leaves[0], graph.vals, process,
                             program.reduce_kind, dp))

  def execute(self, graph, msg, active, dst_prop, program, plan, with_recv):
    from repro_torch.kernels import ops as kops  # lazy: kernels import core
    y, recv = kops.spmv_ell_cuda(graph, msg, active, dst_prop, program,
                                 segments=self.segments(graph),
                                 **plan.kernel_kwargs())
    return y, (recv if with_recv else None)


base.register(CudaEllBackend())
