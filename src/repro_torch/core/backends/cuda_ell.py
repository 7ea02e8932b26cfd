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
    # One message leaf the kernel takes and a process_op; a form that reads
    # the destination property needs it as one leaf the kernel takes.
    leaves = _tree.tree_leaves(msg)
    dp_leaves = _tree.tree_leaves(dst_prop) if program.process_reads_dst else []
    return (isinstance(graph, graphlib.EllGraph)
            and program.process_op is not None and len(leaves) == 1
            and len(dp_leaves) <= 1
            and kernel.takes(leaves[0], graph.vals, program.process_op,
                             program.reduce_kind,
                             dp_leaves[0] if dp_leaves else None))

  def execute(self, graph, msg, active, dst_prop, program, plan, with_recv):
    from repro_torch.kernels import ops as kops  # lazy: kernels import core
    y, recv = kops.spmv_ell_cuda(graph, msg, active, dst_prop, program,
                                 segments=self.segments(graph),
                                 **plan.kernel_kwargs())
    return y, (recv if with_recv else None)


base.register(CudaEllBackend())
