"""CUDA ELL backend: the hand-written Hopper kernel for the packed rows.

It takes the place of the JAX package's ``pallas`` backend, with the same
priority and semantics: it ``supports`` any :class:`EllGraph` (an explicit
plan always routes here, and the shape restrictions raise inside
:mod:`repro_torch.kernels.ops`), and structural auto picks it only where the
kernel can run the call.  The plan's ``block_rows`` / ``block_queries``
override the kernel's launch shape.
"""

from __future__ import annotations

from repro_torch import _tree
from repro_torch.core import graph as graphlib
from repro_torch.core.backends import base
from repro_torch.kernels import ell_spmv as kernel


class CudaEllBackend(base.Backend):
  name = "cuda_ell"
  container = "ell"
  priority = 90  # preferred over torch-ELL when the program shape qualifies

  def supports(self, graph, msg, dst_prop, program):
    return isinstance(graph, graphlib.EllGraph)

  def eligible(self, graph, msg, dst_prop, program):
    # One message leaf the kernel takes and a process_op (whose form reads
    # no destination property: that kernel path is not ported yet).
    leaves = _tree.tree_leaves(msg)
    return (isinstance(graph, graphlib.EllGraph)
            and program.process_op is not None and len(leaves) == 1
            and kernel.takes(leaves[0], graph.vals, program.process_op,
                             program.reduce_kind))

  def execute(self, graph, msg, active, dst_prop, program, plan, with_recv):
    from repro_torch.kernels import ops as kops  # lazy: kernels import core
    y, recv = kops.spmv_ell_cuda(graph, msg, active, dst_prop, program,
                                 **plan.kernel_kwargs())
    return y, (recv if with_recv else None)


base.register(CudaEllBackend())
