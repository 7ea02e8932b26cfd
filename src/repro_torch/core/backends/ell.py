"""ELL backend: degree-sorted packed rows in plain torch (+ COO spill)."""

from __future__ import annotations

from repro_torch.core import graph as graphlib
from repro_torch.core import spmv as spmv_lib
from repro_torch.core.backends import base


class EllBackend(base.Backend):
  name = "ell"
  container = "ell"
  priority = 80  # EllGraph fallback when the kernel is ineligible

  def supports(self, graph, msg, dst_prop, program):
    return isinstance(graph, graphlib.EllGraph)

  def execute(self, graph, msg, active, dst_prop, program, plan, with_recv):
    return spmv_lib.spmv_ell(graph, msg, active, dst_prop, program,
                             with_recv=with_recv)


base.register(EllBackend())
