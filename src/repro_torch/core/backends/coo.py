"""COO backend: gather + scatter reduce over the dst-sorted edge list."""

from __future__ import annotations

from repro_torch.core import graph as graphlib
from repro_torch.core import spmv as spmv_lib
from repro_torch.core.backends import base


class CooBackend(base.Backend):
  name = "coo"
  container = "coo"
  priority = 60  # the CooGraph default

  def supports(self, graph, msg, dst_prop, program):
    return isinstance(graph, graphlib.CooGraph)

  def execute(self, graph, msg, active, dst_prop, program, plan, with_recv):
    return spmv_lib.spmv_coo(graph, msg, active, dst_prop, program,
                             with_recv=with_recv)


base.register(CooBackend())
