"""Dense-adjacency backend: the O(n²) masked oracle (tests/small graphs)."""

from __future__ import annotations

from repro_torch.core import graph as graphlib
from repro_torch.core import spmv as spmv_lib
from repro_torch.core.backends import base


class DenseBackend(base.Backend):
  name = "dense"
  container = "dense"
  priority = 100  # a DenseGraph container always routes here

  def supports(self, graph, msg, dst_prop, program):
    return isinstance(graph, graphlib.DenseGraph)

  def execute(self, graph, msg, active, dst_prop, program, plan, with_recv):
    y, recv = spmv_lib.spmv_dense(graph.vals, graph.struct, msg, active,
                                  dst_prop, program)
    return y, (recv if with_recv else None)


base.register(DenseBackend())
