"""Partitioned-COO backend: equal-size edge tiles (the paper's "many more
partitions than threads").  Only the Planner or an explicit
``Plan(backend="coo_tiled", num_tiles=...)`` selects it."""

from __future__ import annotations

from repro_torch.core import graph as graphlib
from repro_torch.core import spmv as spmv_lib
from repro_torch.core.backends import base


class TiledCooBackend(base.Backend):
  name = "coo_tiled"
  container = "coo"
  priority = 70

  def supports(self, graph, msg, dst_prop, program):
    return (isinstance(graph, graphlib.CooGraph)
            and program.reduce_kind in spmv_lib._SCATTER_FAST)

  def eligible(self, graph, msg, dst_prop, program):
    return False  # profitability is a host-side Planner decision

  def execute(self, graph, msg, active, dst_prop, program, plan, with_recv):
    return spmv_lib.spmv_coo_tiled(graph, msg, active, dst_prop, program,
                                   num_tiles=plan.num_tiles,
                                   with_recv=with_recv)


base.register(TiledCooBackend())
