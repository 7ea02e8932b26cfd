"""Breadth-First Search (port of :mod:`repro.algos.bfs`).

Message = current distance; PROCESS = msg + 1; REDUCE = min; APPLY = min
with current.  Run on a symmetrized graph (the paper's prep).
"""

from __future__ import annotations

import torch

from repro_torch.core.backends.plan import PlanLike
from repro_torch.core.engine import run_graph_program
from repro_torch.core.vertex_program import GraphProgram

UNREACHED = 0x7FFFFFF0


def bfs_program() -> GraphProgram:
  return GraphProgram(
      reduce_kind="min",
      apply=torch.minimum,
      needs_recv=False,  # min-relaxation is monotone: APPLY(∞, old) == old
      # UNREACHED + 1 still loses every min against a real distance.
      inert_message=UNREACHED,
      lanewise=True,
      name="bfs",
      process_op="msg_plus_one")


def bfs(graph, root: int, n: int, *, backend: PlanLike = "auto",
        max_iters: int = 0x7FFFFFF0) -> torch.Tensor:
  """int32 hop distances [n] (UNREACHED where unreachable), on the graph's
  device."""
  dev = graph.device
  dist0 = torch.full((n,), UNREACHED, dtype=torch.int32, device=dev)
  dist0[root] = 0
  active0 = torch.zeros((n,), dtype=torch.bool, device=dev)
  active0[root] = True
  state = run_graph_program(graph, bfs_program(), dist0, active0,
                            max_iters=max_iters, backend=backend)
  return state.prop
