"""Single-Source Shortest Path (port of :mod:`repro.algos.sssp`).

Frontier-driven Bellman-Ford: message = distance; PROCESS = msg + w(u,v);
REDUCE = min; APPLY = min with current.
"""

from __future__ import annotations

import torch

from repro_torch.core.backends.plan import PlanLike
from repro_torch.core.engine import run_graph_program
from repro_torch.core.vertex_program import GraphProgram

INF = float("inf")


def sssp_program() -> GraphProgram:
  return GraphProgram(
      reduce_kind="min",
      apply=torch.minimum,
      needs_recv=False,  # min-relaxation is monotone: APPLY(∞, old) == old
      inert_message=INF,  # ∞ + w == ∞: the min-plus annihilator
      lanewise=True,
      name="sssp",
      process_op="msg_plus_edge")


def sssp(graph, source: int, n: int, *, backend: PlanLike = "auto",
         max_iters: int = 0x7FFFFFF0) -> torch.Tensor:
  """float32 distances [n] (inf where unreachable), on the graph's device."""
  dev = graph.device
  dist0 = torch.full((n,), INF, dtype=torch.float32, device=dev)
  dist0[source] = 0.0
  active0 = torch.zeros((n,), dtype=torch.bool, device=dev)
  active0[source] = True
  state = run_graph_program(graph, sssp_program(), dist0, active0,
                            max_iters=max_iters, backend=backend)
  return state.prop
