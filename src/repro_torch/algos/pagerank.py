"""PageRank (port of :mod:`repro.algos.pagerank`).

    PR_{t+1}(v) = r + (1-r) * Σ_{(u,v)∈E} PR_t(u) / degree(u)

Vertex property = (rank, out_degree); message = rank/degree; PROCESS =
pass the message through; REDUCE = +; APPLY = damped update.  ``tol > 0``
runs delta-PageRank with a tolerance frontier instead.
"""

from __future__ import annotations

import torch

from repro_torch.core.backends.plan import PlanLike
from repro_torch.core.engine import run_fixed_iters, run_graph_program
from repro_torch.core.vertex_program import GraphProgram


def pagerank_program(r: float = 0.15) -> GraphProgram:
  """Paper-faithful PR: fixed sweeps, every vertex broadcasts rank/degree."""
  def send(prop):
    return prop["rank"] / torch.clamp(prop["deg"], min=1.0)

  def apply(red, prop):
    return {"rank": r + (1.0 - r) * red, "deg": prop["deg"]}

  return GraphProgram(
      reduce_kind="add",
      send_message=send,
      apply=apply,
      inert_message=0.0,  # a zero rank contribution is the add-annihilator
      lanewise=True,
      name="pagerank",
      process_op="msg")


def delta_pagerank_program(r: float = 0.15, tol: float = 1e-6
                           ) -> GraphProgram:
  """Frontier-friendly delta PageRank: Δ_{t+1}(v) = (1-r)·Σ_u Δ_t(u)/deg(u);
  rank += Δ; active iff |Δ| > tol."""
  def send(prop):
    return prop["delta"] / torch.clamp(prop["deg"], min=1.0)

  def apply(red, prop):
    nd = (1.0 - r) * red
    return {"rank": prop["rank"] + nd, "delta": nd, "deg": prop["deg"]}

  def activate(old, new):
    return new["delta"].abs() > tol

  return GraphProgram(
      reduce_kind="add",
      send_message=send,
      apply=apply,
      activate=activate,  # |Δ| > tol is already per lane: batched-ready
      inert_message=0.0,
      lanewise=True,
      name="delta_pagerank",
      process_op="msg")


def init_prop(out_deg: torch.Tensor) -> dict:
  n = out_deg.shape[0]
  return {"rank": torch.ones((n,), dtype=torch.float32,
                             device=out_deg.device),
          "deg": out_deg.to(torch.float32)}


def pagerank(graph, out_deg: torch.Tensor, *, num_iters: int = 20,
             r: float = 0.15, tol: float = 0.0,
             backend: PlanLike = "auto") -> torch.Tensor:
  """Final ranks [n].  ``tol=0``: the paper's fixed sweeps (init rank 1.0);
  ``tol>0``: delta-PageRank (init rank r)."""
  out_deg = out_deg.to(graph.device)
  n = out_deg.shape[0]
  active = torch.ones((n,), dtype=torch.bool, device=graph.device)
  if tol > 0.0:
    prog = delta_pagerank_program(r=r, tol=tol)
    full_r = torch.full((n,), r, dtype=torch.float32, device=graph.device)
    prop = {"rank": full_r, "delta": full_r.clone(),
            "deg": out_deg.to(torch.float32)}
    state = run_graph_program(graph, prog, prop, active,
                              max_iters=num_iters, backend=backend)
  else:
    state = run_fixed_iters(graph, pagerank_program(r=r),
                            init_prop(out_deg), active, num_iters,
                            backend=backend)
  return state.prop["rank"]
