"""Multi-query entry points: batched vertex programs (SpMV -> SpMM), port of
:mod:`repro.algos.multi`.

Q queries of one program run as one engine loop — frontier ``bool[n, Q]``,
properties ``[n, Q]`` — so each gathered edge serves all Q lanes.  Each
column converges on its own and equals a single-query run bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import _tree
from repro_torch.algos.bfs import UNREACHED, bfs_program
from repro_torch.algos.pagerank import delta_pagerank_program
from repro_torch.algos.sssp import INF, sssp_program
from repro_torch.core.backends.plan import PlanLike
from repro_torch.core.engine import run_batched
from repro_torch.core.vertex_program import GraphProgram, lanewise_activate


def multi_bfs_program() -> GraphProgram:
  return dataclasses.replace(bfs_program(), activate=lanewise_activate,
                             name="multi_bfs")


def multi_sssp_program() -> GraphProgram:
  return dataclasses.replace(sssp_program(), activate=lanewise_activate,
                             name="multi_sssp")


def _seed_columns(sources: torch.Tensor, n: int, fill, value, dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  q = sources.shape[0]
  lanes = torch.arange(q, device=sources.device)
  col = torch.full((n, q), fill, dtype=dtype, device=sources.device)
  col[sources, lanes] = value
  active = torch.zeros((n, q), dtype=torch.bool, device=sources.device)
  active[sources, lanes] = True
  return col, active


def bfs_columns(sources: torch.Tensor, n: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(dist0 [n, Q], active0 [n, Q]) for a batch of BFS sources."""
  return _seed_columns(sources.long(), n, UNREACHED, 0, torch.int32)


def sssp_columns(sources: torch.Tensor, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
  return _seed_columns(sources.long(), n, INF, 0.0, torch.float32)


def ppr_columns(sources: torch.Tensor, out_deg: torch.Tensor, r: float
                ) -> Tuple[dict, torch.Tensor]:
  """Delta-PPR init: rank₀ = Δ₀ = r at the personalization vertex."""
  n = out_deg.shape[0]
  seed, active0 = _seed_columns(sources.long().to(out_deg.device), n, 0.0, r,
                                torch.float32)
  q = seed.shape[1]
  deg = out_deg.to(torch.float32)[:, None].expand(n, q).contiguous()
  return {"rank": seed, "delta": seed.clone(), "deg": deg}, active0


def _one(source: int, device) -> torch.Tensor:
  return torch.tensor([source], dtype=torch.int64, device=device)


def bfs_column(source: int, n: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Single-query BFS init (the Q=1 slice of :func:`bfs_columns`)."""
  dist0, active0 = bfs_columns(_one(source, device), n)
  return dist0[:, 0], active0[:, 0]


def sssp_column(source: int, n: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  dist0, active0 = sssp_columns(_one(source, device), n)
  return dist0[:, 0], active0[:, 0]


def ppr_column(source: int, out_deg: torch.Tensor, r: float
               ) -> Tuple[dict, torch.Tensor]:
  prop, active0 = ppr_columns(_one(source, out_deg.device), out_deg, r)
  return _tree.tree_map(lambda x: x[:, 0], prop), active0[:, 0]


def _sources(sources, graph) -> torch.Tensor:
  return torch.as_tensor(sources, dtype=torch.int64).to(graph.device)


def multi_bfs(graph, sources, n: int, *, backend: PlanLike = "auto",
              max_iters: int = 0x7FFFFFF0) -> torch.Tensor:
  """Batched BFS from ``sources`` (int[Q]); int32 hops [n, Q]."""
  dist0, active0 = bfs_columns(_sources(sources, graph), n)
  return run_batched(graph, multi_bfs_program(), dist0, active0,
                     max_iters=max_iters, backend=backend).prop


def multi_sssp(graph, sources, n: int, *, backend: PlanLike = "auto",
               max_iters: int = 0x7FFFFFF0) -> torch.Tensor:
  """Batched SSSP from ``sources`` (int[Q]); float32 distances [n, Q]."""
  dist0, active0 = sssp_columns(_sources(sources, graph), n)
  return run_batched(graph, multi_sssp_program(), dist0, active0,
                     max_iters=max_iters, backend=backend).prop


def personalized_pagerank(graph, out_deg: torch.Tensor, sources, *,
                          r: float = 0.15, tol: float = 1e-6,
                          max_iters: int = 100,
                          backend: PlanLike = "auto") -> torch.Tensor:
  """Batched personalized PageRank by delta propagation; ranks [n, Q]."""
  prop, active0 = ppr_columns(_sources(sources, graph),
                              out_deg.to(graph.device), r)
  prog = delta_pagerank_program(r=r, tol=tol)
  return run_batched(graph, prog, prop, active0, max_iters=max_iters,
                     backend=backend).prop["rank"]
