"""Betweenness centrality by Brandes' algorithm, approximated from a few
sources as GAP's BC kernel does (Beamer, Asanović and Patterson, The GAP
Benchmark Suite, arXiv:1508.03619; its reference code ``bc.cc``), as two
GraphMat vertex programs over Q batched source lanes and a sweep over the
stored BFS levels.  Run on a symmetrized graph.

* Forward (:func:`forward`): a batched BFS that counts shortest paths.
  Properties ``depth`` (int32, -1 where unreached) and ``sigma`` (float64,
  GAP's ``CountT``); the message is sigma, summed (the ELL and COO
  kernels' float64 pass-through instances); a vertex still unreached whose
  sum is positive takes the sum as its sigma and the frontier's level plus
  one as its depth.  It runs on ``run_batched`` (one host read a
  superstep); then one host read gives the deepest level.
* Backward (:func:`backward`): ``run_level_sweep`` from the deepest level
  up.  A vertex w at level d sends ``(1 + delta_w) / sigma_w`` in float32
  (GAP's ``ScoreT``), summed; a vertex v at level d - 1 takes ``delta_v =
  sigma_v * sum``.  The sweep reaches the sources' own level, so each
  source's own dependency counts, as in ``bc.cc``, whose backward loop runs
  down to depth 0.
* Finish (:func:`normalized`): each vertex's dependencies summed over the
  lanes and divided by the largest sum, as ``bc.cc`` normalizes its scores.

:data:`supersteps` counts the forward and backward supersteps run (the
benchmark reads them); each pass is a profiler span
(``graphmat.algos.bc.forward``, ``graphmat.algos.bc.backward``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import tracing
from repro_torch.algos.multi import _seed_columns, _sources
from repro_torch.core.backends.plan import PlanLike
from repro_torch.core.engine import run_batched, run_level_sweep
from repro_torch.core.vertex_program import GraphProgram, lanewise_activate

UNREACHED = -1

# Supersteps run by the forward and backward passes, since the process
# started.
supersteps: Dict[str, int] = {"forward": 0, "backward": 0}


def _reach(red: torch.Tensor, old: dict) -> dict:
  """A vertex still unreached in a lane whose sum is positive takes it as
  its sigma, and as its depth the lane's deepest level so far plus one
  (the frontier's level: the BFS is level-synchronous)."""
  depth, sigma = old["depth"], old["sigma"]
  new = (depth == UNREACHED) & (red > 0)
  level = depth.amax(0, keepdim=True) + 1
  return {"depth": torch.where(new, level, depth),
          "sigma": torch.where(new, red, sigma)}


def forward_program() -> GraphProgram:
  """The path-counting BFS over ``{"depth", "sigma"}`` leaves ``[n, Q]``."""
  return GraphProgram(
      reduce_kind="add",
      send_message=lambda prop: prop["sigma"],
      apply=_reach,
      activate=lambda old, new: old["depth"] != new["depth"],
      needs_recv=False,  # an inert lane sums to 0 and reaches nothing
      inert_message=0.0,
      lanewise=True,
      name="bc_forward",
      process_op="msg")


def backward_program(sigma: torch.Tensor) -> GraphProgram:
  """The dependency sweep's program over ``delta`` float32 ``[n, Q]``, for
  the forward pass's ``sigma``."""
  return GraphProgram(
      reduce_kind="add",
      send_message=lambda delta: ((1 + delta).double() / sigma).float(),
      apply=lambda red, delta: (sigma * red).float(),
      activate=lanewise_activate,
      needs_recv=False,  # a vertex with no successor keeps delta = 0
      inert_message=0.0,
      lanewise=True,
      name="bc_backward",
      process_op="msg")


def forward(graph, sources, n: int, *, backend: PlanLike = "auto"
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
  """``(depth int32 [n, Q], sigma float64 [n, Q], deepest level)`` of the
  BFS from each of ``sources`` (int[Q])."""
  with tracing.span(tracing.BC_FORWARD):
    src = _sources(sources, graph)
    depth, active = _seed_columns(src, n, UNREACHED, 0, torch.int32)
    sigma, _ = _seed_columns(src, n, 0.0, 1.0, torch.float64)
    state = run_batched(graph, forward_program(),
                        {"depth": depth, "sigma": sigma}, active,
                        backend=backend)
    with tracing.span(tracing.HOST_READ):
      deepest, steps = torch.stack(
          [state.prop["depth"].max(), state.iteration]).tolist()
  supersteps["forward"] += steps
  return state.prop["depth"], state.prop["sigma"], deepest


def backward(graph, depth: torch.Tensor, sigma: torch.Tensor, deepest: int,
             *, backend: PlanLike = "auto") -> torch.Tensor:
  """Each vertex's dependency ``delta`` float32 ``[n, Q]`` on each lane's
  source, from the forward pass's levels and path counts."""
  with tracing.span(tracing.BC_BACKWARD):
    delta = run_level_sweep(graph, backward_program(sigma),
                            torch.zeros(depth.shape, dtype=torch.float32,
                                        device=depth.device),
                            depth, deepest, backend=backend)
  supersteps["backward"] += deepest
  return delta


def normalized(delta: torch.Tensor) -> torch.Tensor:
  """Scores float32 ``[n]``: the dependencies summed over the lanes,
  divided by the largest sum."""
  scores = delta.sum(1)
  return scores / scores.max()


def betweenness(graph, sources, n: int, *, backend: PlanLike = "auto"
                ) -> torch.Tensor:
  """GAP's approximate betweenness centrality from ``sources`` (int[Q],
  one batched lane each): float32 scores ``[n]``, normalized as ``bc.cc``
  normalizes them."""
  depth, sigma, deepest = forward(graph, sources, n, backend=backend)
  return normalized(backward(graph, depth, sigma, deepest, backend=backend))
