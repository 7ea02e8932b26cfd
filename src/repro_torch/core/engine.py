"""The GraphMat superstep engine (port of :mod:`repro.core.engine`).

SEND_MESSAGE over the active set -> generalized SpMV -> APPLY -> next
active set = vertices whose property changed.

The reference runs the loop as one ``jax.lax.while_loop``.  Here
:func:`run_graph_program` is a host loop whose ``num_active > 0`` check
reads one number from the device per superstep, and
:func:`run_batched_rounds` runs a fixed number of supersteps with no host
read inside, so that it can later be captured as a CUDA graph.  Counters are
int32 (a torch sum of bools would be int64).  Each superstep and each host
read is a profiler span (:mod:`repro_torch.tracing`).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import _tree, tracing
from repro_torch.core import spmv as spmv_lib
from repro_torch.core.backends.plan import AUTO_PLAN, Plan, PlanLike, as_plan
from repro_torch.core.vertex_program import GraphProgram

PyTree = Any


def _count(mask: torch.Tensor, dim=None) -> torch.Tensor:
  return mask.sum(dim=dim, dtype=torch.int32)


class EngineState(NamedTuple):
  prop: PyTree                # vertex properties, leaves [n, ...]
  active: torch.Tensor        # bool[n] frontier
  iteration: torch.Tensor     # int32 scalar
  num_active: torch.Tensor    # int32 scalar


def _superstep(graph, program: GraphProgram, state: EngineState,
               plan: Plan) -> EngineState:
  msg = program.send_message(state.prop)
  y, recv = spmv_lib.spmv(graph, msg, state.active, state.prop, program,
                          backend=plan, with_recv=program.needs_recv)
  new_prop = program.apply(y, state.prop)
  if program.needs_recv:
    new_prop = spmv_lib._tree_where(recv, new_prop, state.prop)
    changed = recv & program.activate(state.prop, new_prop)
  else:
    changed = program.activate(state.prop, new_prop)
  return EngineState(new_prop, changed, state.iteration + 1, _count(changed))


def _any_active(state: EngineState) -> bool:
  """The host's read of the frontier's count, once a superstep."""
  with tracing.span(tracing.HOST_READ):
    return int(state.num_active) > 0


def run_graph_program(graph, program: GraphProgram, init_prop: PyTree,
                      init_active: torch.Tensor, *,
                      max_iters: int = 0x7FFFFFF0,
                      backend: PlanLike = AUTO_PLAN) -> EngineState:
  """Run ``program`` until the frontier empties or ``max_iters`` supersteps
  have run (the paper's Algorithm 2).  One device read per superstep."""
  plan = as_plan(backend)
  dev = init_active.device
  state = EngineState(init_prop, init_active,
                      torch.zeros((), dtype=torch.int32, device=dev),
                      _count(init_active))
  it = 0
  while it < max_iters and _any_active(state):
    with tracing.span(tracing.SUPERSTEP):
      state = _superstep(graph, program, state, plan)
    it += 1
  return state


def run_fixed_iters(graph, program: GraphProgram, init_prop: PyTree,
                    init_active: torch.Tensor, num_iters: int,
                    backend: PlanLike = AUTO_PLAN,
                    keep_all_active: bool = True) -> EngineState:
  """Fixed-iteration variant (PageRank style); ``keep_all_active`` re-arms
  the full frontier each superstep."""
  plan = as_plan(backend)
  dev = init_active.device
  state = EngineState(init_prop, init_active,
                      torch.zeros((), dtype=torch.int32, device=dev),
                      _count(init_active))
  all_active = torch.ones_like(init_active)
  num_all = _count(all_active)
  for _ in range(num_iters):
    with tracing.span(tracing.SUPERSTEP):
      state = _superstep(graph, program, state, plan)
    if keep_all_active:
      state = state._replace(active=all_active, num_active=num_all)
  return state


# ---------------------------------------------------------------------------
# Batched multi-query engine (SpMV -> SpMM)
# ---------------------------------------------------------------------------
#
# Q queries of one program run as one loop: leaves grow a query axis at
# dim 1 ([n, Q, ...]), the frontier is bool[n, Q], inactive lanes send the
# program's inert message, and the backend's bitvector is the column-OR.
# done[q] latches once query q's frontier empties.


class BatchedEngineState(NamedTuple):
  prop: PyTree                # leaves [n, Q, ...]
  active: torch.Tensor        # bool[n, Q] per-query frontier
  iteration: torch.Tensor     # int32 scalar (global superstep count)
  done: torch.Tensor          # bool[Q] latched per-column convergence
  num_active: torch.Tensor    # int32[Q] frontier population per query
  iters: torch.Tensor         # int32[Q] supersteps each query has been live


def init_batched_state(init_prop: PyTree, init_active: torch.Tensor
                       ) -> BatchedEngineState:
  """Step-0 batched state from ``[n, Q]``-shaped init values."""
  num_active = _count(init_active, 0)
  dev = init_active.device
  return BatchedEngineState(
      prop=init_prop,
      active=init_active,
      iteration=torch.zeros((), dtype=torch.int32, device=dev),
      done=num_active == 0,
      num_active=num_active,
      iters=torch.zeros((init_active.shape[1],), dtype=torch.int32,
                        device=dev))


def _batched_superstep(graph, program: GraphProgram,
                       state: BatchedEngineState,
                       plan: Plan) -> BatchedEngineState:
  live = ~state.done
  msg = program.send_message(state.prop)              # leaves [n, Q, ...]
  lane_mask = state.active & live[None, :]
  msg = spmv_lib.mask_inert(msg, lane_mask, program)
  vert_active = lane_mask.any(dim=1)                  # bool[n] bitvector
  y, recv = spmv_lib.spmv(graph, msg, vert_active, state.prop, program,
                          backend=plan, with_recv=program.needs_recv)
  new_prop = program.apply(y, state.prop)
  if program.needs_recv:
    # recv is per vertex; per-lane correctness rests on the inert message.
    new_prop = spmv_lib._tree_where(recv, new_prop, state.prop)
    changed = recv[:, None] & program.activate(state.prop, new_prop)
  else:
    changed = program.activate(state.prop, new_prop)
  changed = changed & live[None, :]                   # retired stay dead
  num_active = _count(changed, 0)
  return BatchedEngineState(
      prop=new_prop,
      active=changed,
      iteration=state.iteration + 1,
      done=state.done | (num_active == 0),
      num_active=num_active,
      iters=state.iters + live.to(torch.int32))


def _all_done(state: BatchedEngineState) -> bool:
  """The host's read of every column's ``done``, once a superstep."""
  with tracing.span(tracing.HOST_READ):
    return bool(state.done.all())


def run_batched(graph, program: GraphProgram, init_prop: PyTree,
                init_active: torch.Tensor, *, max_iters: int = 0x7FFFFFF0,
                backend: PlanLike = AUTO_PLAN) -> BatchedEngineState:
  """Run Q batched queries until every column converges (one device read
  per superstep).  The program needs an ``inert_message`` and a
  query-axis-preserving ``activate``."""
  plan = as_plan(backend)
  state = init_batched_state(init_prop, init_active)
  it = 0
  while it < max_iters and not _all_done(state):
    with tracing.span(tracing.SUPERSTEP):
      state = _batched_superstep(graph, program, state, plan)
    it += 1
  return state


def mask_columns(state: BatchedEngineState, slots) -> BatchedEngineState:
  """Hard-retire the given columns: clear their frontier and latch
  ``done``.  Lane independence keeps the surviving columns bitwise
  unchanged.  ``slots``: int sequence or int tensor of slot indices."""
  idx = torch.as_tensor(slots, dtype=torch.int64, device=state.done.device)
  active = state.active.clone()
  active[:, idx] = False
  done = state.done.clone()
  done[idx] = True
  num_active = state.num_active.clone()
  num_active[idx] = 0
  return state._replace(active=active, done=done, num_active=num_active)


def run_batched_rounds(graph, program: GraphProgram,
                       state: BatchedEngineState, num_steps: int,
                       backend: PlanLike = AUTO_PLAN
                       ) -> Tuple[BatchedEngineState, torch.Tensor]:
  """Advance the batched engine by ``num_steps`` supersteps.

  A step where every column is already done leaves the state as it was
  (a select on the device, not a host branch).  Returns ``(state, trace)``
  with ``trace[t]`` the int32 total frontier population after step t, or
  -1 for a step that changed nothing.
  """
  plan = as_plan(backend)
  trace = torch.full((num_steps,), -1, dtype=torch.int32,
                     device=state.done.device)
  for t in range(num_steps):
    any_live = ~state.done.all()
    with tracing.span(tracing.SUPERSTEP):
      s2 = _batched_superstep(graph, program, state, plan)
    state = _tree.tree_map(lambda a, b: torch.where(any_live, a, b),
                           s2, state)
    trace[t] = torch.where(any_live, state.num_active.sum(dtype=torch.int32),
                           -1)
  return state, trace
