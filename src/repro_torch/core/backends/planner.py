"""Partition-aware planner: graph statistics -> execution plan (port of
:mod:`repro.core.backends.planner`, heuristics unchanged).

  container   condition                                     -> plan
  ---------   -------------------------------------------   -------------
  DenseGraph  always                                        dense
  EllGraph    kernel-shape-eligible & slot eff >= floor     cuda_ell
  EllGraph    otherwise                                     ell
  CooGraph    scatter-fast monoid & hub ratio >= threshold  coo_tiled(T)
  CooGraph    otherwise                                     coo

with T = clamp(nnz / tile_edges, 2, max_tiles).  ``cuda_ell`` stands where
the reference plans ``pallas``.

Measured planning, as in the reference: :meth:`Planner.candidates` lists
the plans worth timing (for ``cuda_ell``: the kernel's default launch, other
warps per block and, for Q > 1, other query tiles), and
:meth:`Planner.autotune` times each on a short real run (CUDA-synchronized
on the card) and memoizes the winner by graph fingerprint.  A candidate is
skipped only for the port's own eligibility errors (``ValueError``,
``NotImplementedError``), raised before anything launches; a launch or
CUDA error propagates, since a faulted launch leaves the context unusable.
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import (Any, Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core import graph as graphlib
from repro_torch.core.backends.plan import Plan
from repro_torch.core.vertex_program import GraphProgram

_FAST_KINDS = ("add", "min", "max", "any", "all")
_KERNEL_KINDS = ("add", "min", "max")
# The ELL kernel's launch shapes worth timing beside its default (8 warps a
# block; a query tile of the largest divisor of Q up to 8): the warps a
# block in 1..32, the query tiles among Q's divisors up to 8.
_KERNEL_BLOCK_ROWS = (4, 16)
_KERNEL_MAX_QUERY_TILE = 8


@dataclasses.dataclass(frozen=True)
class GraphStats:
  """Host-side structural statistics driving plan selection."""

  container: str        # "dense" | "coo" | "ell"
  n: int                # vertices
  nnz: int              # real (unpadded) edges
  avg_degree: float     # nnz / n (in-degree mean)
  max_degree: int       # max in-degree
  degree_cv: float      # in-degree coefficient of variation (std / mean)
  hub_ratio: float      # max / mean in-degree — the skew signal
  density: float        # nnz / n²
  ell_width: int = 0            # ELL slot width (EllGraph only)
  ell_efficiency: float = 0.0   # packed nnz / (n_pad · width)
  spill_frac: float = 0.0       # fraction of edges in the COO spill


def _degree_stats(in_deg: np.ndarray):
  mean = float(in_deg.mean()) if in_deg.size else 0.0
  mx = int(in_deg.max(initial=0))
  cv = float(in_deg.std() / mean) if mean > 0 else 0.0
  hub = float(mx / mean) if mean > 0 else 1.0
  return mean, mx, cv, hub


def compute_stats(graph) -> GraphStats:
  """Measure a graph container (copies what it needs to the host)."""
  if isinstance(graph, graphlib.DenseGraph):
    in_deg = graph.struct.sum(dim=1).cpu().numpy()
    nnz = int(in_deg.sum())
    mean, mx, cv, hub = _degree_stats(in_deg)
    return GraphStats("dense", graph.n, nnz, mean, mx, cv, hub,
                      nnz / max(graph.n * graph.n, 1))
  if isinstance(graph, graphlib.CooGraph):
    nnz = int(graph.emask.sum())
    mean, mx, cv, hub = _degree_stats(graph.in_deg.cpu().numpy())
    return GraphStats("coo", graph.n, nnz, mean, mx, cv, hub,
                      nnz / max(graph.n * graph.n, 1))
  if isinstance(graph, graphlib.EllGraph):
    row_deg = graph.mask.sum(dim=1).cpu().numpy()
    packed = int(row_deg.sum())
    spill = 0 if graph.spill is None else int(graph.spill.emask.sum())
    nnz = packed + spill
    in_deg = row_deg[graph.row_of.cpu().numpy() < graph.n]
    mean, mx, cv, hub = _degree_stats(in_deg.astype(np.float64))
    return GraphStats(
        "ell", graph.n, nnz, nnz / max(graph.n, 1), mx, cv, hub,
        nnz / max(graph.n * graph.n, 1), ell_width=graph.width,
        ell_efficiency=packed / max(graph.mask.numel(), 1),
        spill_frac=spill / max(nnz, 1))
  raise TypeError(f"unknown graph container {type(graph)}")


def _kernel_shape_ok(program: Optional[GraphProgram], q: int = 1) -> bool:
  """Program-level approximation of the kernel's eligibility (the exact
  per-call check needs the payload; see CudaEllBackend.eligible): an
  add/min/max reduce, at most one payload axis, and a process the kernel
  runs, its ``process_op`` or its ``process_message`` traced at float32:
  in the lane form at ``q`` lanes when ``q`` > 1; at ``q`` = 1 in the
  scalar form or, where that is refused, in the lane form (a K-vector
  message, such as collaborative filtering's, which the reference's
  planner sends to Pallas too)."""
  if program is None:
    return False
  if not (program.reduce_kind in _KERNEL_KINDS
          and program.num_message_dims <= 1):
    return False
  if program.process_op is not None:
    return True
  from repro_torch.kernels import process_expr  # lazy: kernels import core
  forms = [dict(lane=True, k=q)] if q > 1 else [dict(lane=False),
                                                dict(lane=True)]
  return any(not isinstance(process_expr.trace(
      program.process_message, torch.float32,
      reads_dst=program.process_reads_dst, **form), process_expr.Refused)
             for form in forms)


class PlanCache:
  """Thread-safe memo of plans keyed by graph fingerprint (+ program name,
  query width).  Counts hits/misses."""

  def __init__(self):
    self._store: Dict[Hashable, Plan] = {}
    self._lock = threading.Lock()
    self.hits = 0
    self.misses = 0

  def get(self, key: Hashable) -> Optional[Plan]:
    with self._lock:
      if key in self._store:
        self.hits += 1
        return self._store[key]
      self.misses += 1
      return None

  def put(self, key: Hashable, plan: Plan) -> None:
    with self._lock:
      self._store[key] = plan

  def __len__(self) -> int:
    with self._lock:
      return len(self._store)

  def __contains__(self, key: Hashable) -> bool:
    with self._lock:
      return key in self._store


@dataclasses.dataclass
class Planner:
  """Picks execution plans from graph statistics (or by measurement).

  Attributes:
    skew_threshold: hub ratio (max/mean in-degree) above which the
      partitioned-COO backend's balanced edge tiles pay off.
    tile_edges: target edges per tile for coo_tiled.
    max_tiles: edge-tile cap.
    ell_efficiency_floor: minimum ELL slot fill for the kernel to beat the
      torch ELL path (below it the kernel mostly reduces padding).
    cache: memo of :meth:`autotune` winners, keyed by graph fingerprint.
    timings: each :meth:`autotune` measurement under its cache key: the
      candidates in order, with the median seconds of each, or None for
      one skipped as ineligible.
  """

  skew_threshold: float = 4.0
  tile_edges: int = 4096
  max_tiles: int = 64
  ell_efficiency_floor: float = 0.25
  cache: PlanCache = dataclasses.field(default_factory=PlanCache)
  timings: Dict[Hashable, List[Tuple[Plan, Optional[float]]]] = (
      dataclasses.field(default_factory=dict))

  def stats(self, graph) -> GraphStats:
    return compute_stats(graph)

  def _coo_tiles(self, stats: GraphStats) -> int:
    return max(2, min(self.max_tiles, -(-stats.nnz // self.tile_edges)))

  def plan(self, graph, program: Optional[GraphProgram] = None,
           q: int = 1) -> Plan:
    """Heuristic plan for running ``program`` (Q-wide) on ``graph``."""
    stats = self.stats(graph)
    if stats.container == "dense":
      return Plan(backend="dense")
    if stats.container == "ell":
      if (_kernel_shape_ok(program, q)
          and stats.ell_efficiency >= self.ell_efficiency_floor):
        return Plan(backend="cuda_ell")
      return Plan(backend="ell")
    fast = program is not None and program.reduce_kind in _FAST_KINDS
    if fast and stats.hub_ratio >= self.skew_threshold:
      return Plan(backend="coo_tiled", num_tiles=self._coo_tiles(stats))
    return Plan(backend="coo")

  def candidates(self, graph, program: Optional[GraphProgram] = None,
                 q: int = 1) -> List[Plan]:
    """Candidate plans worth timing for this (graph, program, Q)."""
    stats = self.stats(graph)
    if stats.container == "dense":
      return [Plan(backend="dense")]
    if stats.container == "ell":
      out = [Plan(backend="ell")]
      if _kernel_shape_ok(program, q):
        out.append(Plan(backend="cuda_ell"))
        out += [Plan(backend="cuda_ell", block_rows=br)
                for br in _KERNEL_BLOCK_ROWS]
        if q > 1:
          tiles = [bq for bq in range(1, min(q, _KERNEL_MAX_QUERY_TILE) + 1)
                   if q % bq == 0]
          out += [Plan(backend="cuda_ell", block_queries=bq)
                  for bq in tiles[:-1]]  # the largest is the default
      return out
    out = [Plan(backend="coo")]
    if program is None or program.reduce_kind in _FAST_KINDS:
      t = self._coo_tiles(stats)
      for nt in sorted({t, max(2, t // 4), min(self.max_tiles, t * 4)}):
        out.append(Plan(backend="coo_tiled", num_tiles=nt))
    return out

  def autotune(self, graph, program: GraphProgram, init_prop: Any,
               init_active: torch.Tensor, *, num_iters: int = 2,
               candidates: Optional[Sequence[Plan]] = None,
               repeats: int = 3,
               timer: Callable[[], float] = time.perf_counter) -> Plan:
    """Time candidate plans on a real (short) run; memoize the winner.

    ``init_prop``/``init_active`` seed the measured supersteps: ``bool[n]``
    runs ``run_fixed_iters``, ``bool[n, Q]`` runs ``run_batched``.  Each
    candidate runs once to warm up, then ``repeats`` times under ``timer``
    (with ``torch.cuda.synchronize()`` on both sides on the card); its
    time is the median.  Winners are memoized in :attr:`cache` under
    ``(graph fingerprint, program name, Q)``, so identical graph snapshots
    (content hash, not object identity) re-plan for free, and the
    measurements are kept in :attr:`timings` under the same key.
    """
    from repro_torch.service.cache import graph_fingerprint  # lazy: layering
    batched = init_active.ndim == 2
    q = int(init_active.shape[1]) if batched else 1
    key = (graph_fingerprint(graph), program.name, q)
    hit = self.cache.get(key)
    if hit is not None:
      return hit

    from repro_torch.core import engine  # lazy: engine imports this package
    cands = list(candidates) if candidates is not None else self.candidates(
        graph, program, q)
    on_card = init_active.device.type == "cuda"

    def run(plan: Plan):
      if batched:
        engine.run_batched(graph, program, init_prop, init_active,
                           max_iters=num_iters, backend=plan)
      else:
        engine.run_fixed_iters(graph, program, init_prop, init_active,
                               num_iters, backend=plan)
      if on_card:
        torch.cuda.synchronize()

    measured: List[Tuple[Plan, Optional[float]]] = []
    for plan in cands:
      try:
        run(plan)  # warm-up; ineligible plans refuse here, before a launch
      except (ValueError, NotImplementedError):
        measured.append((plan, None))
        continue
      times = []
      for _ in range(repeats):
        t0 = timer()
        run(plan)
        times.append(timer() - t0)
      measured.append((plan, statistics.median(times)))
    timed = [(t, i) for i, (_, t) in enumerate(measured) if t is not None]
    best = (measured[min(timed)[1]][0] if timed
            else self.plan(graph, program, q))
    self.timings[key] = measured
    self.cache.put(key, best)
    return best
