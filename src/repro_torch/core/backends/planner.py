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
the reference plans ``pallas``.  The measured planning of the reference
(``candidates`` and ``autotune``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Hashable, Optional

import numpy as np

from repro_torch.core import graph as graphlib
from repro_torch.core.backends.plan import Plan
from repro_torch.core.vertex_program import GraphProgram

_FAST_KINDS = ("add", "min", "max", "any", "all")
_KERNEL_KINDS = ("add", "min", "max")


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


def _kernel_shape_ok(program: Optional[GraphProgram]) -> bool:
  """Program-level approximation of the kernel's eligibility (the exact
  per-call check needs the payload; see CudaEllBackend.eligible)."""
  if program is None:
    return False
  return (program.reduce_kind in _KERNEL_KINDS
          and program.num_message_dims <= 1
          and program.process_op is not None)


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
  """Picks execution plans from graph statistics.

  Attributes:
    skew_threshold: hub ratio (max/mean in-degree) above which the
      partitioned-COO backend's balanced edge tiles pay off.
    tile_edges: target edges per tile for coo_tiled.
    max_tiles: edge-tile cap.
    ell_efficiency_floor: minimum ELL slot fill for the kernel to beat the
      torch ELL path (below it the kernel mostly reduces padding).
    cache: plan memo, keyed by graph fingerprint.
  """

  skew_threshold: float = 4.0
  tile_edges: int = 4096
  max_tiles: int = 64
  ell_efficiency_floor: float = 0.25
  cache: PlanCache = dataclasses.field(default_factory=PlanCache)

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
      if (_kernel_shape_ok(program)
          and stats.ell_efficiency >= self.ell_efficiency_floor):
        return Plan(backend="cuda_ell")
      return Plan(backend="ell")
    fast = program is not None and program.reduce_kind in _FAST_KINDS
    if fast and stats.hub_ratio >= self.skew_threshold:
      return Plan(backend="coo_tiled", num_tiles=self._coo_tiles(stats))
    return Plan(backend="coo")
