"""Backend protocol + registry (port of :mod:`repro.core.backends.base`).

A backend is one strategy for the generalized SpMV ``y[v] = ⊕ process(msg[u],
w_uv, prop[v])``.  The built-ins (dense / coo / coo_tiled / ell / cuda_ell)
register themselves when :mod:`repro_torch.core.backends` is imported.

:func:`resolve` keeps the reference's semantics: an explicit plan naming a
backend that cannot execute the call falls back to structural
auto-selection, and the graph container dominates.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core.backends.plan import Plan
from repro_torch.core.vertex_program import GraphProgram

PyTree = Any


class Backend:
  """One generalized-SpMV execution strategy.

  Class attributes:
    name: registry key (also the legacy string spelling).
    container: preferred graph container — ``"dense" | "coo" | "ell"``.
    priority: structural-auto tie-break; higher is tried first.
    span: the profiler range around :meth:`execute`
      (``graphmat.spmv.<name>``), set by :func:`register`.
  """

  name: str = "?"
  container: str = "coo"
  priority: int = 0
  span: str

  def supports(self, graph, msg: PyTree, dst_prop: PyTree,
               program: GraphProgram) -> bool:
    """Hard capability: can this backend execute this call at all?"""
    raise NotImplementedError

  def eligible(self, graph, msg: PyTree, dst_prop: PyTree,
               program: GraphProgram) -> bool:
    """Should structural auto-selection pick this backend?"""
    return self.supports(graph, msg, dst_prop, program)

  def execute(self, graph, msg: PyTree, active: torch.Tensor,
              dst_prop: PyTree, program: GraphProgram, plan: Plan,
              with_recv: bool) -> Tuple[PyTree, Optional[torch.Tensor]]:
    """Run the generalized SpMV with this backend's plan parameters."""
    raise NotImplementedError

  def __repr__(self) -> str:
    return f"<{type(self).__name__} {self.name!r}>"


_REGISTRY: Dict[str, Backend] = {}


def register(backend: Backend, *, replace: bool = False) -> Backend:
  """Add a backend to the registry (the extension point)."""
  if not backend.name or backend.name == "auto":
    raise ValueError(f"invalid backend name {backend.name!r}")
  if backend.name in _REGISTRY and not replace:
    raise ValueError(
        f"backend {backend.name!r} already registered (pass replace=True)")
  backend.span = tracing.SPMV + backend.name
  _REGISTRY[backend.name] = backend
  return backend


def unregister(name: str) -> None:
  _REGISTRY.pop(name, None)


def get_backend(name: str) -> Backend:
  try:
    return _REGISTRY[name]
  except KeyError:
    raise KeyError(
        f"no backend {name!r} registered; have {registered_backends()}"
        ) from None


def registered_backends() -> Tuple[str, ...]:
  """Registered backend names, highest structural priority first."""
  return tuple(sorted(_REGISTRY, key=lambda k: -_REGISTRY[k].priority))


def resolve(plan: Plan, graph, msg: PyTree, dst_prop: PyTree,
            program: GraphProgram) -> Backend:
  """Pick the backend executing this call (explicit if it supports the
  call, else the highest-priority eligible backend)."""
  if not plan.is_auto:
    impl = get_backend(plan.backend)
    if impl.supports(graph, msg, dst_prop, program):
      return impl
  for name in registered_backends():
    impl = _REGISTRY[name]
    if impl.eligible(graph, msg, dst_prop, program):
      return impl
  raise TypeError(
      f"no registered backend supports graph container {type(graph).__name__}"
      f" with program {program.name!r} (registered: {registered_backends()})")
