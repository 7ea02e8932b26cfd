"""Execution plans: the static description of *how* an SpMV runs.

A copy of :mod:`repro.core.backends.plan` for the PyTorch port.

A :class:`Plan` replaces the stringly-typed ``backend="coo"`` kwarg that used
to thread through every layer.  It is a frozen, hashable dataclass that
also carries the partition/tile parameters (edge-tile count for the
partitioned-COO backend, the ELL kernel's ``(block_rows, block_queries)``)
that the string could never express.

Plans are produced three ways:

* ``Plan(backend="ell")`` — explicit, programmatic.
* :meth:`Plan.from_string` / :func:`as_plan` — the *coercion shim* for the
  legacy string spelling.  ``backend="coo"`` call sites keep working; this is
  the single place strings are interpreted (and the single deprecation
  warning path).
* :class:`repro_torch.core.backends.planner.Planner` — computed from graph
  statistics (degree skew, ELL slot efficiency, query width).

``backend="auto"`` defers the choice to dispatch time, where the registry
picks structurally (see :func:`repro_torch.core.backends.base.resolve`).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

# One warning per process for the legacy string spelling (the "single warning
# path" — kept quiet on "auto", which is the documented default sentinel).
_warned_string_coercion = False


@dataclasses.dataclass(frozen=True)
class Plan:
  """How to execute generalized SpMV: backend id + partition/tile parameters.

  Attributes:
    backend: registered backend name, or ``"auto"`` (structural dispatch).
    num_tiles: edge-tile count for the partitioned-COO backend (the paper's
      "many more partitions than threads" load-balancing knob; tiles are
      equal-size contiguous chunks of the dst-sorted edge array).
    block_rows / block_slots / block_queries: ELL kernel tile overrides
      (``None`` = the wrapper's defaults).  The CUDA kernel reads
      ``block_rows`` as packed rows per thread block and ``block_queries``
      as its query tile; it has no slot tiling.
    direction: message-flow hint.  Only ``"pull"`` (paper's y = Aᵀ ⊗ x) is
      implemented today; recorded so push/pull direction optimization has a
      home in the plan, not in another kwarg.

  Hashable and comparable by value, so it is a valid dict key (the planner's plan-cache values are Plans).
  """

  backend: str = "auto"
  num_tiles: Optional[int] = None
  block_rows: Optional[int] = None
  block_slots: Optional[int] = None
  block_queries: Optional[int] = None
  direction: str = "pull"

  def __post_init__(self):
    if self.direction != "pull":
      raise ValueError(
          f"direction={self.direction!r}: only 'pull' is implemented")
    for field in ("num_tiles", "block_rows", "block_slots", "block_queries"):
      v = getattr(self, field)
      if v is not None and v < 1:
        raise ValueError(f"{field}={v} must be >= 1")

  @property
  def is_auto(self) -> bool:
    return self.backend == "auto"

  def kernel_kwargs(self) -> dict:
    """Kernel tile overrides carried by this plan (unset fields omitted)."""
    out = {}
    for field in ("block_rows", "block_slots", "block_queries"):
      v = getattr(self, field)
      if v is not None:
        out[field] = v
    return out

  def with_backend(self, backend: str) -> "Plan":
    return dataclasses.replace(self, backend=backend)

  @classmethod
  def from_string(cls, backend: str) -> "Plan":
    """Coerce a legacy ``backend=`` string into a :class:`Plan`.

    The single shim between the old spelling and the plan layer: validates
    the name against the registry and warns (once per process) that the
    string form is a compatibility spelling.
    """
    global _warned_string_coercion
    if backend != "auto":
      from repro_torch.core import backends as _b  # lazy: registry must be loaded
      known = ("auto",) + _b.registered_backends()
      if backend not in known:
        raise ValueError(
            f"unknown backend {backend!r}; registered: {known}")
      if not _warned_string_coercion:
        _warned_string_coercion = True
        warnings.warn(
            f"backend={backend!r}: string backend selectors are a "
            "compatibility shim; pass a repro_torch.core.backends.Plan (or let "
            "the Planner choose) instead",
            DeprecationWarning, stacklevel=3)
    return cls(backend=backend)


AUTO_PLAN = Plan()

PlanLike = Union[Plan, str, None]


def as_plan(backend: PlanLike) -> Plan:
  """Coerce ``None`` / ``"name"`` / :class:`Plan` to a :class:`Plan`."""
  if backend is None:
    return AUTO_PLAN
  if isinstance(backend, Plan):
    return backend
  if isinstance(backend, str):
    return Plan.from_string(backend)
  raise TypeError(
      f"backend must be a Plan, a backend-name string, or None; "
      f"got {type(backend)}")
