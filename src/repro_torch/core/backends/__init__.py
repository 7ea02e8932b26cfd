"""Execution-plan layer: backend registry + planner (PyTorch port of
:mod:`repro.core.backends`).

* :class:`Plan` — static, hashable description of how an SpMV runs;
  :func:`as_plan` coerces the legacy string spelling.
* :class:`Backend` + registry — built-ins: dense, coo, coo_tiled, ell and
  cuda_ell (the hand-written Hopper kernel, where the JAX package has its
  Pallas kernel).
* :class:`Planner` — graph statistics -> plan heuristics, and measured
  planning (``candidates``, ``autotune``).
"""

from repro_torch.core.backends.plan import (  # noqa: F401
    AUTO_PLAN, Plan, PlanLike, as_plan)
from repro_torch.core.backends.base import (  # noqa: F401
    Backend, get_backend, register, registered_backends, resolve, unregister)

# Importing the built-in backend modules registers them.
from repro_torch.core.backends import dense as _dense  # noqa: F401
from repro_torch.core.backends import coo as _coo  # noqa: F401
from repro_torch.core.backends import coo_tiled as _coo_tiled  # noqa: F401
from repro_torch.core.backends import ell as _ell  # noqa: F401
from repro_torch.core.backends import cuda_ell as _cuda_ell  # noqa: F401

from repro_torch.core.backends.planner import (  # noqa: F401
    GraphStats, PlanCache, Planner, compute_stats)
