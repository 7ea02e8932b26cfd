"""Multi-query serving on PyTorch (port of :mod:`repro.service`).

* :class:`~repro_torch.service.scheduler.GraphQueryServer` — slot-pool
  server with a thread-safe submit/result frontend, backpressure, deadlines,
  cancellation and drain/abort shutdown.
* :class:`~repro_torch.service.admission.AdmissionPolicy` — FIFO, priority
  and per-tenant fair admission (a copy of the reference's pure Python).
* :class:`~repro_torch.service.driver.ServerDriver` — background thread
  owning the round loop.
* Query families: BFS / SSSP / personalized PageRank.
* :class:`~repro_torch.service.cache.ResultCache` keyed by graph
  fingerprint; :class:`~repro_torch.service.metrics.Counters`.
"""

from repro_torch.service.admission import (ADMISSION_POLICIES,  # noqa: F401
                                           AdmissionPolicy, AdmissionRequest,
                                           FairSharePolicy, FifoPolicy,
                                           PriorityPolicy, make_policy)
from repro_torch.service.cache import (ResultCache,  # noqa: F401
                                       graph_fingerprint)
from repro_torch.service.driver import ServerDriver  # noqa: F401
from repro_torch.service.metrics import Counters, Histogram  # noqa: F401
from repro_torch.service.scheduler import (  # noqa: F401
    BACKPRESSURE_POLICIES, BfsFamily, DeadlineExpired, GraphQueryServer,
    PprFamily, QueryCancelled, QueryError, QueryFamily, QueryRejected,
    QueryShed, QuerySpec, ServerClosed, SsspFamily)
