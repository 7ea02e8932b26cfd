"""Pluggable admission control for :class:`GraphQueryServer`.

The scheduler's admission queue is a policy object, not a deque: the server
calls ``offer`` when a new (uncached, uncoalesced) query arrives, ``pop_next``
when a slot frees, ``pick_victim`` when backpressure must drop something, and
``remove`` when a queued query dies early (deadline, cancel).  Everything runs
under the server's bookkeeping lock — policies need no locking of their own.

Built-in policies:

* :class:`FifoPolicy` — arrival order; the default, behavior-identical to the
  pre-policy deque (victim = oldest, matching ``shed-oldest``).
* :class:`PriorityPolicy` — strict priority classes (higher
  ``QuerySpec.priority`` pops first), FIFO within a class, optionally EDF
  (earliest absolute deadline first) among deadline-bearing queries of the
  same class.  Victims come from the *lowest* class (the entry that would
  have run last).  A coalesced duplicate with higher priority escalates the
  queued entry.
* :class:`FairSharePolicy` — per-tenant weighted fair queuing (deficit round
  robin: each visit grants a tenant ``quantum * weight`` credits, one credit
  per admitted query), per-tenant FIFO order, optional per-tenant queue
  bounds, and victim selection from the most over-share tenant.

Entries are :class:`AdmissionRequest` records carrying the scheduling
metadata (tenant, priority, absolute deadline, arrival sequence) alongside
the cache key and spec the scheduler round-trips.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Union

ADMISSION_POLICIES = ("fifo", "priority", "priority-edf", "fair")

DEFAULT_TENANT = "default"


@dataclasses.dataclass
class AdmissionRequest:
  """One queued query as the admission layer sees it.

  ``key``/``spec`` are round-tripped for the scheduler; ``tenant`` /
  ``priority`` / ``deadline`` (absolute, server-clock units) / ``seq``
  (monotone arrival order) are what policies order by.
  """

  key: Any
  spec: Any
  tenant: str = DEFAULT_TENANT
  priority: int = 0
  deadline: Optional[float] = None
  seq: int = 0
  enqueued_at: float = 0.0


class AdmissionPolicy:
  """Ordering/eviction strategy for the admission queue.

  All methods are called with the server's bookkeeping lock held; policies
  are plain single-threaded data structures.  ``key`` values are opaque and
  unique per queued entry (the scheduler coalesces duplicates upstream).
  """

  name = "policy"

  def offer(self, req: AdmissionRequest) -> None:
    """Enqueue a request (the scheduler has already checked bounds)."""
    raise NotImplementedError

  def pop_next(self) -> Optional[AdmissionRequest]:
    """Remove and return the next request to admit (None when empty)."""
    raise NotImplementedError

  def pick_victim(self, incoming: Optional[AdmissionRequest] = None
                  ) -> Optional[AdmissionRequest]:
    """Remove and return the entry to shed under backpressure.

    ``incoming`` is the request that needs room (policies with per-tenant
    bounds shed within the offender's tenant).  None when nothing can be
    shed.
    """
    raise NotImplementedError

  def remove(self, key: Any) -> Optional[AdmissionRequest]:
    """Remove the entry with this key (deadline/cancel); None if absent."""
    raise NotImplementedError

  def depth(self, tenant: Optional[str] = None) -> int:
    """Queued entries, total or for one tenant."""
    raise NotImplementedError

  def _entries(self) -> List[AdmissionRequest]:
    """All queued entries in pop order (introspection helper)."""
    raise NotImplementedError

  # -- defaults shared by all policies ----------------------------------------

  def full_for(self, req: AdmissionRequest) -> bool:
    """True when this request must wait/shed/reject even if the global
    ``max_queue`` bound has room (e.g. a per-tenant bound)."""
    return False

  def escalate(self, key: Any, priority: int,
               deadline: Optional[float] = None) -> bool:
    """A duplicate of a queued key arrived with new urgency; reorder if the
    policy cares.  Returns True when the entry was re-ranked."""
    return False

  def keys(self) -> List[Any]:
    return [r.key for r in self._entries()]

  def clear(self) -> List[AdmissionRequest]:
    """Drop everything (abort-close); returns the dropped entries."""
    dropped = self._entries()
    for r in dropped:
      self.remove(r.key)
    return dropped

  def tenant_depths(self) -> Dict[str, int]:
    depths: Dict[str, int] = {}
    for r in self._entries():
      depths[r.tenant] = depths.get(r.tenant, 0) + 1
    return depths

  def max_urgency(self) -> Optional[int]:
    """Highest queued priority class (None when empty) — drivers use this
    to order server scans."""
    best: Optional[int] = None
    for r in self._entries():
      if best is None or r.priority > best:
        best = r.priority
    return best


class FifoPolicy(AdmissionPolicy):
  """Arrival order; the pre-policy deque behavior (victim = oldest)."""

  name = "fifo"

  def __init__(self):
    self._q: Deque[AdmissionRequest] = deque()

  def offer(self, req: AdmissionRequest) -> None:
    self._q.append(req)

  def pop_next(self) -> Optional[AdmissionRequest]:
    return self._q.popleft() if self._q else None

  def pick_victim(self, incoming: Optional[AdmissionRequest] = None
                  ) -> Optional[AdmissionRequest]:
    return self._q.popleft() if self._q else None

  def remove(self, key: Any) -> Optional[AdmissionRequest]:
    for i, r in enumerate(self._q):
      if r.key == key:
        del self._q[i]
        return r
    return None

  def depth(self, tenant: Optional[str] = None) -> int:
    if tenant is None:
      return len(self._q)
    return sum(1 for r in self._q if r.tenant == tenant)

  def _entries(self) -> List[AdmissionRequest]:
    return list(self._q)


class PriorityPolicy(AdmissionPolicy):
  """Strict priority classes; FIFO (or EDF) within a class.

  Higher ``priority`` values pop first.  With ``edf=True``, deadline-bearing
  entries of a class run earliest-absolute-deadline-first, ahead of the
  class's deadline-free entries (which stay FIFO).  Victims are taken from
  the lowest non-empty class: the entry that would have been admitted last.
  """

  name = "priority"

  def __init__(self, edf: bool = False):
    self.edf = edf
    self._classes: Dict[int, List[AdmissionRequest]] = {}

  def _rank(self, req: AdmissionRequest):
    """Sort key within a class — smaller pops sooner."""
    if self.edf and req.deadline is not None:
      return (0, req.deadline, req.seq)
    return (1, 0.0, req.seq)

  def offer(self, req: AdmissionRequest) -> None:
    self._classes.setdefault(req.priority, []).append(req)

  def _pop_from(self, cls: int, last: bool) -> AdmissionRequest:
    entries = self._classes[cls]
    pick = (max if last else min)(entries, key=self._rank)
    entries.remove(pick)
    if not entries:
      del self._classes[cls]
    return pick

  def pop_next(self) -> Optional[AdmissionRequest]:
    if not self._classes:
      return None
    return self._pop_from(max(self._classes), last=False)

  def pick_victim(self, incoming: Optional[AdmissionRequest] = None
                  ) -> Optional[AdmissionRequest]:
    if not self._classes:
      return None
    return self._pop_from(min(self._classes), last=True)

  def remove(self, key: Any) -> Optional[AdmissionRequest]:
    for cls, entries in self._classes.items():
      for i, r in enumerate(entries):
        if r.key == key:
          del entries[i]
          if not entries:
            del self._classes[cls]
          return r
    return None

  def escalate(self, key: Any, priority: int,
               deadline: Optional[float] = None) -> bool:
    req = self.remove(key)
    if req is None:
      return False
    changed = False
    if priority > req.priority:
      req.priority = priority
      changed = True
    if deadline is not None and (req.deadline is None
                                 or deadline < req.deadline):
      req.deadline = deadline
      changed = changed or self.edf
    self.offer(req)
    return changed

  def depth(self, tenant: Optional[str] = None) -> int:
    if tenant is None:
      return sum(len(e) for e in self._classes.values())
    return sum(1 for e in self._classes.values()
               for r in e if r.tenant == tenant)

  def _entries(self) -> List[AdmissionRequest]:
    out: List[AdmissionRequest] = []
    for cls in sorted(self._classes, reverse=True):
      out.extend(sorted(self._classes[cls], key=self._rank))
    return out

  def max_urgency(self) -> Optional[int]:
    return max(self._classes) if self._classes else None


class FairSharePolicy(AdmissionPolicy):
  """Per-tenant weighted fair queuing (deficit round robin).

  Each tenant owns a FIFO queue.  ``pop_next`` visits backlogged tenants in
  round-robin order; a visit grants ``quantum * weight(tenant)`` credits and
  each admitted query costs one credit, so over a saturated queue tenant t's
  admitted share converges to ``weight(t) / sum(weights of backlogged
  tenants)``.  Credits do not bank while a tenant is idle (its deficit
  resets when its queue empties — standard DRR).

  ``max_per_tenant`` bounds each tenant's queue; a request over the bound is
  reported via :meth:`full_for` and handled by the server's backpressure
  policy (block / reject / shed).  ``pick_victim`` sheds from the incoming
  request's tenant when that tenant is over its bound, otherwise from the
  tenant most over its fair share (largest depth/weight), oldest entry
  first.
  """

  name = "fair"

  def __init__(self, weights: Optional[Dict[str, float]] = None,
               default_weight: float = 1.0,
               max_per_tenant: Optional[int] = None,
               quantum: float = 1.0):
    if default_weight <= 0 or quantum <= 0:
      raise ValueError("default_weight and quantum must be > 0")
    for t, w in (weights or {}).items():
      if w <= 0:
        raise ValueError(f"weight for tenant {t!r} must be > 0, got {w}")
    self.weights = dict(weights or {})
    self.default_weight = float(default_weight)
    self.max_per_tenant = max_per_tenant
    self.quantum = float(quantum)
    self._queues: Dict[str, Deque[AdmissionRequest]] = {}
    self._active: Deque[str] = deque()       # backlogged tenants, RR order
    self._deficit: Dict[str, float] = {}
    self._current: Optional[str] = None      # tenant mid-visit (credited)

  def weight(self, tenant: str) -> float:
    return self.weights.get(tenant, self.default_weight)

  def _drop_tenant_if_empty(self, tenant: str) -> None:
    if not self._queues.get(tenant):
      self._queues.pop(tenant, None)
      self._deficit.pop(tenant, None)
      if tenant in self._active:
        self._active.remove(tenant)
      if self._current == tenant:
        self._current = None

  def offer(self, req: AdmissionRequest) -> None:
    q = self._queues.get(req.tenant)
    if q is None:
      q = self._queues[req.tenant] = deque()
    if req.tenant not in self._active:
      self._active.append(req.tenant)
    q.append(req)

  def pop_next(self) -> Optional[AdmissionRequest]:
    if not self._active:
      return None
    # Terminates: every full rotation grants each backlogged tenant
    # quantum*weight > 0 credits, so some deficit eventually reaches 1.
    for _ in range(100_000):
      t = self._active[0]
      if t != self._current:
        self._current = t
        self._deficit[t] = self._deficit.get(t, 0.0) + \
            self.quantum * self.weight(t)
      if self._deficit[t] >= 1.0:
        req = self._queues[t].popleft()
        self._deficit[t] -= 1.0
        self._drop_tenant_if_empty(t)
        return req
      # Visit exhausted: rotate; clearing _current re-credits the next head
      # (which is this same tenant again when it is the only one active).
      self._active.rotate(-1)
      self._current = None
    # Fail-safe for degenerate weights: plain FIFO pop.
    t = self._active[0]
    req = self._queues[t].popleft()
    self._drop_tenant_if_empty(t)
    return req

  def full_for(self, req: AdmissionRequest) -> bool:
    return (self.max_per_tenant is not None
            and self.depth(req.tenant) >= self.max_per_tenant)

  def pick_victim(self, incoming: Optional[AdmissionRequest] = None
                  ) -> Optional[AdmissionRequest]:
    if not self._queues:
      return None
    if (incoming is not None and self.max_per_tenant is not None
        and self.depth(incoming.tenant) >= self.max_per_tenant):
      tenant = incoming.tenant
    else:
      tenant = max(self._queues,
                   key=lambda t: len(self._queues[t]) / self.weight(t))
    req = self._queues[tenant].popleft()
    self._drop_tenant_if_empty(tenant)
    return req

  def remove(self, key: Any) -> Optional[AdmissionRequest]:
    for tenant, q in self._queues.items():
      for i, r in enumerate(q):
        if r.key == key:
          del q[i]
          self._drop_tenant_if_empty(tenant)
          return r
    return None

  def depth(self, tenant: Optional[str] = None) -> int:
    if tenant is None:
      return sum(len(q) for q in self._queues.values())
    return len(self._queues.get(tenant, ()))

  def _entries(self) -> List[AdmissionRequest]:
    # Approximate pop order: tenants in current RR order, FIFO within.
    out: List[AdmissionRequest] = []
    for t in self._active:
      out.extend(self._queues[t])
    return out

  def tenant_depths(self) -> Dict[str, int]:
    return {t: len(q) for t, q in self._queues.items()}


PolicyLike = Union[str, AdmissionPolicy, None]


def make_policy(policy: PolicyLike) -> AdmissionPolicy:
  """Coerce a policy spec (None | name string | instance) to a policy.

  Names: ``"fifo"`` (default), ``"priority"``, ``"priority-edf"``,
  ``"fair"``.
  """
  if policy is None:
    return FifoPolicy()
  if isinstance(policy, AdmissionPolicy):
    return policy
  if isinstance(policy, str):
    if policy == "fifo":
      return FifoPolicy()
    if policy == "priority":
      return PriorityPolicy()
    if policy == "priority-edf":
      return PriorityPolicy(edf=True)
    if policy in ("fair", "fair-share"):
      return FairSharePolicy()
    raise ValueError(
        f"unknown admission policy {policy!r}; expected one of "
        f"{ADMISSION_POLICIES} or an AdmissionPolicy instance")
  raise TypeError(f"admission policy must be a name or AdmissionPolicy, "
                  f"got {type(policy).__name__}")
