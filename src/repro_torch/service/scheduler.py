"""Continuous-batching scheduler for multi-query vertex programs (PyTorch
port of :mod:`repro.service.scheduler`).

The LLM-inference serving pattern applied to graph queries: a server owns a
fixed-width pool of Q *slots* (columns of the batched engine state).  Life
of a query::

    submit ──► admission queue ──► slot (batched supersteps, SpMM)
                     ▲                 │ column converges (done[q])
                     │                 ▼
               cache miss          retire: extract column, cache result
               cache hit  ────────────────► result available immediately

Rounds of ``steps_per_round`` supersteps run with no host read inside
(:func:`repro_torch.core.engine.run_batched_rounds`); between rounds
the scheduler retires converged columns mid-flight and swaps queued queries
into the freed slots *without restarting* the unconverged neighbors — slot
state persists across the host round-trip (continuous batching, not static
batching).  Per-round and per-query metrics land in a
:class:`~repro_torch.service.metrics.Counters`: ``queue.wait_ms`` from
submission to admission, ``query.in_slot_ms`` from admission to
retirement.

Threading model
---------------

The frontend is safe for concurrent clients; the engine is single-stepper:

* ``submit`` / ``submit_many`` / ``result`` / ``cancel`` / ``stats`` may be
  called from **any** thread.  Host-side bookkeeping (admission queue, slot
  map, waiter lists, tickets, cache) is guarded by one condition variable;
  each ticket completes a per-query ``threading.Event``, so ``result(qid,
  timeout=...)`` blocks without polling.
* ``step_round`` / ``drain`` / ``close`` serialize on an internal *engine
  lock* — exactly one thread advances the batched device state at a time.
  Normally that thread is a :class:`~repro_torch.service.driver.ServerDriver`;
  calling ``drain()`` yourself without a driver (the PR-7 single-threaded
  pattern) still works.
* Heavy device work (the round of supersteps) runs **outside** the
  bookkeeping lock, so submissions never wait on an SpMM.
* The reference swaps columns in and out with jitted functional updates;
  the port updates the engine state's tensors in place (install, extract)
  or through :func:`~repro_torch.core.engine.mask_columns`, always under
  the engine lock, so no round sees a half-written column.

Admission control, backpressure, deadlines
------------------------------------------

The admission queue's ordering is a pluggable
:class:`~repro_torch.service.admission.AdmissionPolicy` (``admission=`` at
construction): ``"fifo"`` (default — arrival order, the original behavior),
``"priority"`` / ``"priority-edf"`` (strict classes by
``QuerySpec.priority``, FIFO or earliest-deadline-first within a class), or
``"fair"`` (per-tenant deficit-round-robin weighted by
:class:`~repro_torch.service.admission.FairSharePolicy` weights, with optional
per-tenant queue bounds).  ``QuerySpec.tenant`` / ``QuerySpec.priority``
feed the policy; neither is part of the cache key, so identical queries
from different tenants still coalesce and share cached results.

``max_queue`` bounds the admission queue.  When it is full — or the policy
reports a per-tenant bound hit — a new (uncached, uncoalesced) submission
follows ``backpressure``: ``"block"`` waits for space (optionally up to
``timeout``), ``"reject"`` raises :class:`QueryRejected`,
``"shed-oldest"`` drops the policy's chosen victim (its waiters fail with
:class:`QueryShed`) to make room — submit never blocks.  Under FIFO the
victim is the oldest queued query (the original shed-oldest); priority
sheds from the lowest class and fair-share from the most over-share
tenant.  A per-query ``deadline`` (seconds from submit) fails the ticket
with :class:`DeadlineExpired` once it lapses: still-queued queries are
dropped from the queue, in-flight ones are retired mid-flight by masking
their column's frontier (:func:`repro_torch.core.engine.mask_columns`), which is
bitwise-invisible to the surviving columns.  Expired/cancelled queries are
never cached, and neither is the *partial* column of a query force-retired
at ``max_steps_per_query``.

Settled tickets are garbage-collected: once :meth:`result` has delivered a
ticket's outcome it is retained only up to ``retain_delivered`` more
deliveries; settled-but-never-collected tickets are bounded by
``retain_settled`` (oldest evicted first).  ``result`` on an evicted qid
raises KeyError — collect results promptly or raise the retention bounds.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Set, Tuple)

import numpy as np
import torch

from repro_torch import _tree, tracing
from repro_torch.core.backends import Plan, PlanLike, Planner, as_plan
from repro_torch.core.engine import (init_batched_state, mask_columns,
                                     run_batched_rounds)
from repro_torch.core.vertex_program import GraphProgram
from repro_torch.service.admission import (AdmissionPolicy, AdmissionRequest,
                                           PolicyLike, make_policy)
from repro_torch.service.cache import ResultCache, graph_fingerprint
from repro_torch.service.metrics import Counters

Array = torch.Tensor
PyTree = Any

BACKPRESSURE_POLICIES = ("block", "reject", "shed-oldest")

# Distinguishes "not cached" from any cached value on ResultCache.get —
# never pair `in cache` with a separate get (eviction can race between).
_CACHE_MISS = object()


def _host(x: torch.Tensor) -> np.ndarray:
  """A host copy that owns its memory: a CPU tensor's ``.numpy()`` would
  alias the engine state, whose columns are overwritten in place."""
  return x.to("cpu", copy=True).numpy()


class QueryError(RuntimeError):
  """Base class for query lifecycle failures (stored on the ticket and
  re-raised from :meth:`GraphQueryServer.result`)."""


class QueryRejected(QueryError):
  """Admission queue full under the ``reject`` policy (or ``block`` timed
  out)."""


class QueryShed(QueryError):
  """Dropped from a full queue by the ``shed-oldest`` policy."""


class QueryCancelled(QueryError):
  """Explicitly cancelled via :meth:`GraphQueryServer.cancel`."""


class DeadlineExpired(QueryError):
  """The query's deadline lapsed before its column converged."""


class ServerClosed(QueryError):
  """The server was closed (submit after close, or abort-close in flight)."""


@dataclasses.dataclass(frozen=True)
class QuerySpec:
  """One serveable query: a (kind, source, params) triple.

  ``params`` must be hashable (it is part of the cache key).  ``tenant``
  and ``priority`` feed the admission policy only — they are *not* part of
  the cache key, so the same logical query submitted by different tenants
  or at different priorities coalesces and shares cached results.
  """

  kind: str
  source: int
  params: Tuple = ()
  tenant: str = "default"
  priority: int = 0


@dataclasses.dataclass
class _Ticket:
  """Per-submission completion record (one per qid, even when coalesced)."""

  qid: int
  key: Any
  event: threading.Event
  submitted_at: float
  deadline: Optional[float] = None   # absolute, in clock units
  tenant: str = "default"
  priority: int = 0
  value: Any = None
  error: Optional[BaseException] = None


class QueryFamily:
  """Adapter binding one vertex program to per-query init/extract.

  A server serves exactly one family — every in-flight query shares the
  same program (the whole point: one fused SpMM engine loop).
  """

  name: str = "family"

  def program(self) -> GraphProgram:
    raise NotImplementedError

  def init_column(self, spec: QuerySpec, device: torch.device
                  ) -> Tuple[PyTree, Array]:
    """(prop column, active column) on ``device`` — leaves ``[n, ...]``."""
    raise NotImplementedError

  def extract(self, prop_col: PyTree) -> Any:
    """Host-side result from one retired property column."""
    raise NotImplementedError


class BfsFamily(QueryFamily):
  name = "bfs"

  def __init__(self, n: int):
    self.n = n

  def program(self) -> GraphProgram:
    from repro_torch.algos.multi import multi_bfs_program
    return multi_bfs_program()

  def init_column(self, spec: QuerySpec, device: torch.device
                  ) -> Tuple[PyTree, Array]:
    from repro_torch.algos.multi import bfs_column
    return bfs_column(spec.source, self.n, device)

  def extract(self, prop_col: PyTree) -> np.ndarray:
    return _host(prop_col)


class SsspFamily(QueryFamily):
  name = "sssp"

  def __init__(self, n: int):
    self.n = n

  def program(self) -> GraphProgram:
    from repro_torch.algos.multi import multi_sssp_program
    return multi_sssp_program()

  def init_column(self, spec: QuerySpec, device: torch.device
                  ) -> Tuple[PyTree, Array]:
    from repro_torch.algos.multi import sssp_column
    return sssp_column(spec.source, self.n, device)

  def extract(self, prop_col: PyTree) -> np.ndarray:
    return _host(prop_col)


class PprFamily(QueryFamily):
  """Personalized PageRank (delta formulation, tolerance frontier)."""

  name = "ppr"

  def __init__(self, out_deg: Array, r: float = 0.15, tol: float = 1e-6):
    self.out_deg = out_deg.to(torch.float32)
    self.n = int(out_deg.shape[0])
    self.r = float(r)
    self.tol = float(tol)

  def program(self) -> GraphProgram:
    from repro_torch.algos.pagerank import delta_pagerank_program
    return delta_pagerank_program(r=self.r, tol=self.tol)

  def init_column(self, spec: QuerySpec, device: torch.device
                  ) -> Tuple[PyTree, Array]:
    from repro_torch.algos.multi import ppr_column
    return ppr_column(spec.source, self.out_deg.to(device), self.r)

  def extract(self, prop_col: PyTree) -> np.ndarray:
    return _host(prop_col["rank"])


class GraphQueryServer:
  """Serve many queries of one vertex program over one graph.

  Args:
    graph: any engine-compatible container (Dense/Coo/Ell).
    family: the :class:`QueryFamily` to serve.
    num_slots: Q, the batched width (slot pool size).
    steps_per_round: supersteps per round — the continuous-batching
      scheduling quantum.  Small = responsive swap-in, large = less host
      round-trip overhead.
    backend: execution plan for the batched SpMV — a
      :class:`repro_torch.core.backends.Plan` or a legacy name string.  On
      ``"auto"`` (default) the server asks its :class:`Planner` for a plan
      from the graph's statistics (Q = ``num_slots``); the resolved plan is
      exposed as :attr:`plan` and recomputed by :meth:`swap_graph`.
    planner: the :class:`~repro_torch.core.backends.Planner` consulted when the
      requested backend is "auto" (shared planners share their plan cache).
    max_steps_per_query: safety valve — a slot live this long is
      force-retired with its current (partial) column.  Partial results are
      delivered to waiters but never cached.
    max_queue: admission-queue bound (None = unbounded; per-tenant policy
      bounds still apply).
    backpressure: full-queue policy — ``block`` | ``reject`` | ``shed-oldest``
      (the shed victim is chosen by the admission policy; FIFO = oldest).
    admission: admission-queue ordering — an
      :class:`~repro_torch.service.admission.AdmissionPolicy` instance or a name
      (``"fifo"`` default | ``"priority"`` | ``"priority-edf"`` |
      ``"fair"``).
    retain_delivered: settled tickets already delivered by :meth:`result`
      kept before garbage collection (bounds ``_tickets`` growth).
    retain_settled: settled-but-never-collected tickets kept (oldest
      evicted first, delivered ones before undelivered).
    clock: monotonic time source (injectable for deterministic tests).
  """

  def __init__(self, graph, family: QueryFamily, *, num_slots: int = 8,
               steps_per_round: int = 4, backend: PlanLike = "auto",
               planner: Optional[Planner] = None,
               cache: Optional[ResultCache] = None,
               counters: Optional[Counters] = None,
               max_steps_per_query: int = 100_000,
               max_queue: Optional[int] = None,
               backpressure: str = "block",
               admission: PolicyLike = None,
               retain_delivered: int = 4096,
               retain_settled: int = 65536,
               clock: Callable[[], float] = time.monotonic):
    assert num_slots >= 1 and steps_per_round >= 1
    if backpressure not in BACKPRESSURE_POLICIES:
      raise ValueError(f"backpressure must be one of {BACKPRESSURE_POLICIES}")
    if max_queue is not None and max_queue < 1:
      raise ValueError("max_queue must be >= 1 (or None for unbounded)")
    if retain_delivered < 0 or retain_settled < 1:
      raise ValueError("retain_delivered must be >= 0, retain_settled >= 1")
    self.family = family
    self.num_slots = num_slots
    self.steps_per_round = steps_per_round
    self._requested = as_plan(backend)
    self.planner = planner if planner is not None else Planner()
    self.max_steps_per_query = max_steps_per_query
    self.max_queue = max_queue
    self.backpressure = backpressure
    self.retain_delivered = retain_delivered
    self.retain_settled = retain_settled
    self.counters = counters or Counters()
    self.cache = cache if cache is not None else ResultCache(
        counters=self.counters)
    self.program = family.program()
    self._clock = clock

    # Bookkeeping, all guarded by self._cond (its lock).  The engine state
    # (_state) is advanced and updated in place only under _engine_lock.
    self._cond = threading.Condition()
    self._engine_lock = threading.Lock()
    self._closed = False
    self._policy: AdmissionPolicy = make_policy(admission)
    self._results: Dict[int, Any] = {}
    # Concurrent identical queries coalesce: one engine column serves every
    # ticket waiting on the same cache key.
    self._waiters: Dict[Any, list] = {}  # cache key -> [qid, ...]
    self._slot_key: list = [None] * num_slots  # cache key or None per slot
    self._slot_admitted = [0.0] * num_slots    # _clock() at admission
    self._tickets: Dict[int, _Ticket] = {}
    self._pending_deadlines: Set[int] = set()
    self._wake_listeners: List[threading.Event] = []
    self._next_qid = 0
    # Settled-ticket GC: settle/delivery order rings, lazily compacted.
    self._settled_q: Deque[int] = deque()    # settle order (may hold stale)
    self._delivered_q: Deque[int] = deque()  # first-delivery order
    self._delivered: Set[int] = set()
    self._num_settled_live = 0

    self._reset_engine_locked(graph)

  def _make_plan(self, graph) -> Plan:
    """Resolve the requested backend into this server's concrete plan."""
    if self._requested.is_auto:
      return self.planner.plan(graph, self.program, q=self.num_slots)
    return self._requested

  def _reset_engine_locked(self, graph) -> None:
    """(Re)bind the server to a graph: fingerprint, plan, state."""
    self.graph = graph
    self.device = graph.device
    self.fingerprint = graph_fingerprint(graph)
    self.plan = self._make_plan(graph)
    # Legacy alias: callers that read ``server.backend`` see the plan.
    self.backend = self.plan

    # Batched engine state: all slots start empty (inactive ⇒ done).
    family = self.family
    proto_prop, _ = family.init_column(QuerySpec(family.name, 0),
                                       self.device)
    prop0 = _tree.tree_map(
        lambda x: torch.zeros((x.shape[0], self.num_slots) + x.shape[1:],
                              dtype=x.dtype, device=self.device),
        proto_prop)
    n = _tree.tree_leaves(proto_prop)[0].shape[0]
    active0 = torch.zeros((n, self.num_slots), dtype=torch.bool,
                          device=self.device)
    self._state = init_batched_state(prop0, active0)

  def swap_graph(self, graph) -> Plan:
    """Replace the served graph with a new snapshot (idle servers only).

    Re-fingerprints, re-plans (when the requested backend is "auto"), and
    rebuilds the engine state.  The result cache
    is *kept* — its keys embed the graph fingerprint, so entries for the old
    snapshot stay correct and entries for a previously-served snapshot are
    revived for free.  Raises RuntimeError if queries are queued or in
    flight (drain first).  Returns the new plan.
    """
    with self._engine_lock:
      with self._cond:
        if self._closed:
          raise ServerClosed("server is closed")
        if self._policy.depth() or any(k is not None for k in self._slot_key):
          raise RuntimeError(
              "swap_graph requires an idle server: drain() queued and "
              "in-flight queries first")
        self._reset_engine_locked(graph)
        self.counters.inc("graph.swaps")
        return self.plan

  # -- submission ------------------------------------------------------------

  def _cache_key(self, spec: QuerySpec):
    return ResultCache.make_key(
        self.fingerprint, self.program.name,
        (spec.kind, spec.source, spec.params))

  def submit(self, spec: QuerySpec, *, deadline: Optional[float] = None,
             timeout: Optional[float] = None) -> int:
    """Enqueue a query; returns a ticket (thread-safe).

    Cache hits complete instantly; a query identical to one already queued
    or in flight coalesces onto it (one engine column, many tickets).

    Args:
      deadline: seconds from now after which the query fails with
        :class:`DeadlineExpired` instead of completing.
      timeout: under the ``block`` backpressure policy, how long to wait
        for queue space before raising :class:`QueryRejected`
        (None = wait indefinitely).
    """
    with self._cond:
      return self._submit_locked(spec, deadline, timeout)

  def submit_many(self, specs: Sequence[QuerySpec], *,
                  deadline: Optional[float] = None,
                  timeout: Optional[float] = None) -> List[int]:
    """Bulk submit: one ticket per spec, in order (thread-safe)."""
    return [self.submit(s, deadline=deadline, timeout=timeout)
            for s in specs]

  def _inc_q(self, name: str, ticket: _Ticket, value: float = 1.0) -> None:
    """Bump a query counter plus its per-tenant / per-class labels."""
    self.counters.inc(name, value)
    self.counters.inc_labeled(name, value, tenant=ticket.tenant)
    if ticket.priority:
      self.counters.inc_labeled(name, value, **{"class": ticket.priority})

  def _admission_full_locked(self, req: AdmissionRequest) -> bool:
    if self.max_queue is not None and self._policy.depth() >= self.max_queue:
      return True
    return self._policy.full_for(req)

  def _submit_locked(self, spec: QuerySpec, deadline: Optional[float],
                     timeout: Optional[float]) -> int:
    if self._closed:
      raise ServerClosed("server is closed")
    if spec.kind != self.family.name:
      raise ValueError(
          f"query kind {spec.kind!r} does not match served family "
          f"{self.family.name!r}")
    n = getattr(self.family, "n", None)
    if n is not None and not 0 <= spec.source < n:
      raise ValueError(f"source {spec.source} out of range [0, {n})")
    now = self._clock()
    qid = self._next_qid
    self._next_qid += 1
    key = self._cache_key(spec)
    ticket = _Ticket(qid=qid, key=key, event=threading.Event(),
                     submitted_at=now,
                     deadline=None if deadline is None else now + deadline,
                     tenant=spec.tenant, priority=spec.priority)
    self._tickets[qid] = ticket
    self._inc_q("queries.submitted", ticket)
    hit = self.cache.get(key, _CACHE_MISS)
    if hit is not _CACHE_MISS:
      self._settle_locked(ticket, value=hit)
      self._inc_q("queries.completed", ticket)
      return qid
    if ticket.deadline is not None:
      self._pending_deadlines.add(qid)
    if key in self._waiters:
      self._waiters[key].append(qid)
      self.counters.inc("queries.coalesced")
      # A more urgent duplicate escalates the queued entry (no-op for FIFO).
      self._policy.escalate(key, spec.priority, deadline=ticket.deadline)
      return qid
    # New key → admission queue, subject to backpressure (global bound
    # and/or the policy's per-tenant bounds).
    req = AdmissionRequest(key=key, spec=spec, tenant=spec.tenant,
                           priority=spec.priority, deadline=ticket.deadline,
                           seq=qid, enqueued_at=now)
    wait_until = None if timeout is None else now + timeout
    while (self._admission_full_locked(req)
           and key not in self._waiters
           and not ticket.event.is_set()):
      if self.backpressure == "reject":
        self._inc_q("queries.rejected", ticket)
        self._settle_locked(ticket, error=QueryRejected(
            f"admission queue full (max_queue={self.max_queue}, "
            f"policy={self._policy.name})"))
        raise ticket.error
      if self.backpressure == "shed-oldest":
        if self._shed_victim_locked(req):
          continue
        # Policy found nothing sheddable (e.g. only this tenant's bound
        # blocks and its queue is empty): fall back to reject.
        self._inc_q("queries.rejected", ticket)
        self._settle_locked(ticket, error=QueryRejected(
            "admission full and nothing sheddable "
            f"(policy={self._policy.name})"))
        raise ticket.error
      # "block": wait for _admit/shed/cancel to free a queue entry.
      remaining = (None if wait_until is None
                   else wait_until - self._clock())
      if remaining is not None and remaining <= 0:
        self._inc_q("queries.rejected", ticket)
        self._settle_locked(ticket, error=QueryRejected(
            f"timed out after {timeout}s waiting for queue space"))
        raise ticket.error
      self._cond.wait(remaining)
      if self._closed and not ticket.event.is_set():
        self._settle_locked(ticket, error=ServerClosed(
            "server closed while waiting for queue space"))
        raise ticket.error
      # State may have shifted while we slept: the identical query may
      # have completed (cache) — coalescing is handled below.
      hit = self.cache.get(key, _CACHE_MISS)
      if hit is not _CACHE_MISS and not ticket.event.is_set():
        self._settle_locked(ticket, value=hit)
        self._inc_q("queries.completed", ticket)
        return qid
    # The ticket may have settled while blocked (deadline expiry, cancel,
    # abort-close) — it must NOT be enqueued; surface the stored outcome.
    if ticket.event.is_set():
      if ticket.error is not None:
        raise ticket.error
      return qid
    if key in self._waiters:
      # Raced with another submitter of the same key while blocked.
      self._waiters[key].append(qid)
      self.counters.inc("queries.coalesced")
      self._policy.escalate(key, spec.priority, deadline=ticket.deadline)
      return qid
    self._waiters[key] = [qid]
    self._policy.offer(req)
    self.counters.inc("queue.enqueued")
    self.counters.set_gauge_max("queue.depth.high_water",
                                self._policy.depth())
    self._notify_work_locked()
    return qid

  def _shed_victim_locked(self, incoming: Optional[AdmissionRequest] = None
                          ) -> bool:
    """Drop the policy's shed victim; False when nothing is sheddable."""
    victim = self._policy.pick_victim(incoming)
    if victim is None:
      return False
    self.counters.inc("queue.removed")
    for qid in self._waiters.pop(victim.key, []):
      ticket = self._tickets[qid]
      self._inc_q("queries.shed", ticket)
      self._settle_locked(ticket, error=QueryShed(
          f"shed from full queue: {victim.spec}"))
    self._cond.notify_all()
    return True

  def _settle_locked(self, ticket: _Ticket, value: Any = None,
                     error: Optional[BaseException] = None) -> None:
    """Complete a ticket exactly once (idempotent)."""
    if ticket.event.is_set():
      return
    ticket.value = value
    ticket.error = error
    if error is None:
      self._results[ticket.qid] = value
    self._pending_deadlines.discard(ticket.qid)
    latency_ms = (self._clock() - ticket.submitted_at) * 1000.0
    self.counters.observe("query.latency_ms", latency_ms)
    self.counters.observe_labeled("query.latency_ms", latency_ms,
                                  tenant=ticket.tenant)
    ticket.event.set()
    self._settled_q.append(ticket.qid)
    self._num_settled_live += 1
    self._prune_tickets_locked()
    self._cond.notify_all()

  # -- settled-ticket garbage collection ---------------------------------------

  def _drop_ticket_locked(self, qid: int) -> None:
    if self._tickets.pop(qid, None) is None:
      return
    self._results.pop(qid, None)
    self._delivered.discard(qid)
    self._num_settled_live -= 1

  def _prune_tickets_locked(self) -> None:
    """Bound settled-ticket retention: delivered tickets beyond
    ``retain_delivered``, then (delivered-first) anything beyond
    ``retain_settled``.  Pending tickets are never dropped."""
    while len(self._delivered_q) > self.retain_delivered:
      self._drop_ticket_locked(self._delivered_q.popleft())
    while self._num_settled_live > self.retain_settled:
      if self._delivered_q:
        self._drop_ticket_locked(self._delivered_q.popleft())
        continue
      while self._settled_q and (
          self._settled_q[0] not in self._tickets
          or self._settled_q[0] in self._delivered):
        self._settled_q.popleft()   # stale, or tracked by _delivered_q
      if not self._settled_q:
        break
      self._drop_ticket_locked(self._settled_q.popleft())
    # Keep the settle ring from accumulating stale entries forever.
    while self._settled_q and self._settled_q[0] not in self._tickets:
      self._settled_q.popleft()
    if len(self._settled_q) > 2 * (self._num_settled_live + 16):
      self._settled_q = deque(
          q for q in self._settled_q if q in self._tickets)

  def result(self, qid: int, timeout: Optional[float] = 0.0) -> Optional[Any]:
    """The query's result; raises the stored :class:`QueryError` on failure.

    ``timeout=0`` (default) polls — returns None while queued/in flight
    (the PR-7 contract).  ``timeout=None`` blocks until settled;
    ``timeout=x`` blocks up to x seconds and returns None on timeout.
    Blocking requires something to be driving rounds (a
    :class:`~repro_torch.service.driver.ServerDriver` or a ``drain()`` caller).

    Delivery marks the ticket garbage-collectable: it stays readable for
    the next ``retain_delivered`` deliveries, after which this method
    raises KeyError for its qid.
    """
    with self._cond:
      ticket = self._tickets.get(qid)
    if ticket is None:
      raise KeyError(f"unknown query id {qid}")
    if not ticket.event.wait(timeout):
      return None
    with self._cond:
      if qid in self._tickets and qid not in self._delivered:
        self._delivered.add(qid)
        self._delivered_q.append(qid)
        self._prune_tickets_locked()
    if ticket.error is not None:
      raise ticket.error
    return ticket.value

  def cancel(self, qid: int) -> bool:
    """Cancel a pending query; False if it already settled.

    A queued query (whose ticket is the last waiter) is dropped from the
    queue; an in-flight one is early-retired by masking its column.
    Coalesced siblings keep the column alive.
    """
    with self._engine_lock:
      with self._cond:
        ticket = self._tickets.get(qid)
        if ticket is None or ticket.event.is_set():
          return False
        self.counters.inc("queries.cancelled")
        self._settle_locked(ticket, error=QueryCancelled(
            f"query {qid} cancelled"))
        self._remove_waiter_locked(ticket)
        return True

  def _remove_waiter_locked(self, ticket: _Ticket) -> None:
    """Detach a settled ticket from its key; last waiter out retires the
    key (queue removal or in-flight column mask).  Needs the engine lock
    (may mutate device state)."""
    waiters = self._waiters.get(ticket.key)
    if not waiters:
      return
    if ticket.qid in waiters:
      waiters.remove(ticket.qid)
    if waiters:
      return
    del self._waiters[ticket.key]
    if self._policy.remove(ticket.key) is not None:
      self.counters.inc("queue.removed")
      self._cond.notify_all()
      return
    if ticket.key in self._slot_key:
      slot = self._slot_key.index(ticket.key)
      self._slot_key[slot] = None
      self._state = mask_columns(self._state, [slot])
      self.counters.inc("slots.early_retired")

  @property
  def num_in_flight(self) -> int:
    with self._cond:
      return sum(1 for q in self._slot_key if q is not None)

  @property
  def num_queued(self) -> int:
    with self._cond:
      return self._policy.depth()

  @property
  def closed(self) -> bool:
    with self._cond:
      return self._closed

  def queued_urgency(self) -> Optional[int]:
    """Highest queued priority class (None when the queue is empty) — used
    by :class:`~repro_torch.service.driver.ServerDriver` to scan urgent servers
    first."""
    with self._cond:
      return self._policy.max_urgency()

  def add_wake_listener(self, event: threading.Event) -> None:
    """Register an event set whenever new engine work arrives (driver API)."""
    with self._cond:
      if event not in self._wake_listeners:
        self._wake_listeners.append(event)

  def _notify_work_locked(self) -> None:
    for ev in self._wake_listeners:
      ev.set()

  # -- deadlines -------------------------------------------------------------

  def expire_deadlines(self, now: Optional[float] = None) -> int:
    """Fail every pending ticket past its deadline; returns how many.

    Runs automatically at the top of each :meth:`step_round`.
    """
    with self._engine_lock:
      with self._cond:
        return self._expire_locked(self._clock() if now is None else now)

  def _expire_locked(self, now: float) -> int:
    expired = 0
    for qid in list(self._pending_deadlines):
      ticket = self._tickets[qid]
      if ticket.event.is_set():
        self._pending_deadlines.discard(qid)
        continue
      if now < ticket.deadline:
        continue
      self.counters.inc("queries.deadline_expired")
      self._settle_locked(ticket, error=DeadlineExpired(
          f"query {qid} exceeded its "
          f"{ticket.deadline - ticket.submitted_at:.3f}s deadline"))
      self._remove_waiter_locked(ticket)
      expired += 1
    return expired

  # -- continuous batching ---------------------------------------------------

  def _install_locked(self, prop_col: PyTree, active_col: Array,
                      slot: int) -> None:
    """Swap a fresh query into ``slot`` without disturbing neighbors.

    In place on the engine state's tensors (the caller holds the engine
    lock); every write touches column ``slot`` only.
    """
    state = self._state
    _tree.tree_map(lambda full, col: full[:, slot].copy_(col), state.prop,
                   prop_col)
    state.active[:, slot] = active_col
    na = active_col.sum(dtype=torch.int32)
    state.done[slot] = na == 0
    state.num_active[slot] = na
    state.iters[slot] = 0

  def _admit_locked(self) -> int:
    admitted = 0
    for slot in range(self.num_slots):
      if self._slot_key[slot] is not None or not self._policy.depth():
        continue
      req = self._policy.pop_next()
      if req is None:
        continue
      now = self._clock()
      wait_ms = (now - req.enqueued_at) * 1000.0
      self.counters.observe("queue.wait_ms", wait_ms)
      self.counters.observe_labeled("queue.wait_ms", wait_ms,
                                    tenant=req.tenant)
      prop_col, active_col = self.family.init_column(req.spec, self.device)
      self._install_locked(prop_col, active_col, slot)
      self._slot_key[slot] = req.key
      self._slot_admitted[slot] = now
      admitted += 1
    if admitted:
      self.counters.inc("queries.admitted", admitted)
      self._cond.notify_all()   # queue space freed → wake blocked submitters
    return admitted

  def _retire_locked(self) -> int:
    # One device read for both: done and iters of every slot.
    done, iters = torch.stack(
        (self._state.done.to(torch.int32), self._state.iters)).cpu().numpy()
    retired = 0
    for slot in range(self.num_slots):
      key = self._slot_key[slot]
      if key is None:
        continue
      forced = iters[slot] >= self.max_steps_per_query
      if not (done[slot] or forced):
        continue
      col = _tree.tree_map(lambda x: x[:, slot], self._state.prop)
      result = self.family.extract(col)
      waiters = self._waiters.pop(key, [])
      for qid in waiters:
        ticket = self._tickets[qid]
        if ticket.event.is_set():
          continue   # settled while listed (defensive; normally removed)
        self._settle_locked(ticket, value=result)
        self._inc_q("queries.completed", ticket)
      if not forced:
        # A forced retire delivers the *partial* (non-converged) column to
        # its waiters as a safety valve, but caching it would serve the
        # wrong answer to every future identical query.
        self.cache.put(key, result)
      self._slot_key[slot] = None
      retired += 1
      self.counters.inc("slots.retired")
      self.counters.observe(
          "query.in_slot_ms",
          (self._clock() - self._slot_admitted[slot]) * 1000.0)
      self.counters.observe("query.supersteps_to_converge",
                            float(iters[slot]))
      if forced:
        self.counters.inc("queries.force_retired")
        # A force-retired column must not keep burning supersteps.
        self._state = mask_columns(self._state, [slot])
    if retired:
      self._cond.notify_all()
    return retired

  def step_round(self, now: Optional[float] = None) -> bool:
    """One continuous-batching round: expire → admit → supersteps → retire.

    Returns False when there was nothing to do (idle server).  Safe to call
    concurrently (an engine lock serializes steppers), but intended for a
    single driver thread.
    """
    with self._engine_lock, tracing.span(tracing.ROUND):
      with self._cond, tracing.span(tracing.ADMIT):
        self._expire_locked(self._clock() if now is None else now)
        self._admit_locked()
        in_flight = sum(1 for q in self._slot_key if q is not None)
      if in_flight == 0:
        return False
      # The heavy SpMM rounds run outside the bookkeeping lock: submissions
      # land in the queue while the device crunches.
      self._state, trace = run_batched_rounds(
          self.graph, self.program, self._state, self.steps_per_round,
          backend=self.plan)
      self.counters.inc("rounds")
      with tracing.span(tracing.ROUND_READ):
        trace = trace.cpu().numpy()
      self.counters.inc("supersteps", float((trace >= 0).sum()))
      self.counters.observe("round.slot_utilization",
                            in_flight / self.num_slots)
      with self._cond, tracing.span(tracing.RETIRE):
        self._retire_locked()
      return True

  def drain(self, max_rounds: int = 100_000) -> Dict[int, Any]:
    """Run rounds until queue and slots are empty; returns all successful
    results (``{qid: value}``)."""
    rounds = 0
    while (self.num_queued or self.num_in_flight) and rounds < max_rounds:
      if not self.step_round():
        break
      rounds += 1
    with self._cond:
      return dict(self._results)

  # -- shutdown --------------------------------------------------------------

  def close(self, mode: str = "drain",
            reason: Optional[BaseException] = None) -> None:
    """Stop accepting submissions and settle every pending ticket.

    ``mode="drain"`` runs rounds until all pending work completes (in this
    thread if no driver is stepping; alongside a driver it just waits its
    turn on the engine lock).  ``mode="abort"`` deterministically fails all
    queued and in-flight tickets with :class:`ServerClosed` and masks the
    live columns.  Idempotent.
    """
    if mode not in ("drain", "abort"):
      raise ValueError("close mode must be 'drain' or 'abort'")
    with self._cond:
      self._closed = True
      self._cond.notify_all()      # unblock submitters waiting for space
      self._notify_work_locked()
    if mode == "drain":
      self.drain()
      return
    with self._engine_lock:
      with self._cond:
        err = ServerClosed("server closed (abort)")
        if reason is not None:
          err.__cause__ = reason
        for ticket in list(self._tickets.values()):
          if not ticket.event.is_set():
            self._settle_locked(ticket, error=err)
        dropped = self._policy.clear()
        if dropped:
          self.counters.inc("queue.removed", float(len(dropped)))
        self._waiters.clear()
        live = [s for s, k in enumerate(self._slot_key) if k is not None]
        if live:
          self._state = mask_columns(self._state, live)
          self.counters.inc("slots.early_retired", float(len(live)))
          for s in live:
            self._slot_key[s] = None
        self._cond.notify_all()

  def __enter__(self) -> "GraphQueryServer":
    return self

  def __exit__(self, exc_type, exc, tb) -> None:
    self.close("drain" if exc_type is None else "abort")

  # -- introspection ---------------------------------------------------------

  def stats(self) -> dict:
    snap = self.counters.snapshot()
    snap["gauges"]["slots.in_flight"] = self.num_in_flight
    snap["gauges"]["queue.depth"] = self.num_queued
    snap["gauges"]["cache.size"] = len(self.cache)
    with self._cond:
      tenant_depths = self._policy.tenant_depths()
    for tenant, depth in tenant_depths.items():
      snap["gauges"][Counters.label_name("queue.depth", tenant=tenant)] = depth
    return snap

  def debug_snapshot(self) -> dict:
    """Consistent view of the bookkeeping (for conformance tests)."""
    with self._cond:
      pending = [t.qid for t in self._tickets.values()
                 if not t.event.is_set()]
      return {
          "queued_keys": self._policy.keys(),
          "slot_keys": list(self._slot_key),
          "num_tickets": len(self._tickets),
          "pending_qids": pending,
          "closed": self._closed,
          "admission_policy": self._policy.name,
          "tenant_depth": self._policy.tenant_depths(),
      }
