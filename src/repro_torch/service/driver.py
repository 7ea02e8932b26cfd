"""Background round-loop driver for :class:`GraphQueryServer`.

A :class:`ServerDriver` owns the continuous-batching loop on a dedicated
thread: clients on any thread ``submit`` and block in ``result(qid,
timeout=...)``, while the driver repeatedly calls ``step_round`` on each of
its servers.  One driver can drive several servers (e.g. a BFS server and an
SSSP server over the same graph) — a "mixed traffic" frontend is just a
dict from query kind to server sharing one driver.

The driver sleeps when every server is idle and is woken by a per-driver
event that servers set on new submissions (registered via
``add_wake_listener``), so idle CPU burn is bounded by ``idle_wait``
polling — which also bounds how stale a deadline check can go while idle.
A submission wakes the driver regardless of its priority; with several
servers, each scan pass visits them in descending queued-urgency order
(``GraphQueryServer.queued_urgency`` — the admission policy's highest
queued priority class), so a high-priority arrival on one server is not
stuck behind full rounds on its idle-queue siblings.

Shutdown is deterministic: ``close("drain")`` waits until every server's
queue and slot pool empty, then stops the thread and drain-closes the
servers; ``close("abort")`` stops the thread first and abort-closes them,
failing every pending ticket with ``ServerClosed`` so no client is left
blocked.  If the round loop itself raises, the exception is stored on
``driver.error`` and all servers are abort-closed with that cause.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from repro_torch.service.scheduler import GraphQueryServer


class ServerDriver:
  """Dedicated thread calling ``step_round`` on one or more servers."""

  def __init__(self, *servers: GraphQueryServer, idle_wait: float = 0.02):
    if not servers:
      raise ValueError("ServerDriver needs at least one server")
    self._servers: List[GraphQueryServer] = list(servers)
    self.idle_wait = float(idle_wait)
    self._wake = threading.Event()
    self._stop_evt = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self.error: Optional[BaseException] = None

  @property
  def running(self) -> bool:
    return self._thread is not None and self._thread.is_alive()

  def start(self) -> "ServerDriver":
    if self.running:
      raise RuntimeError("driver already started")
    for server in self._servers:
      server.add_wake_listener(self._wake)
    self._stop_evt.clear()
    self._thread = threading.Thread(
        target=self._run, name="graph-service-driver", daemon=True)
    self._thread.start()
    return self

  def _scan_order(self) -> List[GraphQueryServer]:
    """Servers for one pass, most-urgent queued work first (stable)."""
    if len(self._servers) <= 1:
      return self._servers
    urgency = [(s.queued_urgency(), i) for i, s in enumerate(self._servers)]
    return [self._servers[i] for u, i in
            sorted(urgency, key=lambda t: (t[0] is None, -(t[0] or 0), t[1]))]

  def _run(self) -> None:
    while not self._stop_evt.is_set():
      did_work = False
      for server in self._scan_order():
        if self._stop_evt.is_set():
          return
        try:
          did_work = bool(server.step_round()) or did_work
        except BaseException as e:  # noqa: BLE001 — must not die silently
          self.error = e
          self._stop_evt.set()
          # Unblock every waiting client with the real cause attached.
          for s in self._servers:
            try:
              s.close("abort", reason=e)
            except BaseException:
              pass
          return
      if not did_work:
        self._wake.wait(self.idle_wait)
        self._wake.clear()

  def stop(self, timeout: Optional[float] = 30.0) -> None:
    """Stop the loop (does not settle pending tickets — see ``close``)."""
    self._stop_evt.set()
    self._wake.set()
    if self._thread is not None:
      self._thread.join(timeout)
      if self._thread.is_alive():
        raise RuntimeError("driver thread failed to stop")
      self._thread = None

  def wait_idle(self, timeout: Optional[float] = None,
                poll: float = 0.005) -> None:
    """Block until every server has an empty queue and slot pool."""
    limit = None if timeout is None else time.monotonic() + timeout
    while True:
      if self.error is not None:
        raise self.error
      if all(s.num_queued == 0 and s.num_in_flight == 0
             for s in self._servers):
        return
      if limit is not None and time.monotonic() > limit:
        raise TimeoutError(f"servers still busy after {timeout}s")
      time.sleep(poll)

  def close(self, mode: str = "drain",
            timeout: Optional[float] = 120.0) -> None:
    """Drain (finish all pending work) or abort (fail it), then stop."""
    if mode not in ("drain", "abort"):
      raise ValueError("close mode must be 'drain' or 'abort'")
    if mode == "drain" and self.running:
      self.wait_idle(timeout)
    self.stop()
    for server in self._servers:
      server.close(mode)

  def __enter__(self) -> "ServerDriver":
    return self.start()

  def __exit__(self, exc_type, exc, tb) -> None:
    self.close("drain" if exc_type is None else "abort")
