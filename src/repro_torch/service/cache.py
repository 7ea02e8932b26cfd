"""Result cache for served graph queries (port of :mod:`repro.service.cache`).

Keys are ``(graph fingerprint, program name, query spec)``.  The fingerprint
hashes the graph's arrays as host bytes (``.cpu().numpy()`` of each tensor),
so a rebuilt-but-identical graph hits and a mutated graph misses; servers
compute it once at construction.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional, Tuple

from repro_torch.service.metrics import Counters


def graph_fingerprint(graph) -> str:
  """Content hash of a graph container (``n``, ``width`` and its arrays)."""
  h = hashlib.sha1()
  h.update(type(graph).__name__.encode())
  h.update(repr((graph.n, getattr(graph, "width", None))).encode())
  for name, t in graph.arrays().items():
    arr = t.detach().cpu().numpy()
    h.update(name.encode())
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
  return h.hexdigest()


class ResultCache:
  """Thread-safe LRU cache: ``(fingerprint, program, spec) -> result``."""

  def __init__(self, capacity: int = 4096,
               counters: Optional[Counters] = None):
    if capacity <= 0:
      raise ValueError("capacity must be > 0")
    self.capacity = capacity
    self._store: "OrderedDict[Hashable, Any]" = OrderedDict()
    self._lock = threading.RLock()
    self.counters = counters or Counters()

  @staticmethod
  def make_key(fingerprint: str, program_name: str,
               spec: Hashable) -> Tuple:
    return (fingerprint, program_name, spec)

  def get(self, key: Hashable, default: Any = None) -> Optional[Any]:
    """Lookup with an LRU touch; ``default`` on miss (pass a sentinel to
    tell a miss from a cached falsy value)."""
    with self._lock:
      if key in self._store:
        self._store.move_to_end(key)
        self.counters.inc("cache.hits")
        return self._store[key]
      self.counters.inc("cache.misses")
      return default

  def put(self, key: Hashable, value: Any) -> None:
    with self._lock:
      if key in self._store:
        self._store.move_to_end(key)
      self._store[key] = value
      if len(self._store) > self.capacity:
        self._store.popitem(last=False)
        self.counters.inc("cache.evictions")

  def __len__(self) -> int:
    with self._lock:
      return len(self._store)

  def __contains__(self, key: Hashable) -> bool:
    with self._lock:
      return key in self._store
