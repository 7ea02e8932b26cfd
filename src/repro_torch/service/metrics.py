"""Lightweight service counters/histograms (host-side, no deps).

The serving layer's observability surface: monotonically-increasing
counters, gauges, and power-of-two-bucketed histograms.  Everything is plain
Python on the host — metrics are recorded at continuous-batching round
boundaries, never inside traced code.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional


class Histogram:
  """Power-of-two buckets plus count/sum/min/max.

  ``buckets[i]`` counts observations with ``value <= 2**i`` (first matching
  bucket); values above the last bound land in the +inf bucket.
  """

  def __init__(self, max_pow2: int = 20):
    self.bounds = [2.0 ** i for i in range(max_pow2 + 1)] + [math.inf]
    self.bucket_counts = [0] * len(self.bounds)
    self.count = 0
    self.total = 0.0
    self.min: Optional[float] = None
    self.max: Optional[float] = None

  def observe(self, value: float) -> None:
    value = float(value)
    self.count += 1
    self.total += value
    self.min = value if self.min is None else min(self.min, value)
    self.max = value if self.max is None else max(self.max, value)
    for i, b in enumerate(self.bounds):
      if value <= b:
        self.bucket_counts[i] += 1
        return

  @property
  def mean(self) -> float:
    return self.total / self.count if self.count else 0.0

  def percentile(self, q: float) -> float:
    """Approximate q-quantile (q in [0, 1]) from the bucket upper bounds.

    Returns the upper bound of the first bucket whose cumulative count
    reaches ``q * count`` (the observed max for the +inf bucket); 0.0 when
    empty.  Power-of-two buckets make this a ≤2x overestimate — good enough
    for p50/p95 latency reporting.
    """
    if not self.count:
      return 0.0
    target = q * self.count
    seen = 0
    for bound, c in zip(self.bounds, self.bucket_counts):
      seen += c
      if seen >= target and c:
        return float(self.max if math.isinf(bound) else bound)
    return float(self.max)

  def snapshot(self) -> dict:
    nonzero = {("inf" if math.isinf(b) else int(b)): c
               for b, c in zip(self.bounds, self.bucket_counts) if c}
    return {"count": self.count, "sum": self.total, "mean": self.mean,
            "min": self.min, "max": self.max, "le": nonzero}


class Counters:
  """A named bag of counters, gauges and histograms (thread-safe).

  Labeled variants (``inc_labeled`` / ``observe_labeled`` / ``get_labeled``)
  record under a canonical ``name{k=v,...}`` key (labels sorted), giving
  per-tenant / per-priority-class breakdowns next to the unlabeled totals.
  """

  def __init__(self):
    self._lock = threading.Lock()
    self._counters: Dict[str, float] = {}
    self._gauges: Dict[str, float] = {}
    self._hists: Dict[str, Histogram] = {}

  @staticmethod
  def label_name(name: str, **labels) -> str:
    """Canonical key for a labeled series: ``name{k=v,...}``, keys sorted."""
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"

  def inc(self, name: str, value: float = 1.0) -> None:
    with self._lock:
      self._counters[name] = self._counters.get(name, 0.0) + value

  def inc_labeled(self, name: str, value: float = 1.0, **labels) -> None:
    self.inc(self.label_name(name, **labels), value)

  def get_labeled(self, name: str, **labels) -> float:
    return self.get(self.label_name(name, **labels))

  def observe_labeled(self, name: str, value: float, **labels) -> None:
    self.observe(self.label_name(name, **labels), value)

  def hist(self, name: str) -> Optional[Histogram]:
    """The named histogram (None if never observed)."""
    with self._lock:
      return self._hists.get(name)

  def set_gauge(self, name: str, value: float) -> None:
    with self._lock:
      self._gauges[name] = float(value)

  def set_gauge_max(self, name: str, value: float) -> None:
    """Keep the running maximum — high-water-mark gauges (queue depth)."""
    with self._lock:
      cur = self._gauges.get(name)
      if cur is None or value > cur:
        self._gauges[name] = float(value)

  def observe(self, name: str, value: float) -> None:
    with self._lock:
      h = self._hists.get(name)
      if h is None:
        h = self._hists[name] = Histogram()
      h.observe(value)

  def get(self, name: str) -> float:
    with self._lock:
      return self._counters.get(name, 0.0)

  def snapshot(self) -> dict:
    with self._lock:
      return {
          "counters": dict(self._counters),
          "gauges": dict(self._gauges),
          "histograms": {k: h.snapshot() for k, h in self._hists.items()},
      }
