"""What the comparisons that decide ``correct`` share.

Each kind of work (``graphbench/work/<name>.py``) compares what the timed
path produced with the plain reference run on the benchmark's own inputs,
and gives each number it compares with its limit (``limits/<cell>.json``).
A number passes when it is at most its limit; a number that is not a
number (a NaN, an answer that never came, nothing to compare) fails.  The
readings each limit was set from are in PERF.md.
"""

from __future__ import annotations

import math
from typing import Dict, List

NAN = float("nan")


def number(value: float, limit: float) -> Dict[str, float]:
  return {"value": float(value), "limit": float(limit)}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
  return all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())


def worst(values: List[float]) -> float:
  """The largest value; NaN where any is NaN or there is none."""
  if not values or any(math.isnan(v) for v in values):
    return NAN
  return max(values)
