"""Shared benchmark utilities of the port's harness (``benchmarks/*_torch.py``).

The counterpart of ``benchmarks/common.py``, which imports JAX at its top,
so the port keeps its own copy of :func:`row`.  The card's data-sheet rates
that the counted sections (Fig. 5, the roofline) divide by are here too.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_leaves

# NVIDIA's H100 SXM data sheet (dense, 700 W): the bf16 tensor-core rate and
# the HBM3 bandwidth.
H100_BF16_OPS_PER_S = 989e12
H100_BYTES_PER_S = 3.35e12
# The same data sheet's NVLink figure, 900 GB/s per GPU over both
# directions, taken as 450 GB/s a direction.  Unmeasured: one card has no
# peer to measure it against.
H100_NVLINK_BYTES_PER_S = 450e9


def _sync(out) -> None:
  """Wait for the card when any tensor of ``out`` lies on it."""
  leaves = tree_leaves(out)
  if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
    torch.cuda.synchronize()


def bench(fn: Callable, *args, warmup: int = 2, iters: int = 5,
          **kwargs) -> Tuple[float, object]:
  """Median wall-time (µs) of ``fn(*args)``; each call ends in a
  ``torch.cuda.synchronize()`` when its output is on the card."""
  out = None
  for _ in range(warmup):
    out = fn(*args, **kwargs)
    _sync(out)
  times = []
  for _ in range(iters):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(out)
    times.append(time.perf_counter() - t0)
  return float(np.median(times) * 1e6), out


def row(name: str, us: float, derived: str = "") -> str:
  return f"{name},{us:.1f},{derived}"
