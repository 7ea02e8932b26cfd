"""Finding and running the per-layer readers (``metrics/<metric>.py``).

A reader is a module with ``read(rec) -> float | None``; ``rec`` holds the
traced window's reduction (``summary``, :func:`graphbench.trace.summarize`),
the host-clock seconds of the window (``window_s``), the units of work in
it (``units``: supersteps or sweeps), and what its driver adds (server
``counters``; the ``bytes`` the SpMVs need and the ``spmv_wall_s`` they took).
A reader that finds nothing to read returns None, and the metric is left
out of the line.

The kernel names that the readers sort device time by are here, so that
every reader of one kind counts the same operations.
"""

from __future__ import annotations

import importlib.util
import pathlib
from typing import Dict, Optional

from graphbench import roofline
from graphbench.trace import count_matching

HERE = pathlib.Path(__file__).resolve().parent / "metrics"

# The port's hand-written ELL kernels (kernels/csrc/ell_spmv_body.cuh).
ELL_KERNELS = ("ell_spmv_kernel", "lanes_kernel", "active_pass")
# PyTorch's CUDA kernels for gathers, scatters and index ops: the COO paths
# (spmv_coo, spmv_coo_tiled, the spill merge) and the ELL path's gathers
# (ATen's ScatterGatherKernel.cu, IndexKernel.cu, Indexing.cu).
TORCH_INDEX_KERNELS = ("scatter", "gather", "index", "Index")


def load(name: str):
  path = HERE / f"{name}.py"
  spec = importlib.util.spec_from_file_location(
      "graphbench_metric_" + name.replace(".", "_"), path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def read_all(names, rec: Dict) -> Dict[str, float]:
  out = {}
  for name in names:
    value = load(name).read(rec)
    if value is not None:
      out[name] = float(value)
  return out


# -- what the readers share ---------------------------------------------------


def per_unit_ms(rec: Dict, seconds: Optional[float]) -> Optional[float]:
  if seconds is None or not rec.get("units"):
    return None
  return 1e3 * seconds / rec["units"]


def device_ms(rec: Dict, which: str) -> Optional[float]:
  """Card milliseconds a unit of work in the ELL kernels (``ell``) or in
  PyTorch's gather, scatter and index kernels (``torch_index``)."""
  summary = rec.get("summary")
  if not summary or not summary["kernel_s"]:
    return None
  names = summary["kernel_s"]
  ell = count_matching(names, ELL_KERNELS)
  if which == "ell":
    seconds = ell
  else:
    others = {k: v for k, v in names.items()
              if not any(p in k for p in ELL_KERNELS)}
    seconds = count_matching(others, TORCH_INDEX_KERNELS)
  return per_unit_ms(rec, seconds)


def idle_percent(rec: Dict) -> Optional[float]:
  summary = rec.get("summary")
  if not summary or summary["busy_s"] <= 0:
    return None
  return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def superstep_ms(rec: Dict) -> Optional[float]:
  return per_unit_ms(rec, rec.get("window_s"))


def roofline_percent(rec: Dict) -> Optional[float]:
  if not rec.get("bytes") or not rec.get("spmv_wall_s"):
    return None
  return roofline.share_percent(rec["bytes"], rec["spmv_wall_s"])
