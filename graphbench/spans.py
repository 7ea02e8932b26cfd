"""The port's spans (``graphmat.*`` profiler ranges, ``repro_torch.tracing``)
in a traced window: card time by the span that launched it, idle time by
the span the host was in, and each span's own host time.

:func:`reduce` takes the same kineto events as
:func:`graphbench.trace.summarize`, and the same window, device operations
(each once, clipped to the window) and idle gaps, so that its sums meet
the summary's:

* ``span_device_s``: each device operation is linked once, through its
  ``correlation_id``, to the CUDA runtime or driver call that launched it
  (the call carries the same id; ``linked_correlation_id`` names the
  innermost PyTorch operation instead, from another run of ids), and
  credited to the innermost ``graphmat.`` span open on that call's thread
  when the call began, or to ``outside``; an operation whose call is not
  among the events goes under ``unlinked``.  The values sum to the
  summary's ``kernel_s``.
* ``idle_s_by_span``: each idle gap by the innermost ``graphmat.`` span
  open, on any thread, at its midpoint (the one that began last, as the
  summary labels gaps by host operation), or ``outside``.  The values sum
  to the window's idle seconds.
* ``span_host_s``: ``[count, seconds]`` of each span that began and ended
  inside the window.

Spans are recorded on the threads the profiler records: the thread that
started it, or every thread under ``profile_all_threads``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from graphbench import trace
from graphbench.readers import per_unit_ms

PREFIX = "graphmat."
OUTSIDE = "outside"
UNLINKED = "unlinked"
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
# A span is a host operation (the port's) or a user annotation (a
# ``record_function`` of that name).
HOST_SPANS = ("cpu_op", "user_annotation")


def is_launch(kind: str, name: str) -> bool:
  """Whether a host event is a CUDA runtime or driver call: by its kineto
  activity where PyTorch gives one, else by the API's names (``cuda*``,
  ``cu`` and a capital), as PyTorch 2.11's events type them all as host
  operations."""
  if kind in LAUNCH_KINDS:
    return True
  return kind == "cpu_op" and (name.startswith("cuda") or (
      name.startswith("cu") and name[2:3].isupper()))


def _innermost(spans: List[tuple], times: List[int]) -> List[str]:
  """The innermost of ``spans`` ((start, end, name)) open at each of
  ``times``, or ``outside``."""
  labels = trace._label_gaps([(t, t) for t in times], spans)
  return [OUTSIDE if label == "python" else label for label in labels]


def reduce(events, window: Optional[Tuple[int, int]] = None) -> Dict:
  device: Dict[tuple, int] = {}           # (stream, name, lo, hi) -> corr
  launches: Dict[int, Tuple[int, int]] = {}  # corr -> (thread, start)
  spans: Dict[int, List[tuple]] = {}      # thread -> [(start, end, name)]
  for ev in events:
    kind = trace.activity(ev)
    name = ev.name()
    lo = ev.start_ns()
    hi = lo + ev.duration_ns()
    if kind in trace.DEVICE_ACTIVITIES:
      device.setdefault((ev.device_resource_id(), name, lo, hi),
                        ev.correlation_id())
    elif name == trace.WINDOW and kind == "user_annotation":
      window = (lo, hi)
    elif kind in HOST_SPANS and name.startswith(PREFIX):
      spans.setdefault(ev.start_thread_id(), []).append((lo, hi, name))
    elif is_launch(kind, name):
      launches[ev.correlation_id()] = (ev.start_thread_id(), lo)
  if window is None:
    raise RuntimeError("the profiler recorded no window annotation")
  w_lo, w_hi = window

  ops: List[Tuple[int, int]] = []
  labels: List[str] = []
  asked: Dict[int, List[Tuple[int, int]]] = {}  # thread -> [(op, start)]
  for (_, _, lo, hi), corr in device.items():
    lo, hi = max(lo, w_lo), min(hi, w_hi)
    if hi <= lo:
      continue
    launch = launches.get(corr)
    if launch is not None:
      asked.setdefault(launch[0], []).append((len(ops), launch[1]))
    ops.append((lo, hi))
    labels.append(UNLINKED)
  for thread, which in asked.items():
    found = _innermost(spans.get(thread, []), [t for _, t in which])
    for (k, _), label in zip(which, found):
      labels[k] = label
  span_device: Dict[str, float] = {}
  for (lo, hi), label in zip(ops, labels):
    span_device[label] = span_device.get(label, 0.0) + (hi - lo) / 1e9

  every = [s for thread in spans.values() for s in thread]
  busy = trace._merge(ops)
  gaps, prev = [], w_lo
  for lo, hi in busy:
    if lo > prev:
      gaps.append((prev, lo))
    prev = hi
  if w_hi > prev:
    gaps.append((prev, w_hi))
  idle: Dict[str, float] = {}
  for (lo, hi), label in zip(gaps, _innermost(
      every, [(lo + hi) // 2 for lo, hi in gaps])):
    idle[label] = idle.get(label, 0.0) + (hi - lo) / 1e9

  host: Dict[str, List] = {}
  for lo, hi, name in every:
    if w_lo <= lo and hi <= w_hi:
      entry = host.setdefault(name, [0, 0.0])
      entry[0] += 1
      entry[1] += (hi - lo) / 1e9
  return {"span_device_s": span_device, "idle_s_by_span": idle,
          "span_host_s": host}


def metrics(spans: Dict, units) -> Dict[str, Optional[float]]:
  """The per-layer readings of a window's spans, a unit (superstep or
  sweep) at a time: card ms in the spill merge and in ``coo_tiled``,
  card-idle ms while the host was inside any span, and the mean host µs
  of one ELL wrapper call; each None where the window holds nothing of
  it (a program that records no span reads None throughout)."""
  dev = spans["span_device_s"]
  idle = sum(s for name, s in spans["idle_s_by_span"].items()
             if name.startswith(PREFIX)) if spans["span_host_s"] else None
  count, seconds = spans["span_host_s"].get(PREFIX + "kernels.ell_spmv",
                                            (0, 0.0))
  rec = {"units": units}
  return {"spill_ms": per_unit_ms(rec, dev.get(PREFIX + "spmv.merge_spill")),
          "coo_tiled_ms": per_unit_ms(rec, dev.get(PREFIX + "spmv.coo_tiled")),
          "host_idle_ms": per_unit_ms(rec, idle),
          "ell_host_us": 1e6 * seconds / count if count else None}
