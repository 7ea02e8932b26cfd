"""The traced window: ``torch.profiler`` over the whole measured window, and
its reduction in memory to what the per-layer readers need.

The window is padded by :data:`PAD_S` of host sleep on both sides (the
profiler keeps only device events that fall inside its window on the
host's clock; windows padded by 0.05 s lost the first few milliseconds of
their launches, and 2.0 s, the widest pad of the port's smoke run, saw
them all), and a device operation is counted once per (stream, name,
start, end) (a window once reported operations twice).  Both are kept
from the port's smoke run's profiler window, copied here so that the
yardstick cannot change under a later change to that script.  A measured
window cannot be taken again, so where the ELL kernels' events in it
differ from the launches the port counted by more than
:data:`LOST_SHARE`, the run fails (:func:`lost_events`) rather than
report device times with events missing.  No trace file is written.
"""

from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType

PAD_S = 2.0
LOST_SHARE = 0.01
WINDOW = "graphbench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160


def _merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
  out: List[Tuple[int, int]] = []
  for lo, hi in sorted(spans):
    if out and lo <= out[-1][1]:
      if hi > out[-1][1]:
        out[-1] = (out[-1][0], hi)
    else:
      out.append((lo, hi))
  return out


def _label_gaps(gaps: List[Tuple[int, int]], host: List[tuple]
                ) -> List[str]:
  """The host's innermost operation at each gap's midpoint (the one that
  began last among those open there), or ``python`` where none was."""
  host = sorted(host)                      # (start, end, name)
  order = sorted(range(len(gaps)), key=lambda k: gaps[k][0] + gaps[k][1])
  labels = ["python"] * len(gaps)
  open_: List[tuple] = []                  # heap of (end, start, name)
  nxt = 0
  for k in order:
    mid = (gaps[k][0] + gaps[k][1]) // 2
    while nxt < len(host) and host[nxt][0] <= mid:
      heapq.heappush(open_, (host[nxt][1], host[nxt][0], host[nxt][2]))
      nxt += 1
    while open_ and open_[0][0] < mid:
      heapq.heappop(open_)
    if open_:
      labels[k] = max(open_, key=lambda ev: ev[1])[2]
  return labels


def activity(ev) -> str:
  """The kineto activity of an event: its own ``activity_type`` where
  PyTorch has it, else told from its device and whether it annotates."""
  if hasattr(ev, "activity_type"):
    return ev.activity_type()
  annotation = ev.name() == WINDOW or (
      hasattr(ev, "is_user_annotation") and ev.is_user_annotation())
  if ev.device_type() == DeviceType.CUDA:
    return "gpu_user_annotation" if annotation else "kernel"
  return "user_annotation" if annotation else "cpu_op"


def summarize(events, window: Optional[Tuple[int, int]] = None) -> Dict:
  """Reduce kineto events: the device operations inside the window (each
  once), their union (busy), time by name, and the idle gaps with what the
  host was doing in each."""
  device, host = {}, []
  for ev in events:
    kind = activity(ev)
    name = ev.name()
    lo = ev.start_ns()
    hi = lo + ev.duration_ns()
    if kind in DEVICE_ACTIVITIES:
      device[(ev.device_resource_id(), name, lo, hi)] = None
    elif name == WINDOW and kind == "user_annotation":
      window = (lo, hi)
    elif kind in ("cpu_op", "user_annotation", "cuda_runtime",
                  "cuda_driver"):
      host.append((lo, hi, name))
  if window is None:
    raise RuntimeError("the profiler recorded no window annotation")
  w_lo, w_hi = window
  spans, by_name, count = [], {}, {}
  for (_, name, lo, hi) in device:
    lo, hi = max(lo, w_lo), min(hi, w_hi)
    if hi <= lo:
      continue
    spans.append((lo, hi))
    by_name[name] = by_name.get(name, 0) + (hi - lo)
    count[name] = count.get(name, 0) + 1
  busy = _merge(spans)
  gaps, prev = [], w_lo
  for lo, hi in busy:
    if lo > prev:
      gaps.append((prev, lo))
    prev = hi
  if w_hi > prev:
    gaps.append((prev, w_hi))
  idle_by: Dict[str, int] = {}
  for (lo, hi), label in zip(gaps, _label_gaps(gaps, host)):
    idle_by[label] = idle_by.get(label, 0) + (hi - lo)
  return {"window_s": (w_hi - w_lo) / 1e9,
          "busy_s": sum(hi - lo for lo, hi in busy) / 1e9,
          "device_ops": len(spans),
          "kernel_s": {k: v / 1e9 for k, v in by_name.items()},
          "kernel_n": count,
          "idle_s_by_host": {k: v / 1e9 for k, v in idle_by.items()}}


def breakdown(summary: Dict) -> Dict:
  """The line's ``breakdown``: the device operations that took most time
  and the idle time by what the host was doing, each at most :data:`TOP`."""
  def top(d):
    items = sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:NAME_CHARS], seconds] for name, seconds in items]
  return {"device_ops": top(summary["kernel_s"]),
          "idle_gaps": top(summary["idle_s_by_host"])}


class Window:
  """``with Window(enabled): ...`` profiles the body when enabled;
  :attr:`summary` then holds :func:`summarize`'s reduction."""

  def __init__(self, enabled: bool, device):
    self.enabled = enabled
    self.device = torch.device(device)
    self.summary: Optional[Dict] = None

  def __enter__(self) -> "Window":
    if not self.enabled:
      return self
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if self.device.type == "cuda":
      acts.append(ProfilerActivity.CUDA)
    self._prof = profile(activities=acts)
    self._prof.__enter__()
    time.sleep(PAD_S)
    self._range = record_function(WINDOW)
    self._range.__enter__()
    return self

  def __exit__(self, *exc) -> None:
    if not self.enabled:
      return
    if self.device.type == "cuda":
      torch.cuda.synchronize()
    self._range.__exit__(*exc)
    time.sleep(PAD_S)
    self._prof.__exit__(*exc)
    if exc[0] is None:
      self.summary = summarize(self._prof.profiler.kineto_results.events())
    self._prof = None


def count_matching(names: Dict[str, float], patterns) -> float:
  """The sum over the operations whose name holds any of ``patterns``
  (seconds from ``kernel_s``, events from ``kernel_n``)."""
  return sum(s for name, s in names.items()
             if any(p in name for p in patterns))


class LostEvents(RuntimeError):
  """The trace lost device events of the window."""


def lost_events(summary: Dict, launched: int, patterns) -> Tuple[int, int]:
  """``(seen, launched)``: the events of the kernels ``patterns`` names in
  the window, against the kernels the program launched in it; raises
  :class:`LostEvents` where they differ by more than :data:`LOST_SHARE`
  of the launches (or where none was launched and some are seen)."""
  seen = int(count_matching(summary["kernel_n"], patterns))
  if abs(seen - launched) > LOST_SHARE * launched or (launched == 0
                                                      and seen):
    raise LostEvents(f"the traced window saw {seen} ELL kernel events of "
                     f"{launched} launched; its device times are not read")
  return seen, launched

