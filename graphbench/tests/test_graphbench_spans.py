"""The port's spans in a traced window (``graphbench.spans``) on synthetic
kineto events, typed and untyped as in ``test_graphbench_readers.py``, and
on a real CPU profile of the port."""

import importlib.util
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from graphbench import spans, trace
from graphbench.tests.test_graphbench_readers import Ev, OldEv

SUPERSTEP = "graphmat.engine.superstep"
SPILL = "graphmat.spmv.merge_spill"
ELL = "graphmat.kernels.ell_spmv"
ROUND = "graphmat.service.round"
HOST_READ = "graphmat.engine.host_read"


def with_ids(base):
  class SpanEv(base):
    def __init__(self, kind, name, lo, hi, corr=0, tid=1):
      super().__init__(kind, name, lo, hi)
      self._c, self._t = corr, tid

    def correlation_id(self):
      return self._c

    def start_thread_id(self):
      return self._t
  return SpanEv


def window_events(event, annotated=True):
  """Thread 1 runs a superstep holding the spill merge and the ELL
  wrapper; thread 2 a server round; the window is 1000-3000 ns."""
  E = with_ids(event)  # noqa: N806
  events = [
      E("user_annotation", trace.WINDOW, 1000, 3000),
      E("user_annotation", HOST_READ, 950, 1050),     # ends inside
      E("user_annotation", SUPERSTEP, 1100, 1900),
      E("user_annotation", SPILL, 1200, 1500),
      E("user_annotation", ELL, 1520, 1580),
      E("user_annotation", ROUND, 2350, 2900, tid=2),
      E("cuda_runtime", "cudaLaunchKernel", 900, 910, corr=14),
      E("kernel", "k5", 900, 1050, corr=14),           # clipped: outside
      E("cuda_runtime", "cudaLaunchKernel", 1300, 1310, corr=11),
      E("kernel", "k1", 1350, 1450, corr=11),          # inside the spill
      E("kernel", "k1", 1350, 1450, corr=11),          # reported twice
      E("cpu_op", "aten::index", 1590, 1620, corr=12),  # ids of another run
      E("cuda_runtime", "cudaLaunchKernel", 1600, 1610, corr=12),
      E("kernel", "k2", 1600, 1700, corr=12),          # the superstep's
      E("cuda_driver", "cuLaunchKernel", 2000, 2010, corr=13),
      E("kernel", "k3", 2000, 2100, corr=13),          # outside every span
      E("kernel", "k4", 2200, 2300, corr=99),          # no call: unlinked
  ]
  if annotated:
    events.append(E("gpu_user_annotation", SPILL, 1350, 1450, corr=11))
  return events


@pytest.fixture(params=[Ev, OldEv], ids=["typed", "untyped"])
def event(request):
  return request.param


def test_device_time_by_innermost_span(event):
  got = spans.reduce(window_events(event))["span_device_s"]
  assert got == pytest.approx({SPILL: 100e-9, SUPERSTEP: 100e-9,
                               spans.OUTSIDE: 150e-9,
                               spans.UNLINKED: 100e-9})


def test_device_time_sums_to_the_summary(event):
  events = window_events(event)
  got = sum(spans.reduce(events)["span_device_s"].values())
  assert got == pytest.approx(sum(trace.summarize(events)["kernel_s"]
                                  .values()))


def test_idle_by_span_on_any_thread(event):
  events = window_events(event)
  got = spans.reduce(events)["idle_s_by_span"]
  # Gaps 1050-1350 (mid 1200: the spill, begun last), 1450-1600 (1525:
  # the ELL wrapper), 1700-2000 (1850: the superstep), 2100-2200 (2150:
  # none), 2300-3000 (2650: thread 2's round).
  assert got == pytest.approx({SPILL: 300e-9, ELL: 150e-9,
                               SUPERSTEP: 300e-9, spans.OUTSIDE: 100e-9,
                               ROUND: 700e-9})
  s = trace.summarize(events)
  assert sum(got.values()) == pytest.approx(s["window_s"] - s["busy_s"])


def test_host_time_of_spans_inside_the_window(event):
  got = spans.reduce(window_events(event))["span_host_s"]
  assert HOST_READ not in got
  assert got[ELL] == [1, pytest.approx(60e-9)]
  assert got[ROUND] == [1, pytest.approx(550e-9)]


def test_gpu_user_annotation_leaves_busy_and_kernel_time(event):
  plain = trace.summarize(window_events(event, annotated=False))
  annotated = trace.summarize(window_events(event))
  assert annotated["busy_s"] == plain["busy_s"]
  assert annotated["kernel_s"] == plain["kernel_s"]
  assert annotated["kernel_n"] == plain["kernel_n"]


def test_metrics_a_unit():
  got = spans.metrics(spans.reduce(window_events(Ev)), 10)
  assert got == pytest.approx({"spill_ms": 1e-5, "coo_tiled_ms": None,
                               "host_idle_ms": 1.45e-4,
                               "ell_host_us": 0.06}, nan_ok=False)


def test_metrics_with_nothing_to_read():
  empty = {"span_device_s": {}, "idle_s_by_span": {}, "span_host_s": {}}
  assert set(spans.metrics(empty, 10).values()) == {None}
  assert set(spans.metrics(spans.reduce(window_events(Ev)), 0).values()
             ) == {None, 0.06}


@pytest.mark.parametrize("kind, name, launch", [
    ("cpu_op", "cudaLaunchKernel", True),
    ("cpu_op", "cudaLaunchCooperativeKernel", True),
    ("cpu_op", "cuLaunchKernelEx", True),
    ("cuda_runtime", "cudaMemcpyAsync", True),
    ("cpu_op", "aten::scatter_reduce_", False),
    ("cpu_op", "cudnn_convolution", False),
    ("cpu_op", "Runtime Triggered Module Loading", False),
    ("user_annotation", "cudaLaunchKernel", False)])
def test_launch_calls(kind, name, launch):
  assert spans.is_launch(kind, name) is launch


def test_a_real_cpu_profile():
  """The port's own spans through torch's events: no device time here,
  so the window is one idle gap, inside whichever span holds its middle."""
  from repro_torch import tracing
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    with record_function(trace.WINDOW):
      for _ in range(3):
        with tracing.span(tracing.SUPERSTEP), tracing.span(tracing.SPILL):
          torch.ones(64).cumsum(0)
  got = spans.reduce(prof.profiler.kineto_results.events())
  assert got["span_device_s"] == {}
  assert got["span_host_s"][tracing.SUPERSTEP][0] == 3
  assert got["span_host_s"][tracing.SPILL][0] == 3
  (label, seconds), = got["idle_s_by_span"].items()
  assert label in (tracing.SUPERSTEP, tracing.SPILL, spans.OUTSIDE)
  assert seconds > 0


def _span_profile():
  path = pathlib.Path(__file__).resolve().parents[2] / "tools" / (
      "span_profile.py")
  spec = importlib.util.spec_from_file_location("span_profile", path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


@pytest.mark.parametrize("name", ["graph500-s20.sssp",
                                  "graph500-s20.serve-sssp"])
def test_span_profile_reads_a_traced_cell(name):
  """``tools/span_profile.py`` runs the benchmark's own traced cell (tiny,
  on the CPU), sees the port's spans on every thread, and its sums meet
  the window's."""
  from graphbench.tests.test_graphbench_faults import SECONDS, SEED, small
  from graphbench import drive
  real = (torch.profiler.profile, trace.summarize, drive.Served.counters)
  line, out = _span_profile().run(name, SEED, SECONDS, device="cpu",
                                  cell=small(name))
  assert (torch.profiler.profile, trace.summarize,
          drive.Served.counters) == real
  assert line["correct"] and "breakdown" in line
  # A traversal counts its units by the card's ELL launches, none here.
  assert out["units"] > 0 if "serve" in name else out["units"] == 0
  assert "graphmat.engine.superstep" in out["span_host_s"]
  assert out["span_device_sum_s"] == pytest.approx(out["device_s"])
  assert out["idle_by_span_sum_s"] == pytest.approx(out["idle_s"])
  served = "serve" in name
  assert ("graphmat.service.round" in out["span_host_s"]) == served
  for h in ("queue.wait_ms.mean", "query.in_slot_ms.mean"):
    assert (out.get(h, -1.0) >= 0) == served
