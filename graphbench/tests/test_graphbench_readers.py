"""Each per-layer reader on a recorded synthetic window, and the reduction
of profiler events to that window."""

import pytest

from graphbench import manifest, readers, trace

SUMMARY = {
    "window_s": 1.0, "busy_s": 0.8, "device_ops": 9,
    "kernel_s": {
        "void ell_spmv_kernel<Operands<float, float, float, float, float>>"
        "(Args)": 0.10,
        "void lanes_kernel<CfProcess>(Args)": 0.02,
        "void at::native::_scatter_gather_elementwise_kernel<128, 4>(int)":
            0.50,
        "void at::native::index_elementwise_kernel<128, 4>(long)": 0.15,
        "void at::native::indexFuncLargeIndex<float, long>(float*)": 0.05,
        "void at::native::vectorized_elementwise_kernel<4, AddFunctor>()":
            0.05},
    "idle_s_by_host": {"aten::item": 0.15, "python": 0.05}}
REC = {"summary": SUMMARY, "window_s": 1.2, "units": 10,
       "counters": {"slot_util_sum": 7.5, "slot_util_count": 10},
       "bytes": 3.35e10, "spmv_wall_s": 2.0}
WANT = {"coo_ms": 70.0, "ell_kernel_ms": 12.0, "idle_share": 20.0,
        "superstep_ms": 120.0, "spmv_roofline": 0.5, "slot_fill": 75.0}
PER_LAYER = [m["name"] for m in manifest.load()["per_layer"]]


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader(name):
  got = readers.load(name).read(REC)
  assert got == pytest.approx(WANT[name.split(".")[0]])


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_with_nothing_to_read(name):
  assert readers.load(name).read({"window_s": 1.0}) is None


def test_no_device_time_reads_nothing():
  empty = {**REC, "summary": {**SUMMARY, "busy_s": 0.0, "kernel_s": {}}}
  for name in PER_LAYER:
    if name.split(".")[0] in ("coo_ms", "ell_kernel_ms", "idle_share"):
      assert readers.load(name).read(empty) is None


class Ev:
  def __init__(self, kind, name, lo, hi, stream=7):
    self._k, self._n, self._lo, self._hi, self._s = kind, name, lo, hi, stream

  def activity_type(self):
    return self._k

  def name(self):
    return self._n

  def start_ns(self):
    return self._lo

  def duration_ns(self):
    return self._hi - self._lo

  def device_resource_id(self):
    return self._s


class OldEv(Ev):
  """An event of a PyTorch whose events have no ``activity_type``."""

  activity_type = None

  def __getattribute__(self, name):
    if name == "activity_type":
      raise AttributeError(name)
    return object.__getattribute__(self, name)

  def device_type(self):
    from torch.autograd import DeviceType
    return DeviceType.CUDA if self._k in ("kernel", "gpu_memcpy",
                                           "gpu_user_annotation") \
        else DeviceType.CPU

  def is_user_annotation(self):
    return "annotation" in self._k


@pytest.mark.parametrize("event", [Ev, OldEv], ids=["typed", "untyped"])
def test_summarize_window(event):
  Ev = event  # noqa: N806
  events = [
      Ev("user_annotation", trace.WINDOW, 1000, 2000),
      Ev("kernel", "k1", 900, 1100),             # clipped to the window
      Ev("kernel", "k1", 900, 1100),             # reported twice: once
      Ev("kernel", "k2", 1050, 1200),            # overlaps k1
      Ev("gpu_memcpy", "Memcpy DtoH", 1500, 1600),
      Ev("kernel", "late", 2100, 2200),          # outside the window
      Ev("gpu_user_annotation", trace.WINDOW, 1000, 2000),
      Ev("cpu_op", "aten::item", 1210, 1490),
      Ev("cuda_runtime", "cudaMemcpyAsync", 1250, 1480),
      Ev("cpu_op", "aten::add", 1700, 1800),
  ]
  s = trace.summarize(events)
  assert s["window_s"] == pytest.approx(1000e-9)
  assert s["busy_s"] == pytest.approx((1200 - 1000 + 100) * 1e-9)
  assert s["kernel_s"]["k1"] == pytest.approx(100e-9)
  assert "late" not in s["kernel_s"]
  assert s["kernel_n"] == {"k1": 1, "k2": 1, "Memcpy DtoH": 1}
  # Gaps: 1200-1500 (mid 1350: cudaMemcpyAsync, the innermost), 1600-2000
  # (mid 1800: aten::add ends there, still open).
  assert s["idle_s_by_host"]["cudaMemcpyAsync"] == pytest.approx(300e-9)
  assert s["idle_s_by_host"]["aten::add"] == pytest.approx(400e-9)
  b = trace.breakdown(s)
  assert b["device_ops"][0][0] == "k2" and len(b["device_ops"]) <= 10
  assert b["idle_gaps"][0][0] == "aten::add"


ELL_NAMES = {"void ell_spmv_kernel<Operands<float>>(Args)": 99,
             "void lanes_kernel<CfProcess>(Args)": 50,
             "void active_pass<CfProcess>(Args)": 50,
             "void at::native::index_elementwise_kernel<128, 4>(long)": 300}


@pytest.mark.parametrize("launched, lost", [(199, False), (200, False),
                                            (201, False), (197, True),
                                            (196, True), (230, True),
                                            (0, True)])
def test_lost_events(launched, lost):
  """The ELL kernels' events in the window against the launches counted;
  a window that lost (or gained) more than 1% of them is not read."""
  summary = {"kernel_n": ELL_NAMES}
  if lost:
    with pytest.raises(trace.LostEvents):
      trace.lost_events(summary, launched, readers.ELL_KERNELS)
  else:
    assert trace.lost_events(summary, launched, readers.ELL_KERNELS) == (
        199, launched)


def test_no_ell_kernel_launched_none_seen():
  assert trace.lost_events({"kernel_n": {"k": 3}}, 0,
                           readers.ELL_KERNELS) == (0, 0)


def test_window_pads_as_the_smoke_run_widest():
  assert trace.PAD_S == 2.0
