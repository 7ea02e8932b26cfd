#!/usr/bin/env python3
"""The ELL kernel's fixed cost a launch, on the card and on the host.

    python3 tools/ell_launch_cost.py
    PYTHONPATH=<other checkout>/src python3 tools/ell_launch_cost.py

On the card (``torch.profiler``'s device time a launch, the mean of 50):
an empty launch of the cooperative kernel's resident grid (blocks of 256
threads), plain and cooperative, the cooperative launch's grid barrier
alone, its pass over 1,048,576 active flags alone (a plain launch), and the
two together, as ``src/repro_torch/kernels/csrc/ell_spmv.cu`` begins a
cooperative launch (``tools/ell_launch_cost.cu``).  On the host
(microseconds a call, the median of 5 loops of 2,000 calls, the card
synchronized between loops): the wrapper ``ell_spmv`` of the package on
``PYTHONPATH`` at PageRank's form on the road grid (side ``--side``), and
the pieces a launch through ``ctypes`` can pay: two ``torch.empty``, a
device guard, a stream query, a bare ``ctypes`` launch.  Prints one JSON
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("plain_empty", "cooperative_empty", "cooperative_barrier",
         "plain_flag_pass", "cooperative_flag_pass_and_barrier")
N_FLAGS = 1 << 20


def _bind(lib: ctypes.CDLL) -> None:
  lib.ell_cost_resident.argtypes = [ctypes.c_int]
  lib.ell_cost_resident.restype = ctypes.c_int
  lib.ell_cost_launch.argtypes = ([ctypes.c_int] * 3
                                  + [ctypes.c_void_p, ctypes.c_int]
                                  + [ctypes.c_void_p] * 3)
  lib.ell_cost_launch.restype = ctypes.c_int


def host_us(fn, calls: int = 2000, loops: int = 5) -> float:
  import torch
  for _ in range(50):
    fn()
  torch.cuda.synchronize()
  took = []
  for _ in range(loops):
    t0 = time.perf_counter()
    for _ in range(calls):
      fn()
    took.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
  return statistics.median(took)


def device_us(fn, calls: int = 50) -> float:
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
  kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
  return sum(e.time_range.elapsed_us() for e in kernels) / len(kernels)


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--side", type=int, default=1024,
                  help="the road grid's side for the wrapper's host time")
  args = ap.parse_args(argv)
  import torch
  if not torch.cuda.is_available():
    print("ell_launch_cost: no CUDA device", file=sys.stderr)
    return 2
  sys.path.append(str(ROOT / "src"))
  sys.path.insert(0, str(ROOT / "examples"))
  from graph_analytics_suite_torch import grid_road_graph
  from repro_torch.core import graph as G
  from repro_torch.kernels import _build
  from repro_torch.kernels import ell_spmv as ell
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  lib = _build.CudaLibrary(str(ROOT / "tools" / "ell_launch_cost.cu"),
                           _bind).load()
  threads = 256
  blocks = lib.ell_cost_resident(threads)
  sync = torch.zeros(4, dtype=torch.int32, device="cuda")
  out = torch.zeros(blocks, dtype=torch.int32, device="cuda")
  stream = torch.cuda.current_stream().cuda_stream
  gen = torch.Generator(device="cuda").manual_seed(0)
  actives = {"all": torch.ones(N_FLAGS, dtype=torch.bool, device="cuda"),
             "10%": torch.rand(N_FLAGS, generator=gen, device="cuda") < 0.1}
  device = {}
  for name, act in actives.items():
    for kind, label in enumerate(KINDS):
      def launch(kind=kind, act=act):
        rc = lib.ell_cost_launch(kind, blocks, threads, act.data_ptr(),
                                 N_FLAGS, sync.data_ptr(), out.data_ptr(),
                                 stream)
        if rc != 0:
          raise RuntimeError(f"ell_cost_launch({label}) failed: {rc}")
      device[f"{label},{name} active"] = device_us(launch)

  n, src, dst, w = grid_road_graph(args.side, seed=0)
  g = G.build_ell(src, dst, w, n=n, device="cuda")
  ext = {"row_end": g.row_end, "mask_prefix": g.mask_prefix,
         "segments": ell.row_segments(g.row_end)}
  msg = torch.rand((n, 1), device="cuda")
  every = torch.ones(n, dtype=torch.bool, device="cuda")
  dev = g.cols.device

  def guard():
    with torch.cuda.device(dev):
      pass

  host = {
      "wrapper ell_spmv (road grid, PageRank)": host_us(
          lambda: ell.ell_spmv(g.cols, g.vals, g.mask, msg, every,
                               process_op="msg", reduce_kind="add", **ext),
          calls=500),
      "two torch.empty": host_us(lambda: (
          torch.empty((n, 1), device=dev),
          torch.empty((n,), dtype=torch.int8, device=dev))),
      "torch.cuda.device guard": host_us(guard),
      "torch.cuda.current_stream().cuda_stream": host_us(
          lambda: torch.cuda.current_stream(dev).cuda_stream),
      "torch._C._cuda_getCurrentRawStream": host_us(
          lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
      "bare ctypes launch (plain empty)": host_us(
          lambda: lib.ell_cost_launch(0, blocks, threads, 0, 0, 0, 0, stream),
          calls=500),
  }
  print(json.dumps({"card": card, "package": ell.__file__,
                    "resident_blocks": blocks, "threads": threads,
                    "device_us": device, "host_us": host}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
