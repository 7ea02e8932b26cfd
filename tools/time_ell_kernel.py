#!/usr/bin/env python3
"""Time the ELL kernel's wrapper on the RMAT-20 graph or the road grid.

    python3 tools/time_ell_kernel.py --graph build/rmat20.npz
    python3 tools/time_ell_kernel.py --graph road:1024 --block-rows 4,8,16,32
    python3 tools/time_ell_kernel.py --graph road:1024 \\
        --compare <checkout A>/src <checkout B>/src

Times ``repro_torch.kernels.ell_spmv.ell_spmv`` from the package on
``PYTHONPATH`` (else this checkout's ``src``).  With ``--compare A B`` it
runs itself four times, with ``PYTHONPATH`` set to A, B, B and A in turn,
so that two versions of the kernel meet the same card in one call, and
prints their four records on one line.

Graphs: ``--graph PATH.npz`` is the RMAT graph ``chip_smoke.py`` serves
(scale 20, edge factor 16, Graph500 parameters, self-loops removed,
symmetrized) as ELL arrays, built at the first run and kept in ``PATH``;
``--graph road:SIDE`` is the examples' road grid
(``examples/graph_analytics_suite_torch.py::grid_road_graph``, seed 0;
side 1,024 gives 1,048,576 vertices and 4,190,208 edges), built each run.

Rows (milliseconds a launch; CUDA events, the median of 5 means of 20
launches; and the kernel's own time from ``torch.profiler``'s device
events, since on the road grid the events time the host's pace of issuing
calls): PageRank f32 add at Q = 1 with every source active, with
``torch.sparse.mm`` on the same matrix as CSR timed after it; BFS int32 min and
SSSP f32 min at Q = 1 on the calls recorded from one BFS and one SSSP run
of the graph through ``Plan("cuda_ell")`` (every call on the RMAT graph,
every 16th on the road grid) and at three frontiers (every source active,
10%, all but one); BFS int32 min at Q = 8 at the three frontiers; the
destination-reading gradient form f32 add at Q = 1 (Kd = 1) and Q = 8
(Kd = 8) with every source active; and, where the package traces a
program's own process, SSSP written as ``lambda m, e, d: e + m`` (a
generated instance) on the SSSP row's calls and frontiers.  Each at every ``--block-rows`` given
(default: the wrapper's own).  Each row carries its byte bound (the bytes
the work needs over 3.35 TB/s, as ``chip_smoke.py`` counts them).  The
output is one JSON line with the card's name and power limit as
``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("cols", "vals", "mask", "row_of", "packed_of")
H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
ROAD_RECORD_EVERY = 16
DST_OP = "edge_minus_msg_dst_times_msg"
EDGE_OPS = ("msg_plus_edge", "msg_times_edge", DST_OP)
E_PLUS_M = "traced:e+m"
# name -> process_op, reduce, dtype name, Q, Kd (None: no dprop),
# frontiers ("recorded": the calls of the graph's own run of that algorithm)
ROWS = {
    "pagerank,f32,add,Q=1": ("msg", "add", "float32", 1, None, ("all",)),
    "bfs,int32,min,Q=1": ("msg_plus_one", "min", "int32", 1, None,
                          ("recorded", "all", "10%", "all_but_one")),
    "sssp,f32,min,Q=1": ("msg_plus_edge", "min", "float32", 1, None,
                         ("recorded", "all", "10%", "all_but_one")),
    "bfs,int32,min,Q=8": ("msg_plus_one", "min", "int32", 8, None,
                          ("all", "10%", "all_but_one")),
    "gradient,f32,add,Q=1,Kd=1": (DST_OP, "add", "float32", 1, 1, ("all",)),
    "gradient,f32,add,Q=8,Kd=8": (DST_OP, "add", "float32", 8, 8, ("all",)),
    # SSSP's process written as the lambda e + m: a generated instance (the
    # trace is msg_plus_edge's with its operands swapped), timed where the
    # package traces processes.
    "sssp_e_plus_m,f32,min,Q=1": (E_PLUS_M, "min", "float32", 1, None,
                                  ("recorded", "all", "10%", "all_but_one")),
}


def card_line() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()


def load_graph(spec: str, scale: int):
  """``(graph on the card, BFS/SSSP root, every-k of the recorded calls)``."""
  import numpy as np
  from repro_torch.core import graph as G
  if spec.startswith("road:"):
    sys.path.insert(0, str(ROOT / "examples"))
    from graph_analytics_suite_torch import grid_road_graph
    n, src, dst, w = grid_road_graph(int(spec.split(":", 1)[1]), seed=0)
    return G.build_ell(src, dst, w, n=n, device="cuda"), 0, ROAD_RECORD_EVERY
  path = pathlib.Path(spec)
  if not path.exists():
    from repro_torch.graphs import remove_self_loops, rmat_edges, symmetrize
    src, dst = rmat_edges(scale, 16, abc=(0.57, 0.19, 0.19), seed=0)
    src, dst = symmetrize(*remove_self_loops(src, dst))
    w = np.random.default_rng(1).uniform(0.1, 2.0, src.shape[0]).astype(
        np.float32)
    arrays, _, width = G.ell_arrays(src, dst, w, n=1 << scale)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, n=1 << scale, width=width, **arrays)
  data = np.load(path)
  g = G.from_arrays("ell", int(data["n"]), {f: data[f] for f in FIELDS},
                    width=int(data["width"]), device="cuda")
  # The vertex of the first packed row: the highest in-degree.
  return g, int(data["row_of"][0]), 1


def record(g, root: int, every: int) -> dict:
  """``(msg, active)`` of every ``every``-th kernel call of one BFS and one
  SSSP from ``root`` through ``Plan("cuda_ell")``."""
  from repro_torch.algos.bfs import bfs_program
  from repro_torch.algos.multi import bfs_column, sssp_column
  from repro_torch.algos.sssp import sssp_program
  from repro_torch.core import Plan, run_graph_program
  from repro_torch.kernels import ops as kops
  out = {}
  for name, prog, column in (("bfs,int32,min,Q=1", bfs_program(), bfs_column),
                             ("sssp,f32,min,Q=1", sssp_program(),
                              sssp_column)):
    calls, launch, seen = [], kops.ell_spmv, [0]

    def recording(cols, vals, mask, msg, active, **kw):
      if seen[0] % every == 0:
        calls.append((msg.clone(), active.clone()))
      seen[0] += 1
      return launch(cols, vals, mask, msg, active, **kw)

    kops.ell_spmv = recording
    try:
      run_graph_program(g, prog, *column(root, g.n, g.cols.device),
                        backend=Plan("cuda_ell"))
    finally:
      kops.ell_spmv = launch
    out[name] = calls
  return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3, repeats: int = 5) -> float:
  import torch
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  means = []
  for _ in range(repeats):
    start.record()
    for _ in range(iters):
      fn()
    end.record()
    end.synchronize()
    means.append(start.elapsed_time(end) / iters)
  return statistics.median(means)


PAD_S = 0.05


def device_ms(fn, calls: int, repeats: int = 3) -> float:
  """The card's kernel time a call of ``fn``, which makes ``calls`` calls:
  ``torch.profiler``'s device events in the window, summed, over the
  calls (the events of :func:`cuda_ms` also time the host issuing them).
  The window is padded by :data:`PAD_S` of host sleep on both sides: the
  profiler keeps only the device events that fall inside it on the host's
  clock, and in a long process a window of a few short launches came back
  empty (``chip_smoke.py``'s road PageRank row in PR 22).  Raises if the
  profiler saw fewer kernels than the calls launched."""
  import time
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    time.sleep(PAD_S)
    for _ in range(repeats):
      fn()
    torch.cuda.synchronize()
    time.sleep(PAD_S)
  kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
  if len(kernels) < repeats * calls:
    raise RuntimeError(f"the profiler saw {len(kernels)} kernels of "
                       f"{repeats * calls} launches")
  busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
  return busy / (repeats * calls)


def csr_of(g):
  """The packed ELL matrix as CSR over the 0/1 pattern, columns sorted
  within each row: ``torch.sparse.mm`` of it is PageRank's form."""
  import torch
  rows, slots = g.mask.nonzero(as_tuple=True)
  src = g.cols[rows, slots].long()
  order = torch.argsort(rows * g.n + src)
  rows, src = rows[order], src[order]
  crow = torch.zeros(g.n_pad + 1, dtype=torch.int64, device="cuda")
  crow[1:] = torch.cumsum(torch.bincount(rows, minlength=g.n_pad), 0)
  ones = torch.ones(src.shape, dtype=torch.float32, device="cuda")
  return torch.sparse_csr_tensor(crow, src, ones, size=(g.n_pad, g.n))


def bound_ms(g, valid_slots: int, op: str, q: int, kd, size: int,
             calls) -> float:
  """The bytes the work needs over the HBM rate, a launch on average: cols
  of the valid slots, vals for the edge forms of the valid slots whose
  source is active, one row extent per packed row, the active sources'
  messages, active and dprop once, y and recv once (``chip_smoke.py``'s
  count)."""
  active_msgs = sum(int(a.sum()) for _, a in calls) / len(calls)
  edge_slots = (sum(int((g.mask & a[g.cols]).sum()) for _, a in calls)
                / len(calls) if op in EDGE_OPS else 0)
  need = (valid_slots * 4 + edge_slots * 4 + 4 * g.n_pad
          + active_msgs * q * size + g.n + (0 if kd is None
                                            else g.n_pad * kd * size)
          + g.n_pad * q * size + g.n_pad)
  return need / H100_BYTES_PER_S * 1e3


def measure(args) -> dict:
  import torch
  sys.path.append(str(ROOT / "src"))
  from repro_torch.kernels import ell_spmv as ell
  g, root, every = load_graph(args.graph, args.scale)
  ext = {"row_end": g.row_end, "mask_prefix": g.mask_prefix,
         "segments": ell.row_segments(g.row_end)}
  n = g.n
  recorded = record(g, root, every)
  gen = torch.Generator(device="cuda").manual_seed(7)
  every_src = torch.ones((n,), dtype=torch.bool, device="cuda")
  frontiers = {"all": every_src,
               "10%": torch.rand((n,), generator=gen, device="cuda") < 0.1,
               "all_but_one": every_src.clone().index_fill_(
                   0, torch.tensor([n - 1], device="cuda"), False)}
  valid_slots = int(g.mask.sum())
  block_rows = [int(b) for b in args.block_rows.split(",") if b] or [None]
  ms = {str(b or "default"): {} for b in block_rows}
  dev_ms = {str(b or "default"): {} for b in block_rows}
  bounds, library = {}, {}
  csr = None
  for name, (op, red, dt, q, kd, fronts) in ROWS.items():
    dtype = getattr(torch, dt)
    if op == E_PLUS_M:
      if not hasattr(ell, "library_for"):
        continue  # a package that takes only the shipped forms
      from repro_torch.kernels import process_expr
      form = {"process": process_expr.trace(lambda m, e, d: e + m, dtype,
                                            lane=False, reads_dst=False)}
      recorded[name] = recorded["sssp,f32,min,Q=1"]
    else:
      form = {"process_op": op}
    msg = (torch.randint(0, 64, (n, q), generator=gen, device="cuda",
                         dtype=dtype) if dtype == torch.int32
           else torch.rand((n, q), generator=gen, device="cuda"))
    dprop = (None if kd is None
             else torch.rand((g.n_pad, kd), generator=gen, device="cuda"))
    runs = {f: ([(msg, frontiers[f])] if f != "recorded"
                else recorded[name]) for f in fronts}
    bounds[name] = {f: bound_ms(g, valid_slots,
                                "msg_plus_edge" if op == E_PLUS_M else op, q,
                                kd, msg.element_size(), calls)
                    for f, calls in runs.items()}
    for b in block_rows:
      key = str(b or "default")
      row = ms[key][name] = {}
      drow = dev_ms[key][name] = {}
      for f, calls in runs.items():
        def run(calls=calls, b=b):
          for m, a in calls:
            ell.ell_spmv(g.cols, g.vals, g.mask, m, a, **form,
                         reduce_kind=red, dprop=dprop, block_rows=b, **ext)
        row[f] = cuda_ms(run, iters=max(1, 20 // len(calls))) / len(calls)
        drow[f] = device_ms(run, len(calls))
    if op == "msg":
      csr = csr_of(g) if csr is None else csr
      y, _ = ell.ell_spmv(g.cols, g.vals, g.mask, msg, every_src,
                          process_op=op, reduce_kind=red, **ext)
      torch.testing.assert_close(torch.sparse.mm(csr, msg), y, rtol=1e-4,
                                 atol=1e-4 * float(y.abs().max()))
      library[name] = cuda_ms(lambda: torch.sparse.mm(csr, msg))
      library[name + ",device"] = device_ms(
          lambda: torch.sparse.mm(csr, msg), 1)
  return {"label": args.label, "card": card_line(), "package": ell.__file__,
          "graph": args.graph, "n": n, "n_pad": g.n_pad, "width": g.width,
          "valid_slots": valid_slots,
          "recorded_calls": {k: len(v) for k, v in recorded.items()},
          "ms": ms, "device_ms": dev_ms,
          "bound_ms": bounds, "torch_sparse_mm_ms": library}


def compare(args) -> int:
  """This script four times, PYTHONPATH A, B, B, A; one line of all four."""
  runs = []
  for label, path in zip("ABBA", (args.compare[0], args.compare[1],
                                  args.compare[1], args.compare[0])):
    argv = [sys.executable, __file__, "--graph", args.graph, "--scale",
            str(args.scale), "--block-rows", args.block_rows, "--label",
            label]
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(path).resolve()))
    proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
      sys.stderr.write(proc.stderr)
      return proc.returncode
    runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
  print(json.dumps({"card": card_line(), "graph": args.graph,
                    "order": "ABBA", "pythonpath": args.compare,
                    "runs": runs}), flush=True)
  return 0


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--graph", required=True,
                  help="file of the RMAT graph's ELL arrays (made if "
                  "missing), or road:SIDE for the road grid")
  ap.add_argument("--scale", type=int, default=20)
  ap.add_argument("--block-rows", default="",
                  help="comma-separated warps per block to time besides "
                  "the wrapper's default")
  ap.add_argument("--label", default="this checkout")
  ap.add_argument("--compare", nargs=2, metavar=("SRC_A", "SRC_B"),
                  help="run once per PYTHONPATH, in the order A, B, B, A")
  args = ap.parse_args(argv)
  import torch
  if not torch.cuda.is_available():
    print("time_ell_kernel: no CUDA device", file=sys.stderr)
    return 2
  if args.compare:
    return compare(args)
  print(json.dumps(measure(args)), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
