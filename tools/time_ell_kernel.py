#!/usr/bin/env python3
"""Time the ELL kernel's wrapper on the RMAT-20 graph or the road grid.

    python3 tools/time_ell_kernel.py --graph build/rmat20.npz
    python3 tools/time_ell_kernel.py --graph road:1024 --block-rows 4,8,16,32
    python3 tools/time_ell_kernel.py --graph road:1024 \\
        --compare <checkout A>/src <checkout B>/src
    python3 tools/time_ell_kernel.py --graph netflix:build/netflix.npz \\
        --only cf_one_leaf

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
side 1,024 gives 1,048,576 vertices and 4,190,208 edges), built each run;
``--graph netflix:PATH.npz`` is the item-to-user graph of collaborative
filtering at the Netflix Prize's size as ``chip_smoke.py`` builds it
(``bipartite_ratings(480,189, 17,770, 209, seed=11)``: 46,412,692 ratings;
the rows are users, the sources items), kept in ``PATH`` like the RMAT
graph; only its lane rows run there (no BFS or SSSP is recorded).

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
(Kd = 8) with every source active; where the package traces a program's
own process, SSSP written as ``lambda m, e, d: e + m`` (a generated
instance) on the SSSP row's calls and frontiers; and where it takes
processes that mix lanes and mixed dtypes, PageRank's ``0.85 * m`` in
bfloat16 (every source active), SSSP's ``m + e`` with float32 messages on
the graph's edge values in float16 (the SSSP row's calls and frontiers),
and, with every source active, a K = 16 message and property through the
lane dot score ``(m * d).sum(-1)`` (max) and collaborative filtering's
``(e - (m * d).sum(-1, keepdim=True)) * m`` (add); and PageRank's
``msg`` form over float16 messages (add) at Q = 1 and 8, whose sums the
shipped half instances keep in float; and betweenness centrality's two
sums at Q = 4 (``algos/bc.py``), every source and 10% active: the
forward pass's float64 path counts through the pass-through ``m`` (a
generated instance, where the package takes float64) and the backward
pass's float32 shares through the shipped ``msg``.  ``--only`` keeps the rows whose
names start with one of its prefixes.  Each at every
``--block-rows`` given (default: the wrapper's own).  Each row carries its byte bound (the bytes
the work needs over 3.35 TB/s, as ``chip_smoke.py`` counts them), and each
card time the device events seen and the launches of its window.  The
output is one JSON line with the card's name and power limit as
``nvidia-smi`` reports them; ``--compare`` adds each row's B/A.
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
# Traced rows: op -> (process, edge dtype name (None: the message's), K of
# a lane-mixing process (None: lanewise), whether it reads the property).
TRACED = {
    E_PLUS_M: (lambda m, e, d: e + m, None, None, False),
    "traced:0.85*m": (lambda m, e, d: 0.85 * m, None, None, False),
    "traced:m+e": (lambda m, e, d: m + e, "float16", None, False),
    "traced:dot": (lambda m, e, d: (m * d).sum(-1), None, 16, True),
    "traced:cf": (lambda m, e, d: (e - (m * d).sum(-1, keepdim=True)) * m,
                  None, 16, True),
    "traced:m": (lambda m, e, d: m, None, None, False),
}
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
    # The shipped msg form over float16 messages (every source active).
    "pagerank_f16,f16,add,Q=1": ("msg", "add", "float16", 1, None, ("all",)),
    "pagerank_f16,f16,add,Q=8": ("msg", "add", "float16", 8, None, ("all",)),
    # SSSP's process written as the lambda e + m: a generated instance (the
    # trace is msg_plus_edge's with its operands swapped), timed where the
    # package traces processes.
    "sssp_e_plus_m,f32,min,Q=1": (E_PLUS_M, "min", "float32", 1, None,
                                  ("recorded", "all", "10%", "all_but_one")),
    # Processes over bfloat16 and mixed dtypes, and processes that mix the
    # lanes of a K = 16 message, where the package takes them.
    "pr_bf16,bf16,add,Q=1": ("traced:0.85*m", "add", "bfloat16", 1, None,
                             ("all",)),
    "sssp_half_edges,f32+f16,min,Q=1": (
        "traced:m+e", "min", "float32", 1, None,
        ("recorded", "all", "10%", "all_but_one")),
    "dot_score,f32,max,K=16": ("traced:dot", "max", "float32", 16, 16,
                               ("all",)),
    "cf_one_leaf,f32,add,K=16": ("traced:cf", "add", "float32", 16, 16,
                                 ("all",)),
    # Betweenness centrality's sums at Q = 4: the forward pass's float64
    # path counts (where the package takes them) and the backward pass's
    # float32 shares.
    "bc_sigma,f64,add,Q=4": ("traced:m", "add", "float64", 4, None,
                             ("all", "10%")),
    "bc_delta,f32,add,Q=4": ("msg", "add", "float32", 4, None,
                             ("all", "10%")),
}


def card_line() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()


# Collaborative filtering at the Netflix Prize's size (chip_smoke.py's
# CF_SHAPE and seed): users, items, ratings drawn per user.
NETFLIX = (480_189, 17_770, 209, 11)


def load_graph(spec: str, scale: int):
  """``(graph on the card, BFS/SSSP root, every-k of the recorded calls)``."""
  import numpy as np
  from repro_torch.core import graph as G
  if spec.startswith("road:"):
    sys.path.insert(0, str(ROOT / "examples"))
    from graph_analytics_suite_torch import grid_road_graph
    n, src, dst, w = grid_road_graph(int(spec.split(":", 1)[1]), seed=0)
    return G.build_ell(src, dst, w, n=n, device="cuda"), 0, ROAD_RECORD_EVERY
  netflix = spec.startswith("netflix:")
  path = pathlib.Path(spec.split(":", 1)[1] if netflix else spec)
  if netflix and not path.exists():
    from repro_torch.graphs import bipartite_ratings
    nu, ni, per_user, seed = NETFLIX
    users, items, ratings = bipartite_ratings(nu, ni, per_user, seed=seed)
    arrays, _, width = G.ell_arrays(items + nu, users, ratings, n=nu + ni)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, n=nu + ni, width=width, **arrays)
  elif not path.exists():
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


LOST_SHARE = 0.01  # the share of a window's launches the profiler may lose
# (or find in excess)
# The pad of each window taken before a lossy row raises: a window that
# lost events is taken again with a wider pad.
WINDOW_PADS_S = (0.05, 0.5, 2.0)


def device_ms(fn, calls: int, kernels: int = 1) -> dict:
  """The card's kernel time a call of ``fn``, which makes ``calls`` calls
  of ``kernels`` kernels each (the events of :func:`cuda_ms` also time the
  host issuing them):
  ``torch.profiler``'s device events in a window of at least 128 launches,
  summed, over the launches.  The window is padded by a few tens of ms of
  host sleep on both sides: the profiler keeps only the device events
  that fall inside it on the host's clock, and a window of a few short
  launches came back empty or short (``chip_smoke.py``'s road PageRank
  row; 2 of 3 events in a window of three launches).  A window that lost
  more than :data:`LOST_SHARE` of its launches' events, or saw that share
  more than launched, is taken again with the next pad of
  :data:`WINDOW_PADS_S`, and after the last this raises.  Returns ``ms``
  (all of a call's kernels), ``events`` seen and ``launches`` (kernels) of
  the window kept."""
  import time
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  repeats = max(1, -(-128 // calls))
  launches = repeats * calls * kernels
  fn()
  torch.cuda.synchronize()
  seen = []
  for pad_s in WINDOW_PADS_S:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      time.sleep(pad_s)
      for _ in range(repeats):
        fn()
      torch.cuda.synchronize()
      time.sleep(pad_s)
    # A kernel is one (stream, name, start, end): the profiler can report
    # an event twice.
    seen_kernels = list({(e.device_resource_id, e.name, e.time_range.start,
                          e.time_range.end): e for e in prof.events()
                         if e.device_type == DeviceType.CUDA}.values())
    seen.append(len(seen_kernels))
    if abs(len(seen_kernels) - launches) <= launches * LOST_SHARE:
      busy = sum(e.time_range.elapsed_us() for e in seen_kernels) / 1e3
      return {"ms": busy / (repeats * calls), "events": len(seen_kernels),
              "launches": launches}
  raise RuntimeError(f"the profiler saw {seen} device events in {len(seen)} "
                     f"windows of {launches} launches each")


def kernels_of(fn) -> int:
  """The kernels one call of ``fn`` launches (a library call may launch
  several): the device events of one call in a window padded by 0.5 s."""
  import time
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    time.sleep(0.5)
    fn()
    torch.cuda.synchronize()
    time.sleep(0.5)
  return len({(e.device_resource_id, e.name, e.time_range.start,
               e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA})


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


def bound_ms(g, valid_slots: int, edge: bool, q: int, kd, size: int,
             calls, k_out=None, out_size=None) -> float:
  """The bytes the work needs over the HBM rate, a launch on average: cols
  of the valid slots, vals for a process that reads the edge of the valid
  slots whose source is active, one row extent per packed row, active once
  for each source some valid slot names, the messages of those that are
  active, dprop once for each row with such a slot, y (K_out wide) and
  recv once (``chip_smoke.py``'s count)."""
  import torch
  named = torch.zeros((g.n,), dtype=torch.bool, device=g.cols.device)
  named[g.cols[g.mask].long()] = True
  live_slots = active_msgs = live_rows = 0
  for _, a in calls:
    live = g.mask & a[g.cols]
    live_slots += int(live.sum()) / len(calls)
    active_msgs += int((named & a).sum()) / len(calls)
    live_rows += int(live.any(1).sum()) / len(calls)
  edge_slots = live_slots if edge else 0
  need = (valid_slots * 4 + edge_slots * g.vals.element_size() + 4 * g.n_pad
          + active_msgs * q * size + int(named.sum())
          + (0 if kd is None else live_rows * kd * size)
          + g.n_pad * (k_out or q) * (out_size or size) + g.n_pad)
  return need / H100_BYTES_PER_S * 1e3


def half_edges(g):
  """``g`` with its edge values (and its spill's) in float16."""
  import dataclasses
  import torch
  spill = None if g.spill is None else dataclasses.replace(
      g.spill, w=g.spill.w.to(torch.float16))
  return dataclasses.replace(g, vals=g.vals.to(torch.float16), spill=spill)


def measure(args) -> dict:
  import torch
  sys.path.append(str(ROOT / "src"))
  from repro_torch.kernels import ell_spmv as ell
  g, root, every = load_graph(args.graph, args.scale)
  ext = {"row_end": g.row_end, "mask_prefix": g.mask_prefix,
         "segments": ell.row_segments(g.row_end)}
  n = g.n
  rows = {name: row for name, row in ROWS.items()
          if not args.only or name.startswith(tuple(args.only))}
  recorded = (record(g, root, every)
              if any("recorded" in row[5] for row in rows.values()) else {})
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
  half_g = None
  for name, (op, red, dt, q, kd, fronts) in rows.items():
    dtype = getattr(torch, dt)
    graph, k_out, out_size = g, None, None
    if op in TRACED:
      fn, edge_dt, k, reads_dst = TRACED[op]
      if not hasattr(ell, "library_for") or (
          op != E_PLUS_M and not hasattr(ell, "MAX_LANES")):
        continue  # a package that does not take this process
      from repro_torch.kernels import process_expr
      if edge_dt is not None:
        if half_g is None:
          half_g = half_edges(g)
        graph = half_g
      lane = k is not None or q > 1
      expr = process_expr.trace(
          fn, dtype, lane=lane, edge_dtype=graph.vals.dtype,
          kd=kd or 1, reads_dst=reads_dst, **({"k": k or q} if lane else {}))
      if isinstance(expr, process_expr.Refused):
        continue  # a package that does not take this process
      form = {"process": expr}
      edge = expr.reads_edge
      if k is not None:
        k_out = expr.k_out
      out_size = torch.empty((), dtype=getattr(expr, "out_dtype", dtype)
                             ).element_size()
      if "recorded" in fronts:
        recorded[name] = recorded["sssp,f32,min,Q=1"]
    else:
      form = {"process_op": op}
      edge = op in EDGE_OPS
    msg = (torch.randint(0, 64, (n, q), generator=gen, device="cuda",
                         dtype=dtype) if dtype == torch.int32
           else torch.rand((n, q), generator=gen, device="cuda").to(dtype))
    dprop = (None if kd is None
             else torch.rand((g.n_pad, kd), generator=gen, device="cuda"))
    runs = {f: ([(msg, frontiers[f])] if f != "recorded"
                else recorded[name]) for f in fronts}
    bounds[name] = {f: bound_ms(graph, valid_slots, edge, q, kd,
                                msg.element_size(), calls, k_out, out_size)
                    for f, calls in runs.items()}
    # Kernels a call launches (the lane-vector grid's pass and grid, where
    # the package says so).
    kernels = getattr(ell, "kernels_per_call",
                      lambda p: 1)(form.get("process"))
    for b in block_rows:
      key = str(b or "default")
      row = ms[key][name] = {}
      drow = dev_ms[key][name] = {}
      for f, calls in runs.items():
        def run(calls=calls, b=b, graph=graph, form=form, dprop=dprop):
          for m, a in calls:
            ell.ell_spmv(graph.cols, graph.vals, graph.mask, m, a, **form,
                         reduce_kind=red, dprop=dprop, block_rows=b, **ext)
        row[f] = cuda_ms(run, iters=max(1, 20 // len(calls))) / len(calls)
        drow[f] = device_ms(run, len(calls), kernels)
    if op == "msg" and dtype == torch.float32:
      csr = csr_of(g) if csr is None else csr
      y, _ = ell.ell_spmv(g.cols, g.vals, g.mask, msg, every_src,
                          process_op=op, reduce_kind=red, **ext)
      torch.testing.assert_close(torch.sparse.mm(csr, msg), y, rtol=1e-4,
                                 atol=1e-4 * float(y.abs().max()))
      library[name] = cuda_ms(lambda: torch.sparse.mm(csr, msg))
      spmm = lambda: torch.sparse.mm(csr, msg)  # noqa: E731
      library[name + ",device"] = device_ms(spmm, 1, kernels_of(spmm))
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
            label] + [f"--only={o}" for o in args.only or ()]
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(path).resolve()))
    proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
      sys.stderr.write(proc.stderr)
      return proc.returncode
    runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
  print(json.dumps({"card": card_line(), "graph": args.graph,
                    "order": "ABBA", "pythonpath": args.compare,
                    "b_over_a": b_over_a(runs), "runs": runs}), flush=True)
  return 0


def b_over_a(runs: list) -> dict:
  """B's time over A's for each row and frontier that both ran, the mean
  of B's two runs over the mean of A's: by CUDA events (``ms``) and by
  the card's own time (``device_ms``), at each ``--block-rows``."""
  out = {}
  for kind in ("ms", "device_ms"):
    for b, rows in runs[0][kind].items():
      for name, fronts in rows.items():
        for f in fronts:
          got = {"A": [], "B": []}
          for run in runs:
            t = run[kind].get(b, {}).get(name, {}).get(f)
            if t is not None:
              got[run["label"]].append(t["ms"] if isinstance(t, dict) else t)
          if len(got["A"]) == 2 and len(got["B"]) == 2:
            out.setdefault(kind, {}).setdefault(b, {}).setdefault(
                name, {})[f] = sum(got["B"]) / sum(got["A"])
  return out


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
  ap.add_argument("--only", action="append",
                  help="time only the rows whose names start with this "
                  "(repeatable)")
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
