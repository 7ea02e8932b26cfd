#!/usr/bin/env python3
"""Time the ELL kernel's wrapper on an RMAT graph at four frontiers.

    python3 tools/time_ell_kernel.py --graph build/rmat20.npz
    PYTHONPATH=<other checkout>/src python3 tools/time_ell_kernel.py \\
        --graph build/rmat20.npz --label other

Times ``repro_torch.kernels.ell_spmv.ell_spmv`` from the package on
``PYTHONPATH`` (else this checkout's ``src``), so two versions of the kernel
can be compared on one card, one process after the other, in the order
A, B, B, A.  The graph is the one ``chip_smoke.py`` serves (RMAT scale 20,
edge factor 16, Graph500 parameters, self-loops removed, symmetrized), as
ELL arrays: built at the first run and kept in ``--graph`` for the next.
Prints one JSON line: the card, and milliseconds a launch (CUDA events, the
median of 5 means of 20 launches) for PageRank f32 add, BFS int32 min and
SSSP f32 min at Q = 1 and BFS int32 min at Q = 8, each with every source
active, 10% active and all but one active.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("cols", "vals", "mask", "row_of", "packed_of")


def load_graph(path: pathlib.Path, scale: int):
  import numpy as np
  from repro_torch.core import graph as G
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
  return G.from_arrays("ell", int(data["n"]), {f: data[f] for f in FIELDS},
                       width=int(data["width"]), device="cuda")


def extent_kwargs(g, ell) -> dict:
  """What the wrapper takes of the graph besides its arrays."""
  if hasattr(g, "layout"):  # a graph that carries the kernel's layout
    return {"layout": g.layout}
  return {"row_end": g.row_end, "mask_prefix": g.mask_prefix,
          "segments": ell.row_segments(g.row_end)}


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


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--graph", type=pathlib.Path, required=True,
                  help="file of the graph's ELL arrays (made if missing)")
  ap.add_argument("--scale", type=int, default=20)
  ap.add_argument("--label", default="this checkout")
  args = ap.parse_args(argv)
  import torch
  if not torch.cuda.is_available():
    print("time_ell_kernel: no CUDA device", file=sys.stderr)
    return 2
  sys.path.append(str(ROOT / "src"))
  from repro_torch.kernels import ell_spmv as ell
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  g = load_graph(args.graph, args.scale)
  ext = extent_kwargs(g, ell)
  n = g.n
  gen = torch.Generator(device="cuda").manual_seed(7)
  every = torch.ones((n,), dtype=torch.bool, device="cuda")
  frontiers = {"all": every,
               "10%": torch.rand((n,), generator=gen, device="cuda") < 0.1,
               "all_but_one": every.clone().index_fill_(
                   0, torch.tensor([n - 1], device="cuda"), False)}
  out = {}
  for name, op, red, dtype, q in (
      ("pagerank,f32,add,Q=1", "msg", "add", torch.float32, 1),
      ("bfs,int32,min,Q=1", "msg_plus_one", "min", torch.int32, 1),
      ("sssp,f32,min,Q=1", "msg_plus_edge", "min", torch.float32, 1),
      ("bfs,int32,min,Q=8", "msg_plus_one", "min", torch.int32, 8)):
    msg = (torch.randint(0, 64, (n, q), generator=gen, device="cuda",
                         dtype=torch.int32) if dtype == torch.int32
           else torch.rand((n, q), generator=gen, device="cuda"))
    out[name] = {f: cuda_ms(lambda: ell.ell_spmv(
        g.cols, g.vals, g.mask, msg, a, process_op=op, reduce_kind=red,
        **ext)) for f, a in frontiers.items()}
  print(json.dumps({"label": args.label, "card": card,
                    "package": ell.__file__, "ms": out}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
