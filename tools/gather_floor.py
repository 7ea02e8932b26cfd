#!/usr/bin/env python3
"""The gather floor of the lane-vector grid's rows, on the card.

    python3 tools/gather_floor.py --graph build/rmat20.npz
    python3 tools/gather_floor.py --graph netflix:build/netflix.npz

For the graph (as ``tools/time_ell_kernel.py`` loads it) the valid slots'
source ids in packed-row order, every source active, and a random float32
message table [n, K] (K = 16): the time of ``tools/gather_floor.cu``,
which only reads each slot's id and its source's 64-byte message (16 bytes
a thread, 4 messages in flight a thread) and sums them, over a grid of
every resident block.  That is what the lane rows' gathers cost in this
order on this card, with nothing else of the kernel around them; beside
it, the same number of ids drawn uniformly from the first 17,770 sources
(a 1.1 MB table, CF's item factors at the Netflix Prize's size) and from
all of them.  Each time is the card's own (``torch.profiler``, the mean of
20 launches), with the gathered bytes' rate.  Prints one JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
K = 16
THREADS = 256
SMALL_TABLE = 17_770


def _bind(lib: ctypes.CDLL) -> None:
  lib.gather_floor_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
  lib.gather_floor_launch.restype = ctypes.c_int
  lib.gather_floor_blocks.argtypes = [ctypes.c_int]
  lib.gather_floor_blocks.restype = ctypes.c_int


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--graph", required=True,
                  help="as tools/time_ell_kernel.py's --graph")
  ap.add_argument("--scale", type=int, default=20)
  args = ap.parse_args(argv)
  import torch
  if not torch.cuda.is_available():
    print("gather_floor: no CUDA device", file=sys.stderr)
    return 2
  sys.path.append(str(ROOT / "src"))
  sys.path.insert(0, str(ROOT / "tools"))
  from repro_torch.kernels import _build
  from time_ell_kernel import card_line, device_ms, load_graph
  lib = _build.CudaLibrary(str(ROOT / "tools" / "gather_floor.cu"),
                           _bind).load()
  g, _, _ = load_graph(args.graph, args.scale)
  gen = torch.Generator(device="cuda").manual_seed(3)
  msg = torch.rand((g.n, K), generator=gen, device="cuda")
  ids = {"graph": g.cols[g.mask].contiguous()}
  n = ids["graph"].numel()
  ids["uniform_1.1MB"] = torch.randint(0, min(SMALL_TABLE, g.n), (n,),
                                       generator=gen, device="cuda",
                                       dtype=torch.int32)
  ids["uniform_all"] = torch.randint(0, g.n, (n,), generator=gen,
                                     device="cuda", dtype=torch.int32)
  blocks = lib.gather_floor_blocks(THREADS)
  out = torch.empty(blocks * THREADS, device="cuda")
  stream = torch.cuda.current_stream().cuda_stream
  rows = {}
  for name, idx in ids.items():
    def launch(idx=idx):
      rc = lib.gather_floor_launch(idx.data_ptr(), idx.numel(),
                                   msg.data_ptr(), K // 4, out.data_ptr(),
                                   blocks, THREADS, stream)
      if rc != 0:
        raise RuntimeError(f"gather_floor_launch failed: {rc}")
    got = device_ms(lambda: [launch() for _ in range(20)], 20)
    want = msg[idx.long()].sum()
    torch.testing.assert_close(out.sum(), want, rtol=1e-3, atol=0.0)
    gathered = idx.numel() * K * 4
    rows[name] = {"ms": got["ms"], "events": got["events"],
                  "gathered_mb": gathered / 1e6,
                  "tb_per_s": gathered / (got["ms"] * 1e-3) / 1e12}
  print(json.dumps({"card": card_line(), "graph": args.graph, "n": g.n,
                    "slots": n, "k": K, "blocks": blocks,
                    "threads": THREADS, "rows": rows}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
