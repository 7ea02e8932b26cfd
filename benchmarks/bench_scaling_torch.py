"""Paper Fig. 5 analogue on the port: scaling with parallel workers.

The counterpart of ``benchmarks/bench_scaling.py``.  What determines
scaling on a machine of many cards is each rank's work and collective
traffic in the 2-D distributed engine as the grid grows, so for each grid
R × C this counts one PageRank SpMV superstep (``core.distributed.spmv_2d``)
of rank 0 under ``repro_torch.analysis.CostMode``, on a fake process group
of R·C ranks (``launch.mesh.start_fake_group``: its collectives move
nothing), and reports the roofline-projected time and speedup on the
H100's data-sheet rates (989 TF bf16, 3.35 TB/s HBM, NVLink 450 GB/s a
direction, unmeasured; ``benchmarks.common_torch``) plus the block
balance.  Collective bytes count only groups of more than one rank: a
group of one moves nothing.  The counts run in a child process, which
holds the default process group.

  PYTHONPATH=src python -m benchmarks.bench_scaling_torch
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from benchmarks.common_torch import (H100_BF16_OPS_PER_S, H100_BYTES_PER_S,
                                     H100_NVLINK_BYTES_PER_S)
from repro_torch._device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCALE = 14
# 1-D row partitioning (the paper's layout: message vector effectively
# shared) vs 2-D blocks (CombBLAS layout, our beyond-paper distribution).
MESHES = (("1d_1", (1, 1)), ("1d_2", (2, 1)), ("1d_4", (4, 1)),
          ("1d_8", (8, 1)), ("2d_4", (2, 2)), ("2d_8", (4, 2)))

_CHILD = """
import json
from benchmarks.bench_scaling_torch import count_meshes
print(json.dumps(count_meshes(%d, %r)))
"""


def count_meshes(scale: int, device) -> list:
  """Rank 0's counts of one superstep on each grid of :data:`MESHES`.
  Starts a fake default process group for each grid, so run it in a
  process of its own (:func:`count`)."""
  import torch.distributed as dist

  from repro_torch.algos.pagerank import pagerank_program
  from repro_torch.analysis import CostMode
  from repro_torch.core.distributed import Grid, partition_2d, spmv_2d
  from repro_torch.graphs import (dedupe_edges, remove_self_loops,
                                  rmat_edges, shuffle_vertices)
  from repro_torch.graphs.rmat import RMAT_PRBFS
  from repro_torch.launch.mesh import start_fake_group

  dev = resolve_device(device)
  src, dst = rmat_edges(scale, 8, RMAT_PRBFS, seed=9)
  src, dst = remove_self_loops(src, dst)
  src, dst = dedupe_edges(src, dst)
  n = 1 << scale
  src, dst, _ = shuffle_vertices(src, dst, n, seed=2)
  prog = pagerank_program()
  out = []
  try:
    for tag, (r, c) in MESHES:
      start_fake_group(r * c, rank=0)
      grid = Grid.create(r, c)
      dg = partition_2d(src, dst, None, n=n, R=r, C=c)
      nr, nc = dg.rows_per_block, dg.cols_per_block
      block = dg.block(grid.i, grid.j, dev)
      msg = torch.ones((nc,), dtype=torch.float32, device=dev)
      act = torch.ones((nc,), dtype=torch.bool, device=dev)
      ones = torch.ones((nr,), dtype=torch.float32, device=dev)
      prop = {"rank": ones, "deg": ones}
      with CostMode() as cost:
        spmv_2d(block, msg, act, prop, prog, grid)
      acc = cost.result()
      coll = sum(v["bytes"] for v in acc["collectives"].values()
                 if v["group_size"] > 1)
      pop = np.sum(dg.emask, axis=-1).astype(np.float64)
      out.append(dict(tag=tag, devices=r * c, flops=acc["flops"],
                      bytes=acc["bytes"], coll_bytes=coll,
                      collectives=acc["collectives"],
                      balance=float(pop.max() / max(pop.mean(), 1.0))))
  finally:
    if dist.is_initialized():
      dist.destroy_process_group()
  return out


def count(scale: int = SCALE, device="cuda") -> list:
  """:func:`count_meshes` over :data:`MESHES`, run in a child process."""
  dev = resolve_device(device)
  env = dict(os.environ, PYTHONPATH=os.pathsep.join(
      [str(ROOT / "src"), str(ROOT)]))
  res = subprocess.run([sys.executable, "-c", _CHILD % (scale, str(dev))],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
  if res.returncode != 0:
    raise RuntimeError(res.stderr.strip()[-2000:])
  return json.loads(res.stdout.strip().splitlines()[-1])


def main(device="cuda") -> list:
  resolve_device(device)
  try:
    data = count(SCALE, device)
  except RuntimeError as e:
    return [f"scaling/ERROR,0.0,{str(e)[-200:]}"]
  rows = []
  t1 = None
  for rec in data:
    t = max(rec["flops"] / H100_BF16_OPS_PER_S,
            rec["bytes"] / H100_BYTES_PER_S,
            rec["coll_bytes"] / H100_NVLINK_BYTES_PER_S)
    t1 = t1 if t1 is not None else t * rec["devices"]  # D=1 total
    speedup = (t1 / t) if t > 0 else float("nan")
    rows.append(
        f"scaling/pagerank_{rec['tag']},{t*1e6:.2f},"
        f"projected_speedup={speedup:.2f}x balance={rec['balance']:.2f} "
        f"coll_bytes={rec['coll_bytes']:.2e} bytes={rec['bytes']:.2e}")
  return rows


if __name__ == "__main__":
  for r in main():
    print(r)
