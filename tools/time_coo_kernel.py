#!/usr/bin/env python3
"""The COO kernel's rows of ``chip_smoke.py``'s kernels line, on the
benchmark cells' own inputs, on the card.

    python3 tools/time_coo_kernel.py --seed 7

The inputs are made by ``graphbench``'s generators from ``--seed``:
Graph500 scale 20 built as the graph cells build it (``GraphPort``), whose
hub spill is the COO graph of the SSSP rows (Q = 1 with every and 10% of
sources active, Q = 8) and of PageRank's add (beside ``torch.sparse.mm``),
and collaborative filtering's user-to-item graph at the Netflix Prize's
shape (phase V, K = 16).  Each row is :func:`chip_smoke.time_coo`'s: held
against the PyTorch path on the same tensors, timed, with its byte bound
and gather floor.  Prints one JSON line with the card's name and power
limit, the rows and the COO kernel's counters.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--seed", type=int, default=7)
  args = ap.parse_args(argv)
  import torch
  if not torch.cuda.is_available():
    print("time_coo_kernel: no CUDA device", file=sys.stderr)
    return 2
  sys.path[:0] = [str(ROOT), str(ROOT / "src")]
  import chip_smoke
  from graphbench import gen, manifest, port
  from repro_torch.core import graph as graphlib
  from repro_torch.core.vertex_program import GraphProgram
  from repro_torch.kernels import coo_spmv as K
  dev = torch.device("cuda")
  rng = torch.Generator(device=dev).manual_seed(args.seed)
  rows, records = [], {}

  def row(name, *a, **k):
    entry, records[name] = chip_smoke.time_coo("coo", name, *a, {}, **k)
    rows.append(entry)

  config = manifest.cell("graph500-s20.sssp")["config"]
  g = port.GraphPort(config, gen.make(config, args.seed, dev), dev).graph.spill
  n = g.n
  every = torch.ones(n, dtype=torch.bool, device=dev)
  tenth = torch.rand(n, generator=rng, device=dev) < 0.1
  sssp = GraphProgram(process_op="msg_plus_edge", reduce_kind="min")
  m1 = torch.rand(n, generator=rng, device=dev) * 10
  m8 = torch.rand((n, 8), generator=rng, device=dev) * 10
  for m in (m1, m8):
    for frontier, act in (("all", every), ("10%", tenth)):
      q = m.shape[1] if m.ndim == 2 else 1
      row(f"coo_spmv[sssp,f32,min,Q={q},{frontier},graph500-s20 spill]", g,
          m, act, m, sssp,
          library_null="no single PyTorch call takes a min over edges")
  real = g.emask
  csr = torch.sparse_coo_tensor(
      torch.stack([g.dst[real], g.src[real]]),
      torch.ones(int(real.sum()), device=dev), (n, n)).coalesce(
      ).to_sparse_csr()
  col = m1[:, None].contiguous()
  row("coo_spmv[pagerank,f32,add,Q=1,all,graph500-s20 spill]", g, m1, every,
      m1, GraphProgram(process_op="msg", reduce_kind="add"),
      library=lambda: torch.sparse.mm(csr, col))
  del g, csr, col, m1, m8
  torch.cuda.empty_cache()

  config = manifest.cell("netflix-cf.sweeps")["config"]
  data = gen.make(config, args.seed, dev)
  users = int(data["users"])
  n = users + int(data["items"])
  g = graphlib.build_coo(
      data["user"].cpu().numpy(), (data["item"] + users).cpu().numpy(),
      data["rating"].float().cpu().numpy(), n=n, device=dev)
  del data
  k = config["k"]
  cf = GraphProgram(
      process_message=lambda m, e, d: (e - (m * d).sum(-1, keepdim=True)) * m,
      reduce_kind="add", process_reads_dst=True)
  p = torch.rand((n, k), generator=rng, device=dev)
  row(f"coo_spmv[cf_one_leaf,f32,add,K={k},netflix phase V]", g, p,
      torch.ones(n, dtype=torch.bool, device=dev), p, cf, tiled=True,
      library_null="no single PyTorch call sums (e - m.d) m over a run's "
      "edges")
  print(json.dumps({"card": chip_smoke.card_line(), "seed": args.seed,
                    "kernels": rows, "records": records,
                    "coo_launches": K.launches.by_config,
                    "coo_torch_path": K.torch_path}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
