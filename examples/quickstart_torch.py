"""Quickstart on the PyTorch port: write a vertex program, run it on an RMAT
graph.

The port's counterpart of ``examples/quickstart.py``: the paper's SSSP
appendix written against the port's GraphMat API (``repro_torch.core``),
with the same five user hooks, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import GraphProgram, build_ell, run_graph_program
from repro_torch.graphs import dedupe_edges, remove_self_loops, rmat_edges


def build_graph(scale: int = 12, device="cuda"):
  """Graph500 RMAT (paper §5.1), edge factor 8, seed 42, weights
  U(0.1, 2.0) from ``default_rng(0)``, as a degree-sorted ELL graph (+ hub
  spill).  Returns ``(graph, n)``."""
  src, dst = rmat_edges(scale, edge_factor=8, seed=42)
  src, dst = remove_self_loops(src, dst)
  src, dst = dedupe_edges(src, dst)
  n = 1 << scale
  rng = np.random.default_rng(0)
  w = rng.uniform(0.1, 2.0, len(src)).astype(np.float32)
  return build_ell(src, dst, w, n=n, device=device), n


def sssp_program(declared: bool = True) -> GraphProgram:
  """The paper's SSSP appendix as a vertex program.

  PROCESS_MESSAGE is the reference's ``lambda msg, edge, dst_prop: msg +
  edge``.  With ``declared=False`` the program carries that lambda, and the
  CUDA ELL kernel traces it, as Pallas traces it into its body; the trace
  equals the shipped form ``m + e`` node for node, so it runs that form's
  compiled instance.  The declared form names the same form directly,
  ``process_op="msg_plus_edge"``.  Both run the kernel and give the same
  distances.
  """
  return GraphProgram(
      # PROCESS_MESSAGE: distance-so-far + edge weight
      process_op="msg_plus_edge" if declared else None,
      process_message=(None if declared
                       else lambda msg, edge, dst_prop: msg + edge),
      # REDUCE: min  (declared as a kind so backends can use fast paths)
      reduce_kind="min",
      # SEND_MESSAGE: the default — message = vertex property
      # APPLY: keep the shorter distance
      apply=lambda reduced, old: torch.minimum(reduced, old),
      process_reads_dst=False,
      name="sssp")


def run_sssp(graph, n: int, source: int, declared: bool = True) -> dict:
  """Run the program to convergence from ``source``: the final distances,
  the supersteps and the reached-vertex count."""
  dev = graph.device
  dist0 = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
  dist0[source] = 0.0
  active0 = torch.zeros((n,), dtype=torch.bool, device=dev)
  active0[source] = True
  final = run_graph_program(graph, sssp_program(declared), dist0, active0)
  return {"dist": final.prop, "supersteps": int(final.iteration),
          "reached": int(torch.isfinite(final.prop).sum())}


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  # --- build a graph (Graph500 RMAT, paper §5.1) ------------------------
  graph, n = build_graph(12, device)

  # --- run to convergence ------------------------------------------------
  source = 6  # the paper uses vertex 6 in its example
  out = run_sssp(graph, n, source)
  print(f"SSSP from vertex {source}: converged in {out['supersteps']} "
        f"supersteps, reached {out['reached']}/{n} vertices")
  print("sample distances:", out["dist"][:8].cpu().numpy())
  return out


if __name__ == "__main__":
  main()
