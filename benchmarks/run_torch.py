"""Benchmark runner on the port — one section per paper table/figure.

The counterpart of ``benchmarks/run.py``: the same sections, in the same
order, under the same names, printing the same ``name,us_per_call,derived``
CSV rows, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m benchmarks.run_torch [--quick] [--skip-scaling]
                                               [--device cpu]

Where the reference runs its Pallas kernel (``backend="pallas"``, in
interpret mode on its CPU), the port runs its CUDA kernel
(``backend="cuda_ell"``; on CPU tensors the kernel's plain version), and
row names and derived text follow:

  * ``pallas`` → ``cuda_ell`` in a row name
    (``pagerank/graphmat_pallas`` → ``pagerank/graphmat_cuda_ell``,
    ``opt_ladder/4_pallas`` → ``opt_ladder/4_cuda_ell``,
    ``planner/ell_pallas`` → ``planner/ell_cuda_ell``);
  * ``interpret-mode kernel`` → ``CUDA kernel`` in the derived text;
  * the planner's kernel-tile candidates are the port planner's own
    (``planner/ell_cuda_ell_r4`` and ``_r16``, packed rows per thread
    block, where the reference sweeps ``_r128`` and ``_r512``, rows per
    grid tile).

Fig. 5 (``fig5_scaling``) counts one 2-D superstep under
``repro_torch.analysis.CostMode`` on fake process groups and divides by the
H100's data-sheet rates (``benchmarks.common_torch``).
"""

from __future__ import annotations

import argparse
import traceback

from repro_torch._device import resolve_device


def main(argv=None) -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--quick", action="store_true", help="smaller graphs")
  ap.add_argument("--skip-scaling", action="store_true")
  ap.add_argument("--device", default="cuda",
                  help="torch device (default cuda; cpu runs the kernels' "
                  "plain versions)")
  args = ap.parse_args(argv)
  scale = 10 if args.quick else 12
  device = resolve_device(args.device)

  print("name,us_per_call,derived")
  sections = []

  from benchmarks import bench_algorithms_torch
  sections.append(("fig4_table2_algorithms",
                   lambda: bench_algorithms_torch.main(scale, device)))

  sections.append(("multi_query_serving",
                   lambda: bench_algorithms_torch.multi_query(scale, device)))

  from benchmarks import bench_native_gap_torch
  sections.append(("table3_native_gap",
                   lambda: bench_native_gap_torch.main(scale, device)))

  from benchmarks import bench_optimizations_torch
  sections.append(("fig7_optimizations",
                   lambda: bench_optimizations_torch.main(scale,
                                                          device=device)))

  if not args.skip_scaling:
    from benchmarks import bench_scaling_torch
    sections.append(("fig5_scaling",
                     lambda: bench_scaling_torch.main(device)))

  failed = 0
  for name, fn in sections:
    print(f"# --- {name} ---")
    try:
      for row in fn():
        print(row, flush=True)
    except Exception:
      failed += 1
      print(f"{name}/ERROR,0.0,exception", flush=True)
      traceback.print_exc()
  return 1 if failed else 0


if __name__ == "__main__":
  raise SystemExit(main())
