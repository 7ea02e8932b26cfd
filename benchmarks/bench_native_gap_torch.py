"""Paper Table 3 analogue on the port: GraphMat slowdown vs hand-optimized
native code.

The counterpart of ``benchmarks/bench_native_gap.py``.  Paper claims 1.2×
geomean (PageRank 1.15, BFS 1.18, TC 2.10, CF 0.73).  We compute the same
ratios for our framework-vs-native pairs on this device.
:func:`gap_rows` derives them from rows that
:func:`benchmarks.bench_algorithms_torch.main` already printed, so a
caller that has those rows need not run the five algorithms again.
"""

from __future__ import annotations

import numpy as np

from benchmarks import bench_algorithms_torch
from benchmarks.common_torch import row


def gap_rows(rows: list) -> list:
  """Table 3's rows from the rows of ``bench_algorithms_torch.main``."""
  times = {}
  for r in rows:
    name, us, _ = r.split(",", 2)
    times[name] = float(us)
  pairs = {
      "pagerank": ("pagerank/graphmat_ell", "pagerank/native"),
      "bfs": ("bfs/graphmat_ell", "bfs/native"),
      "sssp": ("sssp/graphmat_ell", "sssp/native"),
      "tri_count": ("tri_count/graphmat", "tri_count/native"),
      "collab_filter": ("collab_filter/graphmat", "collab_filter/native"),
  }
  paper = {"pagerank": 1.15, "bfs": 1.18, "tri_count": 2.10,
           "collab_filter": 0.73, "sssp": float("nan")}
  out = []
  ratios = []
  for algo, (g, n) in pairs.items():
    ratio = times[g] / times[n]
    ratios.append(ratio)
    out.append(row(f"native_gap/{algo}", times[g],
                   f"slowdown={ratio:.2f}x paper={paper[algo]}"))
  geo = float(np.exp(np.mean(np.log(ratios))))
  out.append(row("native_gap/geomean", 0.0,
                 f"slowdown={geo:.2f}x paper=1.20"))
  return out


def main(scale: int = 12, device="cuda") -> list:
  return gap_rows(bench_algorithms_torch.main(scale, device))


if __name__ == "__main__":
  for r in main():
    print(r)
