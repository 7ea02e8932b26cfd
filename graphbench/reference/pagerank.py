"""PageRank by the paper's fixed sweeps: every vertex sends rank / out-degree
(an out-degree of 0 counted as 1), and a vertex that receives from some
edge takes ``r + (1 - r) * sum``; one with no in-edge keeps its rank.
Ranks start at 1.  Sums run in float64 unless ``dtype`` is bfloat16 (the
control): then the ranks and messages are kept in bfloat16 and summed in
float32, as the port sums half types."""

from __future__ import annotations

from typing import Dict

import torch


def pagerank(edges: Dict[str, torch.Tensor], n: int, iters: int,
             r: float = 0.15, dtype=torch.float64) -> torch.Tensor:
  src, dst = edges["src"], edges["dst"]
  acc = torch.float64 if dtype == torch.float64 else torch.float32
  out_deg = torch.bincount(src, minlength=n).clamp(min=1).to(acc)
  has_in = torch.bincount(dst, minlength=n) > 0
  rank = torch.ones(n, dtype=dtype, device=src.device)
  for _ in range(iters):
    msg = (rank.to(acc) / out_deg).to(dtype)
    total = torch.zeros(n, dtype=acc, device=src.device)
    total.index_add_(0, dst, msg[src].to(acc))
    rank = torch.where(has_in, (r + (1.0 - r) * total).to(dtype), rank)
  return rank.to(torch.float32)
