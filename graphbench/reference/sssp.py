"""Single-source shortest paths: frontier-driven Bellman-Ford.

A superstep relaxes every edge out of the frontier, ``d[v] = min(d[v],
d[u] + w)``, and the next frontier is the vertices whose distance fell.  In
float32 the result is, for every vertex, the least over paths of the path's
weights added in order, which does not depend on the order of the
relaxations: a sound program gives the same bits.  ``dtype=bfloat16``
stores the weights and adds in bfloat16 (the control).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

BLOCK_EDGES = 1 << 24


def sssp(edges: Dict[str, torch.Tensor], n: int, roots: torch.Tensor,
         dtype=torch.float32, frontiers: Optional[List] = None
         ) -> torch.Tensor:
  """Distances ``[n, Q]`` (float32; inf where unreached) from each of the
  ``Q`` ``roots``.  With ``frontiers`` a list, each superstep appends the
  int64 ``[Q]`` sizes (sources, their out-edges, destinations reached) of
  every root's frontier."""
  src, dst = edges["src"], edges["dst"]
  w = edges["w"].to(dtype)
  q = roots.numel()
  lanes = torch.arange(q, device=src.device)
  dist = torch.full((n, q), float("inf"), dtype=torch.float32,
                    device=src.device)
  dist[roots, lanes] = 0.0
  active = torch.zeros((n, q), dtype=torch.bool, device=src.device)
  active[roots, lanes] = True
  out_deg = torch.bincount(src, minlength=n).to(torch.int64)
  while bool(active.any()):
    new = dist.clone()
    reached = torch.zeros((n, q), dtype=torch.int32, device=src.device)
    for lo in range(0, src.numel(), BLOCK_EDGES):
      s, d = src[lo:lo + BLOCK_EDGES], dst[lo:lo + BLOCK_EDGES]
      live = active[s]
      cand = (dist[s].to(dtype) + w[lo:lo + BLOCK_EDGES, None]).to(
          torch.float32)
      cand = torch.where(live, cand, float("inf"))
      idx = d[:, None].expand_as(cand)
      new.scatter_reduce_(0, idx, cand, "amin")
      if frontiers is not None:
        reached.scatter_reduce_(0, idx, live.to(torch.int32), "amax")
    if frontiers is not None:
      frontiers.append(torch.stack([
          active.sum(0), (active * out_deg[:, None]).sum(0),
          reached.sum(0)]))
    active = new < dist
    dist = new
  return dist
