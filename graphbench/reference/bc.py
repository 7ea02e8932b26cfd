"""Betweenness centrality by Brandes' algorithm from a block of sources, as
GAP's BC kernel computes it (``bc.cc``): a level-synchronous BFS that
counts shortest paths, then the dependencies level by level from the
deepest up, ``delta[v] = sum over successors w of sigma[v] / sigma[w] *
(1 + delta[w])``, down to the sources' own level (a source's own
dependency counts), and the scores, summed over the sources, divided by
the largest.

Plain PyTorch over the benchmark's own directed edge list (both directions
of every undirected pair), every source a lane of ``[n, Q]`` columns, the
sums by ``index_add_`` over blocks of at most ``BLOCK_EDGES`` edges.  Path
counts in float64 are whole numbers, exact while below 2**53 whatever the
order of the sums; dependencies and scores in float64.  The control keeps
the path counts in float32 (exact only to 2**24) and rounds each
dependency to bfloat16, summing in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

BLOCK_EDGES = 1 << 24


def _spread(edges: Dict[str, torch.Tensor], x: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
  """``out[v] = sum of x[u] over the edges u -> v``, in ``dtype``."""
  src, dst = edges["src"], edges["dst"]
  out = torch.zeros(x.shape, dtype=dtype, device=x.device)
  for lo in range(0, src.numel(), BLOCK_EDGES):
    s, d = src[lo:lo + BLOCK_EDGES], dst[lo:lo + BLOCK_EDGES]
    out.index_add_(0, d, x[s].to(dtype))
  return out


def _sizes(edges: Dict[str, torch.Tensor], front: torch.Tensor,
           out_deg: torch.Tensor) -> torch.Tensor:
  """int64 ``[4]`` of one superstep: the vertices active in any lane, their
  out-edges, the active (vertex, lane) pairs, the rows that receive."""
  any_lane = front.any(1)
  reached = torch.zeros_like(any_lane)
  reached[edges["dst"][any_lane[edges["src"]]]] = True
  return torch.stack([any_lane.sum(), out_deg[any_lane].sum(), front.sum(),
                      reached.sum()]).to(torch.int64)


def brandes(edges: Dict[str, torch.Tensor], n: int, sources: torch.Tensor,
            control: bool = False, levels: Optional[List] = None,
            counts_in: Optional[torch.dtype] = None):
  """``(depth int64 [n, Q] (-1 unreached), sigma [n, Q], delta [n, Q])``
  from each of the ``Q`` ``sources``: float64, or with ``control`` sigma
  in float32 and delta in bfloat16 (sums in float32).  ``counts_in``, where
  given, is the path counts' dtype alone (float32: the control's counts
  with float64 dependencies).  With ``levels`` a
  list, each superstep appends ``("forward" | "backward", sizes)``
  (:func:`_sizes`), as the port's engine runs them: the forward pass a
  superstep a level to the deepest, whose frontier reaches nothing new,
  the backward one a level from the deepest to 1."""
  sig_t = counts_in or (torch.float32 if control else torch.float64)
  dev = edges["src"].device
  q = sources.numel()
  lanes = torch.arange(q, device=dev)
  out_deg = torch.bincount(edges["src"], minlength=n)
  depth = torch.full((n, q), -1, dtype=torch.int64, device=dev)
  depth[sources, lanes] = 0
  sigma = torch.zeros((n, q), dtype=sig_t, device=dev)
  sigma[sources, lanes] = 1
  front = depth == 0
  level = 0
  while bool(front.any()):
    if levels is not None:
      levels.append(("forward", _sizes(edges, front, out_deg)))
    total = _spread(edges, torch.where(front, sigma, 0), sig_t)
    new = (depth < 0) & (total > 0)
    level += 1
    depth[new] = level
    sigma = torch.where(new, total, sigma)
    front = new
  deepest = level - 1
  delta = torch.zeros((n, q), dtype=torch.float64, device=dev)
  for d in range(deepest, 0, -1):
    front = depth == d
    if levels is not None:
      levels.append(("backward", _sizes(edges, front, out_deg)))
    share = torch.where(front, (1 + delta) / sigma.double(), 0)
    total = _spread(edges, share, torch.float32 if control
                    else torch.float64).double()
    got = sigma.double() * total
    if control:
      got = got.to(torch.bfloat16).double()
    delta = torch.where(depth == d - 1, got, delta)
  return depth, sigma, delta


def scores(delta: torch.Tensor, control: bool = False) -> torch.Tensor:
  """float64 ``[n]``: the dependencies summed over the sources, divided by
  the largest sum (the control sums its bfloat16 dependencies in
  float32)."""
  total = delta.float().sum(1).double() if control else delta.sum(1)
  return total / total.max()
