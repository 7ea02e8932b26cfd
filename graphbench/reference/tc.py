"""Triangle counting on a DAG-oriented graph (every edge ``u -> v`` with
``u < v``, each undirected pair once), by wedge lookup: for every wedge
``u -> v -> w`` (``w`` in ``v``'s out-list) the pair ``(u, w)`` is looked
up among the sorted keys ``u * n + w`` with ``torch.searchsorted``.  Each
triangle ``u < v < w`` closes exactly one wedge, so each is counted once.
Wedges are made in blocks of at most ``BLOCK_WEDGES`` so that the lookup
fits on the card.

Counts are kept per vertex (the triangles whose least vertex it is) in
int64 and summed in int64, unless ``dtype`` is float16 (the control): then
the per-vertex counts are rounded to float16, which holds integers exactly
only up to 2,048, and summed in float32.
"""

from __future__ import annotations

from typing import Dict

import torch

BLOCK_WEDGES = 1 << 26


def triangles(dag: Dict[str, torch.Tensor], n: int,
              dtype=torch.int64) -> float:
  """The number of triangles of the DAG ``dag`` (``src``, ``dst``)."""
  src, dst = dag["src"].to(torch.int64), dag["dst"].to(torch.int64)
  key, order = torch.sort(src * n + dst)
  s, d = src[order], dst[order]
  out_deg = torch.bincount(s, minlength=n)
  first = torch.cumsum(out_deg, 0) - out_deg
  wedges = out_deg[d]                        # wedges through each edge
  ends = torch.cumsum(wedges, 0)
  per_vertex = torch.zeros(n, dtype=torch.int64, device=src.device)
  total = int(ends[-1]) if ends.numel() else 0
  lo = done = 0                              # edges and wedges counted
  while done < total:
    hi = int(torch.searchsorted(ends, done + BLOCK_WEDGES, right=True))
    hi = max(hi, lo + 1)
    count = wedges[lo:hi]
    edge = torch.repeat_interleave(
        torch.arange(lo, hi, device=src.device), count)
    start = ends[lo:hi] - count - done       # each edge's first wedge here
    rank = torch.arange(edge.numel(), device=src.device) - start[edge - lo]
    w = d[first[d[edge]] + rank]
    u = s[edge]
    pair = u * n + w
    at = torch.searchsorted(key, pair).clamp(max=key.numel() - 1)
    closed = key[at] == pair
    per_vertex.index_add_(0, u[closed], torch.ones_like(u[closed]))
    done = int(ends[hi - 1])
    lo = hi
  if dtype == torch.float16:
    return float(per_vertex.to(torch.float16).to(torch.float32).sum())
  return float(per_vertex.sum())
