"""Breadth-first search (Graph500 kernel 2): the port's ``algos.bfs`` back to
back, or its ``BfsFamily`` served.

The reference is SSSP over the same edges with every weight 1, so a hop
count is an exact float; the port's int32 hop counts are compared as
floats, a count above ``n`` (no path has more hops) being unreached.  BFS
states no precision, so the control breaks its guarantee that every vertex
a root reaches is reached: the reference's answer with its last level
left unreached."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from graphbench.work.traversal import Traversal


class Work(Traversal):
  family = "bfs"
  value_bytes = 0

  def edges(self) -> Dict[str, torch.Tensor]:
    e = self.data["edges"]
    return {"src": e["src"], "dst": e["dst"],
            "w": torch.ones_like(e["w"])}

  def answer(self, got) -> torch.Tensor:
    g = super().answer(got)
    return torch.where(g > self.n, float("inf"), g)

  def control(self, roots: Sequence[int]) -> List[torch.Tensor]:
    out = []
    for d in self.reference(roots):
      finite = torch.isfinite(d)
      last = d[finite].max() if bool(finite.any()) else None
      out.append(d if last is None or float(last) == 0.0
                 else torch.where(d == last, float("inf"), d))
    return out
