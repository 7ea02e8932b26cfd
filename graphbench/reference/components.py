"""Connected components of the undirected graph, by min-label propagation
with pointer jumping, and Graph500's count of the input edge tuples in each
root's component (the numerator of its TEPS)."""

from __future__ import annotations

from typing import Dict

import torch


def labels(edges: Dict[str, torch.Tensor], n: int) -> torch.Tensor:
  """int64 ``[n]``: the least vertex id of each vertex's component."""
  src, dst = edges["src"], edges["dst"]
  label = torch.arange(n, dtype=torch.int64, device=src.device)
  while True:
    new = label.scatter_reduce(0, dst, label[src], "amin")
    new = new[new]
    if bool((new == label).all()):
      return label
    label = new


def tuples_in_component(tuples: Dict[str, torch.Tensor], label: torch.Tensor,
                        roots: torch.Tensor) -> torch.Tensor:
  """int64 ``[Q]``: input tuples (self-loops and repeats included) whose
  start lies in each root's component."""
  per_label = torch.zeros_like(label)
  per_label.index_add_(0, label[tuples["start"]],
                       torch.ones_like(tuples["start"]))
  return per_label[label[roots]]
