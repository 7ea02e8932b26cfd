"""Single-source shortest paths (Graph500 kernel 3): the port's
``algos.sssp`` back to back, or its ``SsspFamily`` served.

SSSP in float32 is exact (the reference's module says why), so a sound
program matches the reference bit for bit.  The control is the reference
with its weights and sums in bfloat16."""

from __future__ import annotations

from typing import List, Sequence

import torch

from graphbench.work.traversal import Traversal


class Work(Traversal):
  family = "sssp"
  value_bytes = 4

  def control(self, roots: Sequence[int]) -> List[torch.Tensor]:
    return self.reference(roots, dtype=torch.bfloat16)
