"""GAP's betweenness centrality on the port: ``port.GraphPort``'s ELL
build of the undirected Kronecker graph (the graph cells' own), and a
trial, the configuration's ``lanes`` sources as the lanes of one batched
sweep, by ``algos.bc``'s public passes on the configuration's plan."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from graphbench import port
from repro_torch.algos import bc


class Container(port.GraphPort):

  def trial(self, sources: Sequence[int]) -> Dict[str, torch.Tensor]:
    """One trial: each vertex's BFS ``depth`` and path count ``sigma`` from
    every source (``[n, Q]``), and the normalized ``scores`` (``[n]``), on
    the device."""
    depth, sigma, deepest = bc.forward(self.graph, sources, self.n,
                                       backend=self.plan)
    delta = bc.backward(self.graph, depth, sigma, deepest, backend=self.plan)
    return {"depth": depth, "sigma": sigma, "scores": bc.normalized(delta)}

  @staticmethod
  def supersteps() -> int:
    """The port's count of BC supersteps so far, forward and backward."""
    return bc.supersteps["forward"] + bc.supersteps["backward"]
