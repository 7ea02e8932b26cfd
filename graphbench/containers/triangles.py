"""Triangle counting on the port: the DAG's edges as two COO graphs, built
on the host by ``core.graph.build_coo`` (``fwd``: ``u -> v``; ``rev``: the
same edges reversed), counted by ``algos.triangle_count.triangle_count``,
the port's public entry, on the configuration's plan."""

from __future__ import annotations

import numpy as np
import torch

from graphbench import port  # noqa: F401 — puts the port's src/ on sys.path
from repro_torch.algos.triangle_count import triangle_count
from repro_torch.core import graph as graphlib
from repro_torch.core.backends import Plan


class Container:

  def __init__(self, config: dict, data: dict, device):
    self.n = int(data["n"])
    self.device = torch.device(device)
    src = data["dag"]["src"].cpu().numpy().astype(np.int32)
    dst = data["dag"]["dst"].cpu().numpy().astype(np.int32)
    self.fwd = graphlib.build_coo(src, dst, n=self.n, device=self.device)
    self.rev = graphlib.build_coo(dst, src, n=self.n, device=self.device)
    self.plan = Plan(config["plan"])

  def count(self) -> torch.Tensor:
    """The number of triangles, an int64 scalar on the device."""
    return triangle_count(self.fwd, self.rev, self.n, backend=self.plan)
