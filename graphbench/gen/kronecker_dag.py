"""Graph500's Kronecker graph (:mod:`graphbench.gen.kronecker`, the same
draws) as a DAG for triangle counting: self-loops dropped, each undirected
pair once, oriented from the lower to the higher label after the seed's
relabelling.  ``--seed`` moves which end of a pair is the lower, not the
pairs, so every seed has the same edges and triangles up to relabelling.
"""

from __future__ import annotations

from typing import Dict

import torch

from graphbench.gen import kronecker


def make(config: dict, shape: torch.Generator, gen: torch.Generator, device
         ) -> Dict[str, object]:
  data = kronecker.make(config, shape, gen, device)
  e = data["edges"]
  keep = e["src"] < e["dst"]
  return {"n": data["n"],
          "dag": {"src": e["src"][keep], "dst": e["dst"][keep]}}
