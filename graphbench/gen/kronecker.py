"""Graph500's Kronecker generator, on the device from a seed.

Follows the Graph500 specification's reference code (v3, section 3): for
each of ``scale`` bit levels, each edge tuple picks its start bit with
probability ``1 - (A + B)`` and its end bit with probability ``D / (C + D)``
or ``B / (A + B)`` given the start bit; then the vertex labels are permuted
and the tuples shuffled.  SSSP's weights (kernel 3) are uniform in [0, 1).
The graph the kernels run on is the tuples made undirected: self-loops
dropped, both directions kept, a pair given twice kept once with its least
weight (a shortest path takes the lightest of parallel edges).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def kronecker_tuples(scale: int, edgefactor: int,
                     abc: Tuple[float, float, float],
                     shape: torch.Generator, gen: torch.Generator, device
                     ) -> Dict[str, torch.Tensor]:
  """The ``edgefactor * 2**scale`` input edge tuples: int64 ``start``,
  ``end`` and float32 ``weight``, and the int64 ``label`` of each
  vertex; ``shape`` draws the bits and the weights, ``gen`` the labels and
  the order."""
  n = 1 << scale
  m = edgefactor * n
  a, b, c = abc
  ab = a + b
  c_norm = c / (1.0 - ab)
  a_norm = a / ab
  start = torch.zeros(m, dtype=torch.int64, device=device)
  end = torch.zeros(m, dtype=torch.int64, device=device)
  for level in range(scale):
    start_bit = torch.rand(m, generator=shape, device=device) > ab
    thresh = torch.where(start_bit, c_norm, a_norm)
    end_bit = torch.rand(m, generator=shape, device=device) > thresh
    start |= start_bit.to(torch.int64) << level
    end |= end_bit.to(torch.int64) << level
  weight = torch.rand(m, generator=shape, device=device)
  label = torch.randperm(n, generator=gen, device=device)
  order = torch.randperm(m, generator=gen, device=device)
  return {"start": label[start][order], "end": label[end][order],
          "weight": weight[order], "label": label}


def undirected(tuples: Dict[str, torch.Tensor], n: int
               ) -> Dict[str, torch.Tensor]:
  """Directed edges ``src -> dst`` with weights ``w``, sorted by (src, dst):
  both directions of every tuple but self-loops, each pair once with its
  least weight."""
  s, e, w = tuples["start"], tuples["end"], tuples["weight"]
  keep = s != e
  s, e, w = s[keep], e[keep], w[keep]
  src = torch.cat([s, e])
  dst = torch.cat([e, s])
  w = torch.cat([w, w])
  by_weight = torch.argsort(w, stable=True)
  key = (src * n + dst)[by_weight]
  w = w[by_weight]
  by_key = torch.argsort(key, stable=True)
  key, w = key[by_key], w[by_key]
  first = torch.ones_like(key, dtype=torch.bool)
  first[1:] = key[1:] != key[:-1]
  key, w = key[first], w[first]
  return {"src": key // n, "dst": key % n, "w": w.contiguous()}


def make(config: dict, shape: torch.Generator, gen: torch.Generator, device
         ) -> Dict[str, object]:
  scale = int(config["scale"])
  n = 1 << scale
  tuples = kronecker_tuples(scale, int(config["edgefactor"]),
                            tuple(config["abc"]), shape, gen, device)
  edges = undirected(tuples, n)
  # The roots of Graph500's searches: vertices with an edge other than a
  # self-loop.  ``keys`` lists them in an order the shape fixes (so its
  # first 64 are the same vertices under every seed's labels); ``roots``
  # in the seed's order.
  label = tuples.pop("label")
  degree = torch.bincount(edges["src"], minlength=n)
  rooted = torch.nonzero(degree[label] > 0).flatten()
  keys = label[rooted[torch.randperm(rooted.numel(), generator=shape,
                                     device=device)]]
  roots = keys[torch.randperm(keys.numel(), generator=gen, device=device)]
  return {"n": n, "tuples": tuples, "edges": edges, "keys": keys,
          "roots": roots}
