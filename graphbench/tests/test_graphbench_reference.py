"""The plain reference on graphs small enough to check by hand."""

import torch

from graphbench.reference import cf, components, pagerank, sssp

INF = float("inf")


def edges(pairs, weights=None):
  src = torch.tensor([p[0] for p in pairs])
  dst = torch.tensor([p[1] for p in pairs])
  w = torch.tensor(weights if weights is not None else [1.0] * len(pairs))
  return {"src": src, "dst": dst, "w": w}


def undirected(pairs, weights):
  both = pairs + [(b, a) for a, b in pairs]
  return edges(both, weights + weights)


def test_sssp_by_hand():
  # 0 -1.0- 1 -1.0- 2, and 0 -2.5- 2; vertex 3 alone.
  g = undirected([(0, 1), (1, 2), (0, 2)], [1.0, 1.0, 2.5])
  d = sssp.sssp(g, 4, torch.tensor([0, 2]))
  assert d[:, 0].tolist() == [0.0, 1.0, 2.0, INF]
  assert d[:, 1].tolist() == [2.0, 1.0, 0.0, INF]


def test_sssp_frontiers():
  g = undirected([(0, 1), (1, 2)], [1.0, 1.0])
  f = []
  sssp.sssp(g, 3, torch.tensor([0]), frontiers=f)
  # Supersteps: {0} -> {1} -> {2} -> {} (2 relaxes 1 again, no change).
  sizes = [t[:, 0].tolist() for t in f]
  assert sizes == [[1, 1, 1], [1, 2, 2], [1, 1, 1]]


def test_sssp_bfloat16_rounds():
  g = undirected([(0, 1)], [0.1])
  d32 = sssp.sssp(g, 2, torch.tensor([0]))
  d16 = sssp.sssp(g, 2, torch.tensor([0]), dtype=torch.bfloat16)
  assert d32[1, 0] == torch.tensor(0.1, dtype=torch.float32)
  assert d16[1, 0] == torch.tensor(0.1, dtype=torch.bfloat16).float()
  assert d16[1, 0] != d32[1, 0]


def test_pagerank_by_hand():
  # A 3-cycle: every rank stays 1; vertex 3 has no in-edge and keeps 1.
  g = edges([(0, 1), (1, 2), (2, 0), (3, 0)])
  r = pagerank.pagerank(g, 4, 5)
  # Vertex 0 gets 1 (from 2) + 1 (from 3, out-degree 1) in the first sweep.
  assert abs(float(r[3]) - 1.0) < 1e-12
  one = pagerank.pagerank(g, 4, 1)
  assert torch.allclose(one, torch.tensor([0.15 + 0.85 * 2, 1.0, 1.0, 1.0]))


def test_cf_one_sweep_by_hand():
  # One user (0), one item (vertex 1), rating 3, K = 1.
  user, item, rating = torch.tensor([0]), torch.tensor([0]), torch.tensor([3.0])
  p0 = torch.tensor([[1.0], [2.0]])
  gamma, lam = 0.1, 0.5
  p = cf.cf(user, item, rating, 1, p0, 1, gamma, lam)
  pu = 1.0 + gamma * ((3.0 - 2.0) * 2.0 - lam * 1.0)       # 1.15
  pi = 2.0 + gamma * ((3.0 - pu * 2.0) * pu - lam * 2.0)
  assert torch.allclose(p, torch.tensor([[pu], [pi]]))
  assert cf.step_size(user, item, rating, 1, 1) == 1.0 / 3.0


def test_components_and_tuples():
  g = undirected([(0, 1), (2, 3), (3, 4)], [1.0, 1.0, 1.0])
  lab = components.labels(g, 6)
  assert lab.tolist() == [0, 0, 2, 2, 2, 5]
  tuples = {"start": torch.tensor([0, 2, 3, 3, 5]),
            "end": torch.tensor([1, 3, 4, 3, 5])}
  got = components.tuples_in_component(tuples, lab, torch.tensor([1, 4]))
  assert got.tolist() == [1, 3]
