"""Triangle counting: the plain reference against a count by brute force,
its float16 control, and the TC cell's own faults run whole on the CPU at a
tiny size (a count with one edge of a triangle dropped)."""

import itertools

import pytest
import torch

from graphbench import cell as cell_mod
from graphbench import gen
from graphbench.reference import tc
from graphbench.tests.test_graphbench_faults import run, small

TC = "gap-kron-s16.tc"


def dag(pairs):
  pairs = sorted({(min(a, b), max(a, b)) for a, b in pairs if a != b})
  return {"src": torch.tensor([p[0] for p in pairs], dtype=torch.int64),
          "dst": torch.tensor([p[1] for p in pairs], dtype=torch.int64)}


def brute(d, n):
  edges = set(zip(d["src"].tolist(), d["dst"].tolist()))
  return sum(1 for u, v, w in itertools.combinations(range(n), 3)
             if (u, v) in edges and (v, w) in edges and (u, w) in edges)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n, m", [(12, 30), (24, 120), (40, 300)])
def test_reference_random(seed, n, m):
  g = torch.Generator().manual_seed(seed)
  pairs = torch.randint(0, n, (m, 2), generator=g).tolist()
  d = dag(pairs)
  assert tc.triangles(d, n) == brute(d, n)


@pytest.mark.parametrize("scale", [5, 6])
def test_reference_kronecker(scale):
  config = {"generator": "kronecker_dag", "shape_seed": 20071024,
            "scale": scale, "edgefactor": 16, "abc": [0.57, 0.19, 0.19]}
  d = gen.make(config, 2**40 + 9, "cpu")
  assert bool((d["dag"]["src"] < d["dag"]["dst"]).all())
  assert tc.triangles(d["dag"], d["n"]) == brute(d["dag"], d["n"]) > 0


@pytest.mark.parametrize("pairs, n", [
    ([], 4),
    ([(0, 1), (1, 2), (2, 3), (3, 0)], 4),                  # a 4-cycle
    ([(0, k) for k in range(1, 9)], 9),                     # a star
    ([(a, b) for a in range(4) for b in range(4, 9)], 9),   # bipartite
])
def test_reference_no_triangle(pairs, n):
  assert tc.triangles(dag(pairs), n) == 0


def test_reference_blocks(monkeypatch):
  """Wedges in blocks far smaller than one edge's give the same count."""
  g = torch.Generator().manual_seed(5)
  d = dag(torch.randint(0, 30, (200, 2), generator=g).tolist())
  want = tc.triangles(d, 30)
  monkeypatch.setattr(tc, "BLOCK_WEDGES", 3)
  assert tc.triangles(d, 30) == want == brute(d, 30)


def test_control_rounds_a_hub():
  """Vertex 0 closes 2,049 triangles ``(0, i, i + 1)``: float16 holds 2,048
  (or 2,050), so the control's count is off by one."""
  k = 2050
  d = dag([(0, i) for i in range(1, k + 1)]
          + [(i, i + 1) for i in range(1, k)])
  assert tc.triangles(d, k + 1) == k - 1
  assert tc.triangles(d, k + 1, dtype=torch.float16) != k - 1


def test_dropped_edge_is_not_correct():
  """The port counts a graph with one edge of a triangle left out."""
  c = small(TC)

  def dropped_port(cell, data, device):
    d = data["dag"]
    want = tc.triangles(d, data["n"])
    for k in torch.argsort(torch.bincount(d["src"], minlength=data["n"])[
        d["src"]], descending=True).tolist():
      keep = torch.arange(d["src"].numel()) != k
      less = {"src": d["src"][keep], "dst": d["dst"][keep]}
      if tc.triangles(less, data["n"]) < want:
        return cell_mod.make_port(cell, {**data, "dag": less}, device)
    raise AssertionError("no edge closes a triangle")
  assert not run(TC, cell=c, port_factory=dropped_port)["correct"]
