"""GAP's betweenness centrality on the port (``algos/bc.py``) against the
benchmark's plain reference (``graphbench/reference/bc.py``), on the CPU.

* The port on ``Plan("ell")``, ``"coo"`` and ``"cuda_ell"`` (the kernel's
  plain version here) from Q = 1 and 4 sources of seeded Kronecker graphs
  at scales 8-11 (the benchmark's generator): every depth and every path
  count exactly, the normalized scores within the cell's ``score_gap``
  (``graphbench/limits/gap-kron-s20.bc.json``).
* The reference against a brute-force enumeration of the shortest paths
  on tiny random graphs: depths, path counts and GAP's dependencies (a
  source's own included).
* A layered graph whose path counts pass 2**24: the port keeps them exact
  in float64; the reference with float32 counts (the control) does not.
* The passes' spans and the port's count of supersteps.

The engine's level sweep has its own cases in ``test_torch_engine.py``;
the float64 pass-through's refusals in ``test_torch_user_process.py``.
"""

import collections
import itertools
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))

from graphbench.gen import kronecker  # noqa: E402
from graphbench.reference import bc as ref_bc  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.algos import bc, betweenness  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.backends import Plan  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

SCORE_GAP = json.loads((ROOT / "graphbench" / "limits"
                        / "gap-kron-s20.bc.json").read_text())["score_gap"]
SEED = 2**33 + 17


def kron(scale: int):
  """``(n, edges, sources)``: the benchmark's Kronecker graph at ``scale``,
  undirected, and its first search keys."""
  config = {"scale": scale, "edgefactor": 16, "abc": [0.57, 0.19, 0.19]}
  shape = torch.Generator().manual_seed(20071024)
  gen = torch.Generator().manual_seed(SEED + scale)
  data = kronecker.make(config, shape, gen, "cpu")
  return data["n"], data["edges"], data["keys"]


def build(n, edges, plan):
  src, dst = edges["src"].numpy(), edges["dst"].numpy()
  if plan == "coo":
    return G.build_coo(src, dst, None, n=n, device="cpu")
  return G.build_ell(src, dst, None, n=n, width=8, device="cpu")


def port_run(g, sources, n, plan):
  depth, sigma, deepest = bc.forward(g, sources, n, backend=Plan(plan))
  delta = bc.backward(g, depth, sigma, deepest, backend=Plan(plan))
  return depth, sigma, bc.normalized(delta), deepest


CASES = [(s, q, p) for s in (8, 9, 10, 11) for q in (1, 4)
         for p in ("ell", "coo", "cuda_ell")]


@pytest.mark.parametrize("scale,q,plan", CASES,
                         ids=[f"s{s}-Q{q}-{p}" for s, q, p in CASES])
def test_port_matches_the_reference(scale, q, plan):
  n, edges, keys = kron(scale)
  sources = keys[scale:scale + q]
  depth, sigma, scores, deepest = port_run(build(n, edges, plan), sources,
                                           n, plan)
  want_d, want_s, want_delta = ref_bc.brandes(edges, n, sources)
  assert depth.dtype == torch.int32 and sigma.dtype == torch.float64
  assert scores.dtype == torch.float32 and scores.shape == (n,)
  assert torch.equal(depth.long(), want_d)
  assert torch.equal(sigma, want_s)
  assert deepest == int(want_d.max()) > 1
  gap = float((scores.double() - ref_bc.scores(want_delta)).abs().max())
  assert gap <= SCORE_GAP
  if plan == "ell":  # the public entry gives the same scores
    assert torch.equal(betweenness(build(n, edges, plan), sources, n,
                                   backend=Plan(plan)), scores)


def tiny(seed: int, n: int, m: int):
  rng = np.random.default_rng(seed)
  pairs = {(int(a), int(b)) for a, b in rng.integers(0, n, (m, 2)) if a != b}
  both = sorted(pairs | {(b, a) for a, b in pairs})
  return {"src": torch.tensor([p[0] for p in both], dtype=torch.int64),
          "dst": torch.tensor([p[1] for p in both], dtype=torch.int64)}


def brute(edges, n, s):
  """Every shortest path from ``s`` enumerated: depths, path counts and the
  dependencies ``delta[v] = sum over t != v of (paths s -> t through v) /
  (paths s -> t)``, ``v = s`` included (GAP's backward loop runs to depth
  0)."""
  adj = collections.defaultdict(list)
  for a, b in zip(edges["src"].tolist(), edges["dst"].tolist()):
    adj[a].append(b)
  dist = {s: 0}
  todo = [s]
  while todo:
    nxt = []
    for u in todo:
      for v in adj[u]:
        if v not in dist:
          dist[v] = dist[u] + 1
          nxt.append(v)
    todo = nxt
  paths = collections.defaultdict(list)

  def walk(path):
    u = path[-1]
    paths[u].append(path)
    for v in adj[u]:
      if dist.get(v) == dist[u] + 1:
        walk(path + [v])
  walk([s])
  depth = [dist.get(v, -1) for v in range(n)]
  sigma = [len(paths.get(v, ())) for v in range(n)]
  delta = [0.0] * n
  for t, ps in paths.items():
    if t == s:
      continue
    for v in range(n):
      if v != t:
        delta[v] += sum(v in p for p in ps) / len(ps)
  return depth, sigma, delta


@pytest.mark.parametrize("seed", range(6))
def test_reference_counts_every_shortest_path(seed):
  n = 9
  edges = tiny(seed, n, 14)
  sources = torch.tensor([0, 3, 7])
  depth, sigma, delta = ref_bc.brandes(edges, n, sources)
  for lane, s in enumerate(sources.tolist()):
    d, sg, dl = brute(edges, n, s)
    assert depth[:, lane].tolist() == d
    assert sigma[:, lane].tolist() == sg
    np.testing.assert_allclose(delta[:, lane].numpy(), dl, rtol=1e-12,
                               atol=1e-12)
  want = np.sum([brute(edges, n, s)[2] for s in sources.tolist()], axis=0)
  np.testing.assert_allclose(ref_bc.scores(delta).numpy(), want / want.max(),
                             rtol=1e-12)


def layered(width: int, layers: int):
  """A source joined to ``width`` vertices, each layer of ``width`` joined
  to every vertex of the next: a vertex of layer k has ``width**(k - 1)``
  shortest paths from the source (layer 1 is k = 1)."""
  pairs = [(0, 1 + i) for i in range(width)]
  for k in range(layers - 1):
    base = 1 + k * width
    pairs += [(base + i, base + width + j)
              for i, j in itertools.product(range(width), repeat=2)]
  n = 1 + layers * width
  src = [a for a, b in pairs] + [b for a, b in pairs]
  dst = [b for a, b in pairs] + [a for a, b in pairs]
  return n, {"src": torch.tensor(src), "dst": torch.tensor(dst)}


@pytest.mark.parametrize("plan", ["ell", "coo"])
def test_path_counts_past_float32_stay_exact(plan):
  """3**16 = 43,046,721 paths to the last layer: exact in float64 on the
  port's path, rounded to 43,046,720 by float32 counts."""
  width, layers = 3, 17
  n, edges = layered(width, layers)
  want = torch.tensor([1] + [width**(k // width) for k in range(n - 1)],
                      dtype=torch.float64)
  assert float(want.max()) == 3**16 > 2**24
  depth, sigma, scores, deepest = port_run(build(n, edges, plan), [0], n,
                                           plan)
  assert deepest == layers
  assert torch.equal(sigma[:, 0], want)
  _, sig32, _ = ref_bc.brandes(edges, n, torch.tensor([0]), control=True)
  assert sig32.dtype == torch.float32
  assert float(sig32[-1, 0]) == 43046720.0 != 3**16
  _, _, delta = ref_bc.brandes(edges, n, torch.tensor([0]))
  gap = float((scores.double() - ref_bc.scores(delta)).abs().max())
  assert gap <= SCORE_GAP


def test_spans_and_supersteps():
  """The forward pass, the backward pass and each level of the sweep are
  spans (the levels inside the backward pass, one a level), and the port
  counts deepest + 1 forward and deepest backward supersteps."""
  n, edges, keys = kron(8)
  g = build(n, edges, "ell")
  before = dict(bc.supersteps)
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    depth, sigma, deepest = bc.forward(g, keys[:4], n, backend=Plan("ell"))
    bc.backward(g, depth, sigma, deepest, backend=Plan("ell"))
  spans = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.name().startswith("graphmat.")]
  names = collections.Counter(name for name, _, _ in spans)
  assert names[tracing.BC_FORWARD] == names[tracing.BC_BACKWARD] == 1
  assert names[tracing.LEVEL] == deepest
  (_, lo, hi), = [s for s in spans if s[0] == tracing.BC_BACKWARD]
  assert all(lo <= a and b <= hi for name, a, b in spans
             if name == tracing.LEVEL)
  assert bc.supersteps["forward"] - before["forward"] == deepest + 1
  assert bc.supersteps["backward"] - before["backward"] == deepest
