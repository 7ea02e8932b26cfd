"""The port's measured planning (``Planner.candidates`` and
``Planner.autotune``), mirroring the reference's tests in
``tests/test_backends_plan.py``, on the CPU.

``autotune`` memoizes by graph fingerprint, skips only candidates that
raise the port's eligibility errors (``ValueError``,
``NotImplementedError``) and lets any other error through, as a kernel
launch's ``RuntimeError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.algos.bfs import bfs_program as j_bfs_program  # noqa: E402
from repro.core import backends as jbe  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro_torch.algos.bfs import UNREACHED, bfs_program  # noqa: E402
from repro_torch.algos.multi import bfs_columns, multi_bfs_program  # noqa: E402
from repro_torch.algos.pagerank import init_prop, pagerank_program  # noqa: E402
from repro_torch.core import backends as B  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core.backends import Plan, Planner  # noqa: E402


def _random_graph(seed, n=96, e=500):
  rng = np.random.default_rng(seed)
  src = rng.integers(0, n, e).astype(np.int32)
  dst = rng.integers(0, n, e).astype(np.int32)
  keep = src != dst
  w = rng.uniform(0.5, 2.0, int(keep.sum())).astype(np.float32)
  return n, src[keep], dst[keep], w


def _skewed_graph(n=128, hub_edges=400, rest=100, seed=0):
  rng = np.random.default_rng(seed)
  src = np.concatenate([rng.integers(1, n, hub_edges),
                        rng.integers(0, n, rest)]).astype(np.int32)
  dst = np.concatenate([np.zeros(hub_edges, np.int32),
                        rng.integers(0, n, rest).astype(np.int32)])
  keep = src != dst
  return n, src[keep], dst[keep], np.ones(int(keep.sum()), np.float32)


def _bfs_seed(n, root=0):
  prop = torch.full((n,), UNREACHED, dtype=torch.int32)
  prop[root] = 0
  active = torch.zeros((n,), dtype=torch.bool)
  active[root] = True
  return prop, active


def test_autotune_memoizes_by_fingerprint():
  n, src, dst, w = _random_graph(7)
  g = TG.build_coo(src, dst, w, n=n, device="cpu")
  # Same content, other tensors: the fingerprint keys the cache.
  g2 = TG.build_coo(src.copy(), dst.copy(), w.copy(), n=n, device="cpu")
  prop0, active0 = _bfs_seed(n)
  planner = Planner()
  cands = [Plan(backend="coo"), Plan(backend="coo_tiled", num_tiles=2)]
  p1 = planner.autotune(g, bfs_program(), prop0, active0, candidates=cands,
                        repeats=1)
  assert planner.cache.misses == 1 and planner.cache.hits == 0
  p2 = planner.autotune(g2, bfs_program(), prop0, active0, candidates=cands,
                        repeats=1)
  assert p2 == p1 and p1.backend in ("coo", "coo_tiled")
  assert planner.cache.hits == 1 and len(planner.cache) == 1
  (key, measured), = planner.timings.items()
  assert key[1:] == ("bfs", 1)
  assert [p for p, _ in measured] == cands
  assert all(t is not None and t >= 0.0 for _, t in measured)


class _Raising(B.Backend):
  """A backend that raises ``error`` when it executes."""
  container = "coo"
  priority = 0

  def __init__(self, name, error):
    self.name = name
    self.error = error

  def supports(self, graph, msg, dst_prop, program):
    return True

  def eligible(self, graph, msg, dst_prop, program):
    return False

  def execute(self, graph, msg, active, dst_prop, program, plan, with_recv):
    raise self.error("boom")


@pytest.fixture
def raising_backend():
  names = []

  def make(error):
    name = f"raise_{error.__name__.lower()}"
    B.register(_Raising(name, error))
    names.append(name)
    return name
  yield make
  for name in names:
    B.unregister(name)


@pytest.mark.parametrize("error", [ValueError, NotImplementedError])
def test_autotune_skips_ineligible_candidates(raising_backend, error):
  name = raising_backend(error)
  n, src, dst, w = _random_graph(8)
  g = TG.build_coo(src, dst, w, n=n, device="cpu")
  prop0, active0 = _bfs_seed(n)
  planner = Planner()
  p = planner.autotune(g, bfs_program(), prop0, active0,
                       candidates=[Plan(backend=name), Plan(backend="coo")],
                       repeats=1)
  assert p == Plan(backend="coo")
  (measured,) = planner.timings.values()
  assert measured[0] == (Plan(backend=name), None)


def test_autotune_lets_a_launch_error_through(raising_backend):
  """A RuntimeError, as a failed kernel launch raises, is not an
  eligibility refusal: autotune does not hide it, and caches nothing."""
  name = raising_backend(RuntimeError)
  n, src, dst, w = _random_graph(8)
  g = TG.build_coo(src, dst, w, n=n, device="cpu")
  prop0, active0 = _bfs_seed(n)
  planner = Planner()
  with pytest.raises(RuntimeError, match="boom"):
    planner.autotune(g, bfs_program(), prop0, active0,
                     candidates=[Plan(backend="coo"), Plan(backend=name)],
                     repeats=1)
  assert len(planner.cache) == 0


def test_autotune_falls_back_to_the_heuristic(raising_backend):
  name = raising_backend(ValueError)
  n, src, dst, w = _random_graph(9)
  g = TG.build_coo(src, dst, w, n=n, device="cpu")
  prop0, active0 = _bfs_seed(n)
  planner = Planner()
  p = planner.autotune(g, bfs_program(), prop0, active0,
                       candidates=[Plan(backend=name)], repeats=1)
  assert p == planner.plan(g, bfs_program())


def test_autotune_picks_the_fastest_by_the_injected_timer():
  """A fake clock that each superstep of the "slow" plan advances five
  times as far as one of the "fast" plan's: the median picks "fast"."""
  clock = [0.0]

  class Clocked(B.Backend):
    container = "coo"
    priority = 0

    def __init__(self, name, cost):
      self.name, self.cost = name, cost

    def supports(self, graph, msg, dst_prop, program):
      return True

    def eligible(self, graph, msg, dst_prop, program):
      return False

    def execute(self, graph, msg, active, dst_prop, program, plan, with_recv):
      clock[0] += self.cost
      return B.get_backend("coo").execute(graph, msg, active, dst_prop,
                                           program, plan, with_recv)

  B.register(Clocked("slow", 5.0))
  B.register(Clocked("fast", 1.0))
  try:
    n, src, dst, w = _random_graph(10)
    g = TG.build_coo(src, dst, w, n=n, device="cpu")
    deg = torch.from_numpy(np.bincount(src, minlength=n).astype(np.float32))
    planner = Planner()
    p = planner.autotune(g, pagerank_program(), init_prop(deg),
                         torch.ones((n,), dtype=torch.bool),
                         candidates=[Plan("slow"), Plan("fast")],
                         num_iters=2, repeats=3, timer=lambda: clock[0])
    assert p == Plan("fast")
    assert list(planner.timings.values())[0] == [(Plan("slow"), 10.0),
                                                 (Plan("fast"), 2.0)]
  finally:
    B.unregister("slow")
    B.unregister("fast")


def test_autotune_batched_on_ell():
  """Q = 4 BFS on an ELL graph runs every kernel candidate (its plain
  version on the CPU) and returns one of them or the torch ELL plan."""
  n, src, dst, w = _random_graph(11)
  g = TG.build_ell(src, dst, w, n=n, device="cpu")
  dist0, active0 = bfs_columns(torch.tensor([0, 5, 9, 30]), n)
  planner = Planner()
  prog = multi_bfs_program()
  cands = planner.candidates(g, prog, 4)
  p = planner.autotune(g, prog, dist0, active0, repeats=1)
  assert p in cands
  (key, measured), = planner.timings.items()
  assert key[1:] == ("multi_bfs", 4)
  assert [c for c, _ in measured] == cands
  assert all(t is not None for _, t in measured)


@pytest.mark.parametrize("q", [1, 6, 8])
def test_candidates_cover_kernel_launch_shapes(q):
  n, src, dst, w = _random_graph(12)
  g = TG.build_ell(src, dst, w, n=n, device="cpu")
  cands = Planner().candidates(g, bfs_program(), q)
  assert cands[:2] == [Plan("ell"), Plan("cuda_ell")]
  assert {c.block_rows for c in cands if c.block_rows} == {4, 16}
  tiles = sorted(c.block_queries for c in cands if c.block_queries)
  assert tiles == {1: [], 6: [1, 2, 3], 8: [1, 2, 4]}[q]
  assert len(set(cands)) == len(cands)
  # A program the kernel cannot take gets the torch ELL plan only.
  from repro_torch.algos.triangle_count import bitmap_build_program
  assert Planner().candidates(g, bitmap_build_program(), q) == [Plan("ell")]


@pytest.mark.parametrize("container", ["coo", "dense"])
def test_candidates_match_jax_outside_the_kernel(container):
  """Outside the ELL kernel's launch shapes the candidates are the
  reference's: the COO tile sweep, the dense oracle."""
  n, src, dst, w = _skewed_graph()
  build_t = TG.build_coo if container == "coo" else TG.build_dense
  build_j = JG.build_coo if container == "coo" else JG.build_dense
  tg = build_t(src, dst, w, n=n, device="cpu")
  jg = build_j(src, dst, w, n=n)
  got = Planner(tile_edges=64).candidates(tg, bfs_program())
  want = jbe.Planner(tile_edges=64).candidates(jg, j_bfs_program())
  assert [(p.backend, p.num_tiles) for p in got] == [
      (p.backend, p.num_tiles) for p in want]
  if container == "coo":
    assert len([p for p in got if p.backend == "coo_tiled"]) >= 2
