"""The generators: the same seed gives the same inputs, another seed other
ones, and the configuration's shape."""

import pytest
import torch

from graphbench import gen
from graphbench.gen import kronecker

SMALL_GRAPH = {"generator": "kronecker", "shape_seed": 11, "scale": 9, "edgefactor": 16,
               "abc": [0.57, 0.19, 0.19]}
SMALL_RATINGS = {"generator": "ratings", "shape_seed": 12, "users": 500, "items": 60,
                 "ratings": 6000,
                 "assumed": {"item_zipf_exponent": 1.2,
                             "user_lognormal_sigma": 1.2,
                             "draws_per_rating": 3.4}}
BIG_SEED = 2**31 + 977


def _same(a, b):
  for k in a:
    if isinstance(a[k], torch.Tensor):
      assert torch.equal(a[k], b[k]), k
    elif isinstance(a[k], dict):
      _same(a[k], b[k])
    else:
      assert a[k] == b[k], k


@pytest.mark.parametrize("config", [SMALL_GRAPH, SMALL_RATINGS],
                         ids=["kronecker", "ratings"])
def test_deterministic_by_seed(config):
  a = gen.make(config, BIG_SEED, "cpu")
  _same(a, gen.make(config, BIG_SEED, "cpu"))
  b = gen.make(config, BIG_SEED + 1, "cpu")
  key = "tuples" if "tuples" in a else "user"
  first = a[key]["start"] if key == "tuples" else a[key]
  other = b[key]["start"] if key == "tuples" else b[key]
  assert not torch.equal(first, other)


def test_kronecker_shape():
  d = gen.make(SMALL_GRAPH, 3, "cpu")
  n, m = 1 << 9, 16 << 9
  t = d["tuples"]
  assert d["n"] == n and t["start"].numel() == m and t["end"].numel() == m
  assert int(t["start"].max()) < n and int(t["start"].min()) >= 0
  assert float(t["weight"].min()) >= 0.0 and float(t["weight"].max()) < 1.0
  e = d["edges"]
  assert not bool((e["src"] == e["dst"]).any())
  key = e["src"] * n + e["dst"]
  assert torch.equal(key, torch.unique(key))           # sorted, no repeats
  rev = torch.sort(e["dst"] * n + e["src"]).values
  assert torch.equal(rev, key)                          # symmetric
  # Each direction carries the least weight of the tuples on the pair.
  w = {(int(s), int(t_)): float(x) for s, t_, x in
       zip(e["src"], e["dst"], e["w"])}
  for s, t_, x in zip(t["start"].tolist(), t["end"].tolist(),
                      t["weight"].tolist()):
    if s != t_:
      assert w[(s, t_)] <= x and w[(t_, s)] <= x
  deg = torch.bincount(e["src"], minlength=n)
  assert bool((deg[d["roots"]] > 0).all())
  assert d["roots"].numel() == int((deg > 0).sum())
  assert torch.unique(d["roots"]).numel() == d["roots"].numel()
  assert torch.equal(torch.sort(d["keys"]).values,
                     torch.sort(d["roots"]).values)


def test_every_seed_an_isomorphic_graph():
  """Another seed relabels the same weighted graph: the search keys are the
  same vertices, with the same degrees and the same weights out of them."""
  a, b = gen.make(SMALL_GRAPH, 1, "cpu"), gen.make(SMALL_GRAPH, 99, "cpu")
  for d in (a, b):
    d["deg"] = torch.bincount(d["edges"]["src"], minlength=d["n"])
  assert torch.equal(a["deg"][a["keys"][:64]], b["deg"][b["keys"][:64]])
  assert torch.equal(torch.sort(a["edges"]["w"]).values,
                     torch.sort(b["edges"]["w"]).values)
  assert not torch.equal(a["keys"][:64], b["keys"][:64])


def test_kronecker_skew():
  """The Kronecker law: the start bit is 1 with probability C + D."""
  t = kronecker.kronecker_tuples(12, 16, (0.57, 0.19, 0.19),
                                 gen.generator(5, "cpu"),
                                 gen.generator(6, "cpu"), "cpu")
  n, m = 1 << 12, 16 << 12
  assert t["start"].numel() == m
  # Vertex 0 before the labels are permuted has the most edges; here the
  # busiest vertex holds far more than the mean.
  deg = torch.bincount(torch.cat([t["start"], t["end"]]), minlength=n)
  assert int(deg.max()) > 20 * (2 * m / n)


@pytest.mark.parametrize("config", [SMALL_GRAPH, SMALL_RATINGS],
                         ids=["kronecker", "ratings"])
def test_every_seed_the_same_sizes(config):
  """Seeds differ in labels, order and values, not in the amount of work:
  the same multiset of degrees."""
  def degrees(d):
    if "edges" in d:
      return torch.sort(torch.bincount(d["edges"]["src"],
                                       minlength=d["n"])).values
    return torch.sort(torch.bincount(d["user"])).values
  a, b = gen.make(config, 1, "cpu"), gen.make(config, 2**40 + 3, "cpu")
  assert torch.equal(degrees(a), degrees(b))


def test_ratings_shape():
  d = gen.make(SMALL_RATINGS, 7, "cpu")
  assert d["user"].numel() == d["item"].numel() == 6000
  key = d["user"] * 60 + d["item"]
  assert torch.unique(key).numel() == 6000              # no pair twice
  assert torch.unique(d["user"]).numel() == 500         # every user
  assert torch.unique(d["item"]).numel() == 60          # every item
  r = d["rating"]
  assert set(torch.unique(r).tolist()) <= {1.0, 2.0, 3.0, 4.0, 5.0}
