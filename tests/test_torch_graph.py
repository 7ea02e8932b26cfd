"""The port's graph builders and carry-across against the JAX package.

Same numpy edges in, the same arrays out: every field is compared by value
(exactly — the builders are the same numpy code; only index dtypes differ,
int64 in the port where torch scatters need it).
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as JG  # noqa: E402
from repro.graphs import preprocess as jpre  # noqa: E402
from repro.graphs import rmat as jrmat  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.graphs import preprocess as tpre  # noqa: E402
from repro_torch.graphs import rmat as trmat  # noqa: E402

COO_FIELDS = ("src", "dst", "w", "emask", "out_deg", "in_deg")
ELL_FIELDS = ("cols", "vals", "mask", "row_of", "packed_of")


def _np(x):
  return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_fields(jg, tg, fields):
  for f in fields:
    np.testing.assert_array_equal(_np(getattr(tg, f)), _np(getattr(jg, f)),
                                  err_msg=f)


def _jax_arrays(g, fields):
  return {f: np.asarray(getattr(g, f)) for f in fields}


def test_generators_are_copies():
  for seed in (0, 3):
    js, jd = jrmat.rmat_edges(9, 8, seed=seed)
    ts, td = trmat.rmat_edges(9, 8, seed=seed)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(td, jd)
    a = jpre.symmetrize(*jpre.remove_self_loops(js, jd))
    b = tpre.symmetrize(*tpre.remove_self_loops(ts, td))
    for x, y in zip(a, b):
      np.testing.assert_array_equal(y, x)


def test_coo_builder_matches_jax(rmat_small):
  n, src, dst, w = rmat_small
  _assert_fields(JG.build_coo(src, dst, w, n=n),
                 TG.build_coo(src, dst, w, n=n, device="cpu"), COO_FIELDS)
  # Padded capacity: padded dst = n-1, padded src = PAD, emask False.
  cap = len(src) + 37
  jg = JG.build_coo(src, dst, w, n=n, capacity=cap)
  tg = TG.build_coo(src, dst, w, n=n, capacity=cap, device="cpu")
  _assert_fields(jg, tg, COO_FIELDS)
  assert tg.capacity == cap and int(tg.num_edges) == len(src)
  assert tg.src.dtype == torch.int64 and tg.dst.dtype == torch.int64


@pytest.mark.parametrize("width", [None, 8])
def test_ell_builder_matches_jax_including_spill(rmat_small, width):
  n, src, dst, w = rmat_small
  jg = JG.build_ell(src, dst, w, n=n, width=width)
  tg = TG.build_ell(src, dst, w, n=n, width=width, device="cpu")
  assert (tg.n, tg.width, tg.n_pad) == (jg.n, jg.width, jg.n_pad)
  _assert_fields(jg, tg, ELL_FIELDS)
  assert (tg.spill is None) == (jg.spill is None)
  if width == 8:
    assert tg.spill is not None
    _assert_fields(jg.spill, tg.spill, COO_FIELDS)
  assert tg.cols.dtype == torch.int32 and tg.mask.dtype == torch.bool


def test_ell_padded_rows_map_to_n():
  # n not a multiple of row_block: padded packed rows point at vertex n.
  src = np.array([0, 1, 2, 3, 4], np.int32)
  dst = np.array([1, 2, 3, 4, 0], np.int32)
  jg = JG.build_ell(src, dst, n=5)
  tg = TG.build_ell(src, dst, n=5, device="cpu")
  _assert_fields(jg, tg, ELL_FIELDS)
  assert tg.n_pad == 8 and (tg.row_of[5:] == 5).all()


def test_dense_builder_matches_jax(rmat_small):
  n, src, dst, w = rmat_small
  jg = JG.build_dense(src, dst, w, n=n)
  tg = TG.build_dense(src, dst, w, n=n, device="cpu")
  _assert_fields(jg, tg, ("vals", "struct"))


def test_from_arrays_round_trips(rmat_small):
  n, src, dst, w = rmat_small
  jg = JG.build_ell(src, dst, w, n=n, width=8)
  tg = TG.from_arrays("ell", n, _jax_arrays(jg, ELL_FIELDS), width=jg.width,
                      spill=_jax_arrays(jg.spill, COO_FIELDS), device="cpu")
  _assert_fields(jg, tg, ELL_FIELDS)
  _assert_fields(jg.spill, tg.spill, COO_FIELDS)
  for a, b in zip(TG.coo_from_ell(tg), JG.coo_from_ell(jg)):
    np.testing.assert_array_equal(a, b)
  jc = JG.build_coo(src, dst, w, n=n)
  tc = TG.from_arrays("coo", n, _jax_arrays(jc, COO_FIELDS), device="cpu")
  _assert_fields(jc, tc, COO_FIELDS)
  jd = JG.build_dense(src, dst, w, n=n)
  td = TG.from_arrays("dense", n, _jax_arrays(jd, ("vals", "struct")),
                      device="cpu")
  _assert_fields(jd, td, ("vals", "struct"))
  moved = tg.to("cpu")
  _assert_fields(jg, moved, ELL_FIELDS)
  with pytest.raises(ValueError):
    TG.from_arrays("csr", n, {}, device="cpu")


def test_tree_helpers():
  Pair = collections.namedtuple("Pair", "a b")
  tree = {"y": (torch.ones(2), [torch.zeros(1)]), "x": Pair(torch.ones(3),
                                                            None)}
  leaves, treedef = _tree.tree_flatten(tree)
  assert [t.numel() for t in leaves] == [3, 2, 1]  # dict keys sorted
  back = _tree.tree_unflatten(treedef, leaves)
  assert isinstance(back["x"], Pair) and back["x"].b is None
  doubled = _tree.tree_map(lambda a, b: a + b, tree, tree)
  assert float(doubled["y"][0].sum()) == 4.0
  assert isinstance(doubled["y"][1], list)
