"""The port's pytree and norm helpers against the reference's:
``core.semiring.tree_select`` / ``tree_full_like`` (over dicts, tuples and
lists, with masks broadcast over trailing dims; scalar, 0-d and pytree
fills) and ``models.common.layer_norm`` (f32 math, the input's dtype out)
and ``is_param_def``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import semiring as RS  # noqa: E402
from repro.models import common as RM  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.core import semiring as S  # noqa: E402
from repro_torch.models import common as M  # noqa: E402


def _tree(rng):
  return {"a": rng.standard_normal((6,)).astype(np.float32),
          "b": (rng.integers(-5, 5, (6, 3)).astype(np.int32),
                [rng.standard_normal((6, 2, 4)).astype(np.float32)])}


def _to(tree, fn):
  if isinstance(tree, dict):
    return {k: _to(v, fn) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_to(v, fn) for v in tree)
  return fn(tree)


def _assert_trees_equal(got, want):
  g, w = tree_leaves(got), tree_leaves(_to(want, np.asarray))
  assert len(g) == len(w)
  for a, b in zip(g, w):
    assert str(a.dtype).split(".")[-1] == np.asarray(b).dtype.name
    np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("mask_shape", [(6,), (6, 1)])
def test_tree_select_matches_reference(mask_shape):
  rng = np.random.default_rng(0)
  a, b = _tree(rng), _tree(rng)
  mask = rng.random(mask_shape) < 0.5
  if len(mask_shape) == 2:  # a [6, 1] mask cannot meet the [6] leaf
    a, b = a["b"], b["b"]
  got = S.tree_select(torch.from_numpy(mask), _to(a, torch.from_numpy),
                      _to(b, torch.from_numpy))
  want = RS.tree_select(jnp.asarray(mask), _to(a, jnp.asarray),
                        _to(b, jnp.asarray))
  _assert_trees_equal(got, want)


@pytest.mark.parametrize("fill", [3, -1.5, True, "0-d", "tree"])
def test_tree_full_like_matches_reference(fill):
  rng = np.random.default_rng(1)
  t = _tree(rng)
  if fill == "0-d":
    port_fill, ref_fill = torch.tensor(2.5), jnp.asarray(2.5)
  elif fill == "tree":
    vals = {"a": 1.0, "b": (7, [-2.0])}
    port_fill = ref_fill = vals
  else:
    port_fill = ref_fill = fill
  got = S.tree_full_like(_to(t, torch.from_numpy), port_fill)
  want = RS.tree_full_like(_to(t, jnp.asarray), ref_fill)
  _assert_trees_equal(got, want)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 0)])
def test_layer_norm_matches_reference(dtype, tol):
  """f32 at rtol/atol 1e-6; bf16 (the output rounded once, from f32 math
  on the same bf16 inputs) within one bf16 ulp of the reference."""
  rng = np.random.default_rng(2)
  x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
  gamma = rng.standard_normal((64,)).astype(np.float32)
  beta = rng.standard_normal((64,)).astype(np.float32)
  tx = torch.from_numpy(x).to(getattr(torch, dtype))
  jx = jnp.asarray(x).astype(dtype)
  got = M.layer_norm(tx, torch.from_numpy(gamma), torch.from_numpy(beta))
  want = RM.layer_norm(jx, jnp.asarray(gamma), jnp.asarray(beta))
  assert got.dtype == tx.dtype and str(want.dtype) == dtype
  g = got.float().numpy()
  w = np.asarray(want.astype(jnp.float32))
  if tol:
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
  else:
    np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=2.0 ** -7)


def test_is_param_def_matches_reference():
  port = [M.ParamDef((2, 3)), M.P("model"), (2, 3), None, 1.0]
  ref = [RM.ParamDef((2, 3)), (2, 3), None, 1.0]
  assert [M.is_param_def(d) for d in port] == [True] + [False] * 4
  assert [RM.is_param_def(d) for d in ref] == [True] + [False] * 3
  assert not M.is_param_def(RM.ParamDef((2, 3)))
