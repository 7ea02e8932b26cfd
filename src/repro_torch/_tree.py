"""Minimal pytree helpers over dict / tuple / list / tensor.

The JAX package threads vertex properties and messages through
``jax.tree_util``.  The port needs only map, leaves, flatten/unflatten and
flatten-with-path over the containers its programs use, so it keeps this
small copy of those semantics: dicts are walked in sorted-key order (as JAX
does), tuples (including named tuples) and lists keep their order, ``None``
is an empty node, and anything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any


def _is_namedtuple(x) -> bool:
  return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
  """Apply ``fn`` leafwise over ``tree`` and same-structured ``rest``."""
  if tree is None:
    return None
  if isinstance(tree, dict):
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}
  if _is_namedtuple(tree):
    return type(tree)(*(tree_map(fn, c, *(r[i] for r in rest))
                        for i, c in enumerate(tree)))
  if isinstance(tree, (tuple, list)):
    return type(tree)(tree_map(fn, c, *(r[i] for r in rest))
                      for i, c in enumerate(tree))
  return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> List[Any]:
  """Leaves in flattening order."""
  return tree_flatten(tree)[0]


def tree_flatten(tree: PyTree) -> Tuple[List[Any], Any]:
  """(leaves, treedef); ``treedef`` is opaque, for :func:`tree_unflatten`."""
  leaves: List[Any] = []
  return leaves, _walk(tree, leaves)


def tree_flatten_with_path(tree: PyTree) -> List[Tuple[str, Any]]:
  """(key, leaf) pairs in flattening order.  A key joins the path's dict
  keys, named-tuple field names and sequence indices with ``/``: the keys
  of the reference's checkpoints (``jax.tree_util.tree_flatten_with_path``
  with each entry's ``key``, ``name`` or ``idx``)."""
  out: List[Tuple[str, Any]] = []
  _walk_paths(tree, (), out)
  return out


def _walk_paths(t, path: Tuple[str, ...], out: List[Tuple[str, Any]]):
  if t is None:
    return
  if isinstance(t, dict):
    for k in sorted(t):
      _walk_paths(t[k], path + (str(k),), out)
  elif _is_namedtuple(t):
    for name, c in zip(t._fields, t):
      _walk_paths(c, path + (name,), out)
  elif isinstance(t, (tuple, list)):
    for i, c in enumerate(t):
      _walk_paths(c, path + (str(i),), out)
  else:
    out.append(("/".join(path), t))


# The walkers are module functions, not closures: a nested function that
# calls itself is a reference cycle, which would keep every flattened leaf
# (whole superstep intermediates, on the card) alive until the garbage
# collector happens to run.
def _walk(t, leaves: List[Any]):
  if t is None:
    return None
  if isinstance(t, dict):
    return ("dict", tuple((k, _walk(t[k], leaves)) for k in sorted(t)))
  if _is_namedtuple(t):
    return ("namedtuple", type(t), tuple(_walk(c, leaves) for c in t))
  if isinstance(t, (tuple, list)):
    return (type(t).__name__, tuple(_walk(c, leaves) for c in t))
  leaves.append(t)
  return "*"


def tree_unflatten(treedef: Any, leaves) -> PyTree:
  """Inverse of :func:`tree_flatten`."""
  return _build(treedef, iter(leaves))


def _build(d, it):
  if d is None:
    return None
  if d == "*":
    return next(it)
  if d[0] == "dict":
    return {k: _build(c, it) for k, c in d[1]}
  if d[0] == "namedtuple":
    return d[1](*(_build(c, it) for c in d[2]))
  children = [_build(c, it) for c in d[1]]
  return tuple(children) if d[0] == "tuple" else children
