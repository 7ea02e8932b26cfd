"""Parameter definitions and shared layers (norms, RoPE, embeddings,
projections).

Params are nested dicts of tensors, with the JAX package's keys and shapes
(stacked layers keep their leading ``[num_layers, ...]`` axis), so weights
carry across one to one (:func:`params_from_numpy`).  Every model module
first builds a nested dict of :class:`ParamDef` (shape + partition spec +
init), from which :func:`init_params` draws the tensors, :func:`num_params`
counts them, :func:`param_shapes` gives meta-tensor stand-ins (the dry run,
no allocation) and :func:`param_shardings` gives DTensor placements on a
``DeviceMesh`` — one source of truth, as in the reference.

A partition spec is a :class:`P`: per tensor dimension a mesh axis name, a
tuple of names, or ``None``, as a JAX ``PartitionSpec``.  On a mesh with
named dimensions an axis named at tensor dim *i* becomes ``Shard(i)`` on
that mesh dimension, and every other mesh dimension is ``Replicate()``
(:func:`placements`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any


class P:
  """A partition spec: one entry per leading tensor dimension, each a mesh
  axis name, a tuple of names (the dimension split over several mesh axes,
  major first) or ``None`` (not split); trailing dimensions not named are
  not split.  ``tuple(P(...))`` equals ``tuple`` of the same JAX
  ``PartitionSpec``.  Not a tuple itself, so the tree helpers keep it as a
  leaf."""

  __slots__ = ("_entries",)

  def __init__(self, *entries):
    self._entries = tuple(tuple(e) if isinstance(e, list) else e
                          for e in entries)

  def __iter__(self):
    return iter(self._entries)

  def __len__(self) -> int:
    return len(self._entries)

  def __getitem__(self, i):
    return self._entries[i]

  def __eq__(self, other) -> bool:
    return isinstance(other, P) and self._entries == other._entries

  def __hash__(self) -> int:
    return hash(self._entries)

  def __repr__(self) -> str:
    return f"P{self._entries!r}"


@dataclasses.dataclass(frozen=True)
class ParamDef:
  shape: Tuple[int, ...]
  pspec: P = P()
  dtype: torch.dtype = torch.float32
  init: str = "normal"       # normal | zeros | ones
  scale: Optional[float] = None  # stddev; None -> 1/sqrt(fan_in)


def is_param_def(x) -> bool:
  return isinstance(x, ParamDef)


def init_params(defs: PyTree, generator: torch.Generator,
                device: DeviceLike = "cuda") -> PyTree:
  """Materialize parameters from ``generator`` (on ``device``), leaf by leaf
  in sorted-key order.  The draws are not those of ``jax.random``; tests
  carry JAX weights across with :func:`params_from_numpy` instead."""
  dev = resolve_device(device)
  leaves, treedef = tree_flatten(defs)
  out = []
  for d in leaves:
    if d.init == "zeros":
      out.append(torch.zeros(d.shape, dtype=d.dtype, device=dev))
    elif d.init == "ones":
      out.append(torch.ones(d.shape, dtype=d.dtype, device=dev))
    else:
      # Stddev 1/sqrt(fan_in), the second-to-last axis, unless given.
      if d.scale is not None:
        std = d.scale
      else:
        fi = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        std = 1.0 / math.sqrt(fi)
      t = torch.empty(d.shape, dtype=torch.float32, device=dev)
      out.append(t.normal_(0.0, std, generator=generator).to(d.dtype))
  return tree_unflatten(treedef, out)


def num_params(defs: PyTree) -> int:
  return sum(int(np.prod(d.shape)) for d in tree_leaves(defs))


def param_shapes(defs: PyTree) -> PyTree:
  """Meta tensors of each leaf's shape and dtype (the dry run: no
  allocation)."""
  return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                        device="meta"), defs)


def param_pspecs(defs: PyTree) -> PyTree:
  return tree_map(lambda d: d.pspec, defs)


def placements(spec: P, mesh) -> Tuple[Any, ...]:
  """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` with
  named dimensions): ``Shard(i)`` on each mesh dimension named at tensor
  dim *i*, ``Replicate()`` on the others.  A tuple entry must name its
  mesh dimensions in the mesh's order (major first), the one order DTensor
  nests shards in."""
  names = mesh.mesh_dim_names
  out = [Replicate()] * len(names)
  for i, entry in enumerate(spec):
    if entry is None:
      continue
    axes = entry if isinstance(entry, tuple) else (entry,)
    idx = [names.index(a) for a in axes]
    if idx != sorted(idx):
      raise ValueError(f"{spec}: the axes {axes} of dim {i} are not in the "
                       f"mesh's order {names}")
    for j in idx:
      if out[j] != Replicate():
        raise ValueError(f"{spec}: mesh axis {names[j]!r} named twice")
      out[j] = Shard(i)
  return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
  """A leaf's placement on a mesh: the port's ``NamedSharding``.  A leaf of
  the tree helpers, so a tree of them matches its parameter tree."""
  mesh: Any
  placements: Tuple[Any, ...]

  def place(self, t: torch.Tensor) -> DTensor:
    """``t`` (the full tensor, the same on every rank) as a DTensor placed
    so.  Every rank cuts its own shard from its copy: no data is sent."""
    return distribute_tensor(t, self.mesh, self.placements,
                             src_data_rank=None)


def named(mesh, spec: P) -> Sharding:
  return Sharding(mesh, placements(spec, mesh))


def param_shardings(defs: PyTree, mesh) -> PyTree:
  """Each leaf's :class:`Sharding` on ``mesh`` (:func:`placements`)."""
  return tree_map(lambda d: named(mesh, d.pspec), defs)


def distribute_params(params: PyTree, shardings: PyTree) -> PyTree:
  """``params`` (full tensors, the same on every rank) as DTensors, each
  placed as ``shardings`` says (:func:`param_shardings`)."""
  return tree_map(lambda t, sh: sh.place(t), params, shardings)


def whole_on(x: torch.Tensor, axis: str) -> torch.Tensor:
  """DTensor ``x`` made whole (replicated) on mesh axis ``axis``, its other
  placements kept; ``x`` itself when it is not a DTensor."""
  if not isinstance(x, DTensor) or axis not in x.device_mesh.mesh_dim_names:
    return x
  i = x.device_mesh.mesh_dim_names.index(axis)
  if x.placements[i] == Replicate():
    return x
  pl = list(x.placements)
  pl[i] = Replicate()
  return x.redistribute(x.device_mesh, pl)


def is_dtensor(x) -> bool:
  return isinstance(x, DTensor)


_NESTING = threading.local()


@contextlib.contextmanager
def sharded_context(tree: PyTree):
  """DTensor's ``implicit_replication`` when ``tree``'s first leaf is a
  DTensor (a plain tensor the code makes — a position, a mask, a step
  count — is then replicated); nothing otherwise.  Nests: only the
  outermost enters ``implicit_replication``, whose exit switches it off
  rather than restoring what was there."""
  leaves = tree_leaves(tree)
  depth = getattr(_NESTING, "depth", 0)
  if depth or not (leaves and is_dtensor(leaves[0])):
    yield
    return
  _NESTING.depth = 1
  try:
    with implicit_replication():
      yield
  finally:
    _NESTING.depth = 0


def params_from_numpy(tree: PyTree, device: DeviceLike = "cuda") -> PyTree:
  """The JAX parameter tree as numpy arrays (for example
  ``jax.tree_util.tree_map(np.asarray, params)``) -> the port's tree, with
  the same keys, shapes and dtypes."""
  dev = resolve_device(device)
  return tree_map(lambda x: torch.from_numpy(np.array(x)).to(dev), tree)


# ---------------------------------------------------------------------------
# Shared layers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
  x32 = x.float()
  var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
  return (x32 * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
  x32 = x.float()
  mu = torch.mean(x32, dim=-1, keepdim=True)
  var = torch.var(x32, dim=-1, keepdim=True, correction=0)
  return ((x32 - mu) * torch.rsqrt(var + eps) * gamma.float()
          + beta.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: DeviceLike = None) -> torch.Tensor:
  """[head_dim/2] inverse frequencies (float32)."""
  return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
  """Rotate [..., S, H, D] by position (half-split: the first and second
  halves of D are the pairs).  ``positions``: [..., S] int."""
  inv = rope_freqs(x.shape[-1], theta, device=x.device)   # [D/2]
  ang = positions[..., None].float() * inv                # [..., S, D/2]
  cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, D/2]
  sin = torch.sin(ang)[..., None, :]
  x1, x2 = x.float().chunk(2, dim=-1)
  out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
  return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
  """Token embedding.  Gathers, then casts the gathered rows (the reference
  casts the whole table first; the values are the same).  In the backward
  pass the gradients of repeated tokens are therefore summed in float32,
  where the reference sums them in the compute dtype: in bf16 the two
  ``embed`` gradients agree at bf16 tolerance, not bit for bit
  (``tests/test_torch_train_grads.py``).  On a vocab-sharded DTensor table
  the partial rows are summed over the vocab axes at once."""
  x = torch.nn.functional.embedding(ids, table)
  if isinstance(x, DTensor):
    # A vocab-sharded table gives partial rows: sum them here, where they
    # arise (the reference's GSPMD does the same before the constraint).
    x = x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])
  return x.to(compute_dtype)


def out_proj_einsum(spec: str, x: torch.Tensor, w: torch.Tensor,
                    cfg) -> torch.Tensor:
  """Row-parallel output projection, in the compute dtype.  (The reference's
  ``low_precision_reduce`` picks the dtype of a tensor-parallel all-reduce;
  unsharded both settings give this product.)  On DTensors the result is
  made whole on "model" — the tensor-parallel all-reduce — so that the
  residual stream stays split on the batch alone, whatever layout DTensor
  would pick for the partial sums."""
  return whole_on(torch.einsum(spec, x, w.to(cfg.compute_dtype)), "model")


def unembed(x: torch.Tensor, table_or_head: torch.Tensor,
            compute_dtype: torch.dtype) -> torch.Tensor:
  """Project to vocab logits: x [..., d] @ W [d, V]."""
  return torch.matmul(x, table_or_head.to(compute_dtype))
