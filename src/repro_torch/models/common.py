"""Parameter definitions and shared layers (norms, RoPE, embeddings,
projections).

Params are nested dicts of tensors, with the JAX package's keys and shapes
(stacked layers keep their leading ``[num_layers, ...]`` axis), so weights
carry across one to one (:func:`params_from_numpy`).  Every model module
first builds a nested dict of :class:`ParamDef`, from which
:func:`init_params` draws the tensors and :func:`num_params` counts them.
The port has no mesh yet, so a ``ParamDef`` carries no partition spec.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
  shape: Tuple[int, ...]
  dtype: torch.dtype = torch.float32
  init: str = "normal"       # normal | zeros | ones
  scale: Optional[float] = None  # stddev; None -> 1/sqrt(fan_in)


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
  (``tests/test_torch_train_grads.py``)."""
  return torch.nn.functional.embedding(ids, table).to(compute_dtype)


def out_proj_einsum(spec: str, x: torch.Tensor, w: torch.Tensor,
                    cfg) -> torch.Tensor:
  """Row-parallel output projection, in the compute dtype.  (The reference's
  ``low_precision_reduce`` picks the dtype of a tensor-parallel all-reduce;
  on one card without a mesh both settings give this product.)"""
  return torch.einsum(spec, x, w.to(cfg.compute_dtype))


def unembed(x: torch.Tensor, table_or_head: torch.Tensor,
            compute_dtype: torch.dtype) -> torch.Tensor:
  """Project to vocab logits: x [..., d] @ W [d, V]."""
  return torch.matmul(x, table_or_head.to(compute_dtype))
