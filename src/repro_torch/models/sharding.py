"""The port's sharding sites: what the reference leaves to GSPMD or writes
with ``with_sharding_constraint`` and ``shard_map``, on DTensors.

With DTensor parameters (:func:`repro_torch.models.common.distribute_params`)
the model code runs as written and DTensor propagates placements op by op,
as GSPMD propagates shardings.  This module holds the places where that is
not enough:

* :func:`unshard_data` — the FSDP gather of a layer's parameters before
  use, leaving only their tensor-parallel shards.
* :func:`constrain` — ``jax.lax.with_sharding_constraint``: a redistribute
  to the placements of a partition spec on the tensor's own mesh; a no-op
  on a plain tensor.
* :func:`per_group` — ops that DTensor has no sharding rule for (the stable
  sort, ``searchsorted``, ``index_copy_`` and ``index_add_`` of the MoE
  routing) but that touch one routing group at a time: run per shard of
  the group axis through ``local_map``, every other axis gathered.
* :func:`per_head` — the chunked attention's online softmax, per (batch
  shard × head shard): DTensor would follow it op by op through merged
  batch-and-head axes it cannot always place.
* :func:`write_slot` and :func:`slot_sharded_decode_attention` — the decode
  cache: one slot written on the shard that holds it, and, where the cache
  is split over its slots (the ``"seq"`` layout), attention as a
  flash-decode: local scores, then the max, the sum of exponentials and the
  weighted sum of values reduced over the slot axes.  The reference gets
  that from GSPMD; DTensor would gather the cache instead.
* :func:`vocab_sharded_nll` — cross entropy on vocab-sharded logits without
  gathering them: the log-sum-exp and the gold logit reduced over the vocab
  axes, a ``[B, S]`` field.

Every function takes its mesh from its inputs (``device_mesh``), never from
global state.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import P, placements

Tensor = torch.Tensor


def constrain(x: Tensor, spec: P) -> Tensor:
  """``x`` redistributed to ``spec``'s placements on its mesh (the port of
  ``with_sharding_constraint``); ``x`` itself when it is not a DTensor.  A
  dimension that its axes do not divide stays whole (B = 1 on the data
  axes): GSPMD would pad it, DTensor would leave ranks with empty shards
  that later reshapes refuse."""
  if not isinstance(x, DTensor):
    return x
  mesh = x.device_mesh
  sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
  entries = []
  for dim, e in zip(x.shape, tuple(spec) + (None,) * (x.dim() - len(spec))):
    axes = e if isinstance(e, tuple) else (e,) if e is not None else ()
    n = 1
    for a in axes:
      n *= sizes[a]
    entries.append(e if dim % n == 0 else None)
  return x.redistribute(mesh, placements(P(*entries), mesh))


def unshard_data(w: Tensor) -> Tensor:
  """A parameter made whole on every mesh axis but "model": the FSDP
  all-gather before use (``launch.specs.fsdp_defs`` shards parameters over
  the data axes; DTensor's backward of this gather is the gradient's
  reduce-scatter).  ``w`` itself when it is not sharded so."""
  if not isinstance(w, DTensor):
    return w
  names = w.device_mesh.mesh_dim_names
  pl = [p if names[i] == "model" or not isinstance(p, Shard) else Replicate()
        for i, p in enumerate(w.placements)]
  if tuple(pl) == tuple(w.placements):
    return w
  return w.redistribute(w.device_mesh, pl)


def is_split(x: Tensor, dim: int) -> bool:
  """Whether DTensor ``x`` is sharded along tensor dim ``dim``."""
  return isinstance(x, DTensor) and any(
      isinstance(p, Shard) and p.dim == dim for p in x.placements)


def _axes_of(x: DTensor, dim: int) -> Tuple[int, ...]:
  """The mesh dimensions that shard tensor dim ``dim`` of ``x``."""
  return tuple(i for i, p in enumerate(x.placements)
               if isinstance(p, Shard) and p.dim == dim)


def _only(x: DTensor, dims: Sequence[int]) -> Tuple:
  """``x``'s placements with every shard of a dim outside ``dims`` (and
  every partial) replaced by ``Replicate()``."""
  return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
               for p in x.placements)


def _all_reduce(t: Tensor, op: str, mesh, mesh_dims: Sequence[int]) -> Tensor:
  for i in mesh_dims:
    t = funcol.all_reduce(t, op, (mesh, i))
  return funcol.wait_tensor(t) if mesh_dims else t


def per_group(fn: Callable, *args, n_out: int = 1):
  """``fn(*args)`` run per shard of the leading (group) axis: each DTensor
  argument keeps its shards of dim 0 and is gathered on every other mesh
  dimension, and each of the ``n_out`` tensors ``fn`` returns (a flat
  tuple when more than one) is sharded on dim 0 as the first DTensor
  argument is.  ``fn(*args)`` itself when no argument is a DTensor."""
  first = next((a for a in args if isinstance(a, DTensor)), None)
  if first is None:
    return fn(*args)
  pl = _only(first, (0,))
  ins = tuple(pl if isinstance(a, DTensor) else None for a in args)
  args = tuple(a.redistribute(a.device_mesh, pl) if isinstance(a, DTensor)
               else a for a in args)
  # local_map reads a tuple as one placement list per output.
  outs = (pl,) * n_out if n_out > 1 else list(pl)
  return local_map(fn, out_placements=outs, in_placements=ins,
                   device_mesh=first.device_mesh)(*args)


def per_head(fn: Callable, q: Tensor, k: Tensor, v: Tensor, *rest,
             **kwargs) -> Tensor:
  """``fn(q, k, v, *rest, **kwargs)`` (q [B,S,H,D], k/v [B,T,H,D] -> [B,S,H,D])
  run per (batch shard × head shard) through ``local_map``: attention is
  local to a batch row and a head.  q keeps its shards of B and H, k and v
  are placed as q is, and every other axis is gathered.  ``fn(...)``
  itself when q is not a DTensor."""
  if not isinstance(q, DTensor):
    return fn(q, k, v, *rest, **kwargs)
  pl = _only(q, (0, 2))
  mesh = q.device_mesh
  q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
  return local_map(lambda *a: fn(*a, **kwargs), out_placements=list(pl),
                   in_placements=(pl, pl, pl) + (None,) * len(rest),
                   device_mesh=mesh)(q, k, v, *rest)


def write_slot(cache: Tensor, slot: Tensor, new: Tensor) -> Tensor:
  """``cache.index_copy(1, slot, new)`` (``slot`` one index; the cache
  passed in is left as it was).  On a DTensor cache ``new`` is placed as
  the cache is (gathered along the slot axis) and each shard writes the
  slot if it holds it."""
  if not isinstance(cache, DTensor):
    return cache.index_copy(1, slot, new)
  mesh = cache.device_mesh
  pl = cache.placements
  new_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in pl)
  new = new.redistribute(mesh, new_pl)
  if not is_split(cache, 1):
    return local_map(lambda c, n, s: c.index_copy(1, s, n),
                     out_placements=list(pl),
                     in_placements=(pl, new_pl, None),
                     device_mesh=mesh)(cache, new, slot)
  local_t, offset = _block(cache, 1)

  def local(c, n, s):
    ls = s - offset
    inside = (ls >= 0) & (ls < local_t)
    ls = torch.clamp(ls, 0, local_t - 1)
    row = torch.where(inside.reshape(1, 1, *([1] * (c.dim() - 2))), n,
                      c.index_select(1, ls))
    return c.index_copy(1, ls, row)

  return local_map(local, out_placements=list(pl),
                   in_placements=(pl, new_pl, None),
                   device_mesh=mesh)(cache, new, slot)


def _block(x: DTensor, dim: int) -> Tuple[int, int]:
  """(this rank's extent of tensor dim ``dim`` of ``x``, its first global
  index): DTensor's nested ``torch.chunk`` split over the mesh dimensions
  that shard ``dim``, in the mesh's order, from the rank's mesh
  coordinate (no tensor op, so it holds under ``FakeTensorMode`` too)."""
  size, offset = x.shape[dim], 0
  coord = x.device_mesh.get_coordinate()
  for i in _axes_of(x, dim):
    chunk = -(-size // x.device_mesh.size(i))
    start = min(coord[i] * chunk, size)
    offset += start
    size = min(chunk, size - start)
  return size, offset


def slot_sharded_decode_attention(q: Tensor, k: Tensor, v: Tensor,
                                  pos: Tensor, *, window: int = 0) -> Tensor:
  """GQA decode attention over a ring cache k/v [B,T,KV,D] split along T:
  a flash-decode.  Each shard scores its slots (their positions recovered
  as the unsharded path does, p(s) = pos − ((pos − s) mod T)), and the
  softmax's max, its denominator and the context are reduced over the
  mesh dimensions that split T; only [B,1,KV,G,·] partials cross ranks.
  The scaling and grouping are those of the unsharded
  ``grouped_decode_attention``.  Returns [B,1,Hp,D], replicated on the slot
  axes.
  """
  from repro_torch.models.attention import MASKED_POS, NEG_INF, causal_swa_mask
  mesh = k.device_mesh
  kv_pl = k.placements
  t_axes = _axes_of(k, 1)
  # q: split on the batch as the cache is, whole on the slot axes.
  q_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else
               Replicate() for p in kv_pl)
  q = q.redistribute(mesh, q_pl) if isinstance(q, DTensor) else q
  t = k.shape[1]
  local_t, offset = _block(k, 1)
  scale = 1.0 / (q.shape[-1] ** 0.5)

  def local(q_, k_, v_, pos_):
    b, s, hp, d = q_.shape
    kv = k_.shape[2]
    g = hp // kv
    s_idx = torch.arange(offset, offset + local_t, dtype=torch.int32,
                         device=k_.device)
    k_pos = pos_ - torch.remainder(pos_ - s_idx, t)
    k_pos = torch.where(k_pos >= 0, k_pos, MASKED_POS)
    qg = (q_ * scale).reshape(b, s, kv, g, d)
    sc = torch.einsum("bskgd,btkd->bskgt", qg.float(), k_.float())
    mask = causal_swa_mask(pos_.reshape(1), k_pos, window, True)
    sc = torch.where(mask[None, :, None, None, :], sc, NEG_INF)
    m = _all_reduce(sc.amax(dim=-1, keepdim=True), "max", mesh, t_axes)
    p = torch.exp(sc - m)
    l = _all_reduce(p.sum(dim=-1, keepdim=True), "sum", mesh, t_axes)
    ctx = _all_reduce(torch.einsum("bskgt,btkd->bskgd", p, v_.float()),
                      "sum", mesh, t_axes)
    ctx = ctx / torch.clamp(l, min=1e-30)
    return ctx.reshape(b, s, hp, d).to(q_.dtype)

  return local_map(local, out_placements=list(q_pl),
                   in_placements=(q_pl, kv_pl, kv_pl, None),
                   device_mesh=mesh)(q, k, v, pos)


class _VocabNll(torch.autograd.Function):
  """Per-shard negative log-likelihood of vocab-sharded logits; the
  arithmetic, forward and backward, is ``torch.logsumexp`` minus the gold
  logit's, so one shard gives the unsharded path's bits."""

  @staticmethod
  def forward(ctx, x, lab, valid, offset, mesh, axes):
    m = _all_reduce(x.amax(dim=-1), "max", mesh, axes)
    m = torch.where(m.abs() == float("inf"), 0.0, m)
    s = _all_reduce(torch.exp(x - m[..., None]).sum(dim=-1), "sum", mesh,
                    axes)
    lse = torch.log(s) + m
    loc = lab - offset
    inside = (loc >= 0) & (loc < x.shape[-1])
    loc = torch.where(inside, loc, 0)
    gold = torch.gather(x, -1, loc[..., None])[..., 0]
    gold = _all_reduce(torch.where(inside, gold, 0.0), "sum", mesh, axes)
    ctx.save_for_backward(x, lse, loc, inside, valid)
    return (lse - gold) * valid

  @staticmethod
  def backward(ctx, g):
    x, lse, loc, inside, valid = ctx.saved_tensors
    gv = g * valid
    grad = gv[..., None] * torch.exp(x - lse[..., None])
    gold = torch.zeros_like(x).scatter_add_(
        -1, loc[..., None], torch.where(inside, -gv, 0.0)[..., None])
    return grad + gold, None, None, None, None, None


def vocab_sharded_nll(logits32: DTensor, lab: Tensor, valid: Tensor
                      ) -> DTensor:
  """(log-sum-exp − gold logit) · valid, [B,S], of float32 logits [B,S,V]
  sharded on V (and perhaps on B), without gathering them: the reference's
  masked-sum cross entropy, whose psum crosses only a [B,S] field."""
  mesh = logits32.device_mesh
  pl = logits32.placements
  v_axes = _axes_of(logits32, 2)
  row_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else
                 Replicate() for p in pl)
  _, vocab_offset = _block(logits32, 2)

  def local(x, lab_, valid_):
    return _VocabNll.apply(x, lab_, valid_, vocab_offset, mesh, v_axes)

  lab = _as_placed(lab, mesh, row_pl)
  valid = _as_placed(valid, mesh, row_pl)
  return local_map(local, out_placements=list(row_pl),
                   in_placements=(pl, row_pl, row_pl),
                   device_mesh=mesh)(logits32, lab, valid)


def _as_placed(x: Tensor, mesh, pl) -> DTensor:
  if isinstance(x, DTensor):
    return x.redistribute(mesh, pl)
  return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim).redistribute(
      mesh, pl)
