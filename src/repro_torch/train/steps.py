"""Train / eval step factories (loss, grads, optimizer update).

The port of :mod:`repro.train.steps`.  Gradients come from
``torch.autograd.grad`` over the parameter leaves; the update runs in place
(:func:`repro_torch.train.optimizer.adamw_update`), so a train step writes
the parameters and optimizer state it is given.  Labels use -1 as the
ignore index (vision positions in VLM batches, padding).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch._tree import (tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)
from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import AdamWState, adamw_update, cosine_lr

PyTree = Any
Tensor = torch.Tensor

IGNORE = -1


def cross_entropy(logits: Tensor, labels: Tensor) -> Tuple[Tensor, Tensor]:
  """Mean CE over non-ignored positions.  logits [B,S,V], labels [B,S].
  Returns (loss, the count of non-ignored positions as float32).

  The reference takes the gold logit with a masked sum over [B,S,V], so
  that a vocab-sharded axis stays sharded.  On one card ``gather`` gives
  the same number (the sum has one non-zero term, and adding zeros is
  exact in float32) without a [B,S,V] bool mask and a second float32 copy
  of the logits: 0.4 and 1.6 GB at Granite-3-2B's [4, 2048, 49408].
  """
  valid = labels != IGNORE
  lab = torch.where(valid, labels, 0).long()
  logits32 = logits.float()
  lse = torch.logsumexp(logits32, dim=-1)
  gold = torch.gather(logits32, -1, lab[..., None])[..., 0]
  nll = (lse - gold) * valid.float()
  denom = torch.clamp(valid.sum(), min=1)
  return torch.sum(nll) / denom, denom.float()


def make_loss_fn(model: Model, aux_weight: float = 0.01):
  def loss_fn(params, batch: Dict[str, Tensor]):
    logits, aux = model.forward(params, batch)
    loss, _ = cross_entropy(logits, batch["labels"])
    total = loss + aux_weight * aux
    return total, {"ce": loss, "moe_aux": aux}
  return loss_fn


def value_and_grad(loss_fn):
  """``jax.value_and_grad(loss_fn, has_aux=True)`` over the port's
  parameter trees: returns fn(params, batch) -> ((loss, aux), grads), with
  the graph freed and the caller's tensors left as they were.  A leaf the
  loss does not reach gets a zero gradient, as in JAX."""
  def fn(params, batch):
    leaves, treedef = tree_flatten(params)
    # Leaves that share the parameters' storage, so that autograd sees
    # them as inputs without touching the caller's tensors.
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
      total, aux = loss_fn(tree_unflatten(treedef, live), batch)
      grads = torch.autograd.grad(total, live, allow_unused=True,
                                  materialize_grads=True)
    aux = tree_map(torch.Tensor.detach, aux)
    return (total.detach(), aux), tree_unflatten(treedef, list(grads))
  return fn


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000,
                    aux_weight: float = 0.01, microbatches: int = 1):
  """Returns step(params, opt_state, batch) -> (params, opt, metrics), which
  updates ``params`` and ``opt_state`` in place.

  ``microbatches > 1`` enables gradient accumulation: the batch's leading
  axis is split and looped over, with gradients summed in float32 and
  averaged, as the reference's scan does (activations peak at one
  microbatch; the float32 gradient sum lives across the loop).
  """
  grads_of = value_and_grad(make_loss_fn(model, aux_weight))

  def step(params, opt_state: AdamWState, batch):
    if microbatches == 1:
      (loss, parts), grads = grads_of(params, batch)
    else:
      b = next(iter(batch.values())).shape[0]
      if b % microbatches:
        raise ValueError(f"batch {b} is not a multiple of microbatches "
                         f"{microbatches}")
      n = b // microbatches
      grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
      l_sum = a_sum = 0.0
      for i in range(microbatches):
        micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        (l, parts), g = grads_of(params, micro)
        torch._foreach_add_(tree_leaves(grads),
                            [x.float() for x in tree_leaves(g)])
        del g
        l_sum = l_sum + l
        a_sum = a_sum + parts["moe_aux"]
      grads = tree_map(lambda g: g / microbatches, grads)
      loss = l_sum / microbatches
      parts = {"ce": loss, "moe_aux": a_sum / microbatches}
    lr = cosine_lr(opt_state.step, peak=peak_lr, warmup=warmup,
                   total=total_steps)
    params, opt_state, gnorm = adamw_update(grads, opt_state, params, lr=lr)
    metrics = {"loss": loss, "ce": parts["ce"], "moe_aux": parts["moe_aux"],
               "lr": lr, "grad_norm": gnorm}
    return params, opt_state, metrics

  return step


def make_eval_step(model: Model):
  """Returns step(params, batch) -> {"loss", "ntok"}, with grad off: there
  the fused selective scan runs (it has no backward)."""
  @torch.no_grad()
  def step(params, batch):
    logits, _ = model.forward(params, batch)
    loss, ntok = cross_entropy(logits, batch["labels"])
    return {"loss": loss, "ntok": ntok}
  return step
