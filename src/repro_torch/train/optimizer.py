"""AdamW + cosine schedule over the port's parameter trees.

The port of :mod:`repro.train.optimizer`, with its arithmetic: the
global-norm clip over every leaf in float32, bias corrections
``1 - b1**step`` in float32, weight decay on every leaf (norms included),
and the update in float32, cast to the parameter's dtype.

The update runs in place: :func:`adamw_update` writes the new parameters
and moments into the tensors it is given.  That is the port's form of the
reference launcher's ``donate_argnums=(0, 1)``: at Granite-3-2B's full
size an out-of-place step would hold two copies of the 37.7 GiB of
parameters, gradients and moments.

On DTensor leaves the update runs leaf by leaf on each rank's shards (each
moment placed as its parameter, ``launch.specs.opt_state_pspecs``), and
the global norm's square sums the leaves' partial sums: DTensor reduces
them once, where the square root needs the total.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.models.common import sharded_context

PyTree = Any
Tensor = torch.Tensor


class AdamWState(NamedTuple):
  step: Tensor     # int32 scalar
  mu: PyTree       # first moment (like params)
  nu: PyTree       # second moment (like params)


def adamw_init(params: PyTree) -> AdamWState:
  """Zero moments like ``params``, and step 0, on the parameters' device."""
  dev = tree_leaves(params)[0].device
  return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(torch.zeros_like, params),
                    tree_map(torch.zeros_like, params))


def cosine_lr(step: Tensor, *, peak: float = 3e-4, warmup: int = 100,
              total: int = 10000, floor: float = 0.1) -> Tensor:
  """Linear warm-up to ``peak``, then a cosine decay to ``floor·peak`` at
  ``total``; a float32 scalar on ``step``'s device."""
  s = step.float()
  warm = s / max(warmup, 1)
  frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
  cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
  return peak * torch.where(s < warmup, warm, cos)


@torch.no_grad()
def adamw_update(grads: PyTree, state: AdamWState, params: PyTree, *,
                 lr: Tensor, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> Tuple[PyTree, AdamWState, Tensor]:
  """Returns (params, new_state, global_grad_norm).  ``params`` and the
  moments of ``state`` are updated in place (and returned); ``grads`` are
  left as they were."""
  with sharded_context(params):
    return _adamw_update(grads, state, params, lr=lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, grad_clip=grad_clip)


def _adamw_update(grads, state, params, *, lr, b1, b2, eps, weight_decay,
                  grad_clip):
  flat_g = tree_leaves(grads)
  sq = sum(torch.sum(torch.square(g.float())) for g in flat_g)
  gnorm = torch.sqrt(sq)
  scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
  step = state.step + 1
  b1c = 1 - b1 ** step.float()
  b2c = 1 - b2 ** step.float()
  for p, g, m, v in zip(tree_leaves(params), flat_g, tree_leaves(state.mu),
                        tree_leaves(state.nu)):
    g = g.float() * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * torch.square(g))
    del g
    delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
    p32 = p.float()
    delta.add_(weight_decay * p32)
    p.copy_(p32 - lr * delta)
  return params, AdamWState(step, state.mu, state.nu), gnorm
