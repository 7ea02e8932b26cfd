"""Serving: prefill and one-token decode steps + a batched greedy loop.

The port of :mod:`repro.serve.engine`.  Each step runs under
``torch.inference_mode()``.  As in the reference, ``generate`` feeds the
prompt token by token through the decode step, so only ``make_prefill``
(``Model.forward``) runs the sequence-level paths: the fused selective-scan
kernel of the SSM family, the chunked attention of the dense family.  A
decode step's ``pos`` is a Python int or a 0-d tensor.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.transformer import Model

PyTree = Any
Tensor = torch.Tensor


def make_prefill(model: Model):
  """prefill(params, batch) -> logits."""
  @torch.inference_mode()
  def prefill(params, batch: Dict[str, Tensor]) -> Tensor:
    logits, _ = model.forward(params, batch)
    return logits
  return prefill


def make_decode_step(model: Model):
  """step(params, token [B,1], cache, pos) -> (logits [B,1,V], cache)."""
  @torch.inference_mode()
  def step(params, token: Tensor, cache: PyTree, pos):
    return model.decode_step(params, token, cache, pos)
  return step


@torch.inference_mode()
def generate(model: Model, params, prompt: Tensor, *, max_new: int = 16,
             max_seq: Optional[int] = None, greedy: bool = True,
             generator: Optional[torch.Generator] = None) -> Tensor:
  """Greedy or sampled generation.

  prompt [B, P] int, on the device that holds ``params``.  Returns
  [B, P + max_new] in the prompt's dtype.  Sampling draws from
  ``generator``; its draws are not those of ``jax.random``, so only the
  greedy mode matches the reference token for token.
  """
  b, p = prompt.shape
  max_seq = max_seq or (p + max_new)
  cache = model.init_cache(b, max_seq, device=prompt.device)
  step = make_decode_step(model)

  # Prefill token by token (simple and exact, as in the reference).
  for i in range(p):
    logits, cache = step(params, prompt[:, i:i + 1], cache, i)
  out = [prompt]
  last = logits[:, -1, : model.cfg.vocab_size]
  for j in range(max_new):
    if greedy or generator is None:
      nxt = torch.argmax(last, dim=-1)[:, None]
    else:
      probs = torch.softmax(last.float(), dim=-1)
      nxt = torch.multinomial(probs, 1, generator=generator)
    nxt = nxt.to(prompt.dtype)
    out.append(nxt)
    logits, cache = step(params, nxt, cache, p + j)
    last = logits[:, -1, : model.cfg.vocab_size]
  return torch.cat(out, dim=1)
