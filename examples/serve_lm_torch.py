"""Serve a small model with batched requests on the PyTorch port: prefill +
batched decode.

The port's counterpart of ``examples/serve_lm.py``: the reference's
Mixtral smoke config at its example widths, random weights from a seeded
``torch.Generator``, 4 requests × 24 new tokens sampled through
``repro_torch.serve.generate``, on the card unless ``--device cpu`` is
given.  The port's draws are not ``jax.random``'s, so the weights, prompts
and samples differ from the reference's; :func:`serve` takes ``params`` and
``prompt`` to run given ones, and ``greedy=True`` to match the reference
token for token.

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""

import argparse
import time

import torch

from repro_torch import configs as C
from repro_torch._device import resolve_device
from repro_torch.models.common import init_params
from repro_torch.models.transformer import build_model
from repro_torch.serve import generate


def example_config():
  """The reference example's model: Mixtral's smoke config, 4 layers,
  d_model 128, 4 experts top-2."""
  return C.get_smoke_config("mixtral_8x7b").scaled(
      num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
      vocab_size=1024, num_experts=4, top_k=2, moe_d_ff=256)


def serve(cfg=None, device="cuda", batch: int = 4, prompt_len: int = 8,
          max_new: int = 24, greedy: bool = False, params=None,
          prompt=None) -> dict:
  """Generate ``max_new`` tokens for ``batch`` prompts.  Weights come from
  ``torch.Generator`` seed 0 unless ``params`` is given, prompts from seed
  1 unless ``prompt`` is given, samples from seed 2 (the reference's
  ``PRNGKey`` 0, 1 and 2).  Returns the tokens ``[batch, prompt_len + max_new]``, the
  seconds (host clock, ending in a copy of the tokens to the host) and the
  model and weights it ran."""
  cfg = cfg or example_config()
  dev = resolve_device(device)
  model = build_model(cfg, tp=1)
  if params is None:
    params = init_params(model.defs(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
  if prompt is None:
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev, dtype=torch.int32)
  t0 = time.perf_counter()
  out = generate(model, params, prompt, max_new=max_new, greedy=greedy,
                 generator=torch.Generator(device=dev).manual_seed(2))
  tokens = out.cpu()
  seconds = time.perf_counter() - t0
  return {"tokens": tokens, "seconds": seconds, "model": model,
          "params": params, "prompt": prompt}


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)
  device = resolve_device(args.device)
  where = (torch.cuda.get_device_name(device) if device.type == "cuda"
           else "the host")

  batch, new = 4, 24
  out = serve(device=device, batch=batch, max_new=new)
  dt = out["seconds"]
  toks = batch * new
  print(f"served {batch} requests × {new} new tokens in {dt:.1f}s "
        f"({toks/dt:.1f} tok/s on {where}, MoE top-2 routing live)")
  print("continuations:")
  for row in out["tokens"].numpy():
    print("  ", row.tolist())
  return out


if __name__ == "__main__":
  main()
