"""End-to-end training driver (the port of :mod:`repro.launch.train`).

config → model → synthetic data pipeline → train step → checkpoint/restore
(fault tolerance: kill and rerun with the same --ckpt-dir; training resumes
at the last committed step, the data pipeline seeks forward
deterministically).  Runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --smoke --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.models.common import init_params
from repro_torch.models.transformer import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticTokenPipeline
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.steps import make_train_step


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", required=True)
  ap.add_argument("--smoke", action="store_true",
                  help="reduced config (CPU-runnable)")
  ap.add_argument("--steps", type=int, default=100)
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--seq", type=int, default=64)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--ckpt-dir", default=None)
  ap.add_argument("--ckpt-every-s", type=float, default=60.0)
  ap.add_argument("--log-every", type=int, default=10)
  ap.add_argument("--device", default="cuda",
                  help="torch device to train on (cpu only when asked)")
  return ap.parse_args(argv)


def train(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
  """Run the driver; returns the final ``params`` and ``opt`` state, the
  step it started from (``start``) and each step's loss (``losses``)."""
  args = parse_args(argv)
  dev = resolve_device(args.device)
  cfg = (C.get_smoke_config(args.arch) if args.smoke
         else C.get_config(args.arch))
  model = build_model(cfg)
  step_fn = make_train_step(model)

  gen = torch.Generator(device=dev).manual_seed(args.seed)
  params = init_params(model.defs(), gen, device=dev)
  opt = adamw_init(params)
  n_params = sum(p.numel() for p in tree_leaves(params))
  print(f"arch={cfg.name} family={cfg.family} params={n_params/1e6:.1f}M")

  start = 0
  mgr = None
  if args.ckpt_dir:
    mgr = CheckpointManager(args.ckpt_dir, interval_s=args.ckpt_every_s)
    restored_step, state = mgr.restore_latest({"params": params, "opt": opt},
                                              device=dev)
    if restored_step is not None:
      params, opt = state["params"], state["opt"]
      start = restored_step
      print(f"resumed from step {start}")

  pipe = SyntheticTokenPipeline(cfg, args.batch, args.seq, seed=args.seed,
                                device=dev)
  pipe.seek(start)
  t0 = time.time()
  losses = []
  for step in range(start, args.steps):
    batch = next(pipe)
    params, opt, metrics = step_fn(params, opt, batch)
    losses.append(float(metrics["loss"]))
    if step % args.log_every == 0 or step == args.steps - 1:
      dt = time.time() - t0
      print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
            f"lr {float(metrics['lr']):.2e} "
            f"gnorm {float(metrics['grad_norm']):.3f} "
            f"({dt:.1f}s)", flush=True)
    if mgr is not None:
      mgr.maybe_save(step + 1, {"params": params, "opt": opt})
  if mgr is not None:
    mgr.maybe_save(args.steps, {"params": params, "opt": opt}, force=True)
  if len(losses) > 10:
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
  return {"params": params, "opt": opt, "start": start, "losses": losses}


def main(argv: Optional[Sequence[str]] = None) -> int:
  train(argv)
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
