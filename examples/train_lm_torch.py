"""End-to-end driver on the PyTorch port: train a ~100M-param dense LM for
a few hundred steps.

The port's counterpart of ``examples/train_lm.py``: config → model → data
pipeline → train step → wall-clock checkpointing → resume, through
``repro_torch.launch.train``, on the card unless ``--device cpu`` is given.
The model is the same ~100M member of the granite family, registered as a
transient config under ``repro_torch.configs``.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]
"""

import argparse
import dataclasses
import sys
import types

from repro_torch.configs import granite_3_2b
from repro_torch.launch import train as train_driver


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--steps", type=int, default=300)
  ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args()

  # ~100M-param member of the granite family: 8 layers, d_model 768.
  cfg = dataclasses.replace(
      granite_3_2b.CONFIG, num_layers=8, d_model=768, num_heads=12,
      num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
      dtype="float32", remat="none")
  # register as a transient config
  mod = types.ModuleType("repro_torch.configs.train_lm_100m")
  mod.CONFIG = cfg
  sys.modules["repro_torch.configs.train_lm_100m"] = mod

  train_driver.main([
      "--arch", "train_lm_100m", "--steps", str(args.steps),
      "--batch", "8", "--seq", "128", "--ckpt-dir", args.ckpt_dir,
      "--log-every", "20", "--device", args.device,
  ])


if __name__ == "__main__":
  main()
