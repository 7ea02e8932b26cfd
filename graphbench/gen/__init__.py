"""The benchmark's inputs, made on the device from ``--seed``: each
configuration's ``generator`` names a module here with a
``make(config, shape, gen, device)``.

``shape`` is seeded with the configuration's ``shape_seed`` and draws what
sets the amount of work (the Kronecker graph's edges, the rating pairs);
``gen`` is seeded with ``--seed`` and draws the rest (vertex labels, the
order of the edge tuples, weights, ratings, roots).  So every seed gives
the same sizes (degrees, spill, components) in another order, and a
seed's runs differ from another's by noise, not by work."""

from __future__ import annotations

import importlib

import torch


def generator(seed: int, device) -> torch.Generator:
  """A generator on ``device`` seeded with ``seed`` (any whole number up to
  2**63)."""
  gen = torch.Generator(device=device)
  gen.manual_seed(int(seed) % (1 << 63))
  return gen


def make(config: dict, seed: int, device) -> dict:
  module = importlib.import_module(f"graphbench.gen.{config['generator']}")
  return module.make(config, generator(config["shape_seed"], device),
                     generator(seed, device), device)
