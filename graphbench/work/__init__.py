"""The kinds of work that traffic mixes drive, one module each, found by the
name a mix gives (``"work": "sssp"``, or ``"serve": [{"work": "bfs", ...}]``):
``graphbench/work/<name>.py`` defines a class ``Work``.

A ``Work`` runs its kind of work on the port and judges what came out;
:mod:`graphbench.drive` decides when work arrives and how long it runs.

* Back to back (``drive.BackToBack``): ``warm_up()``; a job is
  ``steps_per_job`` steps, ``state = start(job)`` and ``state =
  step(state)`` on the port, ``output(state)`` what is checked;
  ``metrics(rec)``, ``layer_inputs(rec, picked)`` and ``check(picked,
  limits, control)`` once the window has closed.
* Served (``drive.ClosedLoop``, ``drive.OpenLoop``): ``family`` names the
  port's query family; ``check_answers(sources, answers, limits,
  control)``.

With ``control`` the plain reference, one precision below the
configuration's, answers in the program's place (the control of the
comparison).  ``data`` is ``None`` while the window runs (the benchmark's
inputs are off the card then); whatever the window needs is taken from it
at construction.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def rng(seed: int, stream: int = 0) -> np.random.Generator:
  """The seed's draws, one stream per use (the same at each call)."""
  return np.random.default_rng((int(seed) % (1 << 63), stream))


def sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


class Work:
  """What every kind of work holds: the cell's parameters, the inputs, the
  port, the seed."""

  steps_per_job = 1
  family = None

  def __init__(self, cell: dict, data: dict, port, seed: int, device):
    self.config = cell["config"]
    self.traffic = cell["traffic"]
    self.plan = self.traffic.get("plan")
    self.data = data
    self.port = port
    self.seed = int(seed)
    self.device = torch.device(device)


def load(name: str, cell: dict, data: dict, port, seed: int, device) -> Work:
  module = importlib.import_module(f"graphbench.work.{name}")
  return module.Work(cell, data, port, seed, device)
