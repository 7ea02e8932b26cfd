"""Checkpointing + fault tolerance, in the reference's on-disk format.

The port of :mod:`repro.train.checkpoint`; a checkpoint written by either
package restores in the other:

* **Atomic commits** — state is serialized into ``step_XXXXXXXX.tmp`` and
  renamed only after ``manifest.json`` (step, time, and each array's file,
  shape and dtype) is written; a crash mid-save can never corrupt the
  latest-valid pointer.
* **Layout** — one ``.npy`` file a leaf, named ``sha1(key)[:16]``, where the
  key joins the leaf's path (dict keys, named-tuple field names, sequence
  indices) with ``/`` (:func:`repro_torch._tree.tree_flatten_with_path`).
  numpy has no bfloat16, so a bfloat16 leaf is refused rather than written
  in another dtype.
* **Resume-from-latest** — ``latest_step()`` scans manifests; the data
  pipeline seeks to the step counter (see train.data), so a restart loses
  at most the steps since the last checkpoint.
* **Cadence** — wall-clock based (``maybe_save``), so slow hosts do not
  skew a step-based cadence.

The reference re-shards a restore onto a JAX mesh (``shardings``); the
port's LM has no mesh yet, so a restore takes a ``device``, or a tree of
devices shaped like the state.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import (tree_flatten, tree_flatten_with_path,
                               tree_unflatten)

PyTree = Any


def _to_numpy(key: str, leaf) -> np.ndarray:
  if isinstance(leaf, torch.Tensor):
    if leaf.dtype == torch.bfloat16:
      raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which numpy "
                      "cannot hold; cast it to float32 before saving")
    return leaf.detach().cpu().numpy()
  return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, state: PyTree) -> str:
  """Atomically write ``state`` under ``directory/step_{step:08d}``."""
  os.makedirs(directory, exist_ok=True)
  final = os.path.join(directory, f"step_{step:08d}")
  tmp = final + ".tmp"
  if os.path.exists(tmp):
    shutil.rmtree(tmp)
  os.makedirs(tmp)
  manifest = {"step": step, "arrays": {}, "time": time.time()}
  for key, leaf in tree_flatten_with_path(state):
    arr = _to_numpy(key, leaf)
    fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
    np.save(os.path.join(tmp, fname), arr)
    manifest["arrays"][key] = {
        "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
  with open(os.path.join(tmp, "manifest.json"), "w") as f:
    json.dump(manifest, f)
  if os.path.exists(final):
    shutil.rmtree(final)
  os.rename(tmp, final)  # the atomic commit
  return final


def latest_step(directory: str) -> Optional[int]:
  if not os.path.isdir(directory):
    return None
  steps = []
  for name in os.listdir(directory):
    if name.startswith("step_") and not name.endswith(".tmp"):
      if os.path.exists(os.path.join(directory, name, "manifest.json")):
        steps.append(int(name.split("_")[1]))
  return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: PyTree,
                       device="cuda") -> PyTree:
  """Restore into the structure of ``like``, each leaf as a tensor on
  ``device``: one device for every leaf, or a tree of devices shaped like
  ``like``."""
  path = os.path.join(directory, f"step_{step:08d}")
  with open(os.path.join(path, "manifest.json")) as f:
    manifest = json.load(f)
  keyed = tree_flatten_with_path(like)
  if isinstance(device, (dict, list, tuple)):
    devices = [resolve_device(d) for _, d in tree_flatten_with_path(device)]
  else:
    devices = [resolve_device(device)] * len(keyed)
  out = []
  for (key, _), dev in zip(keyed, devices):
    arr = np.load(os.path.join(path, manifest["arrays"][key]["file"]))
    out.append(torch.from_numpy(arr).to(dev))
  return tree_unflatten(tree_flatten(like)[1], out)


class CheckpointManager:
  """Wall-clock cadence + retention; resume helper."""

  def __init__(self, directory: str, *, interval_s: float = 600.0,
               keep: int = 3):
    self.directory = directory
    self.interval_s = interval_s
    self.keep = keep
    self._last = 0.0

  def maybe_save(self, step: int, state: PyTree, force: bool = False
                 ) -> Optional[str]:
    now = time.time()
    if not force and now - self._last < self.interval_s:
      return None
    self._last = now
    path = save_checkpoint(self.directory, step, state)
    self._gc()
    return path

  def _gc(self) -> None:
    steps = sorted(s for s in (
        int(n.split("_")[1]) for n in os.listdir(self.directory)
        if n.startswith("step_") and not n.endswith(".tmp")))
    for s in steps[:-self.keep]:
      shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                    ignore_errors=True)

  def restore_latest(self, like: PyTree, device="cuda"
                     ) -> Tuple[Optional[int], PyTree]:
    step = latest_step(self.directory)
    if step is None:
      return None, like
    return step, restore_checkpoint(self.directory, step, like, device)
