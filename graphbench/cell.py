"""One run of one cell: inputs from the seed, the port's containers, the
warm-up, the measured window, then the check and the result line.

The benchmark's inputs leave the card before the window, so that
``memory_peak_bytes`` is the port's own state and what the window
allocates; once the window has closed and the port's state is freed, they
are made again from the seed for the reference.

:func:`run` takes the device as an argument so that the tests can drive
it on the CPU at a tiny size; ``run.py`` gives it the card and refuses to
run without one.
"""

from __future__ import annotations

import gc
import importlib
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from graphbench import check, drive, gen, manifest, readers, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
  """Loaded modules whose top-level name is the JAX package's or JAX's,
  compared whole (``repro_torch`` is not ``repro``)."""
  return sorted({m.split(".")[0] for m in list(sys.modules)}
                & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def container(name: str) -> type:
  """The port's container ``name``: ``port.CONTAINERS``'s, else the
  ``Container`` of ``graphbench/containers/<name>.py``."""
  from graphbench import port as port_mod
  if name in port_mod.CONTAINERS:
    return port_mod.CONTAINERS[name]
  return importlib.import_module(f"graphbench.containers.{name}").Container


def make_port(cell: dict, data: dict, device):
  """The port's container that the configuration names, over its inputs."""
  config = cell["config"]
  return container(config["container"])(config, data, device)


def run(name: str, seed: int, seconds: float, trace_on: bool, *,
        device="cuda", t0: Optional[float] = None,
        cell: Optional[dict] = None, control: bool = False,
        port_factory: Callable = make_port) -> Tuple[Dict, List[str]]:
  """The result line and the notes for standard error (the compared
  numbers last).  With ``control`` the reference in a lower precision
  answers in the program's place (the control of the comparison)."""
  t0 = time.perf_counter() if t0 is None else t0
  device = torch.device(device)
  cell = cell if cell is not None else manifest.cell(name)
  marks = [("imports", time.perf_counter())]
  data = gen.make(cell["config"], seed, device)
  _sync(device)
  marks.append(("inputs", time.perf_counter()))
  port = port_factory(cell, data, device)
  driver = drive.make(cell, data, port, seed, device)
  del port
  _sync(device)
  marks.append(("containers", time.perf_counter()))
  driver.warm_up()
  driver.drop_inputs()
  del data
  _sync(device)
  marks.append(("warm-up", time.perf_counter()))
  gc.collect()
  if device.type == "cuda":
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
  setup_s = time.perf_counter() - t0

  window = trace.Window(trace_on, device)
  rec = driver.window(seconds, window)
  peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
          else 0)
  attempted, failed = driver.work_done(rec)
  driver.free()
  gc.collect()
  if device.type == "cuda":
    torch.cuda.empty_cache()

  t_check = time.perf_counter()
  driver.rebind(gen.make(cell["config"], seed, device))
  checks = driver.check(rec, cell["limits"], control=control)
  check_s = time.perf_counter() - t_check
  if trace_on:
    seen, expected = trace.lost_events(window.summary, rec["ell_kernels"],
                                       readers.ELL_KERNELS)
    inputs = {"summary": window.summary, "window_s": rec["seconds"],
              **driver.layer_inputs(rec)}
    values = readers.read_all([m["name"] for m in cell["per_layer"]], inputs)
    units = {m["name"]: m["unit"] for m in cell["per_layer"]}
  else:
    values = {"setup_s": setup_s, **driver.metrics(rec)}
    units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
  metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()
             if k in units}
  dev = {"platform": "gpu" if device.type == "cuda" else device.type,
         "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                  else "cpu"),
         "count": 1, "memory_peak_bytes": int(peak)}
  line = {"correct": check.passed(checks), "attempted": int(attempted),
          "failed": int(failed), "metrics": metrics, "device": dev}
  split = ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                    for a, b in zip([("", t0)] + marks, marks))
  notes = [f"setup split (s): {split}",
           f"setup_s {setup_s:.3f}; window {rec['seconds']:.3f} s; "
           f"check {check_s:.3f} s; attempted {attempted}, failed {failed}"]
  if trace_on:
    s = window.summary
    dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
    line["breakdown"] = trace.breakdown(s)
    notes.append(f"traced: {s['device_ops']} device operations, busy "
                 f"{s['busy_s']:.6f} of {s['window_s']:.6f} s; ELL kernels "
                 f"seen {seen} of {expected} launched")
  line["checks"] = checks
  notes += [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
            for k, c in checks.items()]
  return line, notes
