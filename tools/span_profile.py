#!/usr/bin/env python3
"""Run one benchmark cell traced, as ``graphbench/run.py --trace 1`` does,
and print the port's spans in its window.

    python3 tools/span_profile.py --workload graph500-s20.sssp --seed 7 \\
        --seconds 20

The run is ``graphbench.cell.run``'s own, with three additions in this
process alone: the profiler session records every thread (a served cell's
driver thread included; ``--all-threads 0`` records only the thread that
starts it, as the benchmark's window does); the window's events are also
reduced by ``graphbench.spans.reduce``; and a served cell's counters also
sum the servers' ``queue.wait_ms`` and ``query.in_slot_ms``, diffed across
the window as the others are.  Prints the cell's result line, then one JSON
line: the card's name and power limit, the window's units (supersteps or
sweeps), the span metrics a unit (``graphbench.spans.metrics``), the means
of the two histograms, the sums that must meet (every device second
credited once; idle inside spans within the window's idle), and the
reduction itself.
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import subprocess
import sys
from typing import Dict, Tuple

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HISTOGRAMS = ("queue.wait_ms", "query.in_slot_ms")


def card() -> str:
  try:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
  except (OSError, subprocess.SubprocessError):
    return "cpu"


def run(name: str, seed: int, seconds: float, *, all_threads: bool = True,
        device="cuda", cell=None) -> Tuple[Dict, Dict]:
  """The cell's traced result line and its spans' line."""
  import torch
  from torch._C._profiler import _ExperimentalConfig

  from graphbench import cell as cell_mod
  from graphbench import drive, readers, spans, trace

  seen: Dict = {}
  real = (torch.profiler.profile, trace.summarize, readers.read_all,
          drive.Served.counters)

  def summarize(events, window=None):
    events = list(events)
    seen["spans"] = spans.reduce(events, window)
    return real[1](events, window)

  def read_all(names, rec):
    seen["rec"] = rec
    return real[2](names, rec)

  def counters(self):
    out = real[3](self)
    for h in HISTOGRAMS:
      out[h + ".count"] = out[h + ".sum"] = 0.0
      for server in self.servers:
        got = server.counters.snapshot()["histograms"].get(h, {})
        out[h + ".count"] += got.get("count", 0)
        out[h + ".sum"] += got.get("sum", 0.0)
    return out

  torch.profiler.profile = functools.partial(
      real[0], experimental_config=_ExperimentalConfig(
          profile_all_threads=all_threads))
  trace.summarize, readers.read_all = summarize, read_all
  drive.Served.counters = counters
  try:
    line, _ = cell_mod.run(name, seed, seconds, True, device=device,
                           cell=cell)
  finally:
    (torch.profiler.profile, trace.summarize, readers.read_all,
     drive.Served.counters) = real

  rec, sp = seen["rec"], seen["spans"]
  s = rec["summary"]
  device_s = sum(s["kernel_s"].values())
  out = {"workload": name, "seed": seed, "card": card(),
         "all_threads": int(all_threads), "units": rec["units"],
         **spans.metrics(sp, rec["units"])}
  for h in HISTOGRAMS:
    count = rec.get("counters", {}).get(h + ".count")
    if count:
      out[h + ".mean"] = rec["counters"][h + ".sum"] / count
  out.update(
      window_s=s["window_s"], device_s=device_s,
      idle_s=s["window_s"] - s["busy_s"],
      span_device_sum_s=sum(sp["span_device_s"].values()),
      idle_by_span_sum_s=sum(sp["idle_s_by_span"].values()),
      unlinked_share=(sp["span_device_s"].get(spans.UNLINKED, 0.0) / device_s
                      if device_s else None),
      **sp)
  return line, out


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, default=20.0)
  ap.add_argument("--all-threads", type=int, choices=(0, 1), default=1,
                  help="0: record only the thread that starts the session, "
                  "as the benchmark's traced window does")
  args = ap.parse_args(argv)
  line, out = run(args.workload, args.seed, args.seconds,
                  all_threads=bool(args.all_threads))
  print(json.dumps(line), flush=True)
  print(json.dumps(out), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
