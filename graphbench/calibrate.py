"""Readings for the correctness limits, on the card, in one process.

    python3 graphbench/calibrate.py --config graph500-s20 --seeds 1,2,3 \
        --seconds 3 --controls 3

For each seed, makes the configuration's inputs once and runs every cell
of the configuration through a short window at the cell's own load, then
prints the numbers its check compares: the program's (``side:
program``), and for the first ``--controls`` seeds the control's
(``side: control``: the reference one precision below in the program's
place, on the same sample).  A limit is set between the largest program
reading and the smallest control reading (PERF.md gives both).  One JSON
line a reading, on standard output.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--config", required=True)
  ap.add_argument("--seeds", required=True)
  ap.add_argument("--seconds", type=float, default=3.0)
  ap.add_argument("--controls", type=int, default=3)
  ap.add_argument("--device", default="cuda")
  ap.add_argument("--only", default="", help="cells to run, comma separated")
  args = ap.parse_args(argv)

  import torch
  from graphbench import cell as cell_mod
  from graphbench import drive, gen, manifest
  from graphbench.trace import Window

  device = torch.device(args.device)
  if device.type == "cuda" and not torch.cuda.is_available():
    print("calibrate: no CUDA card", file=sys.stderr)
    return 3
  wanted = [w["name"] for w in manifest.load()["workloads"]
            if w["config"] == args.config]
  if args.only:
    wanted = [w for w in wanted if w in args.only.split(",")]
  cells = [manifest.cell(w) for w in wanted]
  for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
    t0 = time.perf_counter()
    data = gen.make(cells[0]["config"], seed, device)
    port = cell_mod.make_port(cells[0], data, device)
    setup = time.perf_counter() - t0
    for c in cells:
      driver = drive.make(c, data, port, seed, device)
      driver.warm_up()
      rec = driver.window(args.seconds, Window(False, device))
      attempted, failed = driver.work_done(rec)
      sides = [("program", False)]
      if k < args.controls:
        sides.append(("control", True))
      for side, control in sides:
        t1 = time.perf_counter()
        checks = driver.check(rec, c["limits"], control=control)
        print(json.dumps({
            "cell": c["workload"]["name"], "seed": seed, "side": side,
            "attempted": attempted, "failed": failed,
            "correct": cell_mod.check.passed(checks),
            "readings": {n: v["value"] for n, v in checks.items()},
            "check_s": time.perf_counter() - t1, "setup_s": setup}),
            flush=True)
      driver.free()
    del port, data
    if device.type == "cuda":
      torch.cuda.empty_cache()
  return 0


if __name__ == "__main__":
  sys.exit(main())
