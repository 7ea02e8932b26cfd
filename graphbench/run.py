"""Run one cell of the benchmark on the card and print its result line.

    python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Exits with a code other than 0, printing no
result, where no card is present (there is no CPU fallback), where the
port cannot be imported, or where JAX or the JAX package was loaded.  The
port's kernels are built with ``nvcc`` into ``build/`` in the checkout at
a cell's first run there and found by the runs after it; any other build
cache is kept there too.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)

  import torch
  from graphbench import cell as cell_mod
  from graphbench import manifest

  cell = manifest.cell(args.workload)
  chips = int(cell["workload"]["chips"])
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    print(f"graphbench: {args.workload} needs {chips} CUDA card(s); "
          f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
          file=sys.stderr)
    return 3
  from graphbench import port  # noqa: F401 — the system under test, or fail
  line, notes = cell_mod.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda", t0=T0,
                             cell=cell)
  found = cell_mod.forbidden_modules()
  if found:
    print(f"graphbench: the process loaded {found}; no result",
          file=sys.stderr)
    return 4
  for note in notes:
    print(note, file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(line), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
