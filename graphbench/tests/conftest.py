"""Puts the checkout's root and ``src/`` on ``sys.path`` for the benchmark's
own tests (``python -m pytest graphbench/tests`` from the root)."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
  if str(p) not in sys.path:
    sys.path.insert(0, str(p))
