"""``BENCHMARK.json`` and the files it names, found by name."""

from __future__ import annotations

import json
import pathlib
import re
from typing import Any, Dict, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: pathlib.Path = ROOT) -> Dict[str, Any]:
  return json.loads((root / "BENCHMARK.json").read_text())


def read_json(path: pathlib.Path) -> Dict[str, Any]:
  return json.loads(path.read_text())


def cell(name: str, manifest: Optional[Dict[str, Any]] = None,
         root: pathlib.Path = ROOT) -> Dict[str, Any]:
  """The cell ``name`` with its configuration, traffic mix and limits read
  from their files, and the metrics it reports."""
  manifest = manifest if manifest is not None else load(root)
  wl = {w["name"]: w for w in manifest["workloads"]}.get(name)
  if wl is None:
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")
  entry = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
  config = read_json(root / entry["file"])
  traffic = read_json(HERE / "traffic" / f"{wl['traffic']}.json")
  limits = read_json(HERE / "limits" / f"{name}.json")

  def mine(metric):
    return "workloads" not in metric or name in metric["workloads"]
  return {"workload": wl, "config": config, "traffic": traffic,
          "limits": limits,
          "end_to_end": [m for m in manifest["end_to_end"] if mine(m)],
          "per_layer": [m for m in manifest["per_layer"] if mine(m)]}
