"""BENCHMARK.json against the contract's rules, and every file it names."""

import json
import pathlib

import pytest

from graphbench import manifest, readers

ROOT = pathlib.Path(__file__).resolve().parents[2]
M = manifest.load(ROOT)
TEXT = "[\\s\\S]"


def test_top_level_keys():
  assert set(M) == {"command", "paths", "run_seconds", "configs",
                    "workloads", "end_to_end", "per_layer"}
  assert M["paths"] == ["graphbench"]
  assert M["command"][1] == "graphbench/run.py"
  assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
  assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names(kind):
  names = [e["name"] for e in M[kind]]
  assert len(names) == len(set(names))
  for name in names:
    assert manifest.NAME.match(name), name


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
  assert manifest.UNIT.match(metric["unit"])
  assert metric["better"] in ("lower", "higher")
  allowed = {"name", "unit", "better", "source", "workloads"}
  if metric in M["end_to_end"]:
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric) <= allowed | {"bound"}
  else:
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert set(metric) <= allowed | {"layer", "moves"}
    assert hasattr(readers.load(metric["name"]), "read")
    moved = {m["name"]: m for m in M["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
      assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("wl", M["workloads"], ids=lambda w: w["name"])
def test_cell_files(wl):
  assert wl["chips"] == 1
  assert 1 <= len(wl["why"]) <= 200
  cell = manifest.cell(wl["name"], M, ROOT)
  e2e = {m["name"] for m in cell["end_to_end"]}
  assert "setup_s" in e2e and len(e2e) >= 2
  assert cell["per_layer"]
  assert cell["traffic"]["kind"] in ("closed_loop", "back_to_back")


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_files(config):
  body = json.loads((ROOT / config["file"]).read_text())
  assert body["name"] == config["name"]
  assert body["source"] == config["source"]
  assert sorted(body["reduced"]) == sorted(config["reduced"])
  assert len(config["source"]) <= 200 and len(config["why"]) <= 200
  assert config["file"].startswith("graphbench/")
