"""Whole runs on the CPU at a tiny size, past the look for a card: a sound
run is correct, and the control (the reference in bfloat16 in the
program's place) and every fault a cell can have are not.

The faults, planted in the port underneath the timed path: a superstep
that returns its state unchanged; half of the batch left out with the
mean taken over the rest (the server's slots; CF's ratings); an answer
altered where it is produced (a triangle count too).  No cell spans chips,
so none can lose an exchange between them; PageRank, a single traversal
and a triangle count have no batch.
"""

import subprocess
import sys

import pytest
import torch

from graphbench import cell as cell_mod
from graphbench import manifest
from graphbench.tests.conftest import ROOT

# Triangle counting at scale 12: the float16 control needs a vertex with
# more than 2,048 triangles to round.
SMALL = {"graph500-s20": {"scale": 9},
         "netflix-cf": {"users": 1500, "items": 200, "ratings": 24000},
         "gap-kron-s16": {"scale": 12}}
# CF jobs of one sweep, so that a window on however loaded a CPU finishes
# one (it ends at the first sweep's end after its seconds).
SMALL_TRAFFIC = {"sweeps": 1}
CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2**31 + 4321
SECONDS = 0.3


def small(name):
  c = manifest.cell(name)
  c["config"].update(SMALL[c["config"]["name"]])
  c["traffic"] = {**c["traffic"], "answer_wait_s": 5,
                  **{k: v for k, v in SMALL_TRAFFIC.items()
                     if k in c["traffic"]}}
  return c


def run(name, cell=None, **kw):
  line, notes = cell_mod.run(name, SEED, SECONDS, False, device="cpu",
                             cell=cell or small(name), **kw)
  return line


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
  line = run(name)
  assert line["correct"], line["checks"]
  assert line["attempted"] > 0 and line["failed"] == 0
  assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
  assert not run(name, control=True)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_unchanged_step_is_not_correct(name, monkeypatch):
  from repro_torch.core import engine

  def unchanged(graph, program, state, plan):
    return state._replace(active=torch.zeros_like(state.active),
                          iteration=state.iteration + 1,
                          num_active=torch.zeros_like(state.num_active))

  def unchanged_batched(graph, program, state, plan):
    return state._replace(active=torch.zeros_like(state.active),
                          done=torch.ones_like(state.done),
                          iteration=state.iteration + 1,
                          num_active=torch.zeros_like(state.num_active),
                          iters=state.iters + 1)
  monkeypatch.setattr(engine, "_superstep", unchanged)
  monkeypatch.setattr(engine, "_batched_superstep", unchanged_batched)
  assert not run(name)["correct"]


def test_half_the_slots_is_not_correct(monkeypatch):
  from repro_torch.core import engine
  real = engine._batched_superstep

  def half(graph, program, state, plan):
    q = state.active.shape[1]
    active = state.active.clone()
    active[:, q // 2:] = False
    return real(graph, program, state._replace(active=active), plan)
  monkeypatch.setattr(engine, "_batched_superstep", half)
  assert not run("graph500-s20.serve-sssp")["correct"]


def test_half_the_ratings_is_not_correct():
  name = "netflix-cf.sweeps"
  c = small(name)
  c["config"]["program"] = {**c["config"]["program"], "process_message":
                            "2 * ((e - (m * d).sum(-1, keepdim=True)) * m)"}

  def half_port(cell, data, device):
    half = dict(data)
    keep = torch.arange(data["rating"].numel()) % 2 == 0
    for k in ("user", "item", "rating"):
      half[k] = data[k][keep]
    return cell_mod.make_port(cell, half, device)
  assert not run(name, cell=c, port_factory=half_port)["correct"]


def _alter(t):
  t = t.clone() if isinstance(t, torch.Tensor) else torch.as_tensor(t).clone()
  flat = t.view(-1)
  k = int(torch.nonzero(torch.isfinite(flat) & (flat > 0))[0])
  flat[k] = flat[k] * 1.001 + 0.001
  return t


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(name, monkeypatch):
  from graphbench import port
  from repro_torch.service import SsspFamily
  real_extract = SsspFamily.extract
  monkeypatch.setattr(SsspFamily, "extract",
                      lambda self, col: _alter(real_extract(self, col)).numpy())
  for cls, meth in ((port.GraphPort, "sssp"), (port.GraphPort, "pagerank"),
                    (port.RatingsPort, "sweep"),
                    (cell_mod.container("triangles"), "count")):
    real = getattr(cls, meth)
    monkeypatch.setattr(cls, meth, lambda self, *a, _r=real, **kw: _alter(
        _r(self, *a, **kw)))
  assert not run(name)["correct"]


def test_no_card_no_result():
  """On a machine with no card, run.py exits non-zero and prints nothing
  to standard output."""
  if torch.cuda.is_available():
    pytest.skip("a card is present")
  proc = subprocess.run(
      [sys.executable, "graphbench/run.py", "--workload", CELLS[0],
       "--seed", "1", "--seconds", "1", "--trace", "0"],
      cwd=ROOT, capture_output=True, text=True, timeout=120)
  assert proc.returncode != 0 and proc.stdout == ""


def test_without_the_port_no_result(tmp_path):
  """In a directory that holds only BENCHMARK.json and graphbench/, a run
  exits non-zero and prints no result."""
  import shutil
  shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
  shutil.copytree(ROOT / "graphbench", tmp_path / "graphbench",
                  ignore=shutil.ignore_patterns("__pycache__"))
  proc = subprocess.run(
      [sys.executable, "-c",
       "import sys, runpy; sys.argv = ['graphbench/run.py', '--workload', "
       f"'{CELLS[0]}', '--seed', '1', '--seconds', '1', '--trace', '0']; "
       "import torch; torch.cuda.is_available = lambda: True; "
       "torch.cuda.device_count = lambda: 1; "
       "runpy.run_path('graphbench/run.py', run_name='__main__')"],
      cwd=tmp_path, capture_output=True, text=True, timeout=120)
  assert proc.returncode != 0 and proc.stdout == ""
  assert "repro_torch" in proc.stderr


@pytest.mark.parametrize("name", CELLS)
def test_traced_line(name):
  line, notes = cell_mod.run(name, SEED, SECONDS, True, device="cpu",
                             cell=small(name))
  assert line["correct"]
  assert set(line) == {"correct", "attempted", "failed", "metrics", "device",
                       "breakdown", "checks"}
  per_layer = {m["name"] for m in manifest.cell(name)["per_layer"]}
  assert set(line["metrics"]) <= per_layer
  assert line["device"]["window_s"] > 0
  assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
  assert notes[-1].startswith("check ")
