"""Traffic mixes that no cell runs yet, each given as parameters alone (no
code), run whole on the CPU at a tiny size: the generator serves BFS, both
BFS and SSSP through one driver, open-loop arrivals, repeated sources,
other slot counts and another plan, and judges each (a sound run is
correct, the control is not).  The inputs are off the card while the
window runs."""

import pytest

from graphbench import cell as cell_mod
from graphbench import drive
from graphbench.tests.test_graphbench_faults import SECONDS, SEED, small

SERVE = "graph500-s20.serve-sssp"
EXACT = {"reach_mismatch": 0, "dist_gap": 0}

MIXES = {
    "serve-bfs": ({"serve": [{"work": "bfs", "share": 1}]},
                  {**EXACT, "missing": 0}),
    "serve-bfs-sssp": ({"serve": [{"work": "bfs", "share": 1},
                                  {"work": "sssp", "share": 1}]},
                       {**{"bfs." + k: v for k, v in EXACT.items()},
                        **{"sssp." + k: v for k, v in EXACT.items()},
                        "missing": 0}),
    "open-loop": ({"kind": "open_loop", "rate_per_s": 200},
                  {**EXACT, "missing": 0}),
    "zipf-sources": ({"sources": {"zipf": 1.2, "pool": 16}},
                     {**EXACT, "missing": 0}),
    "slots-32": ({"num_slots": 32}, {**EXACT, "missing": 0}),
    "auto-plan": ({"plan": "auto"}, {**EXACT, "missing": 0}),
    "bfs": ({"kind": "back_to_back", "work": "bfs", "search_keys": 64,
             "warmup_runs": 2, "check_runs": 4}, EXACT),
}


def mix_cell(name):
  traffic, limits = MIXES[name]
  c = small(SERVE)
  c["traffic"] = {**c["traffic"], **traffic}
  c["limits"] = dict(limits)
  return c


@pytest.mark.parametrize("name", sorted(MIXES))
def test_mix_sound_run_is_correct(name):
  line, _ = cell_mod.run(SERVE, SEED, SECONDS, False, device="cpu",
                         cell=mix_cell(name))
  assert line["correct"], line["checks"]
  assert line["attempted"] > 0 and line["failed"] == 0
  assert set(line["checks"]) == set(MIXES[name][1])


@pytest.mark.parametrize("name", sorted(MIXES))
def test_mix_control_is_not_correct(name):
  line, _ = cell_mod.run(SERVE, SEED, SECONDS, False, device="cpu",
                         cell=mix_cell(name), control=True)
  assert not line["correct"]


def test_both_kinds_are_served(monkeypatch):
  seen = {}
  real = drive.Served.check

  def spy(self, rec, limits, control=False):
    seen["kinds"] = {q["kind"] for q in rec["queries"]}
    return real(self, rec, limits, control)
  monkeypatch.setattr(drive.Served, "check", spy)
  cell_mod.run(SERVE, SEED, SECONDS, False, device="cpu",
               cell=mix_cell("serve-bfs-sssp"))
  assert seen["kinds"] == {0, 1}


@pytest.mark.parametrize("name", ["graph500-s20.serve-sssp",
                                  "graph500-s20.sssp", "netflix-cf.sweeps"])
def test_inputs_are_off_the_card_in_the_window(name, monkeypatch):
  """The window sees no benchmark input: the memory peak is the port's."""
  held = []
  for cls in (drive.ClosedLoop, drive.BackToBack):
    real = cls.window

    def window(self, seconds, tracer, _real=real):
      held.append([self.data] + [w.data for w in self.works])
      return _real(self, seconds, tracer)
    monkeypatch.setattr(cls, "window", window)
  line, _ = cell_mod.run(name, SEED, SECONDS, False, device="cpu",
                         cell=small(name))
  assert line["correct"]
  assert held and all(d is None for d in held[0])
