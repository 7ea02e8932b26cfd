"""GAP's betweenness centrality cell (``gap-kron-s20.bc``) run whole on the
CPU at a tiny size: a sound run is correct; the control (the reference
with float32 path counts and bfloat16 dependencies) and each fault the
cell can have are not: a superstep that returns its state unchanged, half
the lanes left out, a backward level dropped, one path count off by one,
path counts kept in float32, one score altered.  Its container is found by
name, its traced line carries its readers, and its readers and bytes on a
synthetic record."""

import pytest
import torch

from graphbench import cell as cell_mod
from graphbench import manifest, port, readers
from graphbench.containers import betweenness
from graphbench.work import bc as work_bc

BC = "gap-kron-s20.bc"
SEED = 2**31 + 4321
SECONDS = 0.3


def small():
  c = manifest.cell(BC)
  c["config"]["scale"] = 9
  return c


def run(**kw):
  line, _ = cell_mod.run(BC, SEED, SECONDS, False, device="cpu",
                         cell=small(), **kw)
  return line


def test_sound_run_is_correct():
  line = run()
  assert line["correct"], line["checks"]
  assert line["attempted"] > 0 and line["failed"] == 0
  assert set(line["checks"]) == {"depth_mismatch", "count_gap",
                                 "count_dtype", "score_gap"}
  assert set(line["metrics"]) == {"setup_s", "gteps"}


def test_control_is_not_correct():
  line = run(control=True)
  assert not line["correct"]
  assert line["checks"]["score_gap"]["value"] > line["checks"]["score_gap"][
      "limit"]
  assert line["checks"]["count_dtype"]["value"] > 0


def test_unchanged_step_is_not_correct(monkeypatch):
  from repro_torch.core import engine

  def unchanged(graph, program, state, plan):
    return state._replace(active=torch.zeros_like(state.active),
                          done=torch.ones_like(state.done),
                          iteration=state.iteration + 1,
                          num_active=torch.zeros_like(state.num_active),
                          iters=state.iters + 1)
  monkeypatch.setattr(engine, "_batched_superstep", unchanged)
  assert not run()["correct"]


def test_half_the_lanes_is_not_correct(monkeypatch):
  """Every superstep, forward and backward, leaves the upper half of the
  trial's lanes out."""
  from repro_torch.core import engine
  real = engine._batched_superstep

  def half(graph, program, state, plan):
    q = state.active.shape[1]
    active = state.active.clone()
    active[:, q // 2:] = False
    return real(graph, program, state._replace(active=active), plan)
  monkeypatch.setattr(engine, "_batched_superstep", half)
  line = run()
  assert not line["correct"]
  assert line["checks"]["depth_mismatch"]["value"] > 0


def test_dropped_level_is_not_correct(monkeypatch):
  """The backward sweep starts one level above the deepest."""
  from repro_torch.algos import bc
  real = bc.run_level_sweep
  monkeypatch.setattr(bc, "run_level_sweep",
                      lambda g, p, prop, depth, deepest, **kw: real(
                          g, p, prop, depth, deepest - 1, **kw))
  line = run()
  assert not line["correct"]
  assert line["checks"]["depth_mismatch"]["value"] == 0
  assert line["checks"]["count_gap"]["value"] == 0


def _altered(monkeypatch, key, alter):
  real = betweenness.Container.trial

  def trial(self, sources):
    out = real(self, sources)
    return {**out, key: alter(out[key].clone())}
  monkeypatch.setattr(betweenness.Container, "trial", trial)


def test_count_off_by_one_is_not_correct(monkeypatch):
  def plus_one(sigma):
    k = int(torch.nonzero(sigma.view(-1) > 1)[0])
    sigma.view(-1)[k] += 1
    return sigma
  _altered(monkeypatch, "sigma", plus_one)
  line = run()
  assert not line["correct"]
  assert line["checks"]["count_gap"]["value"] == 1.0


def test_float32_counts_are_not_correct(monkeypatch):
  """Path counts kept in float32 hold every count of this graph exactly
  (none reaches 2**24): only ``count_dtype`` sees them."""
  _altered(monkeypatch, "sigma", lambda sigma: sigma.float())
  line = run()
  assert not line["correct"]
  assert line["checks"]["count_dtype"]["value"] > 0
  assert line["checks"]["count_gap"]["value"] == 0
  assert line["checks"]["depth_mismatch"]["value"] == 0


def test_float32_counts_reference_reading():
  """The reference with float32 path counts alone (float64 dependencies),
  as the control's reading beside the full control: on this graph it
  matches the float64 reference in every depth, count and score."""
  from graphbench import gen
  from graphbench.reference import bc as ref_bc
  c = small()
  data = gen.make(c["config"], SEED, torch.device("cpu"))
  src = data["keys"][:4]
  d, s, dl = ref_bc.brandes(data["edges"], data["n"], src)
  d32, s32, dl32 = ref_bc.brandes(data["edges"], data["n"], src,
                                  counts_in=torch.float32)
  assert s32.dtype == torch.float32 and float(s.max()) < 2**24
  assert torch.equal(d32, d) and torch.equal(s32.double(), s)
  assert torch.equal(ref_bc.scores(dl32), ref_bc.scores(dl))


def test_altered_score_is_not_correct(monkeypatch):
  def nudge(scores):
    k = int(torch.nonzero(scores > 0)[0])
    scores[k] = scores[k] * 1.001 + 0.001
    return scores
  _altered(monkeypatch, "scores", nudge)
  line = run()
  assert not line["correct"]
  assert line["checks"]["depth_mismatch"]["value"] == 0
  assert line["checks"]["count_gap"]["value"] == 0


def test_container_by_name():
  assert cell_mod.container("betweenness") is betweenness.Container
  assert "betweenness" not in port.CONTAINERS
  assert issubclass(betweenness.Container, port.GraphPort)


def test_traced_line():
  line, notes = cell_mod.run(BC, SEED, SECONDS, True, device="cpu",
                             cell=small())
  assert line["correct"]
  per_layer = {m["name"] for m in manifest.cell(BC)["per_layer"]}
  assert per_layer == {"superstep_ms.bc", "ell_kernel_ms.bc", "coo_ms.bc",
                       "idle_share.bc", "spmv_roofline.bc",
                       "level_idle_ms.bc"}
  # No card: the readers of device time find nothing; the rest read.
  assert {"superstep_ms.bc", "spmv_roofline.bc",
          "level_idle_ms.bc"} <= set(line["metrics"]) <= per_layer
  assert notes[-1].startswith("check ")


def test_readers_on_a_record():
  summary = {
      "window_s": 1.0, "busy_s": 0.6, "device_ops": 4,
      "kernel_s": {"void ell_spmv_kernel<Operands<double>>(Args)": 0.3,
                   "void coo_gather_reduce_kernel<Operands<double>>()": 0.2},
      "kernel_n": {},
      "idle_s_by_host": {"graphmat.engine.level": 0.25,
                         "graphmat.algos.bc.forward": 0.05,
                         "graphmat.engine.host_read": 0.1}}
  rec = {"summary": summary, "window_s": 1.1, "units": 100, "trials": 10,
         "bytes": 6.7e9, "spmv_wall_s": 1.0}
  want = {"superstep_ms.bc": 11.0, "ell_kernel_ms.bc": 3.0,
          "coo_ms.bc": 2.0, "idle_share.bc": 40.0,
          "spmv_roofline.bc": 0.2, "level_idle_ms.bc": 30.0}
  for name, value in want.items():
    assert readers.load(name).read(rec) == pytest.approx(value)
    assert readers.load(name).read({"window_s": 1.0}) is None


def test_level_bytes():
  """A forward level of 3 sources active in any lane, 40 out-edges, 5
  active lanes and 20 receiving rows, at 4 lanes: 40 indices, 5 float64
  messages, 20 rows of 4 float64 results; a backward one in float32."""
  sizes = torch.tensor([3, 40, 5, 20])
  assert work_bc.level_bytes("forward", sizes, 4) == 40 * 4 + 5 * 8 + 20 * 32
  assert work_bc.level_bytes("backward", sizes, 4) == 40 * 4 + 5 * 4 + 20 * 16
