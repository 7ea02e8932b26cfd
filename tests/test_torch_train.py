"""The port's training substrate (``repro_torch.train``, ``launch/train.py``)
against the JAX package.

The reference's seven training tests (``tests/test_train_infra.py``) as
counterparts, each also held against the reference where the two can run
the same inputs; ``adamw_update`` and ``cosine_lr`` on the same gradients
and steps, with the global-norm clip engaged and not; ``cross_entropy``
with ignored labels; ``synthetic_batch`` bit for bit for a dense, a vlm and
an encdec config; three ``make_train_step`` steps of ``granite_3_2b``'s
smoke config from the reference's weights (carried across by
``params_from_numpy``); checkpoints written by each package and restored
by the other, bit for bit; and the driver ``launch/train.py`` on
``--device cpu``, resumed against uninterrupted.

Tolerances, float32 throughout: losses, gradient norms and learning rates
rtol 1e-5 (sums in other orders; a cosine of another library); parameters
after AdamW steps atol 5e-6 (one step moves a parameter by at most about
``lr``, 3e-3 here, times a ratio m/sqrt(v) that the frameworks round at
other places: 3.5e-7 was seen); the moments rtol 1e-5 and atol 2e-5 of
the leaf's largest magnitude (they are running means of gradients, which
the frameworks sum in other orders: an entry near zero keeps the absolute
error of the leaf's large ones, about 1e-6 of them).  What
the port does twice on one device (restore and continue, resume and
continue, tokens, checkpoints) is compared bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.models.common import init_params as j_init_params  # noqa: E402
from repro.models.transformer import build_model as j_build_model  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train.data import (SyntheticTokenPipeline,  # noqa: E402
                                    synthetic_batch)
from repro_torch.train.optimizer import (AdamWState, adamw_init,  # noqa: E402
                                         adamw_update, cosine_lr)
from repro_torch.train.steps import (cross_entropy, make_eval_step,  # noqa: E402
                                     make_train_step)

SCALAR = dict(rtol=1e-5, atol=0)
PARAM_ATOL = 5e-6
MOMENT_RTOL, MOMENT_OF_MAX = 1e-5, 2e-5


def _np(x):
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _models(arch):
  jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
  return jcfg, tcfg, j_build_model(jcfg, tp=1), build_model(tcfg)


def _carried(jparams):
  """The reference's parameters as the port's tree on the CPU."""
  return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


def _clone(tree):
  return tree_map(lambda t: t.clone(), tree)


def _assert_moments_close(got, want):
  got, want = _np(got), _np(want)
  np.testing.assert_allclose(got, want, rtol=MOMENT_RTOL,
                             atol=MOMENT_OF_MAX * np.abs(want).max())


def _assert_trees_equal(a, b):
  la, lb = tree_leaves(a), tree_leaves(b)
  assert len(la) == len(lb)
  for x, y in zip(la, lb):
    np.testing.assert_array_equal(_np(x), _np(y))


# ---------------------------------------------------------------------------
# The reference's seven training tests, as counterparts
# ---------------------------------------------------------------------------


def test_loss_decreases_tiny_model():
  """30 steps on 4 fixed batches: the mean of the last 5 losses falls more
  than 0.1 below the first 5's, as the reference's test asks of it; the
  reference's own losses from the same weights fall with them."""
  jcfg, tcfg, jm, tm = _models("granite_3_2b")
  jparams = j_init_params(jm.defs(), jax.random.PRNGKey(0))
  params = _carried(jparams)
  opt = adamw_init(params)
  step = make_train_step(tm, peak_lr=3e-3, warmup=5, total_steps=60)
  jstep = jax.jit(jsteps.make_train_step(jm, peak_lr=3e-3, warmup=5,
                                         total_steps=60))
  jopt_state = jopt.adamw_init(jparams)
  losses, jlosses = [], []
  for i in range(30):
    params, opt, m = step(params, opt, synthetic_batch(
        tcfg, 4, 32, step=i % 4, seed=0, device="cpu"))
    jparams, jopt_state, jm_ = jstep(
        jparams, jopt_state,
        jdata.synthetic_batch(jcfg, 4, 32, step=i % 4, seed=0))
    losses.append(float(m["loss"]))
    jlosses.append(float(jm_["loss"]))
  assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
  # Float32 differences compound over 30 Adam steps: the traces agree to
  # 1e-3 of a loss near 6.
  np.testing.assert_allclose(losses, jlosses, rtol=1e-3)


def test_checkpoint_roundtrip_and_resume(tmp_path):
  _, tcfg, jm, tm = _models("granite_8b")
  params = _carried(j_init_params(jm.defs(), jax.random.PRNGKey(0)))
  opt = adamw_init(params)
  step = make_train_step(tm)
  for i in range(3):
    params, opt, _ = step(params, opt, synthetic_batch(tcfg, 2, 16, step=i,
                                                       device="cpu"))
  d = str(tmp_path / "ckpt")
  tckpt.save_checkpoint(d, 3, {"params": params, "opt": opt})
  assert tckpt.latest_step(d) == 3
  like = {"params": tree_map(torch.zeros_like, params),
          "opt": tree_map(torch.zeros_like, opt)}
  restored = tckpt.restore_checkpoint(d, 3, like, device="cpu")
  assert isinstance(restored["opt"], AdamWState)
  _assert_trees_equal(restored, {"params": params, "opt": opt})
  # Continue training from restored state == continue from original (the
  # step updates in place, so each side runs on its own tensors).
  batch = synthetic_batch(tcfg, 2, 16, step=3, device="cpu")
  p1, o1, m1 = step(restored["params"], restored["opt"], batch)
  p2, o2, m2 = step(params, opt, batch)
  assert float(m1["loss"]) == float(m2["loss"])
  _assert_trees_equal((p1, o1), (p2, o2))


def test_checkpoint_atomic_commit(tmp_path):
  d = str(tmp_path / "c")
  state = {"x": torch.arange(5, dtype=torch.float32)}
  tckpt.save_checkpoint(d, 1, state)
  tckpt.save_checkpoint(d, 2, state)
  # a stale tmp dir must never be listed as a valid step
  os.makedirs(os.path.join(d, "step_00000009.tmp"))
  assert tckpt.latest_step(d) == 2
  assert jckpt.latest_step(d) == 2


def test_checkpoint_manager_retention(tmp_path):
  mgr = tckpt.CheckpointManager(str(tmp_path / "r"), interval_s=0.0, keep=2)
  state = {"x": torch.zeros((2,))}
  for s in (1, 2, 3, 4):
    mgr.maybe_save(s, state, force=True)
  assert tckpt.latest_step(mgr.directory) == 4
  steps = sorted(int(n.split("_")[1]) for n in os.listdir(mgr.directory))
  assert steps == [3, 4]
  # The wall-clock cadence: a second save inside the interval is skipped.
  slow = tckpt.CheckpointManager(str(tmp_path / "s"), interval_s=3600.0)
  assert slow.maybe_save(1, state) is not None
  assert slow.maybe_save(2, state) is None
  assert slow.restore_latest({"x": torch.ones(2)}, device="cpu")[0] == 1


def test_data_pipeline_deterministic_seek():
  cfg = TC.get_smoke_config("granite_8b")
  p1 = SyntheticTokenPipeline(cfg, 2, 16, seed=3, device="cpu")
  batches = [next(p1) for _ in range(5)]
  p2 = SyntheticTokenPipeline(cfg, 2, 16, seed=3, device="cpu")
  p2.seek(3)
  b3 = next(p2)
  assert torch.equal(b3["tokens"], batches[3]["tokens"])
  assert p2.step == 4
  jb3 = jdata.synthetic_batch(JC.get_smoke_config("granite_8b"), 2, 16,
                              step=3, seed=3)
  np.testing.assert_array_equal(b3["tokens"].numpy(), np.asarray(jb3["tokens"]))


def test_cosine_schedule_shape():
  lrs = [float(cosine_lr(torch.tensor(s, dtype=torch.int32), peak=1.0,
                         warmup=10, total=100)) for s in range(0, 101, 10)]
  assert lrs[0] == 0.0
  assert abs(lrs[1] - 1.0) < 1e-6          # peak at end of warmup
  assert lrs[-1] <= lrs[1]                 # decays
  assert lrs[-1] >= 0.099                  # floor


def test_microbatch_accumulation_matches_full_batch():
  """grad-accum over 4 microbatches == single full-batch step (same data),
  at the reference test's tolerances; and the port's microbatched step
  against the reference's."""
  jcfg, tcfg, jm, tm = _models("granite_8b")
  jparams = j_init_params(jm.defs(), jax.random.PRNGKey(0))
  params = _carried(jparams)
  batch = synthetic_batch(tcfg, 8, 16, step=0, seed=0, device="cpu")
  step1 = make_train_step(tm, peak_lr=1e-3, warmup=1)
  stepm = make_train_step(tm, peak_lr=1e-3, warmup=1, microbatches=4)
  # Two steps each, so that the second runs at a non-zero learning rate.
  p1, o1 = _clone(params), adamw_init(params)
  pm, om = _clone(params), adamw_init(params)
  for _ in range(2):
    p1, o1, m1 = step1(p1, o1, batch)
    pm, om, mm = stepm(pm, om, batch)
  np.testing.assert_allclose(float(m1["loss"]), float(mm["loss"]), rtol=1e-5)
  for a, b in zip(tree_leaves(p1), tree_leaves(pm)):
    np.testing.assert_allclose(_np(a), _np(b), rtol=2e-3, atol=2e-5)
  jstepm = jax.jit(jsteps.make_train_step(jm, peak_lr=1e-3, warmup=1,
                                          microbatches=4))
  jb = jdata.synthetic_batch(jcfg, 8, 16, step=0, seed=0)
  jp, jo = jparams, jopt.adamw_init(jparams)
  for _ in range(2):
    jp, jo, jmm = jstepm(jp, jo, jb)
  np.testing.assert_allclose(float(mm["loss"]), float(jmm["loss"]), **SCALAR)
  np.testing.assert_allclose(float(mm["grad_norm"]), float(jmm["grad_norm"]),
                             **SCALAR)
  for a, b in zip(tree_leaves(pm), jax.tree_util.tree_leaves(jp)):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=PARAM_ATOL)


def test_microbatches_must_divide_the_batch():
  _, tcfg, jm, tm = _models("granite_8b")
  params = _carried(j_init_params(jm.defs(), jax.random.PRNGKey(0)))
  step = make_train_step(tm, microbatches=3)
  with pytest.raises(ValueError, match="microbatches"):
    step(params, adamw_init(params), synthetic_batch(tcfg, 8, 16,
                                                     device="cpu"))


# ---------------------------------------------------------------------------
# The optimizer, the loss and the data against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_clip", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_matches_jax(grad_clip):
  """Three updates on the same gradients (norm about 11): the clip engages
  at 0.5 and not at 1e3.  Parameters, both moments, the step and the
  global norm."""
  rng = np.random.default_rng(0)
  shapes = {"w": (24, 16), "b": (16,), "stack": (2, 8, 4)}
  p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
  jp = {k: jnp.asarray(v) for k, v in p0.items()}
  tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
  jo, to = jopt.adamw_init(jp), adamw_init(tp)
  for i in range(3):
    g = {k: (rng.standard_normal(s) * 0.8).astype(np.float32)
         for k, s in shapes.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    lr = 1e-2 * (i + 1)
    jp, jo, jn = jopt.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                   jo, jp, lr=jnp.float32(lr),
                                   grad_clip=grad_clip)
    tp2, to, tn = adamw_update(tg, to, tp, lr=torch.tensor(lr),
                               grad_clip=grad_clip)
    assert tp2 is tp  # in place
    np.testing.assert_array_equal(tg["w"].numpy(), g["w"])  # grads untouched
    np.testing.assert_allclose(float(tn), float(jn), **SCALAR)
    assert (float(tn) > grad_clip) == (grad_clip == 0.5)
  assert int(to.step) == int(jo.step) == 3 and to.step.dtype == torch.int32
  for k in shapes:
    np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                               atol=PARAM_ATOL)
    _assert_moments_close(to.mu[k], jo.mu[k])
    _assert_moments_close(to.nu[k], jo.nu[k])


def test_cosine_lr_matches_jax():
  for kw in (dict(peak=3e-4, warmup=100, total=10000),
             dict(peak=1.0, warmup=10, total=100, floor=0.2),
             dict(peak=1e-3, warmup=0, total=5)):
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 20000):
      got = cosine_lr(torch.tensor(s, dtype=torch.int32), **kw)
      want = jopt.cosine_lr(jnp.int32(s), **kw)
      assert got.dtype == torch.float32
      np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                 atol=1e-12)


def test_cross_entropy_ignores_labels_like_jax():
  rng = np.random.default_rng(5)
  logits = (rng.standard_normal((3, 7, 40)) * 3).astype(np.float32)
  labels = rng.integers(0, 40, (3, 7)).astype(np.int32)
  labels[0, :4] = -1
  labels[2, 6] = -1
  got, n = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
  want, jn = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
  assert float(n) == float(jn) == 16.0
  np.testing.assert_allclose(float(got), float(want), **SCALAR)
  # Every label ignored: the loss is 0 over a count of 1, as the reference's.
  none = -np.ones_like(labels)
  got, n = cross_entropy(torch.from_numpy(logits), torch.from_numpy(none))
  want, jn = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(none))
  assert float(got) == float(want) == 0.0 and float(n) == float(jn) == 1.0


@pytest.mark.parametrize("arch", ["granite_8b", "internvl2_26b",
                                  "seamless_m4t_medium"])
def test_synthetic_batch_matches_jax_bitwise(arch):
  jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
  for step, seed in ((0, 0), (7, 3)):
    want = jdata.synthetic_batch(jcfg, 3, 12, step=step, seed=seed)
    got = synthetic_batch(tcfg, 3, 12, step=step, seed=seed, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
      w = np.asarray(want[k])
      assert got[k].numpy().dtype == w.dtype, k
      np.testing.assert_array_equal(got[k].numpy(), w)
  if tcfg.family == "vlm":
    assert (got["labels"][:, :tcfg.frontend_seq] == -1).all()


def test_synthetic_batch_needs_a_card_unless_asked_for_cpu():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is valid")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    synthetic_batch(TC.get_smoke_config("granite_8b"), 2, 8)


# ---------------------------------------------------------------------------
# Train and eval steps against the reference
# ---------------------------------------------------------------------------


def test_three_train_steps_match_jax():
  """Three steps of granite_3_2b's smoke config (tied embeddings, full
  remat) in float32 from the reference's weights: loss, lr, grad norm and
  every parameter and moment after each step."""
  jcfg, tcfg, jm, tm = _models("granite_3_2b")
  jparams = j_init_params(jm.defs(), jax.random.PRNGKey(1))
  params = _carried(jparams)
  opt, jo = adamw_init(params), jopt.adamw_init(jparams)
  step = make_train_step(tm, peak_lr=3e-3, warmup=1, total_steps=10)
  jstep = jax.jit(jsteps.make_train_step(jm, peak_lr=3e-3, warmup=1,
                                         total_steps=10))
  for i in range(3):
    batch = synthetic_batch(tcfg, 4, 32, step=i, seed=2, device="cpu")
    params, opt, m = step(params, opt, batch)
    jparams, jo, jm_ = jstep(jparams, jo, jdata.synthetic_batch(
        jcfg, 4, 32, step=i, seed=2))
    for k in ("loss", "ce", "lr", "grad_norm"):
      np.testing.assert_allclose(float(m[k]), float(jm_[k]), **SCALAR)
    assert float(m["moe_aux"]) == float(jm_["moe_aux"]) == 0.0
    for a, b in zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
      np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=PARAM_ATOL)
    for a, b in zip(tree_leaves((opt.mu, opt.nu)),
                    jax.tree_util.tree_leaves((jo.mu, jo.nu))):
      _assert_moments_close(a, b)
  assert int(opt.step) == int(jo.step) == 3


def test_eval_step_matches_jax():
  jcfg, tcfg, jm, tm = _models("granite_3_2b")
  jparams = j_init_params(jm.defs(), jax.random.PRNGKey(2))
  batch = synthetic_batch(tcfg, 2, 16, step=4, device="cpu")
  got = make_eval_step(tm)(_carried(jparams), batch)
  want = jsteps.make_eval_step(jm)(jparams, jdata.synthetic_batch(jcfg, 2, 16,
                                                                  step=4))
  assert not got["loss"].requires_grad
  np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                             **SCALAR)
  assert float(got["ntok"]) == float(want["ntok"]) == 32.0


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------


def _trained_pair():
  """The reference's parameters and AdamW state after one step of
  granite_3_2b's smoke config, and the port's tree of zeros like them."""
  jcfg, tcfg, jm, tm = _models("granite_3_2b")
  jparams = j_init_params(jm.defs(), jax.random.PRNGKey(3))
  jstate = jopt.adamw_init(jparams)
  jparams, jstate, _ = jax.jit(jsteps.make_train_step(jm, warmup=0))(
      jparams, jstate, jdata.synthetic_batch(jcfg, 2, 16))
  params = _carried(jparams)
  like = {"params": tree_map(torch.zeros_like, params),
          "opt": tree_map(torch.zeros_like, adamw_init(params))}
  return {"params": jparams, "opt": jstate}, like


def test_checkpoint_jax_to_port_bitwise(tmp_path):
  jstate, like = _trained_pair()
  d = str(tmp_path / "j2t")
  jckpt.save_checkpoint(d, 1, jstate)
  step, got = tckpt.CheckpointManager(d).restore_latest(like, device="cpu")
  assert step == 1 and got["opt"].step.dtype == torch.int32
  assert int(got["opt"].step) == 1
  _assert_trees_equal(got, jstate)


def test_checkpoint_port_to_jax_bitwise(tmp_path):
  jstate, like = _trained_pair()
  state = tree_map(lambda x: torch.from_numpy(np.array(x)), jstate)
  state = {"params": state["params"], "opt": AdamWState(*state["opt"])}
  d_port, d_jax = str(tmp_path / "t2j"), str(tmp_path / "ref")
  tckpt.save_checkpoint(d_port, 2, state)
  jckpt.save_checkpoint(d_jax, 2, jstate)
  # The same files, names and manifest entries as the reference writes.
  with open(os.path.join(d_port, "step_00000002", "manifest.json")) as f:
    mine = json.load(f)
  with open(os.path.join(d_jax, "step_00000002", "manifest.json")) as f:
    ref = json.load(f)
  assert mine["step"] == ref["step"] == 2
  assert mine["arrays"] == ref["arrays"]
  jlike = jax.tree_util.tree_map(jnp.zeros_like, jstate)
  restored = jckpt.restore_checkpoint(d_port, 2, jlike)
  _assert_trees_equal(restored, jstate)


def test_checkpoint_refuses_bfloat16(tmp_path):
  d = str(tmp_path / "bf")
  with pytest.raises(TypeError, match="bfloat16"):
    tckpt.save_checkpoint(d, 1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
  assert tckpt.latest_step(d) is None


def test_restore_to_a_tree_of_devices(tmp_path):
  d = str(tmp_path / "dev")
  state = {"a": torch.arange(3.0), "b": [torch.ones(2), torch.zeros(())]}
  tckpt.save_checkpoint(d, 5, state)
  got = tckpt.restore_checkpoint(
      d, 5, state, device={"a": "cpu", "b": ["cpu", torch.device("cpu")]})
  _assert_trees_equal(got, state)


# ---------------------------------------------------------------------------
# The training driver
# ---------------------------------------------------------------------------


def test_train_driver_resumes_as_if_uninterrupted(tmp_path, capsys):
  """4 steps with a checkpoint after every one, then a restart to 8 that
  resumes at step 4, against 8 steps in one run: bit for bit on one
  device."""
  common = ["--arch", "granite-8b", "--smoke", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--log-every", "100"]
  d = str(tmp_path / "run")
  first = train_driver.train(common + ["--steps", "4", "--ckpt-dir", d,
                                       "--ckpt-every-s", "0"])
  assert first["start"] == 0 and tckpt.latest_step(d) == 4
  saved = tckpt.restore_checkpoint(
      d, 4, {"params": first["params"], "opt": first["opt"]}, device="cpu")
  _assert_trees_equal(saved, {"params": first["params"], "opt": first["opt"]})
  second = train_driver.train(common + ["--steps", "8", "--ckpt-dir", d,
                                        "--ckpt-every-s", "0"])
  assert second["start"] == 4
  assert "resumed from step 4" in capsys.readouterr().out
  whole = train_driver.train(common + ["--steps", "8"])
  assert first["losses"] + second["losses"] == whole["losses"]
  _assert_trees_equal((second["params"], second["opt"]),
                      (whole["params"], whole["opt"]))
  assert sorted(os.listdir(d)) == ["step_00000006", "step_00000007",
                                   "step_00000008"]
  assert train_driver.main(common + ["--steps", "8", "--ckpt-dir", d]) == 0


def test_train_driver_needs_a_card_unless_asked_for_cpu():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is valid")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    train_driver.main(["--arch", "granite-8b", "--smoke", "--steps", "1"])
