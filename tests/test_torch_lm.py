"""The port's Mamba-1 serving slice against the JAX package.

``Model.forward`` (both ``ssm_impl``s), ``init_cache`` / ``decode_step``,
``make_prefill`` and greedy ``generate`` of the port against the JAX
package at the smoke size of ``falcon_mamba_7b`` (2 layers, d_model 64,
N 8, chunk 8, vocab 512), with the JAX weights carried across by
``params_from_numpy``; and the parameter tree of the full-width model.

Tolerances: float32 logits rtol 2e-4 / atol 2e-4 (sums and scans combined
in other orders, through 2 layers and the head); bfloat16 logits rtol 3e-2
/ atol 3e-2 (the two frameworks round to bfloat16 at other places; one
bfloat16 step is 2^-8 = 3.9e-3 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.transformer import build_model as j_build_model  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.serve import generate, make_decode_step, make_prefill  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
FALCON_PARAMS = 7_272_665_088


def _models(impl="assoc", dtype="float32"):
  jcfg = JC.get_smoke_config("falcon_mamba_7b").scaled(ssm_impl=impl,
                                                        dtype=dtype)
  tcfg = TC.get_smoke_config("falcon_mamba_7b").scaled(ssm_impl=impl,
                                                        dtype=dtype)
  jm, tm = j_build_model(jcfg, tp=1), build_model(tcfg)
  params = jcommon.init_params(jm.defs(), jax.random.PRNGKey(0))
  tparams = tcommon.params_from_numpy(
      jax.tree_util.tree_map(np.asarray, params), device="cpu")
  return jm, tm, params, tparams


def _tokens(shape, seed=1):
  return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _f32(x):
  if isinstance(x, torch.Tensor):
    return x.float().numpy()
  return np.asarray(x, np.float32)


@pytest.mark.parametrize("impl", ["assoc", "fused"])
def test_forward_matches_jax(impl):
  jm, tm, params, tparams = _models(impl)
  toks = _tokens((2, 16))
  want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
  got, aux = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
  assert got.shape == (2, 16, 512) and got.dtype == torch.float32
  assert float(aux) == 0.0
  np.testing.assert_allclose(_f32(got), _f32(want), **F32)


def test_forward_bf16_matches_jax():
  jm, tm, params, tparams = _models("fused", "bfloat16")
  toks = _tokens((2, 16))
  want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
  got, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


def test_decode_steps_match_jax():
  jm, tm, params, tparams = _models()
  toks = _tokens((2, 8))
  jcache = jm.init_cache(2, 8)
  tcache = tm.init_cache(2, 8, device="cpu")
  for name in ("conv", "h"):
    assert tuple(tcache[name].shape) == jcache[name].shape
  step = make_decode_step(tm)
  for t in range(8):
    want, jcache = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                                  jcache, jnp.int32(t))
    got, tcache = step(tparams, torch.from_numpy(toks[:, t:t + 1]), tcache, t)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
  for name in ("conv", "h"):
    np.testing.assert_allclose(_f32(tcache[name]), _f32(jcache[name]), **F32)


@pytest.mark.parametrize("impl", ["assoc", "fused"])
def test_decode_matches_forward(impl):
  """Teacher-forced decode == full forward, within the port."""
  _, tm, _, tparams = _models(impl)
  toks = torch.from_numpy(_tokens((2, 8), seed=2))
  logits, _ = tm.forward(tparams, {"tokens": toks})
  cache = tm.init_cache(2, 8, device="cpu")
  outs = []
  for t in range(8):
    lg, cache = tm.decode_step(tparams, toks[:, t:t + 1], cache, t)
    outs.append(lg)
  torch.testing.assert_close(torch.cat(outs, dim=1), logits, **F32)


def test_make_prefill_equals_forward():
  _, tm, _, tparams = _models("fused")
  toks = torch.from_numpy(_tokens((2, 16), seed=3))
  logits = make_prefill(tm)(tparams, {"tokens": toks})
  assert torch.equal(logits, tm.forward(tparams, {"tokens": toks})[0])
  assert logits.is_inference()


def test_greedy_generate_matches_jax():
  jm, tm, params, tparams = _models()
  prompt = _tokens((2, 8), seed=4)
  want = jengine.generate(jm, params, jnp.asarray(prompt), max_new=8)
  got = generate(tm, tparams, torch.from_numpy(prompt), max_new=8)
  assert got.dtype == torch.int32 and got.shape == (2, 16)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_draws_from_the_generator():
  _, tm, _, tparams = _models()
  prompt = torch.from_numpy(_tokens((2, 4), seed=5))
  runs = [generate(tm, tparams, prompt, max_new=6, greedy=False,
                   generator=torch.Generator().manual_seed(11))
          for _ in range(2)]
  assert torch.equal(runs[0], runs[1])
  assert torch.equal(runs[0][:, :4], prompt)
  assert ((runs[0] >= 0) & (runs[0] < 512)).all()


def test_full_width_param_count():
  cfg = TC.get_config("falcon_mamba_7b")
  defs = build_model(cfg).defs()
  assert tcommon.num_params(defs) == FALCON_PARAMS
  assert tcommon.num_params(defs) == jcommon.num_params(
      j_build_model(JC.get_config("falcon_mamba_7b"), tp=1).defs())


def test_init_params_shapes_and_dtypes_match_jax_defs():
  jm, tm, _, _ = _models()
  want = jax.tree_util.tree_map(
      lambda d: (tuple(d.shape), np.dtype(d.dtype).name), jm.defs(),
      is_leaf=jcommon.is_param_def)
  got = tcommon.init_params(tm.defs(), torch.Generator().manual_seed(0),
                            device="cpu")
  got = jax.tree_util.tree_map(
      lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got)
  assert got == want


def test_init_params_follows_the_defs():
  _, tm, _, _ = _models()
  p1 = tcommon.init_params(tm.defs(), torch.Generator().manual_seed(3),
                           device="cpu")
  p2 = tcommon.init_params(tm.defs(), torch.Generator().manual_seed(3),
                           device="cpu")
  assert all(torch.equal(a, b) for a, b in zip(
      jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)))
  lay = p1["layers"]["ssm"]
  assert torch.equal(lay["a_log"], torch.ones_like(lay["a_log"]))
  assert not lay["conv_b"].any()
  assert abs(float(p1["embed"].std()) - 0.02) < 2e-3
  # in_proj_u [L, 64, 128]: stddev 1/sqrt(64).
  assert abs(float(lay["in_proj_u"].std()) - 0.125) < 0.01


@pytest.mark.parametrize("arch", ["zamba2_7b", "seamless_m4t_medium",
                                  "internvl2_26b"])
def test_remaining_families_build(arch):
  """The hybrid, encdec and vlm families are ported: ``build_model``
  accepts their configs, and their ``defs()`` are the reference's tree."""
  got = build_model(TC.get_smoke_config(arch)).defs()
  want = j_build_model(JC.get_smoke_config(arch), tp=1).defs()
  assert jax.tree_util.tree_map(
      lambda d: tuple(d.shape), got,
      is_leaf=lambda d: isinstance(d, tcommon.ParamDef)) == \
      jax.tree_util.tree_map(lambda d: tuple(d.shape), want,
                             is_leaf=jcommon.is_param_def)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "deepseek_v2_236b",
                                  "granite_8b+mla"])
def test_moe_and_mla_configs_build(arch):
  """The MoE family and latent attention are ported: ``build_model``
  accepts both MoE configs and a dense config with ``use_mla``, and their
  ``defs()`` are the reference's tree."""
  name, _, mla = arch.partition("+")
  over = {"use_mla": True} if mla else {}
  cfg = TC.get_smoke_config(name).scaled(**over)
  want = j_build_model(JC.get_smoke_config(name).scaled(**over), tp=1).defs()
  got = build_model(cfg).defs()
  assert jax.tree_util.tree_map(
      lambda d: tuple(d.shape), got,
      is_leaf=lambda d: isinstance(d, tcommon.ParamDef)) == \
      jax.tree_util.tree_map(lambda d: tuple(d.shape), want,
                             is_leaf=jcommon.is_param_def)
