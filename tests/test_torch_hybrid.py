"""The port's Mamba-2 (SSD) layer and hybrid family against the JAX package.

``_ssd_chunk_scan`` (chunk sizes that split the sequence in several ways,
and a case whose upper-triangle log-decays overflow ``exp``),
``mamba2_forward`` and several ``mamba2_decode`` steps; ``Model.forward``,
``init_cache``, ``decode_step``, ``make_prefill`` and greedy ``generate``
at the smoke size of ``zamba2_7b`` (5 layers: 2 segments of 2 Mamba-2
blocks behind the shared attention block, and a tail of 1), and with no
tail; the layer loops over stacks whose depth is not ``num_layers``; and
the parameter counts at full size.  Inputs are numpy arrays made from a
seed; the JAX weights are carried across by ``params_from_numpy``.

Tolerances (those of ``tests/test_torch_dense.py``): float32 rtol and atol
2e-4 (sums and exponentials of other libraries, in other orders); bfloat16
rtol and atol 3e-2 (the frameworks round to bfloat16 at other places).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import build_model as j_build_model  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.serve import generate, make_decode_step, make_prefill  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
TOL = {"float32": F32, "bfloat16": BF16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ZAMBA2_PARAMS = 6_751_130_832
ZAMBA2_PARTS = {"segments": 6_082_288_992, "tail": 233_934_192,
                "shared": 205_528_064}
# The smoke config's decode state, as the reference's init_cache(2, 8)
# gives it: 2 segments of 2 Mamba-2 blocks, a tail of 1, one K/V ring a
# segment.
SMOKE_CACHE = {"segments": {"conv": (2, 2, 2, 3, 144),
                            "h": (2, 2, 2, 8, 8, 16)},
               "shared": {"k": (2, 2, 8, 2, 16), "v": (2, 2, 8, 2, 16)},
               "tail": {"conv": (1, 2, 3, 144), "h": (1, 2, 8, 8, 16)}}


def _rng(seed):
  return np.random.default_rng(seed)


def _f32(x):
  if isinstance(x, torch.Tensor):
    return x.float().numpy()
  return np.asarray(x, np.float32)


def _shapes(tree):
  return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def _ssd_inputs(b, s, h, p, n, seed=0):
  """x [B,S,H,P], dt = softplus(N(0,1)) [B,S,H], a = -e (the init a_log =
  1), B and C [B,S,N]; float32 numpy."""
  r = _rng(seed)
  x = r.standard_normal((b, s, h, p)).astype(np.float32)
  dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
  a = np.full((h,), -np.e, np.float32)
  bm = r.standard_normal((b, s, n)).astype(np.float32)
  cm = r.standard_normal((b, s, n)).astype(np.float32)
  return x, dt, a, bm, cm


# ---------------------------------------------------------------------------
# The SSD scan and the Mamba-2 layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk", [(16, 8), (16, 4), (12, 16), (8, 8)],
                         ids=["two_chunks", "four_chunks", "one_short_chunk",
                              "one_chunk"])
def test_ssd_chunk_scan_matches_jax(s, chunk):
  args = _ssd_inputs(2, s, 3, 4, 5, seed=s + chunk)
  want = jssm._ssd_chunk_scan(*map(jnp.asarray, args), chunk)
  got = tssm._ssd_chunk_scan(*map(torch.from_numpy, args), chunk)
  assert got.shape == (2, s, 3, 4) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_ssd_chunk_scan_rejects_a_ragged_sequence():
  args = _ssd_inputs(1, 12, 2, 4, 3)
  with pytest.raises(ValueError, match="chunk"):
    tssm._ssd_chunk_scan(*map(torch.from_numpy, args), 8)


def test_ssd_chunk_scan_overflow_matches_jax():
  """At a chunk of 128 the intra-chunk log-decays above the diagonal
  (cum_i - cum_j > 0) overflow float32 ``exp``; the reference's ``where``
  drops them, and so must the port's select (a multiply by the causal
  mask would give inf · 0 = NaN)."""
  x, dt, a, bm, cm = _ssd_inputs(1, 256, 4, 8, 8, seed=0)
  cum = np.cumsum((dt * a).reshape(1, 2, 128, 4), axis=2, dtype=np.float32)
  li = cum[:, :, :, None, :] - cum[:, :, None, :, :]
  with np.errstate(over="ignore"):
    assert np.isinf(np.exp(li)).any()
  want = jssm._ssd_chunk_scan(*map(jnp.asarray, (x, dt, a, bm, cm)), 128)
  got = tssm._ssd_chunk_scan(*map(torch.from_numpy, (x, dt, a, bm, cm)), 128)
  assert torch.isfinite(got).all()
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@functools.lru_cache(maxsize=None)
def _mamba2_layer(dtype="float32"):
  jcfg = JC.get_smoke_config("zamba2_7b").scaled(dtype=dtype)
  tcfg = TC.get_smoke_config("zamba2_7b").scaled(dtype=dtype)
  params = jax.tree_util.tree_map(np.asarray, jcommon.init_params(
      jssm.mamba2_defs(jcfg), jax.random.PRNGKey(0)))
  # Non-zero biases and skips, drawn from a seed (the init makes them 0
  # and 1), so that every term is exercised.
  r = _rng(7)
  for name in ("conv_b", "dt_bias", "d_skip", "norm_g"):
    params[name] = (1.0 + 0.5 * r.standard_normal(params[name].shape)
                    ).astype(np.float32)
  return jcfg, tcfg, params, tcommon.params_from_numpy(params, device="cpu")


def test_mamba2_defs_match_jax():
  jcfg, tcfg, params, _ = _mamba2_layer()
  got = {k: d.shape for k, d in tssm.mamba2_defs(tcfg).items()}
  assert got == {k: v.shape for k, v in params.items()}
  assert tssm.mamba2_dims(tcfg) == jssm.mamba2_dims(jcfg) == (128, 8, 16, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_matches_jax(dtype):
  jcfg, tcfg, params, tparams = _mamba2_layer(dtype)
  x = _rng(1).standard_normal((2, 16, 64)).astype(np.float32)
  want = jssm.mamba2_forward(params, jnp.asarray(x).astype(JDT[dtype]), jcfg)
  got = tssm.mamba2_forward(tparams, torch.from_numpy(x).to(TDT[dtype]), tcfg)
  assert got.shape == (2, 16, 64) and got.dtype == TDT[dtype]
  np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def test_mamba2_decode_steps_match_jax():
  """Eight steps against the reference's (outputs and state), and the
  steps together equal the port's own prefill of the same tokens."""
  jcfg, tcfg, params, tparams = _mamba2_layer()
  x = _rng(2).standard_normal((2, 8, 64)).astype(np.float32)
  _, nh, p, n = tssm.mamba2_dims(tcfg)
  conv = (2, tcfg.ssm_conv - 1, 128 + 2 * n)
  jst = {"conv": jnp.zeros(conv), "h": jnp.zeros((2, nh, n, p))}
  tst = {"conv": torch.zeros(conv), "h": torch.zeros((2, nh, n, p))}
  outs = []
  for t in range(8):
    want, jst = jssm.mamba2_decode(params, jnp.asarray(x[:, t:t + 1]), jst,
                                   jcfg)
    got, new = tssm.mamba2_decode(tparams, torch.from_numpy(x[:, t:t + 1]),
                                  tst, tcfg)
    assert got.shape == (2, 1, 64) and new["h"].dtype == torch.float32
    assert not torch.equal(new["conv"], tst["conv"])  # a new state
    tst = new
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    outs.append(got)
  for name in ("conv", "h"):
    np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]), **F32)
  full = tssm.mamba2_forward(tparams, torch.from_numpy(x), tcfg)
  torch.testing.assert_close(torch.cat(outs, dim=1), full, **F32)


# ---------------------------------------------------------------------------
# The layer loops
# ---------------------------------------------------------------------------


def test_scan_layers_follow_the_stack_not_num_layers():
  """A stack of 3 under a config of 5 layers: 3 steps, and a new stacked
  cache of depth 3 with the one passed in left as it was."""
  stack = {"w": torch.arange(3, dtype=torch.float32)[:, None] + 1.0}
  x, aux = T.scan_layers(stack, torch.zeros(2),
                         lambda lp, h: (h + lp["w"], torch.ones(())))
  assert torch.equal(x, torch.full((2,), 6.0)) and float(aux) == 3.0
  cache = {"c": torch.zeros(3, 2)}
  x, new = T.scan_layers_cache(stack, cache, torch.zeros(2),
                               lambda lp, c, h: (h + lp["w"],
                                                 {"c": c["c"] + lp["w"]}))
  assert torch.equal(x, torch.full((2,), 6.0))
  assert torch.equal(new["c"], torch.tensor([[1.0] * 2, [2.0] * 2, [3.0] * 2]))
  assert not cache["c"].any()


# ---------------------------------------------------------------------------
# The hybrid model and the serving entry points
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(dtype="float32", num_layers=5):
  """(jax model, port model, jax params, port params, jitted jax forward,
  jitted jax decode step) at the smoke size of zamba2_7b."""
  jcfg = JC.get_smoke_config("zamba2_7b").scaled(dtype=dtype,
                                                 num_layers=num_layers)
  tcfg = TC.get_smoke_config("zamba2_7b").scaled(dtype=dtype,
                                                 num_layers=num_layers)
  jm, tm = j_build_model(jcfg, tp=1), build_model(tcfg)
  params = jcommon.init_params(jm.defs(), jax.random.PRNGKey(0))
  tparams = tcommon.params_from_numpy(
      jax.tree_util.tree_map(np.asarray, params), device="cpu")
  return (jm, tm, params, tparams, jax.jit(jm.forward),
          jax.jit(jm.decode_step))


def _tokens(shape, seed=1):
  return _rng(seed).integers(0, 512, shape).astype(np.int32)


@pytest.mark.parametrize("num_layers", [5, 4], ids=["tail", "no_tail"])
def test_forward_matches_jax(num_layers):
  jm, tm, params, tparams, jfwd, _ = _models(num_layers=num_layers)
  assert ("tail" in tparams) == (num_layers == 5)
  toks = _tokens((2, 16))
  want, _ = jfwd(params, {"tokens": jnp.asarray(toks)})
  got, aux = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
  assert got.shape == (2, 16, 512) and got.dtype == torch.float32
  assert float(aux) == 0.0
  np.testing.assert_allclose(_f32(got), _f32(want), **F32)


@pytest.mark.parametrize("block", ["shared", "mamba2"])
def test_blocks_bf16_match_jax(block):
  """Each hybrid block in bfloat16 on the model's embedded tokens, against
  the reference's block run op by op.  (No whole-model bfloat16
  comparison: the reference's compiled layer scans round to bfloat16 at
  other places than its op-by-op run, 0.131 apart at 5 layers, where the
  port is 0.0078 from the op-by-op run.)"""
  jm, tm, params, tparams, _, _ = _models("bfloat16")
  toks = _tokens((2, 16))
  x = jm.embed_inputs(params, {"tokens": jnp.asarray(toks)})
  xt = tm.embed_inputs(tparams, {"tokens": torch.from_numpy(toks)})
  if block == "shared":
    pos = np.arange(16, dtype=np.int32)
    want = jm._shared_block(params, x, jnp.asarray(pos), 8)
    got = tm._shared_block(tparams, xt, torch.from_numpy(pos), 8)
  else:
    lp = jax.tree_util.tree_map(lambda t: t[1, 0], params["segments"])
    want, _ = jm._mamba2_block(lp, x)
    got, _ = tm._mamba2_block(T._layer(T._layer(tparams["segments"], 1), 0),
                              xt)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


def test_init_cache_tree_matches_jax():
  jm, tm, *_ = _models()
  want = _shapes(jm.init_cache(2, 8))
  cache = tm.init_cache(2, 8, device="cpu")
  assert _shapes(cache) == want == SMOKE_CACHE
  assert cache["segments"]["h"].dtype == torch.float32
  assert cache["shared"]["k"].dtype == torch.float32  # the compute dtype
  assert not any(t.any() for t in jax.tree_util.tree_leaves(cache))


def test_decode_steps_match_jax():
  jm, tm, params, tparams, _, jstep = _models()
  toks = _tokens((2, 8), seed=2)
  jcache = jm.init_cache(2, 8)
  tcache = tm.init_cache(2, 8, device="cpu")
  step = make_decode_step(tm)
  for t in range(8):
    want, jcache = jstep(params, jnp.asarray(toks[:, t:t + 1]), jcache,
                         jnp.int32(t))
    got, tcache = step(tparams, torch.from_numpy(toks[:, t:t + 1]), tcache,
                       t)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
  assert _shapes(tcache) == SMOKE_CACHE
  for got, want in zip(jax.tree_util.tree_leaves(tcache),
                       jax.tree_util.tree_leaves(jcache)):
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)


def test_decode_matches_forward():
  """Teacher-forced decode == full forward, within the port (float32)."""
  _, tm, _, tparams, _, _ = _models()
  toks = torch.from_numpy(_tokens((2, 8), seed=3))
  logits, _ = tm.forward(tparams, {"tokens": toks})
  cache = tm.init_cache(2, 8, device="cpu")
  outs = []
  for t in range(8):
    lg, cache = tm.decode_step(tparams, toks[:, t:t + 1], cache, t)
    outs.append(lg)
  torch.testing.assert_close(torch.cat(outs, dim=1), logits, **F32)


def test_make_prefill_equals_forward():
  _, tm, _, tparams, _, _ = _models()
  toks = torch.from_numpy(_tokens((2, 16), seed=5))
  logits = make_prefill(tm)(tparams, {"tokens": toks})
  assert torch.equal(logits, tm.forward(tparams, {"tokens": toks})[0])
  assert logits.is_inference()


def test_greedy_generate_matches_jax():
  jm, tm, params, tparams, _, _ = _models()
  prompt = _tokens((2, 6), seed=6)
  want = jengine.generate(jm, params, jnp.asarray(prompt), max_new=6)
  got = generate(tm, tparams, torch.from_numpy(prompt), max_new=6)
  assert got.dtype == torch.int32 and got.shape == (2, 12)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_full_width_param_counts():
  cfg = TC.get_config("zamba2_7b")
  defs = build_model(cfg).defs()
  want = j_build_model(JC.get_config("zamba2_7b"), tp=1).defs()
  assert tcommon.num_params(defs) == ZAMBA2_PARAMS == jcommon.num_params(want)
  for part, count in ZAMBA2_PARTS.items():
    assert tcommon.num_params(defs[part]) == count
  assert jax.tree_util.tree_map(
      lambda d: tuple(d.shape), defs,
      is_leaf=lambda d: isinstance(d, tcommon.ParamDef)) == \
      jax.tree_util.tree_map(lambda d: tuple(d.shape), want,
                             is_leaf=jcommon.is_param_def)
  assert T.Model(cfg)._hybrid_split() == (13, 6, 3)
