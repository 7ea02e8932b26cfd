"""The port's dense (GQA) serving slice against the JAX package.

RoPE, SwiGLU, the causal/sliding-window mask, chunked and dense attention,
grouped decode attention, the GQA block (prefill and the ring-buffer
decode), and ``Model.forward`` / ``decode_step`` / greedy ``generate`` at
the smoke sizes of granite_8b, granite_3_2b (tied embeddings) and
qwen2_5_32b (QKV bias, carried across non-zero, and rope_theta 1e6), on
numpy inputs made from a seed, with the JAX weights carried across by
``params_from_numpy``; and the parameter counts of the four dense configs
at full size.

Tolerances (those of ``tests/test_torch_lm.py``): float32 rtol and atol
2e-4 (sums in other orders, exp/cos/sin of other libraries); bfloat16
rtol and atol 3e-2 (the frameworks round to bfloat16 at other places).
Masks and token ids compare exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models.transformer import build_model as j_build_model  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.serve import (generate, make_decode_step,  # noqa: E402
                               make_prefill)

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
DENSE = ("granite_8b", "granite_3_2b", "qwen2_5_32b", "deepseek_coder_33b")
SMOKE = ("granite_8b", "granite_3_2b", "qwen2_5_32b")
GRANITE_8B_PARAMS = 8_254_689_280


def _rng(seed):
  return np.random.default_rng(seed)


def _f32(x):
  if isinstance(x, torch.Tensor):
    return x.float().numpy()
  return np.asarray(x, np.float32)


def _t(a, dtype=None):
  t = torch.from_numpy(np.asarray(a))
  return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
  return jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype)


TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": F32, "bfloat16": BF16}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(theta, dtype):
  x = _rng(0).standard_normal((2, 7, 3, 16)).astype(np.float32)
  pos = _rng(1).integers(0, 4096, (2, 7)).astype(np.int32)
  want = jcommon.apply_rope(_j(x, JDT[dtype]), _j(pos), theta)
  got = tcommon.apply_rope(_t(x, TDT[dtype]), _t(pos), theta)
  assert got.dtype == TDT[dtype] and got.shape == x.shape
  np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
  np.testing.assert_allclose(
      tcommon.rope_freqs(16, theta).numpy(),
      np.asarray(jcommon.rope_freqs(16, theta)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_jax(dtype):
  cfg_j = JC.get_smoke_config("granite_8b").scaled(dtype=dtype)
  cfg_t = TC.get_smoke_config("granite_8b").scaled(dtype=dtype)
  params = jcommon.init_params(jffn.swiglu_defs(64, 128),
                               jax.random.PRNGKey(0))
  tparams = tcommon.params_from_numpy(
      jax.tree_util.tree_map(np.asarray, params), device="cpu")
  x = _rng(2).standard_normal((2, 5, 64)).astype(np.float32)
  want = jffn.swiglu(params, _j(x, JDT[dtype]), cfg_j)
  got = tffn.swiglu(tparams, _t(x, TDT[dtype]), cfg_t)
  assert got.dtype == TDT[dtype]
  np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_causal_swa_mask_matches_jax(window, causal):
  q = _rng(3).integers(0, 20, (6,)).astype(np.int32)
  k = np.arange(10, dtype=np.int32)
  want = jattn.causal_swa_mask(_j(q), _j(k), window, causal)
  got = tattn.causal_swa_mask(_t(q), _t(k), window, causal)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _qkv(b, s, t, h, d, seed=4):
  r = _rng(seed)
  return tuple(r.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d)))


@pytest.mark.parametrize("t,chunk", [(12, 4), (13, 4), (10, 16)],
                         ids=["multiple", "ragged", "one_chunk"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(t, chunk, window, causal):
  q, k, v = _qkv(2, t, t, 3, 8)
  pos = np.arange(t, dtype=np.int32)
  kw = dict(window=window, causal=causal, kv_chunk=chunk)
  want = jattn.chunked_attention(*map(_j, (q, k, v, pos, pos)), **kw)
  got = tattn.chunked_attention(*map(_t, (q, k, v, pos, pos)), **kw)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
  dense = tattn.dense_attention(*map(_t, (q, k, v, pos, pos)),
                                window=window, causal=causal)
  if causal or t % min(chunk, t) == 0:
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **F32)
  else:
    # Without the causal mask nothing masks the zero keys that pad a ragged
    # tail, in the reference as here (ROADMAP.md Queue 3): they take part.
    assert np.abs(got.numpy() - dense.numpy()).max() > 1e-2


def test_chunked_attention_bf16_matches_jax():
  q, k, v = _qkv(2, 16, 16, 4, 16, seed=5)
  pos = np.arange(16, dtype=np.int32)
  want = jattn.chunked_attention(*(_j(a, jnp.bfloat16) for a in (q, k, v)),
                                 _j(pos), _j(pos), kv_chunk=8)
  got = tattn.chunked_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                                _t(pos), _t(pos), kv_chunk=8)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


@pytest.mark.parametrize("window", [0, 4])
def test_dense_attention_matches_jax(window):
  q, k, v = _qkv(2, 9, 9, 3, 8, seed=6)
  pos = np.arange(9, dtype=np.int32)
  want = jattn.dense_attention(*map(_j, (q, k, v, pos, pos)), window=window)
  got = tattn.dense_attention(*map(_t, (q, k, v, pos, pos)), window=window)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
def test_grouped_decode_attention_matches_jax(dtype, window):
  r = _rng(7)
  q = r.standard_normal((2, 1, 8, 16)).astype(np.float32)
  k = r.standard_normal((2, 11, 2, 16)).astype(np.float32)
  v = r.standard_normal((2, 11, 2, 16)).astype(np.float32)
  qp = np.array([9], np.int32)
  kp = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 2**30], np.int32)
  want = jattn.grouped_decode_attention(
      _j(q, JDT[dtype]), _j(k, JDT[dtype]), _j(v, JDT[dtype]), _j(qp),
      _j(kp), window=window)
  got = tattn.grouped_decode_attention(
      _t(q, TDT[dtype]), _t(k, TDT[dtype]), _t(v, TDT[dtype]), _t(qp),
      _t(kp), window=window)
  assert got.dtype == TDT[dtype]
  np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
  # The same as repeating the KV heads and attending densely.
  rep = tattn.dense_attention(
      _t(q), tattn._repeat_kv(_t(k), 4), tattn._repeat_kv(_t(v), 4),
      _t(qp), _t(kp), window=window)
  if dtype == "float32":
    np.testing.assert_allclose(got.numpy(), rep.numpy(), **F32)


def test_repeat_kv_matches_jax():
  x = _rng(8).standard_normal((2, 5, 2, 4)).astype(np.float32)
  np.testing.assert_array_equal(tattn._repeat_kv(_t(x), 3).numpy(),
                                np.asarray(jattn._repeat_kv(_j(x), 3)))
  assert tattn._repeat_kv(_t(x), 1).shape == x.shape


# ---------------------------------------------------------------------------
# The GQA block
# ---------------------------------------------------------------------------


def _gqa(arch="qwen2_5_32b", **over):
  """(jcfg, tcfg, jax params, port params) of one GQA block; QKV biases,
  where the config has them, are drawn non-zero (the init makes them 0)."""
  jcfg = JC.get_smoke_config(arch).scaled(**over)
  tcfg = TC.get_smoke_config(arch).scaled(**over)
  params = jcommon.init_params(jattn.gqa_defs(jcfg, 1), jax.random.PRNGKey(0))
  params = jax.tree_util.tree_map(np.asarray, params)
  for i, name in enumerate(("bq", "bk", "bv")):
    if name in params:
      params[name] = _rng(20 + i).standard_normal(
          params[name].shape).astype(np.float32) * 0.5
  return jcfg, tcfg, params, tcommon.params_from_numpy(params, device="cpu")


def test_gqa_defs_match_jax():
  for arch in SMOKE:
    jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    want = {k: d.shape for k, d in jattn.gqa_defs(jcfg, 1).items()}
    got = {k: d.shape for k, d in tattn.gqa_defs(tcfg).items()}
    assert got == want, arch
  assert "bq" in tattn.gqa_defs(TC.get_smoke_config("qwen2_5_32b"))


@pytest.mark.parametrize("arch", ["qwen2_5_32b", "granite_8b"])
@pytest.mark.parametrize("window", [0, 5])
def test_gqa_forward_matches_jax(arch, window):
  jcfg, tcfg, params, tparams = _gqa(arch, sliding_window=window)
  x = _rng(9).standard_normal((2, 11, 64)).astype(np.float32)
  pos = np.arange(11, dtype=np.int32)
  want = jattn.gqa_forward(params, _j(x), _j(pos), jcfg, 1, kv_chunk=4)
  got = tattn.gqa_forward(tparams, _t(x), _t(pos), tcfg, kv_chunk=4)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
  q, k, v = tattn.gqa_qkv(tparams, _t(x), _t(pos), tcfg)
  jq, jk, jv = jattn.gqa_qkv(params, _j(x), _j(pos), jcfg, 1)
  for a, b in ((q, jq), (k, jk), (v, jv)):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_gqa_decode_ring_matches_jax():
  """Decoding past the end of a sliding_window=8 ring: the port's steps
  equal the reference's, the caches too, and the ring decode equals the
  port's own windowed prefill."""
  jcfg, tcfg, params, tparams = _gqa("qwen2_5_32b", sliding_window=8)
  s, t = 20, 8
  x = _rng(10).standard_normal((1, s, 64)).astype(np.float32)
  shape = (1, t, tcfg.num_kv_heads, tcfg.resolved_head_dim)
  jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
  tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
  outs = []
  for p in range(s):
    want, jc = jattn.gqa_decode(params, _j(x[:, p:p + 1]), jc, jnp.int32(p),
                                jcfg, 1)
    got, tc2 = tattn.gqa_decode(tparams, _t(x[:, p:p + 1]), tc, p, tcfg)
    alt, _ = tattn.gqa_decode(tparams, _t(x[:, p:p + 1]), tc,
                              torch.tensor(p, dtype=torch.int32), tcfg)
    assert torch.equal(got, alt)            # pos as an int or a 0-d tensor
    assert not torch.equal(tc2["k"], tc["k"])  # a new cache; the old kept
    tc = tc2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    outs.append(got)
  for name in ("k", "v"):
    np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **F32)
  full = tattn.gqa_forward(tparams, _t(x), _t(np.arange(s, dtype=np.int32)),
                           tcfg, kv_chunk=4)
  np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                             **F32)


# ---------------------------------------------------------------------------
# The model and the serving entry points
# ---------------------------------------------------------------------------


def _models(arch, dtype="float32"):
  jcfg = JC.get_smoke_config(arch).scaled(dtype=dtype)
  tcfg = TC.get_smoke_config(arch).scaled(dtype=dtype)
  jm, tm = j_build_model(jcfg, tp=1), build_model(tcfg)
  params = jax.tree_util.tree_map(
      np.asarray, jcommon.init_params(jm.defs(), jax.random.PRNGKey(1)))
  attn = params["layers"]["attn"]
  for i, name in enumerate(("bq", "bk", "bv")):
    if name in attn:
      attn[name] = _rng(30 + i).standard_normal(
          attn[name].shape).astype(np.float32) * 0.5
  jparams = jax.tree_util.tree_map(jnp.asarray, params)
  return jm, tm, jparams, tcommon.params_from_numpy(params, device="cpu")


def _tokens(shape, seed=1):
  return _rng(seed).integers(0, 512, shape).astype(np.int32)


@pytest.mark.parametrize("arch", SMOKE)
def test_forward_matches_jax(arch):
  jm, tm, params, tparams = _models(arch)
  toks = _tokens((2, 13))
  want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)}, kv_chunk=4)
  got, aux = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                        kv_chunk=4)
  assert got.shape == (2, 13, 512) and got.dtype == torch.float32
  assert float(aux) == 0.0
  np.testing.assert_allclose(_f32(got), _f32(want), **F32)


def test_forward_bf16_matches_jax():
  jm, tm, params, tparams = _models("granite_8b", "bfloat16")
  toks = _tokens((2, 16))
  want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)}, kv_chunk=8)
  got, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                      kv_chunk=8)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


@pytest.mark.parametrize("arch", SMOKE)
def test_decode_steps_match_jax(arch):
  jm, tm, params, tparams = _models(arch)
  toks = _tokens((2, 9), seed=2)
  jcache = jm.init_cache(2, 9)
  tcache = tm.init_cache(2, 9, device="cpu")
  for name in ("k", "v"):
    assert tuple(tcache[name].shape) == jcache[name].shape
    assert tcache[name].dtype == torch.float32
  step = make_decode_step(tm)
  for t in range(9):
    want, jcache = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                                  jcache, jnp.int32(t))
    got, tcache = step(tparams, torch.from_numpy(toks[:, t:t + 1]), tcache,
                       torch.tensor(t, dtype=torch.int32))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
  for name in ("k", "v"):
    np.testing.assert_allclose(_f32(tcache[name]), _f32(jcache[name]), **F32)


@pytest.mark.parametrize("arch", SMOKE)
def test_decode_matches_forward(arch):
  """Teacher-forced decode == full forward, within the port."""
  _, tm, _, tparams = _models(arch)
  toks = torch.from_numpy(_tokens((2, 12), seed=3))
  logits, _ = tm.forward(tparams, {"tokens": toks}, kv_chunk=4)
  cache = tm.init_cache(2, 12, device="cpu")
  outs = []
  for t in range(12):
    lg, cache = tm.decode_step(tparams, toks[:, t:t + 1], cache, t)
    outs.append(lg)
  torch.testing.assert_close(torch.cat(outs, dim=1), logits, **F32)


def test_swa_ring_model_matches_jax():
  """The port of ``test_swa_ring_cache_consistency`` on the dense family:
  a sliding_window=8 ring, decoded 20 steps (past the window), against
  the reference's decode and the full forward."""
  jcfg = JC.get_smoke_config("granite_8b").scaled(sliding_window=8)
  tcfg = TC.get_smoke_config("granite_8b").scaled(sliding_window=8)
  jm, tm = j_build_model(jcfg, tp=1), build_model(tcfg)
  params = jcommon.init_params(jm.defs(), jax.random.PRNGKey(3))
  tparams = tcommon.params_from_numpy(
      jax.tree_util.tree_map(np.asarray, params), device="cpu")
  toks = _tokens((1, 20), seed=4)
  jcache = jm.init_cache(1, 20)
  cache = tm.init_cache(1, 20, device="cpu")
  assert cache["k"].shape[2] == 8 == jcache["k"].shape[2]
  outs = []
  for t in range(20):
    want, jcache = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                                  jcache, jnp.int32(t))
    got, cache = tm.decode_step(tparams, torch.from_numpy(toks[:, t:t + 1]),
                                cache, t)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
    outs.append(got)
  logits, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                         kv_chunk=4)
  torch.testing.assert_close(torch.cat(outs, dim=1), logits, **F32)


def test_make_prefill_equals_forward():
  _, tm, _, tparams = _models("granite_8b")
  toks = torch.from_numpy(_tokens((2, 16), seed=5))
  logits = make_prefill(tm)(tparams, {"tokens": toks})
  assert torch.equal(logits, tm.forward(tparams, {"tokens": toks})[0])
  assert logits.is_inference()


@pytest.mark.parametrize("arch", SMOKE)
def test_greedy_generate_matches_jax(arch):
  jm, tm, params, tparams = _models(arch)
  prompt = _tokens((2, 6), seed=6)
  want = jengine.generate(jm, params, jnp.asarray(prompt), max_new=6)
  got = generate(tm, tparams, torch.from_numpy(prompt), max_new=6)
  assert got.dtype == torch.int32 and got.shape == (2, 12)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_param_count(arch):
  defs = build_model(TC.get_config(arch)).defs()
  want = j_build_model(JC.get_config(arch), tp=1).defs()
  assert tcommon.num_params(defs) == jcommon.num_params(want)
  shapes = jax.tree_util.tree_map(lambda d: tuple(d.shape), want,
                                  is_leaf=jcommon.is_param_def)
  assert jax.tree_util.tree_map(lambda d: tuple(d.shape), defs,
                                is_leaf=lambda d: isinstance(
                                    d, tcommon.ParamDef)) == shapes
  if arch == "granite_8b":
    assert tcommon.num_params(defs) == GRANITE_8B_PARAMS
