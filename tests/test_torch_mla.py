"""The port's multi-head latent attention (MLA, DeepSeek-V2) against the JAX
package.

``mla_defs``, the query and latent projections, ``mla_forward`` (causal
and not, a ragged KV tail included) and the weight-absorbed ``mla_decode``
over several positions of the compressed cache, pos = T included (the
reference's ``dynamic_update_slice`` clamps the write to slot T-1), at the
smoke size of ``deepseek_v2_236b``; and a dense config with
``use_mla=True`` through ``build_model``, ``forward`` and ``decode_step``.
The JAX weights are carried across by ``params_from_numpy``.

Tolerances (those of ``tests/test_torch_dense.py``): float32 rtol and atol
2e-4; bfloat16 rtol and atol 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.transformer import build_model as j_build_model  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _rng(seed):
  return np.random.default_rng(seed)


def _f32(x):
  if isinstance(x, torch.Tensor):
    return x.float().numpy()
  return np.asarray(x, np.float32)


def _mla(dtype="float32", arch="deepseek_v2_236b", **over):
  jcfg = JC.get_smoke_config(arch).scaled(dtype=dtype, **over)
  tcfg = TC.get_smoke_config(arch).scaled(dtype=dtype, **over)
  params = jcommon.init_params(jattn.mla_defs(jcfg, 1), jax.random.PRNGKey(0))
  params = jax.tree_util.tree_map(np.asarray, params)
  # The norms' gains are drawn away from 1, so that a swap would show.
  for i, name in enumerate(("q_norm", "kv_norm")):
    params[name] = 1 + 0.3 * _rng(40 + i).standard_normal(
        params[name].shape).astype(np.float32)
  return jcfg, tcfg, params, tcommon.params_from_numpy(params, device="cpu")


def test_mla_defs_match_jax():
  jcfg, tcfg, _, _ = _mla()
  want = {k: d.shape for k, d in jattn.mla_defs(jcfg, 1).items()}
  got = {k: d.shape for k, d in tattn.mla_defs(tcfg).items()}
  assert got == want
  assert tattn.mla_defs(tcfg)["q_norm"].init == "ones"


def test_mla_projections_match_jax():
  jcfg, tcfg, params, tparams = _mla()
  x = _rng(1).standard_normal((2, 7, 64)).astype(np.float32)
  pos = np.arange(3, 10, dtype=np.int32)
  for got, want in zip(
      tattn._mla_q(tparams, torch.from_numpy(x), torch.from_numpy(pos), tcfg)
      + tattn._mla_ckv(tparams, torch.from_numpy(x), torch.from_numpy(pos),
                       tcfg),
      jattn._mla_q(params, jnp.asarray(x), jnp.asarray(pos), jcfg, 1)
      + jattn._mla_ckv(params, jnp.asarray(x), jnp.asarray(pos), jcfg)):
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,chunk", [(12, 4), (10, 16)],
                         ids=["chunked", "one_chunk"])
def test_mla_forward_matches_jax(causal, s, chunk):
  jcfg, tcfg, params, tparams = _mla()
  x = _rng(2).standard_normal((2, s, 64)).astype(np.float32)
  pos = np.arange(s, dtype=np.int32)
  want = jattn.mla_forward(params, jnp.asarray(x), jnp.asarray(pos), jcfg, 1,
                           causal=causal, kv_chunk=chunk)
  got = tattn.mla_forward(tparams, torch.from_numpy(x), torch.from_numpy(pos),
                          tcfg, causal=causal, kv_chunk=chunk)
  assert got.shape == (2, s, 64)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_mla_forward_bf16_matches_jax():
  jcfg, tcfg, params, tparams = _mla("bfloat16")
  x = _rng(3).standard_normal((2, 16, 64)).astype(np.float32)
  pos = np.arange(16, dtype=np.int32)
  want = jattn.mla_forward(params, jnp.asarray(x).astype(jnp.bfloat16),
                           jnp.asarray(pos), jcfg, 1, kv_chunk=8)
  got = tattn.mla_forward(tparams, torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(pos), tcfg, kv_chunk=8)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(dtype):
  """Positions 0..T-1 of a T = 6 cache, then T and T + 2: the reference
  clamps those writes to slot T-1 and attends every slot."""
  jcfg, tcfg, params, tparams = _mla(dtype)
  jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
  tol = F32 if dtype == "float32" else BF16
  t = 6
  r, dr = tcfg.kv_lora_rank, tcfg.qk_rope_head_dim
  jc = {"c_kv": jnp.zeros((2, t, r), jdt), "k_rope": jnp.zeros((2, t, dr), jdt)}
  tc = {"c_kv": torch.zeros((2, t, r), dtype=tdt),
        "k_rope": torch.zeros((2, t, dr), dtype=tdt)}
  x = _rng(4).standard_normal((2, t + 3, 1, 64)).astype(np.float32)
  for p in list(range(t)) + [t, t + 2]:
    want, jc = jattn.mla_decode(params, jnp.asarray(x[:, p]).astype(jdt), jc,
                                jnp.int32(p), jcfg, 1)
    old = {k: v.clone() for k, v in tc.items()}
    got, tc2 = tattn.mla_decode(tparams, torch.from_numpy(x[:, p]).to(tdt),
                                tc, p, tcfg)
    assert all(torch.equal(old[k], tc[k]) for k in tc)   # the old cache kept
    tc = tc2
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    for k in tc:
      np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), **tol)
  # The last write went to slot T-1.
  c_last, _ = tattn._mla_ckv(tparams, torch.from_numpy(x[:, t + 2]).to(tdt),
                             torch.tensor([t + 2], dtype=torch.int32), tcfg)
  assert torch.equal(tc["c_kv"][:, t - 1], c_last[:, 0])


def test_mla_decode_matches_prefill():
  """Absorbed decode over the latent cache == the decompressing prefill,
  within the port."""
  _, tcfg, _, tparams = _mla()
  s = 9
  x = torch.from_numpy(_rng(5).standard_normal((2, s, 64)).astype(np.float32))
  full = tattn.mla_forward(tparams, x, torch.arange(s, dtype=torch.int32),
                           tcfg, kv_chunk=4)
  cache = {"c_kv": torch.zeros((2, s, tcfg.kv_lora_rank)),
           "k_rope": torch.zeros((2, s, tcfg.qk_rope_head_dim))}
  outs = []
  for p in range(s):
    o, cache = tattn.mla_decode(tparams, x[:, p:p + 1], cache, p, tcfg)
    outs.append(o)
  torch.testing.assert_close(torch.cat(outs, dim=1), full, **F32)


def test_dense_mla_model_matches_jax():
  """A dense config with latent attention builds, and its forward and
  decode steps (MLA cache) match the reference's."""
  jcfg = JC.get_smoke_config("granite_8b").scaled(
      use_mla=True, kv_lora_rank=16, q_lora_rank=24, qk_nope_head_dim=16,
      qk_rope_head_dim=8, v_head_dim=16)
  tcfg = TC.get_smoke_config("granite_8b").scaled(
      use_mla=True, kv_lora_rank=16, q_lora_rank=24, qk_nope_head_dim=16,
      qk_rope_head_dim=8, v_head_dim=16)
  jm, tm = j_build_model(jcfg, tp=1), build_model(tcfg)
  params = jcommon.init_params(jm.defs(), jax.random.PRNGKey(2))
  tparams = tcommon.params_from_numpy(
      jax.tree_util.tree_map(np.asarray, params), device="cpu")
  assert "wkv_a" in tparams["layers"]["attn"] and "mlp" in tparams["layers"]
  toks = _rng(6).integers(0, 512, (2, 7)).astype(np.int32)
  want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)}, kv_chunk=4)
  got, aux = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                        kv_chunk=4)
  assert float(aux) == 0.0
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
  jcache = jm.init_cache(2, 7)
  cache = tm.init_cache(2, 7, device="cpu")
  assert {k: tuple(v.shape) for k, v in cache.items()} == {
      k: v.shape for k, v in jcache.items()} == {
          "c_kv": (2, 2, 7, 16), "k_rope": (2, 2, 7, 8)}
  jstep = jax.jit(jm.decode_step)
  for p in range(7):
    want, jcache = jstep(params, jnp.asarray(toks[:, p:p + 1]), jcache,
                         jnp.int32(p))
    got, cache = tm.decode_step(tparams, torch.from_numpy(toks[:, p:p + 1]),
                                cache, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
