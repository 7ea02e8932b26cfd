"""The port's encdec and vlm families against the JAX package.

At the smoke sizes of ``seamless_m4t_medium`` (2 encoder and 2 decoder
layers, a 16-frame memory) and ``internvl2_26b`` (2 layers, 4 vision
embeddings): ``Model.forward`` with ``enc_frames`` / ``vision_embeds``,
``init_cache``, ``decode_step``, ``make_prefill`` and greedy ``generate``;
the two faults of the reference that these families reach, asserted as the
reference shows them (ROADMAP Queue 3): a non-causal chunked attention
attends the zero keys that pad a ragged memory (item 7), and decode never
sees the frontend (item 9: the cross cache stays zeros, vision embeddings
enter only the prefill), so prefill and decode agree only where the
frontend has no effect; and the parameter counts at full size.  Inputs are
numpy arrays made from a seed; the JAX weights are carried across by
``params_from_numpy``.

Tolerances (those of ``tests/test_torch_dense.py``): float32 rtol and atol
2e-4; bfloat16 rtol and atol 3e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.transformer import build_model as j_build_model  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.serve import generate, make_decode_step, make_prefill  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
ARCHS = ("seamless_m4t_medium", "internvl2_26b")
FULL_PARAMS = {"seamless_m4t_medium": 977_860_608,
               "internvl2_26b": 19_862_722_560}


def _rng(seed):
  return np.random.default_rng(seed)


def _f32(x):
  if isinstance(x, torch.Tensor):
    return x.float().numpy()
  return np.asarray(x, np.float32)


def _shapes(tree):
  return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


@functools.lru_cache(maxsize=None)
def _models(arch, dtype="float32"):
  """(jax model, port model, jax params, port params, jitted jax decode
  step) at the smoke size of ``arch``."""
  jcfg = JC.get_smoke_config(arch).scaled(dtype=dtype)
  tcfg = TC.get_smoke_config(arch).scaled(dtype=dtype)
  jm, tm = j_build_model(jcfg, tp=1), build_model(tcfg)
  params = jcommon.init_params(jm.defs(), jax.random.PRNGKey(0))
  tparams = tcommon.params_from_numpy(
      jax.tree_util.tree_map(np.asarray, params), device="cpu")
  return jm, tm, params, tparams, jax.jit(jm.decode_step)


@functools.lru_cache(maxsize=None)
def _jit_forward(arch, dtype="float32", kv_chunk=1024):
  jm = _models(arch, dtype)[0]
  return jax.jit(functools.partial(jm.forward, kv_chunk=kv_chunk))


def _batch(arch, b=2, s=8, frames=None, seed=1):
  """numpy batch: tokens [B,S], plus the frontend's stub output: 16 memory
  frames (``frames`` to choose) or 4 vision embeddings."""
  r = _rng(seed)
  batch = {"tokens": r.integers(0, 512, (b, s)).astype(np.int32)}
  if arch == "seamless_m4t_medium":
    batch["enc_frames"] = r.standard_normal(
        (b, frames or 16, 64)).astype(np.float32)
  else:
    batch["vision_embeds"] = r.standard_normal(
        (b, 4 if frames is None else frames, 64)).astype(np.float32)
  return batch


def _forwards(arch, batch, dtype="float32", kv_chunk=1024):
  """(reference logits, port logits) of ``forward`` on one numpy batch."""
  _, tm, params, tparams, _ = _models(arch, dtype)
  want, _ = _jit_forward(arch, dtype, kv_chunk)(
      params, {k: jnp.asarray(v) for k, v in batch.items()})
  got, aux = tm.forward(tparams, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                        kv_chunk=kv_chunk)
  assert float(aux) == 0.0
  return want, got


def _decode_last(arch, tokens, params=None):
  """(reference, port) last-position logits after decoding ``tokens``
  token by token from an empty cache (``params``: numpy weights to use)."""
  jm, tm, jp, tp, jstep = _models(arch)
  if params is not None:
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tcommon.params_from_numpy(params, device="cpu")
  b, s = tokens.shape
  jcache, tcache = jm.init_cache(b, s), tm.init_cache(b, s, device="cpu")
  for t in range(s):
    want, jcache = jstep(jp, jnp.asarray(tokens[:, t:t + 1]), jcache,
                         jnp.int32(t))
    got, tcache = tm.decode_step(tp, torch.from_numpy(tokens[:, t:t + 1]),
                                 tcache, t)
  return _f32(want)[:, -1], _f32(got)[:, -1]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
  batch = _batch(arch)
  want, got = _forwards(arch, batch)
  s = 8 + (4 if arch == "internvl2_26b" else 0)  # vision positions first
  assert got.shape == (2, s, 512) and got.dtype == torch.float32
  np.testing.assert_allclose(_f32(got), _f32(want), **F32)


def test_forward_bf16_matches_jax():
  """vlm in bfloat16, the whole model.  (encdec is compared block by block
  below: the reference's compiled layer scans round to bfloat16 at other
  places than its op-by-op run, 0.047 apart at the smoke size, where the
  port is 0.031 from the op-by-op run.)"""
  want, got = _forwards("internvl2_26b", _batch("internvl2_26b", seed=2),
                        "bfloat16")
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


@pytest.mark.parametrize("block", ["encoder", "cross"])
def test_encdec_blocks_bf16_match_jax(block):
  """An encoder layer (non-causal attention and SwiGLU) and a decoder
  layer's cross attention, in bfloat16, against the reference's code run
  op by op: its ``_attn_apply``/``_ffn_apply``, and for the cross block the
  body of its ``_encdec_forward`` (``src/repro/models/transformer.py``,
  the ``dec_block`` lines after the self attention)."""
  arch = "seamless_m4t_medium"
  jm, tm, params, tparams, _ = _models(arch, "bfloat16")
  jcfg, tcfg = jm.cfg, tm.cfg
  r = _rng(10)
  mem = r.standard_normal((2, 16, 64)).astype(np.float32)
  x = r.standard_normal((2, 8, 64)).astype(np.float32)
  jmem, tmem = jnp.asarray(mem, jnp.bfloat16), torch.from_numpy(mem).bfloat16()
  enc_pos = np.arange(16, dtype=np.int32)
  if block == "encoder":
    lp = jax.tree_util.tree_map(lambda t: t[1], params["encoder"])
    h = jtr._attn_apply(lp, jmem, jnp.asarray(enc_pos), jcfg, 1,
                        causal=False, kv_chunk=8)
    want, _ = jtr._ffn_apply(lp, h, jcfg)
    tlp = T._layer(tparams["encoder"], 1)
    h = T._attn_apply(tlp, tmem, torch.from_numpy(enc_pos), tcfg,
                      causal=False, kv_chunk=8)
    got, _ = T._ffn_apply(tlp, h, tcfg)
  else:
    lp = jax.tree_util.tree_map(lambda t: t[1], params["layers"])
    pos = np.arange(8, dtype=np.int32)
    jx = jnp.asarray(x, jnp.bfloat16)
    hn = jcommon.rms_norm(jx, lp["ln_x"], jcfg.norm_eps)
    q, _, _ = jattn.gqa_qkv(lp["xattn"], hn, jnp.asarray(pos), jcfg, 1)
    _, k, v = jattn.gqa_qkv(lp["xattn"], jmem, jnp.asarray(enc_pos), jcfg, 1)
    n_rep = jcfg.padded_heads(1) // jcfg.num_kv_heads
    k, v = jattn._repeat_kv(k, n_rep), jattn._repeat_kv(v, n_rep)
    o = jattn.chunked_attention(q, k, v, jnp.asarray(pos),
                                jnp.asarray(enc_pos), causal=False,
                                kv_chunk=8).reshape(2, 8, -1)
    want = jx + jnp.einsum("bsh,hd->bsd", o,
                           lp["xattn"]["wo"].astype(jnp.bfloat16))
    got = T._cross_attn(T._layer(tparams["layers"], 1),
                        torch.from_numpy(x).bfloat16(), tmem,
                        torch.from_numpy(pos), torch.from_numpy(enc_pos),
                        tcfg, 8)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_input_reaches_the_prefill(arch):
  """The memory or the image changes the logits (so the tests above
  compare a path that uses it)."""
  a, b = _batch(arch, seed=3), _batch(arch, seed=3)
  key = "enc_frames" if "enc_frames" in a else "vision_embeds"
  b[key] = b[key] * 2.0
  _, tm, _, tparams, _ = _models(arch)
  la = tm.forward(tparams, {k: torch.from_numpy(v) for k, v in a.items()})[0]
  lb = tm.forward(tparams, {k: torch.from_numpy(v) for k, v in b.items()})[0]
  assert (la - lb).abs().max() > 1e-2


def test_ragged_memory_matches_jax():
  """Queue 3 item 7: 13 memory frames at ``kv_chunk`` 4 pad the encoder's
  self attention and the cross attention with zero keys that no causal
  mask removes.  The port attends them as the reference does, so both
  differ from the unpadded run (``kv_chunk`` 16 holds all 13) by the same
  amount."""
  arch = "seamless_m4t_medium"
  batch = _batch(arch, frames=13, seed=4)
  want, got = _forwards(arch, batch, kv_chunk=4)
  np.testing.assert_allclose(_f32(got), _f32(want), **F32)
  want_whole, got_whole = _forwards(arch, batch, kv_chunk=16)
  np.testing.assert_allclose(_f32(got_whole), _f32(want_whole), **F32)
  gap = np.abs(_f32(got) - _f32(got_whole)).max()
  assert gap > 1e-2
  np.testing.assert_allclose(
      gap, np.abs(_f32(want) - _f32(want_whole)).max(), **F32)


def test_make_prefill_takes_the_frontend_keys():
  for arch in ARCHS:
    _, tm, _, tparams, _ = _models(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch, seed=5).items()}
    logits = make_prefill(tm)(tparams, batch)
    assert torch.equal(logits, tm.forward(tparams, batch)[0])
    assert logits.is_inference()


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_tree_matches_jax(arch):
  jm, tm, *_ = _models(arch)
  cache = tm.init_cache(2, 8, device="cpu")
  assert _shapes(cache) == _shapes(jm.init_cache(2, 8))
  if arch == "seamless_m4t_medium":
    assert cache["ck"].shape == (2, 2, 16, 2, 16)  # encoder_seq slots
  assert not any(t.any() for t in jax.tree_util.tree_leaves(cache))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
  """Every step's logits and the final cache, against the reference's
  decode over the same (for encdec: zero) cross cache."""
  jm, tm, params, tparams, jstep = _models(arch)
  toks = _batch(arch, s=8, seed=6)["tokens"]
  jcache = jm.init_cache(2, 8)
  tcache = tm.init_cache(2, 8, device="cpu")
  step = make_decode_step(tm)
  for t in range(8):
    want, jcache = jstep(params, jnp.asarray(toks[:, t:t + 1]), jcache,
                         jnp.int32(t))
    got, tcache = step(tparams, torch.from_numpy(toks[:, t:t + 1]), tcache,
                       torch.tensor(t, dtype=torch.int32))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
  assert _shapes(tcache) == _shapes(jcache)
  for name in tcache:
    np.testing.assert_allclose(_f32(tcache[name]), _f32(jcache[name]), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
  jm, tm, params, tparams, _ = _models(arch)
  prompt = _batch(arch, s=6, seed=7)["tokens"]
  want = jengine.generate(jm, params, jnp.asarray(prompt), max_new=6)
  got = generate(tm, tparams, torch.from_numpy(prompt), max_new=6)
  assert got.dtype == torch.int32 and got.shape == (2, 12)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_misses_the_frontend_as_in_jax(arch):
  """Queue 3 item 9: the prefill's last logits (with the memory or a
  4-embedding image) and those of decoding the same tokens differ, in the
  port by the reference's own gap."""
  batch = _batch(arch, seed=8)
  want_pre, got_pre = _forwards(arch, batch)
  want_dec, got_dec = _decode_last(arch, batch["tokens"])
  np.testing.assert_allclose(got_dec, want_dec, **F32)
  gap = np.abs(_f32(got_pre)[:, -1] - got_dec).max()
  want_gap = np.abs(_f32(want_pre)[:, -1] - want_dec).max()
  assert gap > 0.1 * np.abs(got_dec).max()
  np.testing.assert_allclose(gap, want_gap, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_where_the_frontend_has_no_effect(arch):
  """Prefill == decode, in float32, on the input where item 9 cannot show:
  encdec with every ``xattn.wo`` zeroed (a copy of the weights), vlm with
  no vision embeddings."""
  _, tm, params, tparams, _ = _models(arch)
  if arch == "seamless_m4t_medium":
    batch = _batch(arch, seed=9)
    npp = jax.tree_util.tree_map(np.asarray, params)
    npp["layers"]["xattn"]["wo"] = np.zeros_like(npp["layers"]["xattn"]["wo"])
    tparams = tcommon.params_from_numpy(npp, device="cpu")
  else:
    npp = None
    batch = _batch(arch, frames=0, seed=9)
  pre = tm.forward(tparams, {k: torch.from_numpy(v)
                             for k, v in batch.items()})[0]
  _, dec = _decode_last(arch, batch["tokens"], npp)
  np.testing.assert_allclose(dec, _f32(pre)[:, -1], **F32)


# ---------------------------------------------------------------------------
# Full size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_count(arch):
  defs = build_model(TC.get_config(arch)).defs()
  want = j_build_model(JC.get_config(arch), tp=1).defs()
  assert tcommon.num_params(defs) == FULL_PARAMS[arch] == \
      jcommon.num_params(want)
  assert jax.tree_util.tree_map(
      lambda d: (tuple(d.shape), d.init), defs,
      is_leaf=lambda d: isinstance(d, tcommon.ParamDef)) == \
      jax.tree_util.tree_map(lambda d: (tuple(d.shape), d.init), want,
                             is_leaf=jcommon.is_param_def)
