"""Grouped-query attention (+QKV bias, +sliding window) and multi-head
latent attention (MLA, DeepSeek-V2): the port of :mod:`repro.models.attention`.

Sequence-level attention is the reference's **chunked online softmax**: a
loop over KV chunks with a running (max, denominator, accumulator) in
float32, written as torch ops, one chunk at a time.  Every chunk is
computed, the fully masked ones too, as in the reference.  GQA decode
attends over a ring-buffer cache without repeating the KV heads; MLA
decode attends over the compressed latent cache with the up-projections
absorbed into the query and the output.

Sharding, as in the reference: Q heads are padded to a multiple of the
tensor-parallel degree ``tp`` (``cfg.padded_heads(tp)``; at ``tp=1`` the
published head count) and sharded on "model"; KV projections whose head
count does not divide ``tp`` stay replicated.  With DTensor parameters the
ops below run sharded as DTensor propagates their placements; the chunked
attention (per batch × head shard), the decode cache's slot write and,
where the cache is split over its slots (the ``"seq"`` layout), the decode
attention run per shard through ``local_map``
(:mod:`repro_torch.models.sharding`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import sharding as shd
from repro_torch.models.common import (P, ParamDef, apply_rope,
                                       out_proj_einsum, rms_norm, whole_on)
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

NEG_INF = -1e30
MASKED_POS = 2**30   # the position of a padded or unwritten key: never attended


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------


def causal_swa_mask(q_pos: Tensor, k_pos: Tensor, window: int,
                    causal: bool = True) -> Tensor:
  """bool[..., Q, K]: True = attend.  window=0 -> plain causal (or full)."""
  q = q_pos[..., :, None]
  k = k_pos[..., None, :]
  ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                  device=q.device)
  if causal:
    ok = ok & (k <= q)
  if window > 0:
    ok = ok & (k > q - window)
  return ok


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention core
# ---------------------------------------------------------------------------


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                      k_pos: Tensor, *, window: int = 0, causal: bool = True,
                      kv_chunk: int = 1024, scale: Optional[float] = None
                      ) -> Tensor:
  """q [B,S,H,D], k/v [B,T,H,D] (already head-aligned) -> [B,S,H,D].

  Online softmax over KV chunks of ``kv_chunk`` keys; equal, up to float
  rounding, to softmax(QKᵀ)V with the causal/SWA mask applied.  A ragged
  tail is padded with keys at position ``MASKED_POS``.  On DTensors it
  runs per (batch shard × head shard) (``sharding.per_head``).
  """
  return shd.per_head(_chunked_attention, q, k, v, q_pos, k_pos,
                      window=window, causal=causal, kv_chunk=kv_chunk,
                      scale=scale)


def _chunked_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                       k_pos: Tensor, *, window: int, causal: bool,
                       kv_chunk: int, scale: Optional[float]) -> Tensor:
  b, s, h, d = q.shape
  t = k.shape[1]
  scale = scale if scale is not None else 1.0 / math.sqrt(d)
  kv_chunk = min(kv_chunk, t)
  if t % kv_chunk:
    pad = kv_chunk - t % kv_chunk
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=MASKED_POS)
    t += pad

  qf = (q * scale).float()
  m = torch.full((b, s, h), NEG_INF, dtype=torch.float32, device=q.device)
  l = torch.zeros((b, s, h), dtype=torch.float32, device=q.device)
  acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
  for lo in range(0, t, kv_chunk):
    kb = k[:, lo:lo + kv_chunk].float()                  # [B,C,H,D]
    vb = v[:, lo:lo + kv_chunk].float()
    sc = torch.einsum("bshd,bchd->bshc", qf, kb)
    mask = causal_swa_mask(q_pos, k_pos[lo:lo + kv_chunk], window, causal)
    sc = torch.where(mask[None, :, None, :], sc, NEG_INF)  # [B,S,H,C]
    m_new = torch.maximum(m, sc.amax(dim=-1))
    p = torch.exp(sc - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bshc,bchd->bshd", p, vb)
    m = m_new
  out = acc / torch.clamp(l[..., None], min=1e-30)
  return out.to(q.dtype)


def dense_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                    k_pos: Tensor, *, window: int = 0, causal: bool = True,
                    scale: Optional[float] = None) -> Tensor:
  """Unchunked reference (S small)."""
  d = q.shape[-1]
  scale = scale if scale is not None else 1.0 / math.sqrt(d)
  sc = torch.einsum("bshd,bthd->bsht", (q * scale).float(), k.float())
  mask = causal_swa_mask(q_pos, k_pos, window, causal)
  sc = torch.where(mask[None, :, None, :], sc, NEG_INF)
  p = torch.softmax(sc, dim=-1)
  out = torch.einsum("bsht,bthd->bshd", p, v.float())
  return out.to(q.dtype)


def _repeat_kv(x: Tensor, n_rep: int) -> Tensor:
  """[B,T,KV,D] -> [B,T,KV*n_rep,D] (GQA head alignment)."""
  if n_rep == 1:
    return x
  b, t, kv, d = x.shape
  return x[:, :, :, None, :].expand(b, t, kv, n_rep, d).reshape(
      b, t, kv * n_rep, d)


def grouped_decode_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                             k_pos: Tensor, *, window: int = 0,
                             scale: Optional[float] = None) -> Tensor:
  """GQA decode without repeating the KV heads.

  q [B,1,Hp,D] with Hp = KV·G; k/v [B,T,KV,D] in the cache dtype.  Both
  products accumulate in float32 from the cache's values, as the
  reference's ``preferred_element_type=float32`` does: the operands are
  widened (exactly) before the product.  Returns [B,1,Hp,D].
  """
  b, s, hp, d = q.shape
  kv = k.shape[2]
  g = hp // kv
  scale = scale if scale is not None else 1.0 / math.sqrt(d)
  qg = (q * scale).reshape(b, s, kv, g, d)
  sc = torch.einsum("bskgd,btkd->bskgt", qg.float(), k.float())
  mask = causal_swa_mask(q_pos, k_pos, window, True)          # [1, T]
  sc = torch.where(mask[None, :, None, None, :], sc, NEG_INF)
  p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
  l = p.sum(dim=-1, keepdim=True)
  p = (p / torch.clamp(l, min=1e-30)).to(v.dtype)
  ctx = torch.einsum("bskgt,btkd->bskgd", p.float(), v.float())
  return ctx.reshape(b, s, hp, d).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def gqa_defs(cfg: ModelConfig, tp: int = 1) -> Dict[str, ParamDef]:
  d, hd = cfg.d_model, cfg.resolved_head_dim
  hp = cfg.padded_heads(tp)
  kv = cfg.num_kv_heads
  kv_shardable = kv % tp == 0
  kv_spec = P(None, "model") if kv_shardable else P(None, None)
  defs = {
      "wq": ParamDef((d, hp * hd), P(None, "model")),
      "wk": ParamDef((d, kv * hd), kv_spec),
      "wv": ParamDef((d, kv * hd), kv_spec),
      "wo": ParamDef((hp * hd, d), P("model", None)),
  }
  if cfg.qkv_bias:
    kv_bias_spec = P("model") if kv_shardable else P(None)
    defs["bq"] = ParamDef((hp * hd,), P("model"), init="zeros")
    defs["bk"] = ParamDef((kv * hd,), kv_bias_spec, init="zeros")
    defs["bv"] = ParamDef((kv * hd,), kv_bias_spec, init="zeros")
  return defs


def gqa_qkv(params, x: Tensor, positions: Tensor, cfg: ModelConfig,
            tp: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
  """Project + rope.  x [B,S,d] -> q [B,S,Hp,hd], k/v [B,S,KV,hd]."""
  b, s, _ = x.shape
  hd = cfg.resolved_head_dim
  hp = cfg.padded_heads(tp)
  kv = cfg.num_kv_heads
  cd = cfg.compute_dtype
  q = torch.matmul(x, params["wq"].to(cd))
  k = torch.matmul(x, params["wk"].to(cd))
  v = torch.matmul(x, params["wv"].to(cd))
  if cfg.qkv_bias:
    q = q + params["bq"].to(cd)
    k = k + params["bk"].to(cd)
    v = v + params["bv"].to(cd)
  if kv % tp:
    # KV heads that do not divide the tensor axis stay whole on it, as
    # their replicated weights say (DTensor may pick a column split).
    k, v = whole_on(k, "model"), whole_on(v, "model")
  q = apply_rope(q.reshape(b, s, hp, hd), positions, cfg.rope_theta)
  k = apply_rope(k.reshape(b, s, kv, hd), positions, cfg.rope_theta)
  return q, k, v.reshape(b, s, kv, hd)


def gqa_forward(params, x: Tensor, positions: Tensor, cfg: ModelConfig,
                tp: int = 1, *, causal: bool = True, kv_chunk: int = 1024
                ) -> Tensor:
  """Full-sequence GQA attention (prefill)."""
  q, k, v = gqa_qkv(params, x, positions, cfg, tp)
  n_rep = cfg.padded_heads(tp) // cfg.num_kv_heads
  k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
  out = chunked_attention(q, k, v, positions, positions,
                          window=cfg.sliding_window, causal=causal,
                          kv_chunk=kv_chunk)
  b, s = x.shape[:2]
  return out_proj_einsum("bsh,hd->bsd", out.reshape(b, s, -1), params["wo"],
                         cfg)


def gqa_decode(params, x: Tensor, cache: Dict[str, Tensor], pos,
               cfg: ModelConfig, tp: int = 1
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
  """One-token decode.  x [B,1,d]; cache {"k","v": [B,T,KV,hd]}; ``pos``
  the token's position, a Python int or a 0-d tensor (the same slot and
  mask either way).

  The cache is a **ring buffer**: slot = pos mod T.  With T = max_seq it
  is the plain append cache; with T = sliding_window it holds exactly the
  window.  Slot positions are recovered as p(s) = pos − ((pos − s) mod T);
  a negative one has not been written yet and is masked.  The cache passed
  in is left as it was.

  Returns (out [B,1,d], updated cache)."""
  pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
  positions = pos.reshape(1)
  q, k, v = gqa_qkv(params, x, positions, cfg, tp)
  t = cache["k"].shape[1]
  slot = torch.remainder(positions, t).long()
  ck = shd.write_slot(cache["k"], slot, k)
  cv = shd.write_slot(cache["v"], slot, v)
  if shd.is_split(ck, 1):
    out = shd.slot_sharded_decode_attention(q, ck, cv, pos,
                                            window=cfg.sliding_window)
  else:
    s_idx = torch.arange(t, dtype=torch.int32, device=x.device)
    k_pos = pos - torch.remainder(pos - s_idx, t)
    k_pos = torch.where(k_pos >= 0, k_pos, MASKED_POS)
    out = grouped_decode_attention(q, ck, cv, positions, k_pos,
                                   window=cfg.sliding_window)
  out = out_proj_einsum("bsh,hd->bsd", out.reshape(x.shape[0], 1, -1),
                        params["wo"], cfg)
  return out, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention, DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_defs(cfg: ModelConfig, tp: int = 1) -> Dict[str, ParamDef]:
  d = cfg.d_model
  hp = cfg.padded_heads(tp)
  qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
  return {
      "wq_a": ParamDef((d, cfg.q_lora_rank), P(None, None)),
      "q_norm": ParamDef((cfg.q_lora_rank,), P(None), init="ones"),
      "wq_b": ParamDef((cfg.q_lora_rank, hp * qk), P(None, "model")),
      "wkv_a": ParamDef((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                        P(None, None)),
      "kv_norm": ParamDef((cfg.kv_lora_rank,), P(None), init="ones"),
      "wk_b": ParamDef((cfg.kv_lora_rank, hp * cfg.qk_nope_head_dim),
                       P(None, "model")),
      "wv_b": ParamDef((cfg.kv_lora_rank, hp * cfg.v_head_dim),
                       P(None, "model")),
      "wo": ParamDef((hp * cfg.v_head_dim, d), P("model", None)),
  }


def _mla_q(params, x: Tensor, positions: Tensor, cfg: ModelConfig,
           tp: int = 1) -> Tuple[Tensor, Tensor]:
  """x [B,S,d] -> (q_nope [B,S,H,nope], roped q_rope [B,S,H,rope])."""
  cd = cfg.compute_dtype
  b, s, _ = x.shape
  nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
  ql = torch.matmul(x, params["wq_a"].to(cd))
  ql = rms_norm(ql, params["q_norm"], cfg.norm_eps)
  q = torch.matmul(ql, params["wq_b"].to(cd))
  q = q.reshape(b, s, cfg.padded_heads(tp), nope + rope_d)
  q_nope, q_rope = q[..., :nope], q[..., nope:]
  return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(params, x: Tensor, positions: Tensor, cfg: ModelConfig
             ) -> Tuple[Tensor, Tensor]:
  """x [B,S,d] -> (c_kv [B,S,R] normed, k_rope [B,S,rope] roped): the
  latent that the decode cache keeps."""
  kv = torch.matmul(x, params["wkv_a"].to(cfg.compute_dtype))
  c_kv, k_rope = kv[..., :cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
  c_kv = rms_norm(c_kv, params["kv_norm"], cfg.norm_eps)
  k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
  return c_kv, k_rope[:, :, 0, :]


def mla_forward(params, x: Tensor, positions: Tensor, cfg: ModelConfig,
                tp: int = 1, *, causal: bool = True, kv_chunk: int = 1024
                ) -> Tensor:
  """Full-sequence MLA (prefill): decompress K and V from the latent, join
  the nope and rope parts into one score space, pad V to the QK head
  dimension for the shared chunked attention, and slice the output back
  to ``v_head_dim``."""
  cd = cfg.compute_dtype
  b, s, _ = x.shape
  hp = cfg.padded_heads(tp)
  nope, rope_d, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
  q_nope, q_rope = _mla_q(params, x, positions, cfg, tp)
  c_kv, k_rope = _mla_ckv(params, x, positions, cfg)
  k_nope = torch.matmul(c_kv, params["wk_b"].to(cd)).reshape(b, s, hp, nope)
  v = torch.matmul(c_kv, params["wv_b"].to(cd)).reshape(b, s, hp, vd)
  q = torch.cat([q_nope, q_rope], dim=-1)
  k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, hp, rope_d)],
                dim=-1)
  v_p = torch.nn.functional.pad(v, (0, q.shape[-1] - vd))
  out = chunked_attention(q, k, v_p, positions, positions, causal=causal,
                          kv_chunk=kv_chunk,
                          scale=1.0 / math.sqrt(nope + rope_d))[..., :vd]
  return out_proj_einsum("bsh,hd->bsd", out.reshape(b, s, hp * vd),
                         params["wo"], cfg)


def mla_decode(params, x: Tensor, cache: Dict[str, Tensor], pos,
               cfg: ModelConfig, tp: int = 1
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
  """Weight-absorbed MLA decode over the *compressed* cache.

  cache: {"c_kv": [B,T,R], "k_rope": [B,T,Dr]} — the MLA memory win.
  score = q_nopeᵀ·(Wk_b c) + q_ropeᵀ·k_rope = (Wk_bᵀ q_nope)ᵀ·c + …, in
  float32 from the compute-dtype weights, as in the reference.  The cache
  is not a ring: the token goes to slot ``pos`` clamped into [0, T-1] (the
  reference's ``dynamic_update_slice`` clamps its start), and every slot
  at a position ≤ ``pos`` is attended.  The cache passed in is left as it
  was.  Returns (out [B,1,d], updated cache)."""
  cd = cfg.compute_dtype
  b = x.shape[0]
  hp = cfg.padded_heads(tp)
  nope, vd, r = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
  pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
  positions = pos.reshape(1)
  q_nope, q_rope = _mla_q(params, x, positions, cfg, tp)       # [B,1,H,*]
  c_kv, k_rope = _mla_ckv(params, x, positions, cfg)           # [B,1,*]
  t = cache["c_kv"].shape[1]
  slot = torch.clamp(positions, 0, t - 1).long()
  cc = shd.write_slot(cache["c_kv"], slot, c_kv)
  cr = shd.write_slot(cache["k_rope"], slot, k_rope)
  wk_b = params["wk_b"].to(cd).reshape(r, hp, nope).float()
  q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(), wk_b)  # [B,1,H,R]
  scale = 1.0 / math.sqrt(nope + cfg.qk_rope_head_dim)
  sc = (torch.einsum("bshr,btr->bsht", q_abs, cc.float())
        + torch.einsum("bshd,btd->bsht", q_rope.float(), cr.float())) * scale
  k_pos = torch.arange(t, dtype=torch.int32, device=x.device)
  mask = causal_swa_mask(positions, k_pos, 0, True)
  sc = torch.where(mask[None, :, None, :], sc, NEG_INF)
  p = torch.softmax(sc, dim=-1)
  ctx = torch.einsum("bsht,btr->bshr", p, cc.float())          # [B,1,H,R]
  wv_b = params["wv_b"].to(cd).reshape(r, hp, vd).float()
  out = torch.einsum("bshr,rhv->bshv", ctx, wv_b)
  out = out.reshape(b, 1, hp * vd).to(cd)
  out = out_proj_einsum("bsh,hd->bsd", out, params["wo"], cfg)
  return out, {"c_kv": cc, "k_rope": cr}
