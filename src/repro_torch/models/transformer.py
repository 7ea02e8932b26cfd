"""Model assembly for all six families: ``"dense"`` (GQA or MLA decoder),
``"moe"`` (GQA or MLA attention + routed experts), ``"ssm"`` (Mamba-1),
``"hybrid"`` (Mamba-2 + one weight-shared attention block, Zamba-2 style),
``"encdec"`` (a non-causal encoder over stub frontend frames + a decoder
with cross attention) and ``"vlm"`` (the dense decoder behind precomputed
vision embeddings).

The port of :mod:`repro.models.transformer`.  Layer parameters keep the
reference's stacked axes (``[num_layers, ...]``; the hybrid's segments
``[seg, per, ...]``); the reference's ``lax.scan`` over them becomes a
Python loop over the leading axis.  Under autograd each layer of that loop
is rematerialized as ``cfg.remat`` says (:func:`_remat`); with grad off
(serving) the layers run as they are.

The public surface is :class:`Model` (closures over config, the
tensor-parallel degree ``tp`` and the data mesh axes ``dp_spec``):
  * ``defs()``            — nested ParamDef tree (partition specs included)
  * ``forward``           — full-sequence logits (+ the MoE aux loss)
  * ``init_cache``        — decode-state tree of zeros (meta tensors when
                            ``abstract``)
  * ``decode_step``       — one-token serving step

Sharded, the parameters are DTensors placed by their specs
(:func:`repro_torch.models.common.param_shardings`) and the batch or cache
DTensors placed by :mod:`repro_torch.launch.specs`; ``forward`` and
``decode_step`` then run the same code under DTensor's
``implicit_replication`` (a plain tensor they make, a position or a mask,
is replicated), with the reference's activation constraints
(:meth:`Model._constrain`).  ``tp=1, dp_spec=None`` on plain tensors is the
unsharded model, op for op.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffnlib
from repro_torch.models import moe as moelib
from repro_torch.models import ssm as ssmlib
from repro_torch.models import sharding as shd
from repro_torch.models.common import (P, ParamDef, embed_lookup,
                                       out_proj_einsum, rms_norm,
                                       sharded_context, unembed)
from repro_torch.models.config import ModelConfig

PyTree = Any
Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Stacking helpers
# ---------------------------------------------------------------------------


def stack_defs(defs: PyTree, n: int) -> PyTree:
  """Prepend a layer axis of size n to every ParamDef (replicated spec)."""
  return tree_map(lambda d: ParamDef((n,) + d.shape, P(None, *d.pspec),
                                     d.dtype, d.init, d.scale), defs)


def _layer(stacked: PyTree, i: int) -> PyTree:
  return tree_map(lambda t: t[i], stacked)


def _layer_params(stacked_params: PyTree, i: int) -> PyTree:
  """Layer ``i``'s parameters, FSDP-gathered (``sharding.unshard_data``)."""
  return tree_map(lambda t: shd.unshard_data(t[i]), stacked_params)


def _unshard_data(params: PyTree) -> PyTree:
  """The parameters outside the layer stacks, FSDP-gathered."""
  return {k: v if k in _STACKS else tree_map(shd.unshard_data, v)
          for k, v in params.items()}


_STACKS = ("layers", "segments", "tail", "encoder")


def _stack(*slices: Tensor) -> Tensor:
  return torch.stack(slices)


def _depth(stacked: PyTree) -> int:
  """The leading axis of a stack: its layer (or segment) count."""
  return tree_leaves(stacked)[0].shape[0]


def _save_weight_products(ctx, op, *args, **kwargs):
  """The selective remat policy, JAX's ``dots_with_no_batch_dims_saveable``:
  keep the products with no batch dimension (the weight projections), and
  recompute the rest.  ``torch.matmul`` of activations by a weight lowers to
  ``aten.mm``; ``torch.einsum`` lowers a product with no batch dimension
  (``"bsh,hd->bsd"``) to an ``aten.bmm`` over a batch of one, and one with
  batch dimensions (attention's ``bhqd,bhkd``, the experts') to a wider
  ``bmm``."""
  if op is torch.ops.aten.mm.default or (
      op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
    return ckpt.CheckpointPolicy.MUST_SAVE
  return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
  """``fn`` rematerialized under autograd, as the reference's ``_remat``:
  ``"full"`` saves only the layer's inputs and recomputes the layer in the
  backward pass, ``"selective"`` also saves its weight products; ``"none"``,
  or grad off, runs ``fn`` as it is.  The layers draw no random numbers, so
  the RNG state is not saved for the recomputation."""
  if remat == "none" or not torch.is_grad_enabled():
    return fn
  fn = _replicating(fn)
  if remat == "full":
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)
  if remat == "selective":
    return functools.partial(
        ckpt.checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
        context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     _save_weight_products))
  raise ValueError(f"remat {remat!r}: expected none, full or selective")


def _replicating(fn):
  """``fn(layer_params, ...)`` under :func:`sharded_context` of its layer
  parameters: the recomputation in the backward pass runs outside the
  forward's context, and needs it again on DTensors."""
  def run(lp, *rest):
    with sharded_context(lp):
      return fn(lp, *rest)
  return run


def scan_layers(stacked_params: PyTree, x: Tensor,
                fn: Callable[[PyTree, Tensor], Tuple[Tensor, Any]],
                remat: str = "none") -> Tuple[Tensor, Tensor]:
  """fn(layer_params, x) -> (x', aux_scalar), over the stack's leading
  axis, each layer rematerialized as ``remat`` says (:func:`_remat`).
  Returns (x, Σaux)."""
  body = _remat(fn, remat)
  aux = torch.zeros((), dtype=torch.float32, device=x.device)
  for i in range(_depth(stacked_params)):
    x, a = body(_layer_params(stacked_params, i), x)
    aux = aux + a
  return x, aux


def scan_layers_cache(stacked_params: PyTree, cache: PyTree, x: Tensor,
                      fn) -> Tuple[Tensor, PyTree]:
  """Decode variant: fn(layer_params, cache_slice, x) -> (x', cache_slice'),
  over the stack's leading axis.  Returns a new stacked cache; the one
  passed in is left as it was."""
  slices = []
  for i in range(_depth(stacked_params)):
    x, c = fn(_layer_params(stacked_params, i), _layer(cache, i), x)
    slices.append(c)
  return x, tree_map(_stack, *slices)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _norm_def(cfg: ModelConfig) -> ParamDef:
  return ParamDef((cfg.d_model,), P(None), init="ones")


def _attn_block_defs(cfg: ModelConfig, tp: int = 1) -> Dict[str, Any]:
  a = attn.mla_defs(cfg, tp) if cfg.use_mla else attn.gqa_defs(cfg, tp)
  return {"ln1": _norm_def(cfg), "attn": a}


def _attn_apply(params, x, positions, cfg, tp=1, *, causal=True,
                kv_chunk=1024):
  h = rms_norm(x, params["ln1"], cfg.norm_eps)
  fwd = attn.mla_forward if cfg.use_mla else attn.gqa_forward
  return x + fwd(params["attn"], h, positions, cfg, tp, causal=causal,
                 kv_chunk=kv_chunk)


def _attn_apply_decode(params, x, cache, pos, cfg, tp=1):
  h = rms_norm(x, params["ln1"], cfg.norm_eps)
  dec = attn.mla_decode if cfg.use_mla else attn.gqa_decode
  out, cache = dec(params["attn"], h, cache, pos, cfg, tp)
  return x + out, cache


def _ffn_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
  if cfg.family == "moe":
    return {"ln2": _norm_def(cfg), "moe": moelib.moe_defs(cfg)}
  return {"ln2": _norm_def(cfg),
          "mlp": ffnlib.swiglu_defs(cfg.d_model, cfg.d_ff)}


def _ffn_apply(params, x, cfg, dp_spec=None):
  """Returns (x + the block's output, aux): the MoE load-balancing loss of
  router logits in the compute dtype, or 0.0."""
  h = rms_norm(x, params["ln2"], cfg.norm_eps)
  if cfg.family != "moe":
    return x + ffnlib.swiglu(params["mlp"], h, cfg), 0.0
  mp = params["moe"]
  logits = torch.matmul(h, mp["router"].to(cfg.compute_dtype))
  aux = moelib.moe_aux_loss(logits, cfg.top_k, cfg.num_experts)
  out = moelib.moe_forward(mp, h, cfg, group_size=cfg.moe_group_size,
                           dp_spec=dp_spec, moe_impl=cfg.moe_impl)
  return x + out, aux


def _cross_attn(params, h: Tensor, mem: Tensor, positions: Tensor,
                enc_pos: Tensor, cfg: ModelConfig, kv_chunk: int,
                tp: int = 1) -> Tensor:
  """The encdec decoder's cross attention block (prefill): q from the
  decoder, k and v from the encoder memory (both roped at their own
  positions), non-causal."""
  hn = rms_norm(h, params["ln_x"], cfg.norm_eps)
  xp = params["xattn"]
  q, _, _ = attn.gqa_qkv(xp, hn, positions, cfg, tp)
  _, k, v = attn.gqa_qkv(xp, mem, enc_pos, cfg, tp)
  n_rep = cfg.padded_heads(tp) // cfg.num_kv_heads
  k, v = attn._repeat_kv(k, n_rep), attn._repeat_kv(v, n_rep)
  o = attn.chunked_attention(q, k, v, positions, enc_pos, causal=False,
                             kv_chunk=kv_chunk)
  return h + out_proj_einsum("bsh,hd->bsd", o.reshape(h.shape[0], h.shape[1],
                                                      -1), xp["wo"], cfg)


# ---------------------------------------------------------------------------
# Model container
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Model:
  cfg: ModelConfig
  tp: int = 1
  dp_spec: Any = None  # data mesh axes ("data" or ("pod","data")) or None

  # ---------------- defs ----------------

  def defs(self) -> PyTree:
    cfg, tp = self.cfg, self.tp
    vpad = cfg.padded_vocab(tp)
    d = {"embed": ParamDef((vpad, cfg.d_model), P("model", None), scale=0.02),
         "ln_f": _norm_def(cfg)}
    if not cfg.tie_embeddings:
      d["lm_head"] = ParamDef((cfg.d_model, vpad), P(None, "model"))
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
      layer = {**_attn_block_defs(cfg, tp), **_ffn_block_defs(cfg)}
      d["layers"] = stack_defs(layer, cfg.num_layers)
    elif fam == "ssm":
      layer = {"ln1": _norm_def(cfg), "ssm": ssmlib.mamba1_defs(cfg)}
      d["layers"] = stack_defs(layer, cfg.num_layers)
    elif fam == "hybrid":
      seg, per, tail = self._hybrid_split()
      layer = {"ln1": _norm_def(cfg), "ssm": ssmlib.mamba2_defs(cfg)}
      d["segments"] = stack_defs(stack_defs(layer, per), seg)
      if tail:
        d["tail"] = stack_defs(layer, tail)
      d["shared"] = {**_attn_block_defs(cfg, tp), "ln2": _norm_def(cfg),
                     "mlp": ffnlib.swiglu_defs(cfg.d_model, cfg.d_ff)}
    elif fam == "encdec":
      enc_layer = {**_attn_block_defs(cfg, tp), **_ffn_block_defs(cfg)}
      dec_layer = {**_attn_block_defs(cfg, tp), "ln_x": _norm_def(cfg),
                   "xattn": attn.gqa_defs(cfg, tp), **_ffn_block_defs(cfg)}
      d["encoder"] = stack_defs(enc_layer, cfg.encoder_layers)
      d["enc_ln_f"] = _norm_def(cfg)
      d["layers"] = stack_defs(dec_layer, cfg.num_layers)
    else:
      raise ValueError(fam)
    return d

  def _hybrid_split(self) -> Tuple[int, int, int]:
    """(segments, Mamba-2 blocks a segment, tail blocks)."""
    per = self.cfg.hybrid_attn_every
    seg = self.cfg.num_layers // per
    return seg, per, self.cfg.num_layers - seg * per

  # ---------------- forward ----------------

  def _constrain(self, x: Tensor, *tail) -> Tensor:
    """Batch-axis activation sharding, ``P(dp_spec, *tail)``, on a DTensor
    (:func:`repro_torch.models.sharding.constrain`); a no-op when
    ``dp_spec`` is unset, as in the reference."""
    if self.dp_spec is None:
      return x
    return shd.constrain(x, P(self.dp_spec, *tail))

  def embed_inputs(self, params, batch: Dict[str, Tensor]) -> Tensor:
    """Token embeddings; the vlm family prepends ``batch["vision_embeds"]``
    [B,F,d] (the patch-embedding stub's output), cast to the compute
    dtype."""
    cd = self.cfg.compute_dtype
    x = embed_lookup(params["embed"], batch["tokens"], cd)
    if self.cfg.family == "vlm":
      x = torch.cat([batch["vision_embeds"].to(cd), x], dim=1)
    return self._constrain(x, None, None)

  def forward(self, params, batch: Dict[str, Tensor], *,
              kv_chunk: int = 1024) -> Tuple[Tensor, Tensor]:
    """Returns (logits [B,S,Vpad], aux scalar: the MoE aux loss summed over
    layers, 0 for the other families).  ``batch``: ``tokens`` [B,S], and
    ``enc_frames`` [B,T,d] (encdec) or ``vision_embeds`` [B,F,d] (vlm,
    which then returns F + S positions).  ``kv_chunk``: keys per chunk of
    the attention's online softmax."""
    with sharded_context(params):
      return self._forward(_unshard_data(params), batch, kv_chunk)

  def _forward(self, params, batch: Dict[str, Tensor],
               kv_chunk: int) -> Tuple[Tensor, Tensor]:
    cfg, tp, dp = self.cfg, self.tp, self.dp_spec
    fam = cfg.family
    x = self.embed_inputs(params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if fam in ("dense", "moe", "vlm"):
      def block(lp, h):
        h = _attn_apply(lp, h, positions, cfg, tp, kv_chunk=kv_chunk)
        return _ffn_apply(lp, h, cfg, dp)
      x, aux = scan_layers(params["layers"], x, block, cfg.remat)
    elif fam == "ssm":
      def block(lp, h):
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        return h + ssmlib.mamba1_forward(lp["ssm"], hn, cfg, dp_spec=dp), 0.0
      x, _ = scan_layers(params["layers"], x, block, cfg.remat)
    elif fam == "hybrid":
      x = self._hybrid_forward(params, x, positions, kv_chunk)
    else:
      x = self._encdec_forward(params, batch, x, positions, kv_chunk)
    return self._logits(params, x), aux

  def _mamba2_block(self, lp, h: Tensor) -> Tuple[Tensor, float]:
    hn = rms_norm(h, lp["ln1"], self.cfg.norm_eps)
    return h + ssmlib.mamba2_forward(lp["ssm"], hn, self.cfg), 0.0

  def _shared_block(self, params, h: Tensor, positions: Tensor,
                    kv_chunk: int) -> Tensor:
    cfg = self.cfg
    sp = params["shared"]
    h = _attn_apply(sp, h, positions, cfg, self.tp, kv_chunk=kv_chunk)
    hn = rms_norm(h, sp["ln2"], cfg.norm_eps)
    return h + ffnlib.swiglu(sp["mlp"], hn, cfg)

  def _hybrid_forward(self, params, x: Tensor, positions: Tensor,
                      kv_chunk: int) -> Tensor:
    """Each segment: the shared block, then its Mamba-2 blocks; then the
    tail's Mamba-2 blocks."""
    segments = params["segments"]
    for i in range(_depth(segments)):
      x = self._shared_block(params, x, positions, kv_chunk)
      x, _ = scan_layers(_layer(segments, i), x, self._mamba2_block,
                         self.cfg.remat)
    if "tail" in params:
      x, _ = scan_layers(params["tail"], x, self._mamba2_block,
                         self.cfg.remat)
    return x

  def _encdec_forward(self, params, batch, x_dec: Tensor, positions: Tensor,
                      kv_chunk: int) -> Tensor:
    """The encoder (non-causal) over ``batch["enc_frames"]``, the stub
    frontend's output, then the decoder with cross attention over its
    normed memory."""
    cfg, tp, dp = self.cfg, self.tp, self.dp_spec
    mem = batch["enc_frames"].to(cfg.compute_dtype)
    enc_pos = torch.arange(mem.shape[1], dtype=torch.int32, device=mem.device)

    def enc_block(lp, h):
      h = _attn_apply(lp, h, enc_pos, cfg, tp, causal=False,
                      kv_chunk=kv_chunk)
      return _ffn_apply(lp, h, cfg, dp)

    mem, _ = scan_layers(params["encoder"], mem, enc_block, cfg.remat)
    mem = rms_norm(mem, params["enc_ln_f"], cfg.norm_eps)

    def dec_block(lp, h):
      h = _attn_apply(lp, h, positions, cfg, tp, kv_chunk=kv_chunk)
      h = _cross_attn(lp, h, mem, positions, enc_pos, cfg, kv_chunk, tp)
      return _ffn_apply(lp, h, cfg, dp)

    x, _ = scan_layers(params["layers"], x_dec, dec_block, cfg.remat)
    return x

  def _logits(self, params, x: Tensor) -> Tensor:
    cfg = self.cfg
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return self._constrain(unembed(x, head, cfg.compute_dtype), None, "model")

  # ---------------- decode ----------------

  def init_cache(self, batch_size: int, max_seq: int, *,
                 device: DeviceLike = "cuda", abstract: bool = False
                 ) -> PyTree:
    """Decode state.  Dense, MoE and vlm: per layer a K and a V ring of
    ``min(max_seq, sliding_window)`` slots (``max_seq`` without a window),
    or with MLA the latent ``c_kv`` and ``k_rope`` of ``max_seq`` slots (not
    a ring).  SSM: per layer the last K-1 conv inputs and the SSM state (its
    size does not grow with ``max_seq``).  Hybrid: the Mamba-2 states of
    ``segments`` ([seg, per, ...]) and ``tail``, and one K/V ring a segment
    for the shared block (``shared``).  Encdec: the decoder's K/V and the
    cross attention's ``ck``/``cv`` of ``encoder_seq`` slots, which stay
    zeros: as in the reference, nothing writes the encoder's memory into
    them (ROADMAP Queue 3, item 9).  ``abstract``: meta tensors of those
    shapes and dtypes (the dry run: no allocation; ``device`` unused)."""
    cfg = self.cfg
    dev = torch.device("meta") if abstract else resolve_device(device)
    L, B = cfg.num_layers, batch_size
    cd = cfg.compute_dtype
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    t = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq

    def zeros(*shape, dtype=cd):
      return torch.zeros(shape, dtype=dtype, device=dev)

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
      if cfg.use_mla:
        return {"c_kv": zeros(L, B, max_seq, cfg.kv_lora_rank),
                "k_rope": zeros(L, B, max_seq, cfg.qk_rope_head_dim)}
      return {"k": zeros(L, B, t, kv, hd), "v": zeros(L, B, t, kv, hd)}
    if fam == "ssm":
      d_inner, _, n = ssmlib.mamba1_dims(cfg)
      return {"conv": zeros(L, B, cfg.ssm_conv - 1, d_inner),
              "h": zeros(L, B, d_inner, n, dtype=torch.float32)}
    if fam == "hybrid":
      seg, per, tail = self._hybrid_split()
      d_inner, nh, p, n = ssmlib.mamba2_dims(cfg)
      conv = (B, cfg.ssm_conv - 1, d_inner + 2 * n)
      c = {"segments": {"conv": zeros(seg, per, *conv),
                        "h": zeros(seg, per, B, nh, n, p,
                                   dtype=torch.float32)},
           "shared": {"k": zeros(seg, B, t, kv, hd),
                      "v": zeros(seg, B, t, kv, hd)}}
      if tail:
        c["tail"] = {"conv": zeros(tail, *conv),
                     "h": zeros(tail, B, nh, n, p, dtype=torch.float32)}
      return c
    if fam == "encdec":
      return {"k": zeros(L, B, max_seq, kv, hd),
              "v": zeros(L, B, max_seq, kv, hd),
              "ck": zeros(L, B, cfg.encoder_seq, kv, hd),
              "cv": zeros(L, B, cfg.encoder_seq, kv, hd)}
    raise ValueError(fam)

  def decode_step(self, params, token: Tensor, cache: PyTree, pos
                  ) -> Tuple[Tensor, PyTree]:
    """token [B,1] int; pos the token's position, a Python int or a 0-d
    tensor (unused by the SSM family).  Takes tokens only, as the
    reference does: encdec and vlm decode see no frontend input.  Returns
    (logits [B,1,V], cache); the cache passed in is left as it was."""
    with sharded_context(params):
      return self._decode_step(_unshard_data(params), token, cache, pos)

  def _decode_step(self, params, token: Tensor, cache: PyTree, pos
                   ) -> Tuple[Tensor, PyTree]:
    cfg, tp, dp = self.cfg, self.tp, self.dp_spec
    fam = cfg.family
    x = embed_lookup(params["embed"], token, cfg.compute_dtype)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)

    if fam in ("dense", "moe", "vlm"):
      def block(lp, c, h):
        h, c = _attn_apply_decode(lp, h, c, pos, cfg, tp)
        h, _ = _ffn_apply(lp, h, cfg, dp)
        return h, c
      x, cache = scan_layers_cache(params["layers"], cache, x, block)
    elif fam == "ssm":
      def block(lp, c, h):
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        o, c = ssmlib.mamba1_decode(lp["ssm"], hn, c, cfg)
        return h + o, c
      x, cache = scan_layers_cache(params["layers"], cache, x, block)
    elif fam == "hybrid":
      x, cache = self._hybrid_decode(params, x, cache, pos)
    else:
      x, cache = self._encdec_decode(params, x, cache, pos)
    return self._logits(params, x), cache

  def _mamba2_decode_block(self, lp, c, h: Tensor):
    hn = rms_norm(h, lp["ln1"], self.cfg.norm_eps)
    o, c = ssmlib.mamba2_decode(lp["ssm"], hn, c, self.cfg)
    return h + o, c

  def _hybrid_decode(self, params, x: Tensor, cache: PyTree, pos: Tensor
                     ) -> Tuple[Tensor, PyTree]:
    """Segment by segment: the shared block over that segment's K/V ring,
    then its Mamba-2 blocks; then the tail.  Returns a new cache with the
    tree of :meth:`init_cache`."""
    cfg = self.cfg
    sp = params["shared"]
    segments = params["segments"]
    attn_cs, ssm_cs = [], []
    for i in range(_depth(segments)):
      x, ac = _attn_apply_decode(sp, x, _layer(cache["shared"], i), pos, cfg,
                                 self.tp)
      x = x + ffnlib.swiglu(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps),
                            cfg)
      x, sc = scan_layers_cache(_layer(segments, i),
                                _layer(cache["segments"], i), x,
                                self._mamba2_decode_block)
      attn_cs.append(ac)
      ssm_cs.append(sc)
    out = {"shared": tree_map(_stack, *attn_cs),
           "segments": tree_map(_stack, *ssm_cs)}
    if "tail" in cache:
      x, out["tail"] = scan_layers_cache(params["tail"], cache["tail"], x,
                                         self._mamba2_decode_block)
    return x, out

  def _encdec_decode(self, params, x: Tensor, cache: PyTree, pos: Tensor
                     ) -> Tuple[Tensor, PyTree]:
    """The decoder alone: self attention over the K/V ring, then grouped
    cross attention over ``ck``/``cv`` with the query's position pinned
    past the memory (every slot attended); ``ck``/``cv`` pass through."""
    cfg, tp, dp = self.cfg, self.tp, self.dp_spec
    positions = pos.reshape(1)
    enc_pos = torch.arange(cfg.encoder_seq, dtype=torch.int32,
                           device=x.device)
    q_pos = torch.full((1,), 2**29, dtype=torch.int32, device=x.device)

    def block(lp, c, h):
      h, self_c = _attn_apply_decode(lp, h, {"k": c["k"], "v": c["v"]}, pos,
                                     cfg, tp)
      hn = rms_norm(h, lp["ln_x"], cfg.norm_eps)
      q, _, _ = attn.gqa_qkv(lp["xattn"], hn, positions, cfg, tp)
      o = attn.grouped_decode_attention(q, c["ck"], c["cv"], q_pos, enc_pos)
      h = h + out_proj_einsum("bsh,hd->bsd", o.reshape(h.shape[0], 1, -1),
                              lp["xattn"]["wo"], cfg)
      h, _ = _ffn_apply(lp, h, cfg, dp)
      return h, {**self_c, "ck": c["ck"], "cv": c["cv"]}

    return scan_layers_cache(params["layers"], cache, x, block)


def build_model(cfg: ModelConfig, tp: int = 1, dp_spec=None) -> Model:
  return Model(cfg=cfg, tp=tp, dp_spec=dp_spec)
