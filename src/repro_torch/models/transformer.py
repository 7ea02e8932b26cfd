"""Model assembly: the ``"dense"`` (GQA or MLA decoder), ``"moe"`` (GQA or
MLA attention + routed experts) and ``"ssm"`` (Mamba-1) families.

The port of :mod:`repro.models.transformer` for the families ported so
far.  Layer parameters keep the reference's stacked ``[num_layers, ...]``
axis; the reference's ``lax.scan`` over them becomes a Python loop over the
layer index.  Remat is a training matter and has no place here.

The public surface is :class:`Model` (closures over config):
  * ``defs()``            — nested ParamDef tree
  * ``forward``           — full-sequence logits (+ the MoE aux loss)
  * ``init_cache``        — decode-state tree of zeros
  * ``decode_step``       — one-token serving step
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffnlib
from repro_torch.models import moe as moelib
from repro_torch.models import ssm as ssmlib
from repro_torch.models.common import (ParamDef, embed_lookup, rms_norm,
                                       unembed)
from repro_torch.models.config import ModelConfig

PyTree = Any
Tensor = torch.Tensor

# The ROADMAP item (Queue 1) that ports each family not ported yet.
_FAMILY_ITEM = {"vlm": "6.4", "hybrid": "6.3", "encdec": "6.4"}
_PORTED = ("dense", "moe", "ssm")


# ---------------------------------------------------------------------------
# Stacking helpers
# ---------------------------------------------------------------------------


def stack_defs(defs: PyTree, n: int) -> PyTree:
  """Prepend a layer axis of size n to every ParamDef."""
  return tree_map(lambda d: ParamDef((n,) + d.shape, d.dtype, d.init, d.scale),
                  defs)


def _layer(stacked_params: PyTree, i: int) -> PyTree:
  return tree_map(lambda t: t[i], stacked_params)


def scan_layers(stacked_params: PyTree, x: Tensor,
                fn: Callable[[PyTree, Tensor], Tuple[Tensor, Any]],
                cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
  """fn(layer_params, x) -> (x', aux_scalar), layer by layer.  Returns
  (x, Σaux)."""
  aux = torch.zeros((), dtype=torch.float32, device=x.device)
  for i in range(cfg.num_layers):
    x, a = fn(_layer(stacked_params, i), x)
    aux = aux + a
  return x, aux


def scan_layers_cache(stacked_params: PyTree, cache: PyTree, x: Tensor,
                      fn, cfg: ModelConfig) -> Tuple[Tensor, PyTree]:
  """Decode variant: fn(layer_params, cache_slice, x) -> (x', cache_slice').
  Returns a new stacked cache; the one passed in is left as it was."""
  slices = []
  for i in range(cfg.num_layers):
    x, c = fn(_layer(stacked_params, i), _layer(cache, i), x)
    slices.append(c)
  return x, tree_map(lambda *ts: torch.stack(ts), *slices)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _attn_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
  a = attn.mla_defs(cfg) if cfg.use_mla else attn.gqa_defs(cfg)
  return {"ln1": ParamDef((cfg.d_model,), init="ones"), "attn": a}


def _attn_apply(params, x, positions, cfg, *, causal=True, kv_chunk=1024):
  h = rms_norm(x, params["ln1"], cfg.norm_eps)
  fwd = attn.mla_forward if cfg.use_mla else attn.gqa_forward
  return x + fwd(params["attn"], h, positions, cfg, causal=causal,
                 kv_chunk=kv_chunk)


def _attn_apply_decode(params, x, cache, pos, cfg):
  h = rms_norm(x, params["ln1"], cfg.norm_eps)
  dec = attn.mla_decode if cfg.use_mla else attn.gqa_decode
  out, cache = dec(params["attn"], h, cache, pos, cfg)
  return x + out, cache


def _ffn_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
  if cfg.family == "moe":
    return {"ln2": ParamDef((cfg.d_model,), init="ones"),
            "moe": moelib.moe_defs(cfg)}
  return {"ln2": ParamDef((cfg.d_model,), init="ones"),
          "mlp": ffnlib.swiglu_defs(cfg.d_model, cfg.d_ff)}


def _ffn_apply(params, x, cfg):
  """Returns (x + the block's output, aux): the MoE load-balancing loss of
  router logits in the compute dtype, or 0.0."""
  h = rms_norm(x, params["ln2"], cfg.norm_eps)
  if cfg.family != "moe":
    return x + ffnlib.swiglu(params["mlp"], h, cfg), 0.0
  mp = params["moe"]
  logits = torch.matmul(h, mp["router"].to(cfg.compute_dtype))
  aux = moelib.moe_aux_loss(logits, cfg.top_k, cfg.num_experts)
  out = moelib.moe_forward(mp, h, cfg, group_size=cfg.moe_group_size,
                           moe_impl=cfg.moe_impl)
  return x + out, aux


# ---------------------------------------------------------------------------
# Model container
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Model:
  cfg: ModelConfig

  def __post_init__(self):
    fam = self.cfg.family
    if fam not in _PORTED:
      item = _FAMILY_ITEM.get(fam, "6")
      raise NotImplementedError(
          f"family {fam!r} is not ported yet (ROADMAP.md Queue 1, item "
          f"{item}); the port serves the 'dense', 'moe' and 'ssm' (Mamba-1) "
          "families")

  # ---------------- defs ----------------

  def defs(self) -> PyTree:
    cfg = self.cfg
    vpad = cfg.padded_vocab(1)  # one device, no mesh yet
    d = {"embed": ParamDef((vpad, cfg.d_model), scale=0.02),
         "ln_f": ParamDef((cfg.d_model,), init="ones")}
    if not cfg.tie_embeddings:
      d["lm_head"] = ParamDef((cfg.d_model, vpad))
    if cfg.family in ("dense", "moe"):
      layer = {**_attn_block_defs(cfg), **_ffn_block_defs(cfg)}
    else:
      layer = {"ln1": ParamDef((cfg.d_model,), init="ones"),
               "ssm": ssmlib.mamba1_defs(cfg)}
    d["layers"] = stack_defs(layer, cfg.num_layers)
    return d

  # ---------------- forward ----------------

  def embed_inputs(self, params, batch: Dict[str, Tensor]) -> Tensor:
    return embed_lookup(params["embed"], batch["tokens"],
                        self.cfg.compute_dtype)

  def forward(self, params, batch: Dict[str, Tensor], *,
              kv_chunk: int = 1024) -> Tuple[Tensor, Tensor]:
    """Returns (logits [B,S,Vpad], aux scalar: the MoE aux loss summed over
    layers, 0 for the other families).  ``kv_chunk``: keys per chunk of
    the attention's online softmax."""
    cfg = self.cfg
    x = self.embed_inputs(params, batch)

    if cfg.family in ("dense", "moe"):
      positions = torch.arange(x.shape[1], dtype=torch.int32,
                               device=x.device)

      def block(lp, h):
        h = _attn_apply(lp, h, positions, cfg, kv_chunk=kv_chunk)
        return _ffn_apply(lp, h, cfg)
    else:
      def block(lp, h):
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        return h + ssmlib.mamba1_forward(lp["ssm"], hn, cfg), 0.0

    x, aux = scan_layers(params["layers"], x, block, cfg)
    return self._logits(params, x), aux

  def _logits(self, params, x: Tensor) -> Tensor:
    cfg = self.cfg
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return unembed(x, head, cfg.compute_dtype)

  # ---------------- decode ----------------

  def init_cache(self, batch_size: int, max_seq: int, *,
                 device: DeviceLike = "cuda") -> PyTree:
    """Decode state.  Dense and MoE: per layer a K and a V ring of
    ``min(max_seq, sliding_window)`` slots (``max_seq`` without a window),
    or with MLA the latent ``c_kv`` and ``k_rope`` of ``max_seq`` slots (not
    a ring).  SSM: per layer the last K-1 conv inputs and the SSM state (its
    size does not grow with ``max_seq``)."""
    cfg = self.cfg
    dev = resolve_device(device)
    L, B = cfg.num_layers, batch_size
    cd = cfg.compute_dtype
    if cfg.use_mla:
      return {"c_kv": torch.zeros((L, B, max_seq, cfg.kv_lora_rank),
                                  dtype=cd, device=dev),
              "k_rope": torch.zeros((L, B, max_seq, cfg.qk_rope_head_dim),
                                    dtype=cd, device=dev)}
    if cfg.family in ("dense", "moe"):
      t = (min(max_seq, cfg.sliding_window) if cfg.sliding_window
           else max_seq)
      shape = (L, B, t, cfg.num_kv_heads, cfg.resolved_head_dim)
      return {"k": torch.zeros(shape, dtype=cd, device=dev),
              "v": torch.zeros(shape, dtype=cd, device=dev)}
    d_inner, _, n = ssmlib.mamba1_dims(cfg)
    return {"conv": torch.zeros((L, B, cfg.ssm_conv - 1, d_inner),
                                dtype=cd, device=dev),
            "h": torch.zeros((L, B, d_inner, n), dtype=torch.float32,
                             device=dev)}

  def decode_step(self, params, token: Tensor, cache: PyTree, pos
                  ) -> Tuple[Tensor, PyTree]:
    """token [B,1] int; pos the token's position, a Python int or a 0-d
    tensor (unused by the SSM family).  Returns (logits [B,1,V], cache);
    the cache passed in is left as it was."""
    cfg = self.cfg
    x = embed_lookup(params["embed"], token, cfg.compute_dtype)

    if cfg.family in ("dense", "moe"):
      pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)

      def block(lp, c, h):
        h, c = _attn_apply_decode(lp, h, c, pos, cfg)
        h, _ = _ffn_apply(lp, h, cfg)
        return h, c
    else:
      def block(lp, c, h):
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        o, c = ssmlib.mamba1_decode(lp["ssm"], hn, c, cfg)
        return h + o, c

    x, cache = scan_layers_cache(params["layers"], cache, x, block, cfg)
    return self._logits(params, x), cache


def build_model(cfg: ModelConfig) -> Model:
  return Model(cfg=cfg)
