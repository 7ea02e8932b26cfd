"""Input specs + shardings for every (arch × shape) cell: the port of
:mod:`repro.launch.specs`, rule for rule.

``sds`` makes meta tensors (shape and dtype, no allocation) where the
reference makes ``ShapeDtypeStruct``s; the partition specs are
:class:`repro_torch.models.common.P`; :func:`named` turns a tree of specs
into :class:`~repro_torch.models.common.Sharding`s (DTensor placements) on
a mesh.  The step of each shape kind:

  train_*   -> train_step(params, opt_state, batch)
  prefill_* -> prefill(params, batch)
  decode_*  -> decode_step(params, token, cache, pos)   (ONE new token vs a
               ``seq_len`` KV cache / SSM state)
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch._tree import tree_map
from repro_torch.models.common import (P, ParamDef, named as _named,
                                       param_pspecs, param_shapes)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import AdamWState

PyTree = Any


def sds(shape, dtype) -> torch.Tensor:
  """A meta tensor: the port's ``ShapeDtypeStruct``."""
  return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _dp(dp_axes) -> Any:
  """Partition-spec entry for the data axes (axis name or tuple)."""
  return tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]


def batch_specs(cfg: ModelConfig, batch: int, seq: int, dp_axes,
                dp_size: int, *, with_labels: bool
                ) -> Tuple[Dict[str, Any], Dict[str, P]]:
  """(meta tensors, partition specs) for a data batch."""
  dp = _dp(dp_axes) if batch % dp_size == 0 and batch >= dp_size else None
  shapes: Dict[str, Any] = {}
  specs: Dict[str, P] = {}
  if cfg.family == "vlm":
    fs = cfg.frontend_seq
    shapes["tokens"] = sds((batch, seq - fs), torch.int32)
    specs["tokens"] = P(dp, None)
    shapes["vision_embeds"] = sds((batch, fs, cfg.d_model), torch.float32)
    specs["vision_embeds"] = P(dp, None, None)
  else:
    shapes["tokens"] = sds((batch, seq), torch.int32)
    specs["tokens"] = P(dp, None)
  if cfg.family == "encdec":
    shapes["enc_frames"] = sds((batch, cfg.encoder_seq, cfg.d_model),
                               torch.float32)
    specs["enc_frames"] = P(dp, None, None)
  if with_labels:
    shapes["labels"] = sds((batch, seq), torch.int32)
    specs["labels"] = P(dp, None)
  return shapes, specs


def cache_pspecs(cfg: ModelConfig, batch: int, dp_axes, dp_size: int,
                 tp: int, layout: str = "seq") -> PyTree:
  """Partition specs matching ``Model.init_cache``'s tree.

  ``layout``:
    * "head" (baseline) — shard kv heads on "model" when divisible, else
      shard head_dim (GQA) / the latent dim (MLA).  Contracting a sharded
      feature dim reduces big score tensors across ranks.
    * "seq" — when heads don't shard, put "model" on the *sequence* axis
      instead: scores, softmax and context stay T-sharded and only tiny
      [B,1,H,·] partials cross ranks (a flash-decode; the port writes it
      out, :func:`repro_torch.models.sharding.slot_sharded_decode_attention`).
  """
  dp = _dp(dp_axes) if batch % dp_size == 0 and batch >= dp_size else None
  seq_extra = None if dp is not None else _dp(dp_axes)  # B=1 -> seq on data
  fam = cfg.family

  def t_axes(use_model: bool):
    axes = []
    if seq_extra is not None:
      axes.extend(dp_axes)
    if use_model:
      axes.append("model")
    if not axes:
      return None
    return tuple(axes) if len(axes) > 1 else axes[0]

  kv_shardable = bool(cfg.num_kv_heads) and cfg.num_kv_heads % tp == 0
  if fam in ("dense", "moe", "vlm"):
    if cfg.use_mla:
      if layout == "seq":
        return {"c_kv": P(None, dp, t_axes(True), None),
                "k_rope": P(None, dp, t_axes(True), None)}
      return {"c_kv": P(None, dp, t_axes(False), "model"),
              "k_rope": P(None, dp, t_axes(False), None)}
    if kv_shardable:
      return {"k": P(None, dp, t_axes(False), "model", None),
              "v": P(None, dp, t_axes(False), "model", None)}
    if layout == "seq":
      return {"k": P(None, dp, t_axes(True), None, None),
              "v": P(None, dp, t_axes(True), None, None)}
    return {"k": P(None, dp, t_axes(False), None, "model"),
            "v": P(None, dp, t_axes(False), None, "model")}
  if fam == "ssm":
    return {"conv": P(None, dp, None, "model"),
            "h": P(None, dp, "model", None)}
  # Attention caches of hybrid/encdec families reuse the GQA rules.
  if kv_shardable:
    attn_kv = dict(t=t_axes(False), kvh="model", hdx=None)
  elif layout == "seq":
    attn_kv = dict(t=t_axes(True), kvh=None, hdx=None)
  else:
    attn_kv = dict(t=t_axes(False), kvh=None, hdx="model")
  if fam == "hybrid":
    # conv channels = d_inner + 2*ssm_state — divisible by 16 for zamba2.
    out = {"segments": {"conv": P(None, None, dp, None, "model"),
                        "h": P(None, None, dp, "model", None, None)},
           "shared": {"k": P(None, dp, attn_kv["t"], attn_kv["kvh"],
                             attn_kv["hdx"]),
                      "v": P(None, dp, attn_kv["t"], attn_kv["kvh"],
                             attn_kv["hdx"])}}
    seg, per, tail = Model(cfg, tp)._hybrid_split()
    if tail:
      out["tail"] = {"conv": P(None, dp, None, "model"),
                     "h": P(None, dp, "model", None, None)}
    return out
  if fam == "encdec":
    kv = P(None, dp, attn_kv["t"], attn_kv["kvh"], attn_kv["hdx"])
    cross = P(None, dp, None, attn_kv["kvh"], attn_kv["hdx"])
    return {"k": kv, "v": kv, "ck": cross, "cv": cross}
  raise ValueError(fam)


def fsdp_defs(defs: PyTree, dp_axes, dp_size: int) -> PyTree:
  """ZeRO/FSDP: additionally shard each parameter (and, through the
  derived optimizer specs, its Adam moments) over the data axes.

  Rule: the first dimension whose spec is unassigned (None) and whose size
  divides the data-parallel degree takes the dp axes.  DTensor gathers the
  parameter where an op needs it whole and reduce-scatters its gradient.
  Small params (norms, biases) stay replicated.
  """
  dp = _dp(dp_axes)

  def shard(d: ParamDef) -> ParamDef:
    if len(d.shape) < 2:          # tiny: norms/biases
      return d
    specs = list(d.pspec) + [None] * (len(d.shape) - len(d.pspec))
    for i, (dim, sp) in enumerate(zip(d.shape, specs)):
      if sp is None and dim % dp_size == 0 and dim >= dp_size:
        specs[i] = dp
        return ParamDef(d.shape, P(*specs), d.dtype, d.init, d.scale)
    return d

  return tree_map(shard, defs)


def opt_state_pspecs(defs: PyTree) -> AdamWState:
  like = param_pspecs(defs)
  return AdamWState(step=P(), mu=like, nu=like)


def opt_state_shapes(defs: PyTree) -> AdamWState:
  like = param_shapes(defs)
  return AdamWState(step=sds((), torch.int32), mu=like,
                    nu=param_shapes(defs))


def named(mesh, tree: PyTree) -> PyTree:
  """A tree of partition specs -> the tree of their shardings on ``mesh``."""
  return tree_map(lambda spec: _named(mesh, spec), tree)
