"""Model assembly: the ``"ssm"`` (Mamba-1) family.

The port of :mod:`repro.models.transformer` for the one family ported so
far.  Layer parameters keep the reference's stacked ``[num_layers, ...]``
axis; the reference's ``lax.scan`` over them becomes a Python loop over the
layer index.  Remat is a training matter and has no place here.

The public surface is :class:`Model` (closures over config):
  * ``defs()``            — nested ParamDef tree
  * ``forward``           — full-sequence logits (+ an aux scalar, 0 here)
  * ``init_cache``        — decode-state tree of zeros
  * ``decode_step``       — one-token serving step
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_map
from repro_torch.models import ssm as ssmlib
from repro_torch.models.common import (ParamDef, embed_lookup, rms_norm,
                                       unembed)
from repro_torch.models.config import ModelConfig

PyTree = Any
Tensor = torch.Tensor

# The ROADMAP item (Queue 1) that ports each family not ported yet.
_FAMILY_ITEM = {"dense": "6.1", "vlm": "6.4", "moe": "6.2", "hybrid": "6.3",
                "encdec": "6.4"}


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
# Model container
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Model:
  cfg: ModelConfig

  def __post_init__(self):
    fam = self.cfg.family
    if fam != "ssm":
      item = _FAMILY_ITEM.get(fam, "6")
      raise NotImplementedError(
          f"family {fam!r} is not ported yet (ROADMAP.md Queue 1, item "
          f"{item}); the port serves the 'ssm' (Mamba-1) family")

  # ---------------- defs ----------------

  def defs(self) -> PyTree:
    cfg = self.cfg
    vpad = cfg.padded_vocab(1)  # one device, no mesh yet
    d = {"embed": ParamDef((vpad, cfg.d_model), scale=0.02),
         "ln_f": ParamDef((cfg.d_model,), init="ones")}
    if not cfg.tie_embeddings:
      d["lm_head"] = ParamDef((cfg.d_model, vpad))
    layer = {"ln1": ParamDef((cfg.d_model,), init="ones"),
             "ssm": ssmlib.mamba1_defs(cfg)}
    d["layers"] = stack_defs(layer, cfg.num_layers)
    return d

  # ---------------- forward ----------------

  def embed_inputs(self, params, batch: Dict[str, Tensor]) -> Tensor:
    return embed_lookup(params["embed"], batch["tokens"],
                        self.cfg.compute_dtype)

  def forward(self, params, batch: Dict[str, Tensor]
              ) -> Tuple[Tensor, Tensor]:
    """Returns (logits [B,S,Vpad], aux scalar)."""
    cfg = self.cfg
    x = self.embed_inputs(params, batch)

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
    """Decode state: per layer the last K-1 conv inputs and the SSM state
    (its size does not grow with ``max_seq``)."""
    cfg = self.cfg
    dev = resolve_device(device)
    d_inner, _, n = ssmlib.mamba1_dims(cfg)
    L, B = cfg.num_layers, batch_size
    return {"conv": torch.zeros((L, B, cfg.ssm_conv - 1, d_inner),
                                dtype=cfg.compute_dtype, device=dev),
            "h": torch.zeros((L, B, d_inner, n), dtype=torch.float32,
                             device=dev)}

  def decode_step(self, params, token: Tensor, cache: PyTree, pos
                  ) -> Tuple[Tensor, PyTree]:
    """token [B,1] int; pos the token's position (unused by the SSM family).
    Returns (logits [B,1,V], cache)."""
    cfg = self.cfg
    x = embed_lookup(params["embed"], token, cfg.compute_dtype)

    def block(lp, c, h):
      hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
      o, c = ssmlib.mamba1_decode(lp["ssm"], hn, c, cfg)
      return h + o, c

    x, cache = scan_layers_cache(params["layers"], cache, x, block, cfg)
    return self._logits(params, x), cache


def build_model(cfg: ModelConfig) -> Model:
  return Model(cfg=cfg)
