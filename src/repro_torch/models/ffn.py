"""Dense feed-forward (SwiGLU) blocks (port of :mod:`repro.models.ffn`)."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import P, ParamDef, out_proj_einsum
from repro_torch.models.config import ModelConfig


def swiglu_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
  return {
      "w_gate": ParamDef((d_model, d_ff), P(None, "model")),
      "w_up": ParamDef((d_model, d_ff), P(None, "model")),
      "w_down": ParamDef((d_ff, d_model), P("model", None)),
  }


def swiglu(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
  """``w_down(silu(x w_gate) * x w_up)``; the gate in float32, as in the
  reference, the matmuls in the compute dtype."""
  cd = cfg.compute_dtype
  g = torch.matmul(x, params["w_gate"].to(cd))
  u = torch.matmul(x, params["w_up"].to(cd))
  h = torch.nn.functional.silu(g.float()).to(cd) * u
  return out_proj_einsum("bsf,fd->bsd", h, params["w_down"], cfg)
