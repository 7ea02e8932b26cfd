"""Assigned-architecture registry (10 archs) + input-shape definitions,
copied from :mod:`repro.configs`."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCHITECTURES: List[str] = [
    "internvl2_26b",
    "deepseek_v2_236b",
    "mixtral_8x7b",
    "zamba2_7b",
    "seamless_m4t_medium",
    "granite_3_2b",
    "deepseek_coder_33b",
    "granite_8b",
    "qwen2_5_32b",
    "falcon_mamba_7b",
]


# CLI ids use dashes; module names use underscores.
def canon(name: str) -> str:
  return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
  mod = importlib.import_module(f"repro_torch.configs.{canon(name)}")
  return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
  mod = importlib.import_module(f"repro_torch.configs.{canon(name)}")
  if hasattr(mod, "SMOKE_CONFIG"):
    return mod.SMOKE_CONFIG
  return reduce_config(mod.CONFIG)


def reduce_config(cfg: ModelConfig) -> ModelConfig:
  """Family-preserving reduction for CPU smoke tests."""
  kw = dict(
      num_layers=2, d_model=64, d_ff=128, vocab_size=512,
      dtype="float32", ssm_chunk=8, encoder_seq=16, frontend_seq=4)
  if cfg.num_heads:
    kw.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2), head_dim=16)
  if cfg.family == "moe":
    kw.update(num_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=32,
              num_shared_experts=min(cfg.num_shared_experts, 1))
  if cfg.use_mla:
    kw.update(kv_lora_rank=16, q_lora_rank=24, qk_nope_head_dim=16,
              qk_rope_head_dim=8, v_head_dim=16, head_dim=0)
  if cfg.family in ("ssm", "hybrid"):
    kw.update(ssm_state=8, ssm_head_dim=16)
  if cfg.family == "hybrid":
    kw.update(num_layers=5, hybrid_attn_every=2)
  if cfg.family == "encdec":
    kw.update(encoder_layers=2)
  if cfg.sliding_window:
    kw.update(sliding_window=8)
  return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned): seq_len × global_batch per cell.
# ---------------------------------------------------------------------------

SHAPES: Dict[str, Dict] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def shape_supported(cfg: ModelConfig, shape: str) -> bool:
  """Which (arch × shape) cells run: long_500k needs sub-quadratic
  attention; pure full-attention archs skip it."""
  if shape == "long_500k":
    return cfg.supports_long_decode
  return True
