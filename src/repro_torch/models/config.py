"""Architecture configuration (one dataclass covers all 10 assigned archs).

A copy of :mod:`repro.models.config`; ``compute_dtype`` is a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _round_up(x: int, m: int) -> int:
  return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
  """Static architecture description.

  ``family``: dense | moe | ssm | hybrid | encdec.  All sizes are the
  published ones; padded derivatives (vocab/head padding for the fixed
  16-way tensor axis) are computed properties, never stored.
  """

  name: str
  family: str
  num_layers: int
  d_model: int
  num_heads: int = 0
  num_kv_heads: int = 0
  d_ff: int = 0
  vocab_size: int = 0
  head_dim: int = 0                # 0 -> d_model // num_heads
  qkv_bias: bool = False
  tie_embeddings: bool = False
  rope_theta: float = 1e4
  norm_eps: float = 1e-5

  # --- MoE ---
  num_experts: int = 0
  num_shared_experts: int = 0
  top_k: int = 0
  moe_d_ff: int = 0                # per-expert hidden
  moe_sharding: str = "ep"         # "ep" (expert-parallel) | "tp"
  capacity_factor: float = 1.25
  moe_group_size: int = 512        # routing-group tokens (§Perf knob)
  moe_impl: str = "sort"           # "sort" (index/SpMV) | "onehot" (GShard)

  # --- MLA (DeepSeek-V2) ---
  use_mla: bool = False
  kv_lora_rank: int = 0
  q_lora_rank: int = 0
  qk_nope_head_dim: int = 128
  qk_rope_head_dim: int = 64
  v_head_dim: int = 128

  # --- sliding-window attention ---
  sliding_window: int = 0          # 0 = full causal

  # --- SSM ---
  ssm_variant: str = ""            # "mamba1" | "mamba2"
  ssm_state: int = 0
  ssm_conv: int = 4
  ssm_expand: int = 2
  ssm_head_dim: int = 64           # mamba2 head dim
  ssm_chunk: int = 256             # scan chunk
  ssm_impl: str = "assoc"          # "assoc" (chunked scan) | "fused" (kernel)
  ssm_scan_dtype: str = "float32"  # dtype of the [B,S,C,N] scan operands

  # --- hybrid (Zamba2): shared attention block every k SSM blocks ---
  hybrid_attn_every: int = 0

  # --- encoder-decoder ---
  encoder_layers: int = 0
  encoder_seq: int = 4096          # stub-frontend memory length for serving

  # --- modality frontend stub ---
  frontend: str = ""               # "" | "patch" | "audio"
  frontend_seq: int = 0            # vision/audio positions within the seq

  # --- numerics / execution ---
  dtype: str = "bfloat16"
  remat: str = "none"              # none | full | selective
  # Unroll layer scans at trace time.  XLA's cost analysis counts a while
  # body once regardless of trip count, so roofline lowering unrolls; the
  # default (scanned) keeps HLO small for the multi-pod pass and training.
  scan_unroll: bool = False
  # §Perf: emit row-parallel output projections (wo / w_down / out_proj) in
  # compute dtype so the tensor-parallel all-reduce moves bf16, not the f32
  # dot accumulator (halves TP collective bytes; MXU still accumulates f32).
  low_precision_reduce: bool = False

  # ------------------------------------------------------------------
  @property
  def compute_dtype(self):
    return getattr(torch, self.dtype)

  @property
  def resolved_head_dim(self) -> int:
    if self.head_dim:
      return self.head_dim
    return self.d_model // max(self.num_heads, 1)

  def padded_heads(self, tp: int) -> int:
    """Q heads padded to a multiple of the tensor-parallel degree."""
    return _round_up(self.num_heads, tp) if self.num_heads else 0

  def padded_vocab(self, tp: int) -> int:
    # 256 is a multiple of every tp we use (16); keeps lanes aligned too.
    return _round_up(self.vocab_size, max(256, tp))

  @property
  def is_attention_free(self) -> bool:
    return self.family == "ssm"

  @property
  def supports_long_decode(self) -> bool:
    """True if decode cost is sub-quadratic in context (DESIGN.md §5)."""
    return (self.family in ("ssm", "hybrid")
            or (self.sliding_window > 0 and self.family in ("moe", "dense")))

  def scaled(self, **overrides) -> "ModelConfig":
    """A reduced copy for smoke tests."""
    return dataclasses.replace(self, **overrides)
