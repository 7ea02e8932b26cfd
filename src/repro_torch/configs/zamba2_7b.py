"""Zamba2-7B [hybrid]: Mamba-2 backbone + weight-shared attention blocks.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242; unverified].  Shared attention+MLP block applied every 6
Mamba-2 blocks (13 applications + 3 tail blocks); the Zamba concat-embedding
variant is simplified to a plain residual insertion (DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_variant="mamba2",
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    hybrid_attn_every=6,
    remat="full",
)
