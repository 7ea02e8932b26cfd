"""Mixtral-8x7B [moe]: 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000 [arXiv:2401.04088; hf].
Experts are wide (14336) and few (8): tensor-parallel expert sharding
(14336/16 = 896 per device) — see DESIGN.md §5.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    num_experts=8,
    top_k=2,
    moe_d_ff=14336,
    moe_sharding="tp",
    sliding_window=4096,
    rope_theta=1e6,
    remat="full",
)
