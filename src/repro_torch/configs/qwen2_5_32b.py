"""Qwen2.5-32B [dense]: GQA with QKV bias.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
[hf:Qwen/Qwen2.5-0.5B family; hf].  40 heads pad to 48 for the 16-way
tensor axis (+20% attention FLOPs, recorded in EXPERIMENTS.md §Dry-run).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    remat="full",
)
