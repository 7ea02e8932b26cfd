"""DeepSeek-Coder-33B [dense]: llama-arch code model.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256
[arXiv:2401.14196; hf].  56 heads pad to 64 for the 16-way tensor axis
(+14% attention FLOPs, recorded in EXPERIMENTS.md §Dry-run).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    head_dim=128,
    rope_theta=1e5,
    remat="full",
)
