"""InternVL2-26B [vlm]: InternViT frontend (stub) + InternLM2-20B backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 [arXiv:2404.16821; hf].
The transformer BACKBONE only; ``input_specs()`` supplies precomputed patch
embeddings (frontend stub per assignment).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    rope_theta=1e6,
    frontend="patch",
    frontend_seq=256,
    remat="full",
)
