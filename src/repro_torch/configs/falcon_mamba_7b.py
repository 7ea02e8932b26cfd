"""Falcon-Mamba-7B [ssm]: pure Mamba-1, attention-free.

64L d_model=4096 d_inner=8192 ssm_state=16 vocab=65024
[arXiv:2410.05355; unverified].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    vocab_size=65024,
    ssm_variant="mamba1",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=256,
    remat="full",
)
