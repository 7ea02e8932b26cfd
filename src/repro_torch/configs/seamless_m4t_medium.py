"""SeamlessM4T-medium [audio]: encoder-decoder, multimodal frontend stub.

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596; hf].
``input_specs()`` provides precomputed audio-frame embeddings for the
encoder (frontend stub per assignment); 12 encoder + 12 decoder layers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    encoder_seq=4096,
    frontend="audio",
    remat="full",
)
