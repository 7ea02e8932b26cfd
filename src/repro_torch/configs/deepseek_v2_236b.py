"""DeepSeek-V2 236B [moe]: MLA attention + 160-expert top-6 MoE.

60L d_model=5120 128H d_ff=1536(per expert) vocab=102400, MLA kv_lora=512,
2 shared + 160 routed top-6 [arXiv:2405.04434; hf].
Simplification (documented): every layer is MoE (the HF model uses a dense
first layer); expert parallelism over the 16-way "model" axis (10/device).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    moe_sharding="ep",
    rope_theta=1e4,
    remat="full",
)
