"""qwen3-14b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family, 14B scale]

40L d_model=5120 40H (GQA kv=8, head_dim=128) d_ff=17408 vocab=151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    d_ff=17408,
    vocab_size=151936,
    attn_type="gqa",
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)
