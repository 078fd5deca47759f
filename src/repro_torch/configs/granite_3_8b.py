"""granite-3-8b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base family]

40L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=12800 vocab=49155.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    d_ff=12800,
    vocab_size=49155,
    attn_type="gqa",
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
