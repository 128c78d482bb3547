"""stablelm-3b — dense [hf:stabilityai/stablelm-*].

32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    block_pattern=("attn",),
    mlp_kind="swiglu",
)
