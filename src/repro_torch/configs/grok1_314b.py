"""grok-1-314b — 8 experts top-2 MoE [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE every layer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    block_pattern=("moe",),
    n_experts=8,
    experts_per_token=2,
    mlp_kind="geglu",   # gated 3-matrix expert MLP => ~314B total
    param_dtype="bfloat16",  # 16 GB/chip memory plan — see DESIGN.md §5
)
