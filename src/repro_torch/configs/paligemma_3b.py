"""paligemma-3b — SigLIP + gemma backbone [arXiv:2407.07726].

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.
Vision frontend is a STUB: input_specs() provides precomputed SigLIP patch
embeddings (B, 256, 1152); prefix-LM attention over the vision prefix.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    block_pattern=("attn",),
    mlp_kind="geglu",
    frontend="vision",
    vision_tokens=256,
    vision_dim=1152,
    tie_embeddings=True,
)
