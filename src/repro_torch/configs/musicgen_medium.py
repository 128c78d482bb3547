"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=1536 24H (MHA kv=24) d_ff=6144, 4 codebooks x vocab 2048.
EnCodec frontend is a STUB: input_specs() provides codebook token ids
(B, S, 4) with the delay pattern preapplied.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=("attn",),
    mlp_kind="gelu",
    frontend="audio",
    n_codebooks=4,
)
