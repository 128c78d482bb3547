"""recurrentgemma-2b — RG-LRU + local attention, pattern (R,R,A)
[arXiv:2402.19427].

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000, window=2048.
26 = 8 x (rec,rec,attn_local) + prefix (rec,rec).
Sub-quadratic decode (fixed recurrent state + 2048-window KV) => long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn_local"),
    rnn_width=2560,
    window=2048,
    mlp_kind="geglu",
    tie_embeddings=True,
    subquadratic=True,
)
