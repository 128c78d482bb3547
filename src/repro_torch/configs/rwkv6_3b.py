"""rwkv6-3b — "Finch": attention-free, data-dependent decay [arXiv:2404.05892].

32L d_model=2560, d_ff=8960, vocab=65536. Head size 64 => 40 heads.
Sub-quadratic (O(1) decode state) => runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv",),
    mlp_kind="swiglu",        # unused by rwkv blocks (channel-mix instead)
    subquadratic=True,
)
