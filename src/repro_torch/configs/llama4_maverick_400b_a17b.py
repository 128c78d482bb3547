"""llama4-maverick-400b-a17b — MoE, early fusion [hf:meta-llama/Llama-4-*].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
MoE on every *second* layer (interleave step 2, matching the HF architecture
and the ~400B total / ~17B active counts — see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("attn", "moe"),
    n_experts=128,
    experts_per_token=1,
    mlp_kind="swiglu",
    rope_theta=500000.0,
    # memory plan (16 GB v5e): bf16 params + bf16 inner-momentum + bf16
    # anchor, FSDP over 'data' x TP over 'model' (DESIGN.md §5)
    param_dtype="bfloat16",
)
