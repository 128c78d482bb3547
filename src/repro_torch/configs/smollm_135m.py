"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    block_pattern=("attn",),
    mlp_kind="swiglu",
    tie_embeddings=True,
    parallelism="dp_only",  # 135M params: TP-16 is pure overhead (§Perf)
)
