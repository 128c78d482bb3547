"""Config dataclasses shared by all architectures (PyTorch port).

A field-for-field copy of `repro.configs.base`: every architecture gets one
module `src/repro_torch/configs/<id>.py` exporting `CONFIG: ModelConfig`
(exact published sizes) — the registry in `configs/__init__.py` resolves
`--arch <id>`. `reduced()` yields the CPU-smoke-test variant of the same
family. `act_dtype` / `p_dtype` resolve to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# the config's dtype strings, resolved to torch dtypes
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    # block structure: tuple of 'attn' | 'moe' | 'rwkv' | 'rec' | 'attn_local'
    block_pattern: Tuple[str, ...] = ("attn",)
    mlp_kind: str = "swiglu"
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # sequence-chunk for the MoE dispatch: 4096 = unchunked at train_4k
    # (chunking the train path puts one expert-grad all-reduce per chunk in
    # the backward — measured 4.6 TB/step on grok; §Perf iteration 5);
    # 32k prefill still chunks 8x, and has no backward.
    moe_chunk: int = 4096
    # recurrence
    rnn_width: int = 0
    conv_width: int = 4
    window: int = 2048             # local-attention window for 'attn_local'
    # frontends
    frontend: str = "none"         # none | vision | audio
    n_codebooks: int = 1
    vision_tokens: int = 256
    vision_dim: int = 1152
    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_chunk: int = 512
    attn_impl: str = "chunked"     # chunked | bisect (perf variant)
    remat_policy: str = "full"     # full | dots (save matmul outputs)
    # 'tp': shard params over 'model' (default). 'dp_only': replicate params
    # and use the model axis as extra data parallelism — right for <1B archs
    # where 16-way TP means 36-column matmuls and per-layer psums dominate
    # (smollm measured collective-bound at mfu 0.038; §Perf).
    parallelism: str = "tp"
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "float32"
    # long-context capability: True iff sequence mixing is sub-quadratic
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.rnn_width == 0 and "rec" in self.block_pattern:
            object.__setattr__(self, "rnn_width", self.d_model)

    @property
    def act_dtype(self):
        return _TORCH_DTYPES[self.dtype]

    @property
    def p_dtype(self):
        return _TORCH_DTYPES[self.param_dtype]

    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_super(self) -> int:
        return self.n_layers // self.pattern_len

    @property
    def prefix_pattern(self) -> Tuple[str, ...]:
        rem = self.n_layers % self.pattern_len
        return self.block_pattern[:rem]

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 2 * self.pattern_len
                         + len(self.prefix_pattern) % self.pattern_len),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            rnn_width=64 if self.rnn_width else 0,
            vision_dim=32,
            vision_tokens=8,
            window=min(self.window, 16),
            attn_chunk=16,
            moe_chunk=16,
            param_dtype="float32",
            dtype="float32",
        )
        # keep prefix-layer structure representative: n_layers =
        # 2 superblocks + original remainder
        rem = self.n_layers % self.pattern_len
        changes["n_layers"] = 2 * self.pattern_len + rem
        changes.update(overrides)
        return dataclasses.replace(self, **changes)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.n_heads, self.n_kv_heads, self.head_dim
        total = 0
        emb = V * D * (self.n_codebooks if self.frontend == "audio" else 1)
        total += emb
        if not self.tie_embeddings:
            total += D * V * (self.n_codebooks
                              if self.frontend == "audio" else 1)
        if self.frontend == "vision":
            total += self.vision_dim * D

        def attn_p():
            return D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D

        def mlp_p():
            mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
            return mult * D * F

        def block_p(kind):
            if kind == "attn" or kind == "attn_local":
                return attn_p() + mlp_p() + 2 * D
            if kind == "moe":
                mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                return attn_p() + D * self.n_experts \
                    + self.n_experts * mult * D * F + 2 * D
            if kind == "rwkv":
                dh = H * hd
                tmix = 4 * D * dh + dh * D + 64 * (D + dh) + dh
                cmix = D * F + F * D + D * D
                return tmix + cmix + 2 * D
            if kind == "rec":
                rd = self.rnn_width
                rec = 2 * D * rd + 2 * rd * rd + rd * D \
                    + self.conv_width * rd
                return rec + mlp_p() + 2 * D
            raise ValueError(kind)

        for kind in self.prefix_pattern:
            total += block_p(kind)
        for kind in self.block_pattern:
            total += self.n_super * block_p(kind)
        total += D  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        per_expert = mult * self.d_model * self.d_ff
        n_moe_layers = (self.block_pattern.count("moe") * self.n_super
                        + self.prefix_pattern.count("moe"))
        inactive = n_moe_layers * (self.n_experts
                                   - self.experts_per_token) * per_expert
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
