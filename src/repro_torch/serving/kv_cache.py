"""Paged KV cache: fixed-size physical blocks + per-sequence block tables
(PyTorch port of `repro.serving.kv_cache`).

Every attention layer's cache is a pool of `num_blocks` blocks of
`block_size` tokens; a sequence holding n tokens owns ceil(n / block_size)
blocks, found through its block-table row. Block 0 is the null sink:
inactive decode slots and padded prefill positions write there, and the
allocator never hands it out.

Layer-state layout (mirrors models/lm.init_decode_state): attention layers
hold {"k", "v"}: (num_blocks, block_size, KV, hd) pools in the activation
dtype, one dict per layer in the unstacked {"prefix", "blocks"} tree. The
pools are updated in place. Only kv_dtype "fp16" (the activation dtype) is
ported; the quantized int8 / fp8 pools belong to a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

ATTN_KINDS = ("attn", "attn_local", "moe")
KV_DTYPES = ("fp16", "int8", "fp8")


def _fp16_only(kv_dtype: str) -> None:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected "
                         f"{KV_DTYPES}")
    if kv_dtype != "fp16":
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r}: quantized KV pools are not wired into "
            f"the PyTorch port yet (a later slice); use 'fp16'")


def pool_dtype(cfg: ModelConfig, kv_dtype: str = "fp16") -> torch.dtype:
    """Element dtype of the K/V pools ("fp16" = the activation dtype)."""
    _fp16_only(kv_dtype)
    return cfg.act_dtype


def init_paged_state(cfg: ModelConfig, num_slots: int, num_blocks: int,
                     block_size: int, kv_dtype: str = "fp16", *, device):
    """Paged decode state: zeroed pools for every attention layer, in the
    lm state tree. `num_slots` sizes recurrent slot state, which the
    attention-only layers of this slice do not have."""
    dt = pool_dtype(cfg, kv_dtype)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    lm._check_paged(cfg)
    return lm._to_tree(cfg, [
        {"k": torch.zeros(shape, dtype=dt, device=device),
         "v": torch.zeros(shape, dtype=dt, device=device)}
        for _ in lm.layer_kinds(cfg)])


def _n_attn_layers(cfg: ModelConfig) -> int:
    return (sum(k in ATTN_KINDS for k in cfg.prefix_pattern)
            + cfg.n_super * sum(k in ATTN_KINDS for k in cfg.block_pattern))


def paged_bytes(cfg: ModelConfig, num_blocks: int, block_size: int,
                kv_dtype: str = "fp16") -> int:
    """Attention-cache bytes of the pool (the memory the paging bounds)."""
    itemsize = torch.empty((), dtype=pool_dtype(cfg, kv_dtype)).element_size()
    per_tok = 2 * cfg.n_kv_heads * cfg.head_dim * itemsize
    return _n_attn_layers(cfg) * num_blocks * block_size * per_tok


def block_bytes(cfg: ModelConfig, block_size: int,
                kv_dtype: str = "fp16") -> int:
    """Bytes one physical block occupies across all attention pools."""
    return paged_bytes(cfg, 1, block_size, kv_dtype)


def copy_block(cfg: ModelConfig, state, src: int, dst: int):
    """Copy physical block `src` into `dst` in every attention pool, in
    place — the copy-on-write primitive (see serving/scheduler.py)."""
    for kind, st in lm._layers(state, cfg):
        if kind in ATTN_KINDS:
            for a in st.values():
                a[dst] = a[src]
    return state
