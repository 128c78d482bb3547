"""Paged KV cache: fixed-size physical blocks + per-sequence block tables
(PyTorch port of `repro.serving.kv_cache`).

Every attention layer's cache is a pool of `num_blocks` blocks of
`block_size` tokens; a sequence holding n tokens owns ceil(n / block_size)
blocks, found through its block-table row. Block 0 is the null sink:
inactive decode slots and padded prefill positions write there, and the
allocator never hands it out.

Layer-state layout (mirrors models/lm.init_decode_state), one entry per
layer in the unstacked {"prefix", "blocks"} tree:
  attention layers   {"k", "v"}: (num_blocks, block_size, KV, hd) pools in
                     the activation dtype;
  recurrent layers   slot-indexed dense state, (num_slots, ...) per leaf
                     (lm.recurrent_state): O(num_slots), never paged.
Everything is updated in place. Only kv_dtype "fp16" (the activation
dtype) is ported; the quantized int8 / fp8 pools belong to a later slice.
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
    """Paged decode state in the lm state tree: zeroed pools for every
    attention layer, zeroed (num_slots, ...) state for every recurrent
    one."""
    dt = pool_dtype(cfg, kv_dtype)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    lm._check_supported(cfg)

    def one(kind):
        if kind not in ATTN_KINDS:
            return lm.recurrent_state(cfg, kind, num_slots, device)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    return lm._to_tree(cfg, [one(kind) for kind in lm.layer_kinds(cfg)])


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
    place — the copy-on-write primitive (see serving/scheduler.py).
    Recurrent slot state is per slot, never shared, and is untouched."""
    for kind, st in lm._layers(state, cfg):
        if kind in ATTN_KINDS:
            for a in st.values():
                a[dst] = a[src]
    return state


def load_prefill(cfg: ModelConfig, state, cache, slot: int, table_row,
                 block_size: int):
    """Scatter one sequence's prefill cache (lm.prefill at batch 1) into
    the paged state, in place: attention K/V of prompt position p lands in
    block table_row[p // block_size] at offset p % block_size, each
    recurrent layer's final state at index `slot`. The engine fuses
    prefill and this scatter in lm.prefill_paged; this standalone loader
    is the oracle that path is tested against, and the way to seed paged
    state outside the engine. Returns `state`."""
    table_row = torch.as_tensor(table_row).long()
    for (kind, st), (_, ca) in zip(lm._layers(state, cfg),
                                   lm._layers(cache, cfg)):
        if kind in ATTN_KINDS:
            pos = torch.arange(ca["k"].shape[1], device=st["k"].device)
            blk = table_row.to(pos.device)[pos // block_size]
            for name in ("k", "v"):
                st[name][blk, pos % block_size] = ca[name][0].to(
                    st[name].dtype)
            continue
        lm._map(lambda s, c: s.__setitem__(slot, c[0].to(s.dtype)), st, ca)
    return state
