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
Everything is updated in place. Quantized pools (`kv_dtype` "int8" /
"fp8", fp8 being float8_e4m3fn) add float32 "k_scale" / "v_scale" tables
of shape (num_blocks, block_size, KV): one max-abs scale per (token slot,
KV head), so every write quantizes on its own and copying a block's
(q, scale) pair is exact — what the host spill tier relies on. "fp16" is
the activation dtype.

Host-tier payloads (`gather_blocks` / `scatter_blocks`) mirror the state
tree: per attention layer a dict of (W, ...) leaves, one row per block,
the scale tables among them; recurrent layers give empty dicts.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, lm

ATTN_KINDS = ("attn", "attn_local", "moe")
KV_DTYPES = ("fp16", "int8", "fp8")


def pool_dtype(cfg: ModelConfig, kv_dtype: str = "fp16") -> torch.dtype:
    """Element dtype of the K/V pools for a kv_dtype knob."""
    if kv_dtype == "fp16":
        return cfg.act_dtype
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected {KV_DTYPES}")


def quantized(kv_dtype: str) -> bool:
    return kv_dtype != "fp16"


def init_paged_state(cfg: ModelConfig, num_slots: int, num_blocks: int,
                     block_size: int, kv_dtype: str = "fp16", *, device):
    """Paged decode state in the lm state tree: zeroed pools (and scale
    tables, when quantized) for every attention layer, zeroed
    (num_slots, ...) state for every recurrent one."""
    dt = pool_dtype(cfg, kv_dtype)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    lm._check_supported(cfg)

    def one(kind):
        if kind not in ATTN_KINDS:
            return lm.recurrent_state(cfg, kind, num_slots, device)
        # zero bytes are 0.0 in every pool dtype (fp8 included)
        st = {n: torch.zeros(shape, dtype=torch.uint8 if dt.itemsize == 1
                             else dt, device=device).view(dt)
              for n in ("k", "v")}
        if quantized(kv_dtype):
            for name in ("k_scale", "v_scale"):
                st[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
        return st

    return lm._to_tree(cfg, [one(kind) for kind in lm.layer_kinds(cfg)])


def _n_attn_layers(cfg: ModelConfig) -> int:
    return (sum(k in ATTN_KINDS for k in cfg.prefix_pattern)
            + cfg.n_super * sum(k in ATTN_KINDS for k in cfg.block_pattern))


def paged_bytes(cfg: ModelConfig, num_blocks: int, block_size: int,
                kv_dtype: str = "fp16") -> int:
    """Attention-cache bytes of the pool (the memory the paging bounds),
    from the pool dtype plus the scale tables."""
    itemsize = pool_dtype(cfg, kv_dtype).itemsize
    per_tok = 2 * cfg.n_kv_heads * cfg.head_dim * itemsize
    if quantized(kv_dtype):
        per_tok += 2 * cfg.n_kv_heads * 4      # f32 scale per (slot, head)
    return _n_attn_layers(cfg) * num_blocks * block_size * per_tok


def block_bytes(cfg: ModelConfig, block_size: int,
                kv_dtype: str = "fp16") -> int:
    """Bytes one physical block occupies across all attention pools (the
    host-tier payload size per demoted block)."""
    return paged_bytes(cfg, 1, block_size, kv_dtype)


def copy_block(cfg: ModelConfig, state, src: int, dst: int):
    """Copy physical block `src` into `dst` in every attention pool, in
    place — the copy-on-write primitive (see serving/scheduler.py). Every
    pool leaf is copied, the scale tables of a quantized pool with their
    payload. Recurrent slot state is per slot, never shared, and is
    untouched."""
    for kind, st in lm._layers(state, cfg):
        if kind in ATTN_KINDS:
            for a in st.values():
                b = attention.pool_bytes(a)
                b[dst] = b[src]
    return state


def load_prefill(cfg: ModelConfig, state, cache, slot: int, table_row,
                 block_size: int):
    """Scatter one sequence's prefill cache (lm.prefill at batch 1) into
    the paged state, in place: attention K/V of prompt position p lands in
    block table_row[p // block_size] at offset p % block_size, each
    recurrent layer's final state at index `slot`. The engine fuses
    prefill and this scatter in lm.prefill_paged; this standalone loader
    is the oracle that path is tested against, and the way to seed paged
    state outside the engine. Quantized pools quantize on landing,
    scattering (q, scale) per token slot. Returns `state`."""
    table_row = torch.as_tensor(table_row).long()
    for (kind, st), (_, ca) in zip(lm._layers(state, cfg),
                                   lm._layers(cache, cfg)):
        if kind in ATTN_KINDS:
            pos = torch.arange(ca["k"].shape[1], device=st["k"].device)
            blk = table_row.to(pos.device)[pos // block_size]
            off = pos % block_size
            for name in ("k", "v"):
                x = ca[name][0]
                if f"{name}_scale" in st:
                    x, sc = attention.quantize_kv(x, st[name].dtype)
                    st[f"{name}_scale"][blk, off] = sc
                attention.pool_bytes(st[name])[blk, off] = \
                    attention.pool_bytes(x.to(st[name].dtype))
            continue
        lm._map(lambda s, c: s.__setitem__(slot, c[0].to(s.dtype)), st, ca)
    return state


# ----------------------------------------------------------------------------
# host-tier payload movement: gather blocks out of / scatter them back into
# the attention pools, every leaf with the block axis first
# ----------------------------------------------------------------------------

def gather_blocks(cfg: ModelConfig, state, ids, device=None):
    """Gather physical blocks `ids` ((W,) int64 on the state's device) from
    every attention pool, copied to `device` when one is given (the host
    tier's demotion). Returns the state tree with a dict of (W, ...)
    leaves per attention layer (the scale tables included) and an empty
    dict per recurrent layer (its state is per slot, never demoted)."""
    def take(a):
        return attention.pool_bytes(a)[ids].to(device or a.device) \
            .view(a.dtype)

    return lm._to_tree(cfg, [
        {n: take(a) for n, a in st.items()} if kind in ATTN_KINDS else {}
        for kind, st in lm._layers(state, cfg)])


def scatter_blocks(cfg: ModelConfig, state, ids, payload):
    """Scatter a gather_blocks-shaped payload back into the pools at `ids`,
    in place. Padded entries may target NULL_BLOCK (the null sink).
    Returns `state`."""
    for (kind, st), (_, pa) in zip(lm._layers(state, cfg),
                                   lm._layers(payload, cfg)):
        if kind in ATTN_KINDS:
            for n, a in st.items():
                attention.pool_bytes(a)[ids] = attention.pool_bytes(
                    pa[n].to(a.dtype)).to(a.device)
    return state
