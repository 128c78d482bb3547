"""GQA attention (PyTorch port of `repro.models.attention`).

Dense (training / single-shot prefill), dense-cache decode, and the paged
serving paths. The three attention blocks launch the port's CUDA kernels
on CUDA tensors (through the wrappers in `repro_torch.kernels`, which take
their plain twins on CPU tensors):

  attention_block                 -> kernels.flash_attention
  decode_attention_block          -> kernels.paged_attention, the dense
                                     cache viewed as a paged pool with an
                                     identity block table (one block per
                                     row), so `generate()` decodes with the
                                     same kernel as the serving engine
  paged_decode_attention_block    -> kernels.paged_attention
  paged_prefill_attention_block   -> kernels.paged_prefill

Caches and pools are updated in place (the JAX runner donates them).
The dense path's local-attention `window` runs through the flash kernel;
quantized (int8 / fp8) pools, the paged decode `window` and the dense
path's bidirectional `prefix_len` on CUDA belong to later slices and raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (flash_attention, paged_attention,
                                 paged_prefill_attention)
from repro_torch.models.layers import apply_rope, init_dense

NEG_INF = -1e30


def init_attention(gen, d_model, n_heads, n_kv_heads, head_dim, dtype):
    return {
        "wq": init_dense(gen, d_model, n_heads * head_dim, dtype),
        "wk": init_dense(gen, d_model, n_kv_heads * head_dim, dtype),
        "wv": init_dense(gen, d_model, n_kv_heads * head_dim, dtype),
        "wo": init_dense(gen, n_heads * head_dim, d_model, dtype),
    }


def _qkv(params, x, n_heads, n_kv_heads, head_dim, positions, rope_theta):
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(B, S, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _no_quant(cache):
    if "k_scale" in cache:
        raise NotImplementedError(
            "int8/fp8 KV pools are not wired into the PyTorch port yet "
            "(a later slice); use kv_dtype='fp16'")


def chunked_causal_attention(q, k, v, *, chunk: int = 512, window: int = 0,
                             prefix_len: int = 0):
    """Exact causal attention over query chunks: the plain version of the
    flash kernel, with the JAX path's `window` (local attention) and
    `prefix_len` (bidirectional prefix) options. q: (B, S, H, hd);
    k/v: (B, S, KV, hd). Returns (B, S, H, hd) in v's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    scale = hd ** -0.5
    chunk = min(chunk, S)
    kpos = torch.arange(S, device=q.device)
    kf = k.float()
    outs = []
    for c0 in range(0, S, chunk):
        qi = q[:, c0:c0 + chunk]
        qpos = torch.arange(c0, c0 + qi.shape[1], device=q.device)
        qg = qi.float().reshape(B, -1, KV, group, hd)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
        ok = kpos[None, :] <= qpos[:, None]
        if prefix_len > 0:
            ok = ok | ((qpos[:, None] < prefix_len)
                       & (kpos[None, :] < prefix_len))
        if window > 0:
            ok = ok & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
        outs.append(o.reshape(B, -1, H, hd))
    return torch.cat(outs, dim=1).to(v.dtype)


def attention_block(params, x, positions, cfg, *, window: int = 0,
                    prefix_len: int = 0, return_kv: bool = False):
    """Full attention sub-layer (projections + causal attention).

    Causal attention, with or without a local `window`, runs through the
    flash kernel wrapper; `cfg.attn_impl` ("chunked" / "bisect") selects
    between two TPU-side formulations of the same exact attention and has
    no counterpart here. A bidirectional prefix (prefix_len > 0) takes
    `chunked_causal_attention` on the CPU and raises on CUDA.
    return_kv=True also returns the rope'd (k, v)."""
    B, S, D = x.shape
    q, k, v = _qkv(params, x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                   positions, cfg.rope_theta)
    if prefix_len == 0:
        o = flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            causal=True, window=window).transpose(1, 2)
    elif x.device.type == "cuda":
        raise NotImplementedError(
            "flash attention with a bidirectional prefix has no CUDA kernel "
            "yet (the MoE-and-frontends slice)")
    else:
        o = chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk,
                                     window=window, prefix_len=prefix_len)
    out = o.reshape(B, S, -1) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


# ----------------------------------------------------------------------------
# KV-cache decode
# ----------------------------------------------------------------------------

def init_kv_cache(batch, max_len, n_kv_heads, head_dim, dtype, device):
    shape = (batch, max_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention_block(params, x, cache, pos: int, cfg, *,
                           window: int = 0):
    """One-token decode. x: (B, 1, D); cache k/v: (B, S_max, KV, hd),
    updated in place; pos: the current position (an int). For window > 0
    the cache is a rolling buffer of size `window`. Returns (out, cache).

    Attention runs through the paged decode kernel: the cache is a pool
    of B blocks of S_max tokens, row b's table is [b], and the context is
    pos + 1 tokens (all written slots of a rolling buffer)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                   positions, cfg.rope_theta)
    S_max = cache["k"].shape[1]
    slot = pos % max(window, 1) if window > 0 else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    ctx = min(pos + 1, S_max) if window > 0 else pos + 1
    tables = torch.arange(B, dtype=torch.int32, device=x.device)[:, None]
    ctx_lens = torch.full((B,), ctx, dtype=torch.int32, device=x.device)
    o = paged_attention(q[:, 0].contiguous(), cache["k"], cache["v"], tables,
                        ctx_lens)
    return (o.reshape(B, 1, -1) @ params["wo"]).to(x.dtype), cache


# ----------------------------------------------------------------------------
# Paged KV-cache prefill (bucketed batched admission over cached prefixes)
# ----------------------------------------------------------------------------

def streamed_paged_attention(q, k, v, cache, block_tables, positions,
                             starts, lengths, *, scale, attn_chunk,
                             window: int = 0):
    """Suffix-prefill attention over a paged KV cache, with the JAX
    oracle's signature. q: (N, Ls, H, hd) rope'd suffix queries; k/v:
    (N, Ls, KV, hd) rope'd suffix K/V; cache k/v: (P, bs, KV, hd) pools;
    block_tables: (N, M); positions: (N, Ls) (= starts[:, None] + i);
    starts/lengths: (N,). Queries attend to pool positions < starts and
    causally within the suffix (index < lengths - starts).

    Runs the paged-prefill kernel (its plain twin on the CPU). The JAX
    version streams the pool in bands of `attn_chunk` keys to bound its
    score memory; the kernel's fixed tiles bound it instead, so
    `attn_chunk` does not change the result and is not used. Returns
    (N, Ls, H, hd) in q's dtype."""
    if abs(scale - q.shape[-1] ** -0.5) > 1e-12:
        raise ValueError("the paged-prefill kernel uses scale = hd ** -0.5")
    return paged_prefill_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), cache["k"],
        cache["v"], block_tables, starts, lengths,
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        window=window)


def paged_prefill_attention_block(params, x, cache, positions, block_tables,
                                  starts, lengths, cached_lens, cfg, *,
                                  window: int = 0):
    """Suffix prefill for a batch of sequences straight into paged KV.

    x: (N, Ls, D) — each row one prompt SUFFIX (tokens from starts[n] on),
    right-padded to Ls; positions: (N, Ls) absolute positions; starts /
    lengths / cached_lens: (N,) as in the JAX block; block_tables:
    (N, max_blocks); cache k/v: the pools, updated in place.

    Scatter-then-attend: the suffix's rope'd K/V lands at
    (table[p // bs], p % bs) for cached_lens <= p < lengths (padded and
    already-cached positions go to the null block 0, where duplicate
    indices make the write order, and nothing else, nondeterministic);
    then the kernel attends. The writes never touch what the kernel reads
    (pool positions < starts <= cached_lens), so the order is free.
    Returns (out, cache)."""
    _no_quant(cache)
    N, Ls, D = x.shape
    q, k, v = _qkv(params, x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                   positions, cfg.rope_theta)
    bs = cache["k"].shape[1]
    M = block_tables.shape[1]
    write = (positions >= cached_lens[:, None]) & (positions
                                                   < lengths[:, None])
    blk = torch.gather(block_tables, 1,
                       (positions // bs).clamp(0, M - 1).long())
    blk = torch.where(write, blk, torch.zeros_like(blk)).long()
    off = (positions % bs).long()
    cache["k"].index_put_((blk, off), k)
    cache["v"].index_put_((blk, off), v)
    o = streamed_paged_attention(q, k, v, cache, block_tables, positions,
                                 starts, lengths,
                                 scale=cfg.head_dim ** -0.5,
                                 attn_chunk=cfg.attn_chunk, window=window)
    out = (o.reshape(N, Ls, -1) @ params["wo"]).to(x.dtype)
    return out, cache


# ----------------------------------------------------------------------------
# Paged KV-cache decode (continuous-batching serving)
# ----------------------------------------------------------------------------

def paged_decode_attention_block(params, x, cache, positions, block_tables,
                                 cfg, *, window: int = 0):
    """One-token decode through a paged KV cache. x: (B, 1, D); cache k/v:
    (num_blocks, block_size, KV, hd) pools, updated in place; positions:
    (B,) int32 per-slot positions; block_tables: (B, max_blocks) int32.

    The current token's K/V is scattered into (table[b, p // bs], p % bs),
    then the kernel attends over ctx = positions + 1 tokens through the
    table. Returns (out, cache)."""
    _no_quant(cache)
    if window > 0:
        raise NotImplementedError(
            "paged decode with a sliding window: the paged_attention kernel "
            "has no window yet (a later slice)")
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                   positions[:, None], cfg.rope_theta)
    bs = cache["k"].shape[1]
    M = block_tables.shape[1]
    rows = torch.arange(B, device=x.device)
    blk = block_tables[rows, (positions // bs).clamp(0, M - 1).long()].long()
    off = (positions % bs).long()
    cache["k"].index_put_((blk, off), k[:, 0])
    cache["v"].index_put_((blk, off), v[:, 0])
    o = paged_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                        block_tables, (positions + 1).to(torch.int32))
    return (o.reshape(B, 1, -1) @ params["wo"]).to(x.dtype), cache
