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
A local-attention `window` runs through every kernel (the dense path's
flash, the paged decode's and the paged prefill's). Quantized (int8 /
fp8-e4m3) pools carry float32 "k_scale" / "v_scale" tables, one max-abs
scale per (token slot, KV head); K/V quantize on landing in the pool and
the kernels dequantize what they read (their int8 / fp8 arms). The dense
path's bidirectional `prefix_len` (paligemma's vision prefix) runs
through the flash kernels' prefix arm, forward and backward.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels import (flash_attention, paged_attention,
                                 paged_prefill_attention)
from repro_torch.models.layers import apply_rope, init_dense


def init_attention(key, d_model, n_heads, n_kv_heads, head_dim, dtype):
    kq, kk, kv, ko = prng.split(key, 4)
    return {
        "wq": init_dense(kq, d_model, n_heads * head_dim, dtype),
        "wk": init_dense(kk, d_model, n_kv_heads * head_dim, dtype),
        "wv": init_dense(kv, d_model, n_kv_heads * head_dim, dtype),
        "wo": init_dense(ko, n_heads * head_dim, d_model, dtype),
    }


def _qkv(params, x, n_heads, n_kv_heads, head_dim, positions, rope_theta):
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(B, S, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


# ----------------------------------------------------------------------------
# Quantized paged KV pools (the reference's per-slot quantizer): scales are
# max-abs over head_dim per (token slot, KV head), so each write quantizes
# on its own and copying a block's (q, scale) pair is an exact round trip.
# ----------------------------------------------------------------------------

_POOL_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def pool_qmax(dtype) -> float:
    """Max representable magnitude targeted by quantize_kv for a pool."""
    return _POOL_QMAX[dtype]


def quantize_kv(x, dtype):
    """x: (..., KV, hd) -> (q: same shape in `dtype`, scale: (..., KV) f32).

    scale = max|x| / qmax over head_dim; q = x / max(scale, 1e-12) (a
    division, as the reference), rounded half to even and clipped to
    [-127, 127] for int8; fp8 takes the cast's round to nearest even with
    no clip (the largest element lands on 448 within an ulp). All-zero
    slots get scale 0, so dequantize returns exact zeros."""
    qmax = pool_qmax(dtype)
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / qmax
    q = xf / torch.clamp(scale, min=1e-12)[..., None]
    if not dtype.is_floating_point:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(dtype), scale


def dequantize_kv(q, scale):
    """Inverse of quantize_kv: (..., KV, hd) pool values -> float32."""
    return q.float() * scale[..., None]


def pool_bytes(t):
    """An fp8 pool (or payload) viewed as uint8, so indexing and copies
    take the byte kernels every device has; other dtypes as they are."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _write_pool(cache, blk, off, k, v):
    """Scatter K/V rows into the pools at (blk, off), in place; into a
    quantized pool as (q, scale) pairs."""
    if "k_scale" in cache:                       # quantize on landing
        k, sk = quantize_kv(k, cache["k"].dtype)
        v, sv = quantize_kv(v, cache["v"].dtype)
        cache["k_scale"].index_put_((blk, off), sk)
        cache["v_scale"].index_put_((blk, off), sv)
    pool_bytes(cache["k"]).index_put_((blk, off), pool_bytes(k))
    pool_bytes(cache["v"]).index_put_((blk, off), pool_bytes(v))


def attention_block(params, x, positions, cfg, *, window: int = 0,
                    prefix_len: int = 0, return_kv: bool = False):
    """Full attention sub-layer (projections + causal attention).

    Causal attention, with or without a local `window` or a bidirectional
    prefix (prefix_len > 0: the first prefix_len positions see one another
    both ways), runs through the flash kernel wrapper; `cfg.attn_impl`
    ("chunked" / "bisect") selects between two TPU-side formulations of
    the same exact attention and has no counterpart here.
    return_kv=True also returns the rope'd (k, v)."""
    B, S, D = x.shape
    q, k, v = _qkv(params, x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                   positions, cfg.rope_theta)
    o = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=True,
                        window=window, prefix_len=prefix_len).transpose(1, 2)
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
    (pool positions < starts <= cached_lens), so the order is free. A
    quantized pool takes the suffix quantized; the kernel attends to the
    raw suffix K/V and the dequantized prefix, as the reference. Returns
    (out, cache)."""
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
    _write_pool(cache, blk, off, k, v)
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
    table, the last `window` of them when window > 0 (the pools keep the
    whole history; the mask bounds the receptive field, as in the JAX
    block). A quantized pool takes the token quantized, and the kernel
    reads it back dequantized with the rest. Returns (out, cache)."""
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                   positions[:, None], cfg.rope_theta)
    bs = cache["k"].shape[1]
    M = block_tables.shape[1]
    rows = torch.arange(B, device=x.device)
    blk = block_tables[rows, (positions // bs).clamp(0, M - 1).long()].long()
    off = (positions % bs).long()
    _write_pool(cache, blk, off, k[:, 0], v[:, 0])
    o = paged_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                        block_tables, (positions + 1).to(torch.int32),
                        k_scale=cache.get("k_scale"),
                        v_scale=cache.get("v_scale"), window=window)
    return (o.reshape(B, 1, -1) @ params["wo"]).to(x.dtype), cache
