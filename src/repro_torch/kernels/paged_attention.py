"""Paged single-token GQA decode attention: CUDA kernel wrapper.

The port of `repro/kernels/paged_attention.py` (a Pallas TPU kernel). The
kernel is `csrc/paged_attention.cu`; `ref.paged_attention_ref` is its
plain twin. A CPU tensor takes the twin; a CUDA tensor launches the kernel
or raises. `paged_attention.launches` counts kernel launches. The kernel
gathers pool rows with TMA, so a pool view off a 16-byte boundary is
first copied into a fresh buffer (`build.tma_ready`).

The kernel splits each row's tokens into chunks of `build.PAGED_CHUNK`
and merges the chunks inside the same launch: the wrapper sizes its
float32 scratch from the table's shape alone (reading ctx_lens on the
host would sync every decode step) and keeps one zeroed int32 counter per
(row, KV head) per device, which the kernel leaves zeroed. Calls on one
device share the counters, so they must run on one stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import (FLOAT_DTYPES, HEAD_DIMS, PAGED_CHUNK,
                                      QUANT_DTYPES)

# largest H / KV the CUDA kernel takes, by head dim (csrc max_group)
MAX_GROUP = {hd: 16 if hd >= 256 else 8 for hd in HEAD_DIMS}


def _check(q, k_pool, v_pool, block_tables, ctx_lens, k_scale, v_scale):
    B, H, hd = q.shape
    N, bs, KV, hd_p = k_pool.shape
    tensors = [q, k_pool, v_pool, block_tables, ctx_lens]
    if k_scale is not None or v_scale is not None:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t is None:
            raise ValueError("paged_attention: k_scale and v_scale go "
                             "together")
        if t.device != q.device:
            raise ValueError(f"paged_attention: tensor on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention: inputs must be contiguous")
    if q.dtype not in FLOAT_DTYPES:
        raise TypeError(f"paged_attention: q dtype {q.dtype}")
    quant = k_pool.dtype in QUANT_DTYPES
    if v_pool.dtype != k_pool.dtype or (k_pool.dtype != q.dtype
                                        and not quant):
        raise TypeError(f"paged_attention: pool dtype {k_pool.dtype} with "
                        f"q dtype {q.dtype}")
    if quant != (k_scale is not None):
        raise ValueError("paged_attention: int8/fp8 pools need scale "
                         "tables, float pools take none")
    if v_pool.shape != k_pool.shape or hd_p != hd or H % KV:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} vs pool "
                         f"{tuple(k_pool.shape)}")
    if hd not in HEAD_DIMS or H // KV > MAX_GROUP[hd]:
        raise ValueError(f"paged_attention: CUDA kernel takes head_dim in "
                         f"{HEAD_DIMS} and H/KV up to {MAX_GROUP}; got "
                         f"hd={hd}, H/KV={H // KV}")
    if quant and (k_scale.shape != (N, bs, KV) or v_scale.shape != (N, bs, KV)
                  or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError("paged_attention: scale tables must be float32 "
                         f"of shape {(N, bs, KV)}")
    if (block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != B
            or ctx_lens.shape != (B,)):
        raise ValueError("paged_attention: block_tables (B, M) and "
                         "ctx_lens (B,) must be int32")


_COUNTERS = {}   # device -> zeroed int32 counters, grown as needed


def _counters(device, n):
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = _COUNTERS[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                            device=device)
    return c


def paged_attention(q, k_pool, v_pool, block_tables, ctx_lens, *,
                    k_scale=None, v_scale=None):
    """q: (B, H, hd); k_pool/v_pool: (N, bs, KV, hd); block_tables: (B, M)
    int32; ctx_lens: (B,) int32 valid-token counts (0 => zeros); k_scale /
    v_scale (optional): (N, bs, KV) float32 tables of an int8 / fp8-e4m3
    pool. Returns (B, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                       ctx_lens, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check(q, k_pool, v_pool, block_tables, ctx_lens, k_scale, v_scale)
    # the kernel copies pool rows with TMA: a pool view off a 16-byte
    # boundary is copied whole first
    k_pool, v_pool = build.tma_ready(k_pool, v_pool)
    B, H, hd = q.shape
    _, bs, KV, _ = k_pool.shape
    M = block_tables.shape[1]
    out = torch.empty_like(q)
    # each split's partial: acc (group x hd), m and l per query head,
    # padded to whole float4s
    group, n_split = H // KV, -(-M * bs // PAGED_CHUNK)
    scratch = torch.empty(B * KV * n_split
                          * (group * hd + -(-2 * group // 4) * 4),
                          dtype=torch.float32, device=q.device)
    counters = _counters(q.device, B * KV)
    fn = build.load("paged_attention")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 build.ptr(k_scale), build.ptr(v_scale),
                 block_tables.data_ptr(), ctx_lens.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
                 build.DTYPE_CODES[q.dtype],
                 build.DTYPE_CODES[k_pool.dtype], B, H, KV, hd, bs, M,
                 hd ** -0.5, build.stream())
    build.check_launch("paged_attention", err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
