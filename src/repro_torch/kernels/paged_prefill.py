"""Paged suffix-prefill attention: CUDA kernel wrapper.

The port of `repro/kernels/paged_prefill.py` (a Pallas TPU kernel). The
kernels are in `csrc/paged_prefill.cu`; `ref.paged_prefill_ref` is their
plain twin. A CPU tensor takes the twin; a CUDA tensor launches a kernel
or raises. The dtypes pick the kernel: bf16 / f16 q (the serving path) run
the tensor-core kernel (wgmma, the GQA group at most 64 heads), over a pool
of q's dtype (TMA tiles, the pool gathered in 8-row runs through the block
table) or over an int8 / fp8 pool with its float32 scales (the block's
threads read the 1-byte rows and convert them exactly to q's dtype; the
scales multiply S's and P's columns in float32); a view off a 16-byte
boundary is first copied into a fresh buffer by `build.tma_ready`.
float32 q, over a float32, int8 or fp8 pool, runs the CUDA-core kernel,
since TF32 would keep too few bits for float32's 2e-5. Neither stands in
for the other.
`ref.paged_prefill_tiled_ref` orders the tensor-core kernel's work on the
CPU. `paged_prefill_attention.launches` counts kernel launches,
`paged_prefill_attention.quant_launches` those of them over int8 / fp8
pools.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import FLOAT_DTYPES, HEAD_DIMS, QUANT_DTYPES

# csrc/paged_prefill.cu: a tensor-core block's 64 rows hold whole positions
# of one GQA group
WGMMA_MAX_GROUP = 64


def route(q_dtype) -> str:
    """The kernel a CUDA call launches, from q's dtype alone: "wgmma" for
    bf16 / f16 q (over a pool of q's dtype or an int8 / fp8 pool),
    "cuda_cores" for float32 q (over any pool)."""
    return "cuda_cores" if q_dtype == torch.float32 else "wgmma"


def _check(q, k_suf, v_suf, k_pool, v_pool, block_tables, starts, lengths,
           k_scale, v_scale):
    N, Ls, H, hd = q.shape
    P, bs, KV, hd_p = k_pool.shape
    tensors = [q, k_suf, v_suf, k_pool, v_pool, block_tables, starts,
               lengths]
    quant = k_pool.dtype in QUANT_DTYPES
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale
                                                              is None):
        raise ValueError("paged_prefill_attention: int8/fp8 pools need "
                         "both scale tables, float pools take none")
    if quant:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"paged_prefill_attention: tensor on "
                             f"{t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged_prefill_attention: inputs must be "
                             "contiguous")
    if (q.dtype not in FLOAT_DTYPES or k_suf.dtype != q.dtype
            or v_suf.dtype != q.dtype or v_pool.dtype != k_pool.dtype
            or (k_pool.dtype != q.dtype and not quant)):
        raise TypeError(f"paged_prefill_attention: dtypes q {q.dtype}, "
                        f"suffix {k_suf.dtype}/{v_suf.dtype}, pool "
                        f"{k_pool.dtype}")
    if (k_suf.shape != (N, Ls, KV, hd) or v_suf.shape != k_suf.shape
            or v_pool.shape != k_pool.shape or hd_p != hd or H % KV):
        raise ValueError(f"paged_prefill_attention: q {tuple(q.shape)}, "
                         f"suffix {tuple(k_suf.shape)}, pool "
                         f"{tuple(k_pool.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_prefill_attention: CUDA kernel takes "
                         f"head_dim in {HEAD_DIMS}; got {hd}")
    if quant and (k_scale.shape != (P, bs, KV) or v_scale.shape != (P, bs, KV)
                  or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError("paged_prefill_attention: scale tables must be "
                         f"float32 of shape {(P, bs, KV)}")
    for name, t in (("block_tables", block_tables), ("starts", starts),
                    ("lengths", lengths)):
        if t.dtype != torch.int32 or t.shape[0] != N:
            raise ValueError(f"paged_prefill_attention: {name} must be "
                             f"int32 with leading dim {N}")


def paged_prefill_attention(q, k_suf, v_suf, k_pool, v_pool, block_tables,
                            starts, lengths, *, k_scale=None, v_scale=None,
                            window: int = 0):
    """q: (N, Ls, H, hd) suffix queries at positions starts[n] + i;
    k_suf/v_suf: (N, Ls, KV, hd) fresh suffix K/V (same dtype as q);
    k_pool/v_pool: (P, bs, KV, hd); block_tables: (N, M) int32;
    starts/lengths: (N,) int32; k_scale/v_scale (optional): (P, bs, KV)
    float32 tables of an int8 / fp8 pool; window > 0 limits each query to
    the trailing `window` positions. Rows with no valid key (lengths == 0)
    give zeros. Returns (N, Ls, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_prefill_ref(q, k_suf, v_suf, k_pool, v_pool,
                                     block_tables, starts, lengths, k_scale,
                                     v_scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: unsupported device "
                         f"{q.device}")
    build.refuse_grad("paged_prefill_attention", q, k_suf, v_suf, k_pool,
                      v_pool, k_scale, v_scale)
    _check(q, k_suf, v_suf, k_pool, v_pool, block_tables, starts, lengths,
           k_scale, v_scale)
    N, Ls, H, hd = q.shape
    P, bs, KV, _ = k_pool.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    tensor_cores = route(q.dtype) == "wgmma"
    if tensor_cores:
        if H // KV > WGMMA_MAX_GROUP:
            raise ValueError(f"paged_prefill_attention: {H // KV} query "
                             f"heads per KV head; the tensor-core kernel "
                             f"takes at most {WGMMA_MAX_GROUP}")
        # TMA reads q, the suffix and a 16-bit pool, 16-byte loads a 1-byte
        # pool: a view off a 16-byte boundary is copied first (for a pool,
        # the whole pool)
        q, k_suf, v_suf, k_pool, v_pool = build.tma_ready(
            q, k_suf, v_suf, k_pool, v_pool)
    with torch.cuda.device(q.device):
        if tensor_cores:
            err = build.load("paged_prefill", "paged_prefill_wgmma")(
                q.data_ptr(), k_suf.data_ptr(), v_suf.data_ptr(),
                k_pool.data_ptr(), v_pool.data_ptr(), build.ptr(k_scale),
                build.ptr(v_scale), block_tables.data_ptr(),
                starts.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pool.dtype],
                N, Ls, H, KV, hd, P, bs, block_tables.shape[1], int(window),
                hd ** -0.5, build.stream())
        else:
            err = build.load("paged_prefill")(
                q.data_ptr(), k_suf.data_ptr(), v_suf.data_ptr(),
                k_pool.data_ptr(), v_pool.data_ptr(), build.ptr(k_scale),
                build.ptr(v_scale), block_tables.data_ptr(),
                starts.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pool.dtype],
                N, Ls, H, KV, hd, bs, block_tables.shape[1], int(window),
                hd ** -0.5, build.stream())
    build.check_launch("paged_prefill_attention", err)
    paged_prefill_attention.launches += 1
    paged_prefill_attention.quant_launches += k_scale is not None
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.quant_launches = 0   # of them, over int8 / fp8 pools
