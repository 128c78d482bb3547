"""Blocked GQA flash attention (forward): CUDA kernel wrapper.

The port of `repro/kernels/flash_attention.py` (a Pallas TPU kernel). The
kernels are in `csrc/flash_attention.cu`; `ref.flash_attention_ref` is
their plain twin. A CPU tensor takes the twin; a CUDA tensor launches a
kernel or raises. The dtype picks the kernel: bf16 / f16 run the
tensor-core (wgmma) kernel, float32 the CUDA-core one, since TF32 tensor
cores would keep too few bits for float32's 2e-5. Neither stands in for
the other. The tensor-core kernel reads q, k and v with TMA, so a bf16 /
f16 view off a 16-byte boundary is first copied into a fresh buffer
(`build.tma_ready`). `flash_attention.launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import FLOAT_DTYPES, HEAD_DIMS


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd), one float dtype; KV head
    h // (H / KV). window > 0: key u is visible to query i only when
    u > i - window (local attention). Returns (B, H, Sq, hd)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: k/v on {t.device} {t.dtype},"
                             f" q on {q.device} {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    if q.dtype not in FLOAT_DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}")
    if (k.shape != (B, KV, Sk, hd) or v.shape != k.shape or H % KV
            or hd not in HEAD_DIMS):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; "
                         f"the CUDA kernel takes head_dim in {HEAD_DIMS}")
    if q.dtype != torch.float32:
        # the tensor-core kernel reads q, k and v with TMA: a view off a
        # 16-byte boundary is copied first
        q, k, v = build.tma_ready(q, k, v)
    out = torch.empty_like(q)
    fn = (build.load("flash_attention") if q.dtype == torch.float32
          else build.load("flash_attention", "flash_attention_wgmma"))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 build.DTYPE_CODES[q.dtype], B, H, KV, Sq, Sk, hd,
                 int(causal), max(int(window), 0), hd ** -0.5,
                 build.stream())
    build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
