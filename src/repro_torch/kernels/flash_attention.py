"""Blocked GQA flash attention, forward and backward: CUDA kernel wrappers.

The port of `repro/kernels/flash_attention.py` (a Pallas TPU kernel,
forward only). The forward kernels are in `csrc/flash_attention.cu`, the
backward in `csrc/flash_attention_bwd.cu`; `ref.flash_attention_ref` and
`ref.flash_attention_bwd_ref` are their plain twins. A CPU tensor takes
the twin; a CUDA tensor launches a kernel or raises. The dtype picks the
forward kernel: bf16 / f16 run the tensor-core (wgmma) kernel, float32 the
CUDA-core one, since TF32 tensor cores would keep too few bits for
float32's 2e-5. Neither stands in for the other. The tensor-core kernel
reads q, k and v with TMA, so a bf16 / f16 view off a 16-byte boundary is
first copied into a fresh buffer (`build.tma_ready`).

Under autograd (grad mode on and an input that requires grad)
`flash_attention` is a `torch.autograd.Function`: its forward is the
plain call, which saves q, k, v and the output (and, from the tensor-core
kernel, each row's log-sum-exp), and its backward is
`flash_attention_bwd` (the backward kernels on CUDA, its twin on the
CPU). Otherwise the call is the plain forward and records nothing.
The backward's dtype picks its kernels as the forward's does: bf16 / f16
run two wgmma passes and, for a GQA group, a fixed-order sum of per-head
dK / dV partials; float32 runs the two CUDA-core passes.
`flash_attention.launches` counts forward launches,
`flash_attention_bwd.launches` backward calls (two or three kernels
each).

Both take the JAX model's masks: causal or not, a local `window`, and a
bidirectional prefix (`prefix_len`, the prefix-LM mask of paligemma's
vision tokens: the first prefix_len positions see one another both ways,
and every later query sees them). Every route of both kernels has the
prefix arm; prefix_len = 0 is the plain causal mask.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import FLOAT_DTYPES, HEAD_DIMS

# csrc/flash_attention_bwd.cu: BM, the rows of a tensor-core tile (queries
# in the first pass, keys in the second)
BWD_TILE = 64


def _check(name, q, k, v, *more):
    """The CUDA kernels' shape / dtype / layout contract: q (and `more`:
    o, dO) (B, H, Sq, hd), k / v (B, KV, Sk, hd), one float dtype, one
    device, contiguous, H a multiple of KV, hd in HEAD_DIMS."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    for t in (k, v) + more:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: an input on {t.device} {t.dtype}, q "
                             f"on {q.device} {q.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v) + more):
        raise ValueError(f"{name}: inputs must be contiguous")
    if q.dtype not in FLOAT_DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype}")
    if (k.shape != (B, KV, Sk, hd) or v.shape != k.shape or H % KV
            or hd not in HEAD_DIMS
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; the CUDA kernel takes "
                         f"head_dim in {HEAD_DIMS}")


def _forward(q, k, v, causal: bool, window: int, lse=None,
             prefix_len: int = 0):
    """The forward launch. lse: None, or a (B, H, Sq) float32 buffer the
    tensor-core kernel fills with each row's log-sum-exp (log2 units)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       prefix_len=prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check("flash_attention", q, k, v)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if q.dtype != torch.float32:
        # the tensor-core kernel reads q, k and v with TMA: a view off a
        # 16-byte boundary is copied first
        q, k, v = build.tma_ready(q, k, v)
    out = torch.empty_like(q)
    fn = (build.load("flash_attention") if q.dtype == torch.float32
          else build.load("flash_attention", "flash_attention_wgmma"))
    with torch.cuda.device(q.device):
        lse_arg = () if q.dtype == torch.float32 else (build.ptr(lse),)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *lse_arg, build.DTYPE_CODES[q.dtype], B, H, KV, Sq, Sk, hd,
                 int(causal), max(int(window), 0), hd ** -0.5,
                 build.stream(), max(int(prefix_len), 0))
    build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len):
        # the tensor-core forward also writes each row's log-sum-exp, which
        # spares the backward a second forward launch to write them
        lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
               if q.device.type == "cuda" and q.dtype != torch.float32
               else None)
        o = _forward(q, k, v, causal, window, lse, prefix_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.prefix_len = causal, window, prefix_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window,
                                         prefix_len=ctx.prefix_len, lse=lse)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix_len: int = 0):
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd), one float dtype; KV head
    h // (H / KV). window > 0: key u is visible to query i only when
    u > i - window (local attention). prefix_len > 0 (causal): queries
    and keys below prefix_len also see one another both ways (a
    prefix-LM). Returns (B, H, Sq, hd). Carries a gradient to q, k and v
    when grad mode is on and one of them requires it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, prefix_len)
    return _forward(q, k, v, causal, window, prefix_len=prefix_len)


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True,
                        window: int = 0, prefix_len: int = 0, lse=None):
    """The gradient of flash_attention: q, o (its output) and do (the
    output's gradient) (B, H, Sq, hd), k/v (B, KV, Sk, hd), one float
    dtype, contiguous. Returns (dq (B, H, Sq, hd), dk, dv (B, KV, Sk,
    hd)) in the inputs' dtype, accumulated in float32. On CUDA one call
    launches the kernels' two passes (dq per query tile, then dk / dv per
    key tile: per query head for bf16 / f16, whose group's partials a
    third kernel sums in head order; over the group's heads for float32);
    none uses atomics, so the bits do not change from call to call.
    lse: None, or the (B, H, Sq) float32 log-sum-exps the bf16 / f16
    forward saved under autograd; without them a bf16 / f16 call first
    runs the forward kernel to write them (one more forward launch). The
    twin and float32 ignore it. The masks are flash_attention's."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                           window=window,
                                           prefix_len=prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    _check("flash_attention_bwd", q, k, v, o, do)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if Sq == 0 or Sk == 0 or B == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    args = (build.DTYPE_CODES[q.dtype], B, H, KV, Sq, Sk, hd, int(causal),
            max(int(window), 0), hd ** -0.5, build.stream(),
            max(int(prefix_len), 0))
    if q.dtype == torch.float32:
        # each query row's log-sum-exp and rowsum(dO * O), written by the
        # first pass and read by the second
        scratch = torch.empty(2, B, H, Sq, dtype=torch.float32,
                              device=q.device)
        with torch.cuda.device(q.device):
            err = build.load("flash_attention_bwd")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                scratch[0].data_ptr(), scratch[1].data_ptr(), *args)
    else:
        if lse is None:
            # the first pass reads each row's lse as the forward writes it
            lse = torch.empty(B, H, Sq, dtype=torch.float32,
                              device=q.device)
            _forward(q, k, v, causal, window, lse, prefix_len)
        elif (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
              or lse.device != q.device or not lse.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                             f"{lse.dtype} on {lse.device}; the forward's "
                             f"is ({B}, {H}, {Sq}) float32, contiguous")
        # the tensor-core passes read q, k, v, o and dO with TMA / 4-byte
        # loads: a view off a 16-byte boundary is copied first
        q, k, v, o, do = build.tma_ready(q, k, v, o, do)
        # each query row's lse and D, padded to whole 64-row tiles; the
        # group's per-head float32 dK / dV partials when H > KV
        sqp = -(-Sq // BWD_TILE) * BWD_TILE
        scratch = torch.empty(2, B, H, sqp, dtype=torch.float32,
                              device=q.device)
        parts = (torch.empty(2, B, H, Sk, hd, dtype=torch.float32,
                             device=q.device) if H > KV else None)
        with torch.cuda.device(q.device):
            err = build.load("flash_attention_bwd",
                             "flash_attention_bwd_wgmma")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                build.ptr(lse), scratch[0].data_ptr(), scratch[1].data_ptr(),
                build.ptr(None if parts is None else parts[0]),
                build.ptr(None if parts is None else parts[1]), *args)
    build.check_launch("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
