"""RG-LRU gated linear recurrence: CUDA kernel wrapper.

The port of `repro/kernels/rglru_scan.py` (a Pallas TPU kernel), the scan
of every RG-LRU layer (`models/recurrent.py:rglru_block_seq`). The kernel
is `csrc/rglru_scan.cu`, one launch a call of one of its two kernels,
chosen by `route` from the shape and the pointers before the launch: the
bulk kernel (a block per 32-channel tile of a batch row, time chunks
staged through shared memory by asynchronous copies) for rows that are
16-byte multiples at 16-byte aligned pointers and T of at least a chunk;
the direct kernel (a thread per channel) for the rest, decode's T = 1
among them. Both give the same bits. `ref.rglru_scan_ref` is its plain
twin. A CPU tensor takes the twin; a CUDA tensor launches the kernel or
raises.
`rglru_scan.launches` counts kernel launches.

Under autograd (grad mode on and an input that requires grad)
`rglru_scan` is a `torch.autograd.Function`: its forward is the plain
call, which saves a, h_seq and h0, and its backward is `rglru_scan_bwd`,
the reverse scan of `csrc/rglru_scan_bwd.cu` (a thread per channel
walking its steps backward; `ref.rglru_scan_bwd_ref` is its twin and the
CPU route). `rglru_scan_bwd.launches` counts its launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import FLOAT_DTYPES

# csrc/rglru_scan.cu: TC (steps a staged chunk), CW (channels a bulk
# block), THREADS (threads a direct block)
BULK_CHUNK = 64
BULK_TILE = 32
DIRECT_THREADS = 128
MAX_GRID_Y = 65535


def route(B: int, T: int, C: int, dtype: torch.dtype, *ptrs: int) -> str:
    """The kernel a call of shape (B, T, C) in `dtype` with inputs at
    device addresses `ptrs` launches: "bulk" where every row of a channel
    tile can be copied in 16-byte pieces (C * itemsize and every pointer
    16-byte multiples) and T fills at least one chunk, else "direct"."""
    if (T >= BULK_CHUNK and B <= MAX_GRID_Y and C * dtype.itemsize % 16 == 0
            and all(p % 16 == 0 for p in ptrs)):
        return "bulk"
    return "direct"


def blocks(B: int, C: int, kernel: str) -> int:
    """Blocks the launch takes: one per 32-channel tile of a batch row
    (bulk), one per 128 channels of the flattened (B, C) (direct)."""
    if kernel == "bulk":
        return B * -(-C // BULK_TILE)
    return -(-B * C // DIRECT_THREADS)


def plan(a, x):
    """(kernel, blocks) of a call on tensors a, x (h_seq is a fresh
    allocation, so aligned)."""
    B, T, C = a.shape
    kernel = route(B, T, C, a.dtype, a.data_ptr(), x.data_ptr())
    return kernel, blocks(B, C, kernel)


def _check(name, a, x, h0):
    """The CUDA kernels' contract: a, x (B, T, C) of one float dtype on
    one device, h0 (B, C) float32 or None, all contiguous."""
    if a.dim() != 3 or x.shape != a.shape:
        raise ValueError(f"{name}: a {tuple(a.shape)}, x "
                         f"{tuple(x.shape)}; both must be (B, T, C)")
    B, T, C = a.shape
    if x.device != a.device or x.dtype != a.dtype:
        raise ValueError(f"{name}: x on {x.device} {x.dtype}, a on "
                         f"{a.device} {a.dtype}")
    if a.dtype not in FLOAT_DTYPES:
        raise TypeError(f"{name}: dtype {a.dtype}")
    if h0 is not None and (h0.device != a.device or h0.dtype != torch.float32
                           or h0.shape != (B, C)):
        raise ValueError(f"{name}: h0 must be float32 {(B, C)} on "
                         f"{a.device}; got {h0.dtype} {tuple(h0.shape)} on "
                         f"{h0.device}")
    for t in (a, x) + (() if h0 is None else (h0,)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x, h0):
        h_seq, h_T = _scan(a, x, h0)
        ctx.save_for_backward(a, h_seq, h0)
        ctx.set_materialize_grads(False)
        return h_seq, h_T

    @staticmethod
    def backward(ctx, dh_seq, dh_T):
        a, h_seq, h0 = ctx.saved_tensors
        if dh_seq is None:
            dh_seq = torch.zeros_like(h_seq)
        da, dx, dh0 = rglru_scan_bwd(a, h_seq, h0, dh_seq.contiguous(),
                                     None if dh_T is None
                                     else dh_T.contiguous())
        return da, dx, (dh0 if h0 is not None else None)


def rglru_scan(a, x, h0=None):
    """h_t = a_t * h_{t-1} + x_t per channel, float32 state.

    a, x: (B, T, C), one float dtype, contiguous; h0: (B, C) float32 or
    None (zeros). Returns (h_seq (B, T, C) in x's dtype, h_T (B, C)
    float32). Carries a gradient to a, x and h0 when grad mode is on and
    one of them requires it."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, x, h0)):
        return _RGLRUScan.apply(a, x, h0)
    return _scan(a, x, h0)


def _scan(a, x, h0):
    """The forward launch (the twin on the CPU)."""
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, x, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    _check("rglru_scan", a, x, h0)
    B, T, C = a.shape
    h_seq = torch.empty_like(x)
    h_T = torch.empty(B, C, dtype=torch.float32, device=a.device)
    if B * C == 0:
        return h_seq, h_T
    kernel, _ = plan(a, x)
    fn = build.load("rglru_scan")
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), x.data_ptr(), build.ptr(h0),
                 h_seq.data_ptr(), h_T.data_ptr(),
                 build.DTYPE_CODES[a.dtype], B, T, C, kernel == "bulk",
                 build.stream())
    build.check_launch("rglru_scan", err)
    rglru_scan.launches += 1
    return h_seq, h_T


rglru_scan.launches = 0
rglru_scan.route = route
rglru_scan.blocks = blocks
rglru_scan.plan = plan


def rglru_scan_bwd(a, h_seq, h0, dh_seq, dh_T=None):
    """The gradient of rglru_scan: a and h_seq (the forward's output) and
    dh_seq (B, T, C) of one float dtype, h0 / dh_T (B, C) float32 or None
    (zeros), contiguous. Returns (da (B, T, C) in a's dtype, dx in
    h_seq's dtype, dh0 (B, C) float32). On CUDA one launch of
    csrc/rglru_scan_bwd.cu; its twin is ref.rglru_scan_bwd_ref, whose
    bits it gives (each step a float32 add and two float32 multiplies,
    each rounded on its own)."""
    if a.device.type == "cpu":
        return ref.rglru_scan_bwd_ref(a, h_seq, h0, dh_seq, dh_T)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd: unsupported device {a.device}")
    _check("rglru_scan_bwd", a, h_seq, h0)
    _check("rglru_scan_bwd", a, dh_seq, dh_T)
    B, T, C = a.shape
    da, dx = torch.empty_like(a), torch.empty_like(h_seq)
    dh0 = torch.empty(B, C, dtype=torch.float32, device=a.device)
    if B * C == 0:
        return da, dx, dh0
    with torch.cuda.device(a.device):
        err = build.load("rglru_scan_bwd")(
            a.data_ptr(), h_seq.data_ptr(), build.ptr(h0), dh_seq.data_ptr(),
            build.ptr(dh_T), da.data_ptr(), dx.data_ptr(), dh0.data_ptr(),
            build.DTYPE_CODES[a.dtype], B, T, C, build.stream())
    build.check_launch("rglru_scan_bwd", err)
    rglru_scan_bwd.launches += 1
    return da, dx, dh0


rglru_scan_bwd.launches = 0
