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


def rglru_scan(a, x, h0=None):
    """h_t = a_t * h_{t-1} + x_t per channel, float32 state.

    a, x: (B, T, C), one float dtype, contiguous; h0: (B, C) float32 or
    None (zeros). Returns (h_seq (B, T, C) in x's dtype, h_T (B, C)
    float32)."""
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, x, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    if a.dim() != 3 or x.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, x "
                         f"{tuple(x.shape)}; both must be (B, T, C)")
    B, T, C = a.shape
    if x.device != a.device or x.dtype != a.dtype:
        raise ValueError(f"rglru_scan: x on {x.device} {x.dtype}, a on "
                         f"{a.device} {a.dtype}")
    if a.dtype not in FLOAT_DTYPES:
        raise TypeError(f"rglru_scan: dtype {a.dtype}")
    if h0 is not None and (h0.device != a.device or h0.dtype != torch.float32
                           or h0.shape != (B, C)):
        raise ValueError(f"rglru_scan: h0 must be float32 {(B, C)} on "
                         f"{a.device}; got {h0.dtype} {tuple(h0.shape)} on "
                         f"{h0.device}")
    for t in (a, x) + (() if h0 is None else (h0,)):
        if not t.is_contiguous():
            raise ValueError("rglru_scan: inputs must be contiguous")
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
