"""RWKV6 recurrence: CUDA kernel wrapper.

The port of `repro/kernels/rwkv6_scan.py` (a Pallas TPU kernel), the time
mix of every RWKV6 layer (`models/recurrent.py:rwkv_seq`). The kernel is
`csrc/rwkv6_scan.cu`: blocks of 16 value columns of one head, each
column's key rows split over 4 lanes of N / 4 rows with the state in
registers and y summed in one serial chain passed lane to lane (lane g a
step behind lane g - 1), the inputs staged a 32-step chunk at a time by
bulk TMA copies, which need 16-byte aligned rows: a head dim that is a
multiple of 8 and 16-byte aligned r, k, v and w. Any other head dim up to
64, or an input that is not so aligned, is first copied by `pad_head_dim`
into fresh buffers whose head dim is the next multiple of 8 (zeros in the
padded key rows add exact zeros at the end of y's chain and keep their
state rows zero), and y and S_T are sliced back. With return_states the
kernel also writes the state after every step (the speculative verify's
rollback points), bit-equal to S_T of the call cut to that step.
`ref.rwkv6_scan_ref` is its plain twin; `ref.rwkv6_scan_split_ref` sums y
in the kernel's order.
A CPU tensor takes the twin; a CUDA tensor launches the kernel or raises.
`rwkv6_scan.launches` counts kernel launches, `rwkv6_scan.state_launches`
those made with return_states.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import FLOAT_DTYPES

MAX_HEAD_DIM = 64


def pad_head_dim(r, k, v, w, u, s0=None):
    """r, k, v, w, u and s0 copied into fresh (so 16-byte aligned)
    tensors whose head dim N is rounded up to a multiple of 8: r, k, v, u
    and s0 (along both of its axes) padded with zeros, w with ones. A
    padded key row i has r_i = k_i = u_i = 0, so its state row stays zero
    and its terms r_i (S_ij + u_i k_i v_j) of y are exact zeros added last
    to y's chain; padded value columns are sliced away. Returns the six
    (s0 None if it was)."""
    N = r.shape[-1]
    P = -(-N // 8) * 8

    def pad(t, value, axes=1):
        out = t.new_full(t.shape[:-axes] + (P,) * axes, value)
        out[(..., ) + (slice(0, N),) * axes] = t
        return out

    return (pad(r, 0), pad(k, 0), pad(v, 0), pad(w, 1.0), pad(u, 0),
            None if s0 is None else pad(s0, 0, axes=2))


def rwkv6_scan(r, k, v, w, u, s0=None, return_states=False):
    """y_t = r_t (S_{t-1} + diag(u) k_t^T v_t), S_t = diag(w_t) S_{t-1} +
    k_t^T v_t per (batch, head), float32 state.

    r, k, v: (B, H, T, N), one float dtype; w: (B, H, T, N) float32; u:
    (H, N) float32; s0: (B, H, N, N) float32 or None (zeros); all
    contiguous, N up to 64 (a head dim that is not a multiple of 8, or
    r, k, v or w not 16-byte aligned, costs one padded copy of each
    input; see pad_head_dim). Returns (y (B, H, T, N) in r's dtype, S_T
    (B, H, N, N) float32), and with return_states also S_steps (B, H, T,
    N, N) float32, the state after each step. y and S_T do not depend on
    the flag."""
    if r.device.type == "cpu":
        return ref.rwkv6_scan_ref(r, k, v, w, u, s0, return_states)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    build.refuse_grad("rwkv6_scan", r, k, v, w, u, s0)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv6_scan: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}; all must be (B, H, T, N)")
    B, H, T, N = r.shape
    if not 0 < N <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan: head dim {N} (the kernel takes up "
                         f"to {MAX_HEAD_DIM})")
    if r.dtype not in FLOAT_DTYPES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan: r/k/v dtypes {r.dtype}, {k.dtype}, "
                        f"{v.dtype}; one of {FLOAT_DTYPES}")
    want = {"w": (w, (B, H, T, N)), "u": (u, (H, N))}
    if s0 is not None:
        want["s0"] = (s0, (B, H, N, N))
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"rwkv6_scan: {name} must be float32 {shape}; "
                             f"got {t.dtype} {tuple(t.shape)}")
    tensors = (r, k, v, w, u) + (() if s0 is None else (s0,))
    for t in tensors:
        if t.device != r.device:
            raise ValueError(f"rwkv6_scan: a tensor on {t.device}, r on "
                             f"{r.device}")
        if not t.is_contiguous():
            raise ValueError("rwkv6_scan: inputs must be contiguous")
    if B * H == 0:
        out = (torch.empty_like(r), torch.empty(
            B, H, N, N, dtype=torch.float32, device=r.device))
        return out + ((torch.empty(B, H, T, N, N, dtype=torch.float32,
                                   device=r.device),)
                      if return_states else ())
    # chosen from the shape and the pointers, before any launch
    padded = N % 8 or any(t.data_ptr() % 16 for t in (r, k, v, w))
    if padded:
        r, k, v, w, u, s0 = pad_head_dim(r, k, v, w, u, s0)
    P = r.shape[-1]
    y = torch.empty_like(r)
    s_out = torch.empty(B, H, P, P, dtype=torch.float32, device=r.device)
    s_steps = (torch.empty(B, H, T, P, P, dtype=torch.float32,
                           device=r.device) if return_states else None)
    fn = build.load("rwkv6_scan")
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), build.ptr(s0), y.data_ptr(), s_out.data_ptr(),
                 build.ptr(s_steps), build.DTYPE_CODES[r.dtype], B, H, T, P,
                 build.stream())
    build.check_launch("rwkv6_scan", err)
    rwkv6_scan.launches += 1
    rwkv6_scan.state_launches += return_states
    out = (y, s_out) + ((s_steps,) if return_states else ())
    if padded:
        out = (y[..., :N],) + tuple(s[..., :N, :N] for s in out[1:])
        return tuple(t.contiguous() for t in out)
    return out


rwkv6_scan.launches = 0
rwkv6_scan.state_launches = 0   # of them, with return_states
