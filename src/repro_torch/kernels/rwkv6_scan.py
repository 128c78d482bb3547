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

Under autograd (grad mode on, an input that requires grad, no
return_states) `rwkv6_scan` is a `torch.autograd.Function`: its forward is
the plain call, which saves its inputs, and its backward is
`rwkv6_scan_bwd`. On CUDA that launches the forward kernel once more
with return_states (the states S_{t-1} the backward walks over, the
forward's own bits), then `csrc/rwkv6_scan_bwd.cu`: a block per 16 value
columns of a head walks the steps backward with G = dL/dS in registers
and writes its columns' dv and per-tile partial sums of dr, dk, dw and
du, which a second and third kernel sum over the tiles (and du over the
batch) in a fixed order. `ref.rwkv6_scan_bwd_ref` is its twin and the
CPU route. `rwkv6_scan_bwd.launches` counts backward calls (three
kernels each, plus the states launch counted above). return_states
under autograd raises on CUDA (build.refuse_grad): the engine's verify
never takes a gradient.
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
    P = -(-r.shape[-1] // 8) * 8
    return tuple(_pad(t, value, P, axes) for t, value, axes in (
        (r, 0, 1), (k, 0, 1), (v, 0, 1), (w, 1.0, 1), (u, 0, 1),
        (s0, 0, 2)))


def _pad(t, value, P, axes=1):
    """t (None passes) copied into a fresh tensor whose last `axes` dims
    are P wide, the new entries `value`."""
    if t is None:
        return None
    N = t.shape[-1]
    out = t.new_full(t.shape[:-axes] + (P,) * axes, value)
    out[(..., ) + (slice(0, N),) * axes] = t
    return out


class _RWKV6Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, s_T = _scan(r, k, v, w, u, s0, False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return y, s_T

    @staticmethod
    def backward(ctx, dy, dS_T):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        dr, dk, dv, dw, du, ds0 = rwkv6_scan_bwd(
            r, k, v, w, u, s0, dy.contiguous(),
            None if dS_T is None else dS_T.contiguous())
        return dr, dk, dv, dw, du, (ds0 if s0 is not None else None)


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
    the flag. Without return_states, carries a gradient to r, k, v, w, u
    and s0 when grad mode is on and one of them requires it."""
    if not return_states and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        return _RWKV6Scan.apply(r, k, v, w, u, s0)
    return _scan(r, k, v, w, u, s0, return_states)


def _check(name, r, k, v, w, u, s0, extra=()):
    """The CUDA kernels' contract (see rwkv6_scan); `extra`: (name, tensor,
    dtype, shape) of further inputs."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"{name}: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}; all must be (B, H, T, N)")
    B, H, T, N = r.shape
    if not 0 < N <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {N} (the kernel takes up "
                         f"to {MAX_HEAD_DIM})")
    if r.dtype not in FLOAT_DTYPES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"{name}: r/k/v dtypes {r.dtype}, {k.dtype}, "
                        f"{v.dtype}; one of {FLOAT_DTYPES}")
    want = {"w": (w, torch.float32, (B, H, T, N)),
            "u": (u, torch.float32, (H, N))}
    if s0 is not None:
        want["s0"] = (s0, torch.float32, (B, H, N, N))
    for nm, t, dt, shape in extra:
        if t is not None:
            want[nm] = (t, dt, shape)
    for nm, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {nm} must be {dt} {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (r, k, v) + tuple(t for t, _, _ in want.values()):
        if t.device != r.device:
            raise ValueError(f"{name}: a tensor on {t.device}, r on "
                             f"{r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _scan(r, k, v, w, u, s0, return_states):
    """The forward launch (the twin on the CPU)."""
    if r.device.type == "cpu":
        return ref.rwkv6_scan_ref(r, k, v, w, u, s0, return_states)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    build.refuse_grad("rwkv6_scan", r, k, v, w, u, s0)
    _check("rwkv6_scan", r, k, v, w, u, s0)
    B, H, T, N = r.shape
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

# csrc/rwkv6_scan_bwd.cu: JC, the value columns a block owns
BWD_TILE = 16


def rwkv6_scan_bwd(r, k, v, w, u, s0, dy, dS_T=None):
    """The gradient of rwkv6_scan (y, S_T): rwkv6_scan's inputs, dy (B, H,
    T, N) in r's dtype and dS_T (B, H, N, N) float32 or None (zeros), all
    contiguous. Returns (dr, dk, dv in r's dtype, accumulated in float32;
    dw (B, H, T, N), du (H, N) and ds0 (B, H, N, N) float32). On CUDA: the
    forward kernel with return_states for the states S_{t-1}, then the
    backward kernel and its two fixed-order sums (csrc/rwkv6_scan_bwd.cu;
    no atomics, so two calls give the same bits). A head dim that is not a
    multiple of 8, or an input off a 16-byte boundary, is padded as the
    forward pads it (dy and dS_T with zeros) and the gradients are sliced
    back. Its twin is ref.rwkv6_scan_bwd_ref."""
    if r.device.type == "cpu":
        return ref.rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dy, dS_T)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_bwd: unsupported device {r.device}")
    B, H, T, N = r.shape
    _check("rwkv6_scan_bwd", r, k, v, w, u, s0,
           (("dy", dy, r.dtype, (B, H, T, N)),
            ("dS_T", dS_T, torch.float32, (B, H, N, N))))
    padded = N % 8 or any(t.data_ptr() % 16 for t in (r, k, v, w, s0, dy)
                          if t is not None)
    if padded:
        P = -(-N // 8) * 8
        r, k, v, w, u, s0 = pad_head_dim(r, k, v, w, u, s0)
        dy, dS_T = _pad(dy, 0, P), _pad(dS_T, 0, P, axes=2)
    P = r.shape[-1]
    f32 = dict(dtype=torch.float32, device=r.device)
    if B * H == 0 or T == 0:
        grads = (torch.zeros_like(r), torch.zeros_like(k),
                 torch.zeros_like(v), torch.zeros_like(w),
                 torch.zeros(H, P, **f32),
                 torch.zeros(B, H, P, P, **f32) if dS_T is None
                 else dS_T.clone())
    else:
        # the states S_0 .. S_{T-1}, bit-equal to the forward's
        _, _, steps = _scan(r, k, v, w, u, s0, True)
        tiles = -(-P // BWD_TILE)
        dr, dk, dv = (torch.empty_like(r) for _ in range(3))
        dw = torch.empty(B, H, T, P, **f32)
        du = torch.empty(H, P, **f32)
        ds0 = torch.empty(B, H, P, P, **f32)
        # per column tile: the partial sums of dr, dk, dw (B, H, T, P)
        # and of du (B, H, P)
        parts = torch.empty(3, tiles, B, H, T, P, **f32)
        du_parts = torch.empty(tiles, B, H, P, **f32)
        with torch.cuda.device(r.device):
            err = build.load("rwkv6_scan_bwd")(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), build.ptr(s0), steps.data_ptr(),
                dy.data_ptr(), build.ptr(dS_T), dr.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                ds0.data_ptr(), parts.data_ptr(), du_parts.data_ptr(),
                build.DTYPE_CODES[r.dtype], B, H, T, P, build.stream())
        build.check_launch("rwkv6_scan_bwd", err)
        rwkv6_scan_bwd.launches += 1
        grads = (dr, dk, dv, dw, du, ds0)
    if padded:
        grads = tuple(g[..., :N].contiguous() for g in grads[:5]) + (
            grads[5][..., :N, :N].contiguous(),)
    return grads


rwkv6_scan_bwd.launches = 0
