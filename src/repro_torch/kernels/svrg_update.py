"""Fused variance-reduced prox step: CUDA kernel wrapper.

The port of `repro/kernels/svrg_update.py` (a Pallas TPU kernel), the
update of every step of MP-DSVRG's without-replacement pass
(`core/mp_dsvrg.py`). The kernel is `csrc/svrg_update.cu`;
`ref.svrg_update_ref` is its plain twin. A CPU tensor takes the twin; a
CUDA tensor launches the kernel or raises. `svrg_update.launches` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import FLOAT_DTYPES


def svrg_update(x, g_x, g_z, mu, w_anchor, eta: float, gamma: float):
    """x - eta * (g_x - g_z + mu + gamma * (x - w_anchor)) in x's dtype.

    The five vectors are 1-D, of one length, dtype and device, and
    contiguous; eta and gamma are Python floats (so the host never waits
    on the device for them)."""
    if x.device.type == "cpu":
        return ref.svrg_update_ref(x, g_x, g_z, mu, w_anchor, eta, gamma)
    if x.device.type != "cuda":
        raise ValueError(f"svrg_update: unsupported device {x.device}")
    build.refuse_grad("svrg_update", x, g_x, g_z, mu, w_anchor)
    ts = (x, g_x, g_z, mu, w_anchor)
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"svrg_update: tensor on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"svrg_update: dtype {t.dtype}, x is {x.dtype}")
        if t.ndim != 1 or t.shape != x.shape:
            raise ValueError(f"svrg_update: shape {tuple(t.shape)}, x is "
                             f"{tuple(x.shape)}; all five must be 1-D of "
                             f"one length")
        if not t.is_contiguous():
            raise ValueError("svrg_update: inputs must be contiguous")
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"svrg_update: dtype {x.dtype}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = build.load("svrg_update")
    with torch.cuda.device(x.device):
        err = fn(*(t.data_ptr() for t in ts), out.data_ptr(),
                 build.DTYPE_CODES[x.dtype], x.numel(), eta, gamma,
                 build.stream())
    build.check_launch("svrg_update", err)
    svrg_update.launches += 1
    return out


svrg_update.launches = 0
