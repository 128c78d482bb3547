"""Device selection for the port's entry points.

Entry points (`lm.init_params`, `ServingEngine`, `launch.serve.generate`,
the serve CLI) run on CUDA unless the caller names another device. With no
GPU and no explicit `device="cpu"` they raise: nothing falls back to the
CPU on its own.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_float_flags() -> None:
    """Pin the CUDA float flags the kernels' tolerances assume: float32
    matmuls in full float32 (no TF32) and bf16 matmul reductions in float32
    (no reduced-precision reduction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> "cuda" (raises when no GPU is present); an explicit device
    is taken as given. Selecting CUDA also sets the float flags."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        set_float_flags()
    return dev


def to_device(tree, device):
    """A param / state tree (dicts and lists of tensors) on `device`;
    tensors already there are kept as they are."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)
