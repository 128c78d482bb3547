"""JAX param (and state) trees -> the port's layout, through numpy.

`repro.models.lm.init_params` returns
  {"embed", ["vision"], "prefix": [layer, ...],
   "blocks": {"p0": layer-with-leading-n_super-axis, ...},
   "final_norm", ["head"]}
and the decode / paged states share the {"prefix", "blocks"} layout.
`from_jax` turns such a tree, with numpy leaves (`jax.device_get`), into
the port's: the same dicts and lists, with every `blocks["p{i}"]` unstacked
into a list of n_super per-layer trees. This is how the parity tests share
weights between the two packages; nothing is downloaded. It handles every
architecture's tree (recurrent, MoE, frontends) even where the port's
models do not run it yet.
"""
from __future__ import annotations

import numpy as np
import torch

# numpy has no bfloat16 / float8: JAX hands them over as ml_dtypes arrays,
# which go through float32 (exact) and are cast back
_VIA_F32 = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name in _VIA_F32:
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=_VIA_F32[a.dtype.name])
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _unstack(tree, n: int):
    return [_map(tree, lambda a, i=i: a[i]) for i in range(n)]


def from_jax(tree, cfg, *, device="cpu"):
    """A JAX params or state tree (numpy leaves) in the port's layout on
    `device`: `blocks["p{i}"]` becomes a list of cfg.n_super layers."""
    out = {}
    for key, sub in tree.items():
        if key == "blocks":
            out[key] = {pk: _unstack(_map(pv, lambda a: _tensor(a, device)),
                                     cfg.n_super)
                        for pk, pv in sub.items()}
        else:
            out[key] = _map(sub, lambda a: _tensor(a, device))
    return out


def param_count(tree) -> int:
    """Total elements over every tensor of a (port-layout) tree."""
    total = 0

    def add(t):
        nonlocal total
        total += t.numel()
        return t

    _map(tree, add)
    return total
