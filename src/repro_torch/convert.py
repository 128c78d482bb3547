"""JAX param (and state) trees -> the port's layout, through numpy.

`repro.models.lm.init_params` returns
  {"embed", ["vision"], "prefix": [layer, ...],
   "blocks": {"p0": layer-with-leading-n_super-axis, ...},
   "final_norm", ["head"]}
and the decode / paged states share the {"prefix", "blocks"} layout.
`from_jax` turns such a tree, with numpy leaves (`jax.device_get`), into
the port's: the same dicts and lists, with every `blocks["p{i}"]` unstacked
into a list of n_super per-layer trees. This is how the parity tests share
weights between the two packages; nothing is downloaded. `to_jax` is the
inverse (port trees back to the JAX layout with numpy leaves), and
`stack_blocks` / `unstack_blocks` turn any tree that holds the port's
params layout (a params tree, or an optimizer state of such trees) into
the JAX layout and back with tensor leaves: the checkpoint format, which
the two packages share, stores the JAX layout. It handles every
architecture's tree (recurrent, MoE with its (E, D, F) / (E, F, D) expert
stacks, the frontends' vision projection and (n_codebooks, V, D) audio
tables).
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


def _is_blocks(key, sub) -> bool:
    """A "blocks" entry of the port's layout: {"p{i}": [layer, ...]}."""
    return (key == "blocks" and isinstance(sub, dict)
            and all(isinstance(v, list) for v in sub.values()))


def stack_blocks(tree):
    """The JAX layout of a port tree with tensor leaves: every "blocks"
    entry, at any depth, gets its lists of n_super layers stacked into a
    leading axis (torch.stack). Other nodes are copied as they are."""
    if isinstance(tree, dict):
        return {k: ({pk: _stack(pv) for pk, pv in v.items()}
                    if _is_blocks(k, v) else stack_blocks(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [stack_blocks(v) for v in tree]
    return tree


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return torch.stack(layers)


def unstack_blocks(tree, like):
    """The inverse of stack_blocks: `tree` in the JAX layout (tensor leaves)
    back into the layout of the port tree `like`."""
    if isinstance(like, dict):
        return {k: ({pk: _unstack(tree[k][pk], len(pv))
                     for pk, pv in v.items()}
                    if _is_blocks(k, v) else unstack_blocks(tree[k], v))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [unstack_blocks(t, v) for t, v in zip(tree, like)]
    return tree


def _numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes      # JAX's bfloat16 numpy type (only where JAX is)
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def to_jax(tree, cfg):
    """A port params or state tree in the JAX layout with numpy leaves:
    every `blocks["p{i}"]` list of cfg.n_super layers re-stacked into a
    leading axis. bf16 leaves become `ml_dtypes.bfloat16` arrays (JAX's
    numpy bfloat16), imported only for them."""
    for v in tree.get("blocks", {}).values():
        if len(v) != cfg.n_super:
            raise ValueError(f"to_jax: {len(v)} layers in a blocks entry, "
                             f"the config has n_super = {cfg.n_super}")
    return _map(stack_blocks(tree), _numpy)
