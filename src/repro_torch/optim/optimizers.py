"""Pure-tree optimizers (the port of `repro/optim/optimizers.py`): every
state leaf mirrors its param leaf.

Updates are functional, as in the JAX package: `update` returns new
params and state and leaves its inputs as they are. The update math runs
in float32 and is cast back (bf16 params stay bf16). `lr` is a Python
float or a 0-d tensor; a Python float enters the float32 math rounded to
float32, as JAX's float32 lr does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable          # params -> opt_state
    update: Callable        # (grads, opt_state, params, lr) -> (new_p, new_s)


def _cast_like(x, ref):
    return x.to(ref.dtype)


def weak(c: float, t):
    """The Python constant c as JAX's weak typing applies it to tensor t:
    rounded to t's dtype. A float32 op rounds a Python scalar to float32
    by itself; a bf16 / f16 one would keep it in float32, so it becomes a
    0-d tensor of t's dtype there."""
    if t.dtype in (torch.float32, torch.float64):
        return c
    return torch.tensor(c, dtype=t.dtype, device=t.device)


def sgd(momentum: float = 0.0, nesterov: bool = False,
        state_dtype=None) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros_like(
            p, dtype=state_dtype or p.dtype), params)

    def _apply(p, s, lr):
        # update math in f32, cast back (bf16 params stay bf16)
        return (p.float() - lr * s.float()).to(p.dtype)

    def update(grads, state, params, lr):
        if momentum == 0.0:
            new_p = tree_map(lambda p, g: _apply(p, g, lr), params, grads)
            return new_p, ()
        new_m = tree_map(
            lambda m, g: weak(momentum, m) * m + _cast_like(g, m),
            state, grads)
        if nesterov:
            step = tree_map(
                lambda m, g: weak(momentum, m) * m + _cast_like(g, m),
                new_m, grads)
        else:
            step = new_m
        new_p = tree_map(lambda p, s: _apply(p, s, lr), params, step)
        return new_p, new_m

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype=None) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=state_dtype or p.dtype)
        dev = next(tree_leaves(params)).device
        return {"m": tree_map(zeros, params),
                "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        # bias corrections in float32 from the int32 count, as JAX
        cf = count.float()
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32,
                                device=cf.device) ** cf
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32,
                                device=cf.device) ** cf

        new_m = tree_map(
            lambda m, g: weak(b1, m) * m + weak(1 - b1, m) * _cast_like(g, m),
            state["m"], grads)
        new_v = tree_map(
            lambda v, g: weak(b2, v) * v + weak(1 - b2, v) * _cast_like(
                torch.square(g.float()), v), state["v"], grads)

        def step(p, m, v):
            mh = m.float() / c1
            vh = v.float() / c2
            upd = mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        new_p = tree_map(step, params, new_m, new_v)
        return new_p, {"m": new_m, "v": new_v, "count": count}

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most max_norm, the norm before);
    both stay on the device (no host read)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Linear warmup + cosine decay."""
    peak: float
    warmup: int = 100
    total: int = 10000
    floor: float = 0.1

    def __call__(self, step) -> float:
        """The lr at `step` as a Python float: JAX's float32 arithmetic in
        numpy float32 (every constant made float32 first, so numpy's
        promotion rules cannot widen it)."""
        f = np.float32
        step = f(step)
        warm = f(self.peak) * step / f(max(self.warmup, 1))
        frac = np.clip((step - f(self.warmup))
                       / f(max(self.total - self.warmup, 1)), f(0), f(1))
        cos = f(self.floor) + f((1 - self.floor) * 0.5) * (
            f(1) + np.cos(f(math.pi) * frac))
        return float(warm if step < f(self.warmup)
                     else f(self.peak) * cos)
