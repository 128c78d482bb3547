"""Minibatch-prox as a first-class deep-learning optimizer (the port of
`repro/optim/mbprox.py`).

One MBProx *outer step* consumes a held global minibatch of `n_micro`
microbatches and approximately solves (paper eq. 12)

    min_w  loss_minibatch(w) + (gamma/2) ||w - anchor||^2 ,

then advances the anchor. Both of the JAX module's variants are here:

  * `local` (MP-DANE form, App. D / Algorithm 2): every data shard solves
    the prox subproblem on ITS OWN shard of the minibatch with
    `inner_passes` epochs of momentum-SGD, then the solutions are averaged
    (eq. 34). An optional DANE gradient correction <pmean(g) - g_local, w>
    is computed at the anchor from the first microbatch.
  * `sync` (Theorem 7's generic inexact solver): inner steps are plain
    minibatch-SGD steps on the held minibatch.

The averages go through `pmean`, one tensor at a time. On one process it
is the identity (this module's `pmean`), so the two variants differ only
by the DANE correction, which is then computed as JAX computes it and is
exactly zero; the distributed slice passes a `torch.distributed`
all-reduce instead. The inner loop is a Python loop over `inner_passes` x
microbatches (JAX's two nested `lax.scan`s); gradients come from
`torch.autograd.grad`, and the updates are functional, as in JAX.

`MBProxConfig.inner_lr` is kept as a field, as in the JAX package, which
never reads it: the step takes `lr`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.optim.optimizers import sgd, weak
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class MBProxConfig:
    gamma: float = 0.1            # prox strength (theory.py scaling)
    inner_lr: float = 0.02
    inner_momentum: float = 0.9
    inner_passes: int = 1         # epochs over the held minibatch
    dane_correction: bool = True  # gradient-correction all-reduce at anchor
    variant: str = "local"        # 'local' | 'sync'


def pmean(x):
    """The mean over data shards of one tensor: the identity on one
    process."""
    return x


def _tree_add(a, b, alpha=1.0):
    return tree_map(lambda x, y: x + weak(alpha, x) * y.to(x.dtype), a, b)


def _tree_sub(a, b):
    return tree_map(lambda x, y: x - y.to(x.dtype), a, b)


def value_and_grad(loss_fn: Callable, params, micro):
    """((loss, metrics), grads) of loss_fn(params, micro) with respect to
    every leaf of params (zeros for a leaf the loss does not reach), as
    `jax.value_and_grad(loss_fn, has_aux=True)`. params are not changed."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = list(tree_leaves(p))
    with torch.enable_grad():
        loss, metrics = loss_fn(p, micro)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    metrics = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                       else t, metrics)
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def _micro(batch, i: int):
    return tree_map(lambda x: x[i], batch)


def make_mbprox_step(loss_fn: Callable, mp_cfg: MBProxConfig,
                     pmean: Callable = pmean):
    """Returns mbprox_train_step(params, inner_state, batch, lr)
    -> (params, inner_state, metrics).

    loss_fn(params, microbatch) -> (loss, metrics); microbatch is a tree
    whose leaves have a leading microbatch-batch dim.
    `batch` leaves: (n_micro, B_micro, ...).
    """
    inner_opt = sgd(momentum=mp_cfg.inner_momentum)

    def solve(params, inner_state, batch, lr, correction):
        """inner_passes epochs of momentum-SGD on the prox subproblem."""
        anchor = params
        n_micro = next(tree_leaves(batch)).shape[0]
        losses = []
        for _ in range(mp_cfg.inner_passes):
            for i in range(n_micro):
                (l, _), g = value_and_grad(loss_fn, params,
                                           _micro(batch, i))
                with torch.no_grad():
                    # prox pull + DANE correction
                    g = _tree_add(g, _tree_sub(params, anchor),
                                  mp_cfg.gamma)
                    if correction is not None:
                        g = _tree_add(g, correction)
                    params, inner_state = inner_opt.update(
                        g, inner_state, params, lr)
                losses.append(l)
        return params, inner_state, torch.stack(losses).mean()

    def local_subproblem(params, inner_state, local_batch, lr):
        """One data shard's local prox solve, then the average (eq. 34)."""
        if mp_cfg.dane_correction:
            # anchor gradient from the FIRST microbatch of the local held
            # minibatch (a stochastic DANE correction — one microbatch,
            # not an average over all n_micro)
            _, g_loc = value_and_grad(loss_fn, params,
                                      _micro(local_batch, 0))
            g_glob = tree_map(pmean, g_loc)                # all-reduce #1
            correction = _tree_sub(g_glob, g_loc)
        else:
            correction = None
        params, inner_state, loss = solve(params, inner_state, local_batch,
                                          lr, correction)
        # average the local solutions (eq. 34)           # all-reduce #2
        params = tree_map(pmean, params)
        inner_state = tree_map(pmean, inner_state)
        return params, inner_state, pmean(loss)

    def sync_subproblem(params, inner_state, batch, lr):
        """Synchronous inexact prox (per-step gradient all-reduce)."""
        return solve(params, inner_state, batch, lr, None)

    if mp_cfg.variant == "sync":
        def step(params, inner_state, batch, lr):
            p, s, l = sync_subproblem(params, inner_state, batch, lr)
            return p, s, {"loss": l}
        return step

    def step(params, inner_state, batch, lr):
        p, s, l = local_subproblem(params, inner_state, batch, lr)
        return p, s, {"loss": l}

    return step
