"""Step-function builders: train (MBProx paper-faithful / baseline AdamW),
prefill, decode (the port of `repro/launch/steps.py`).

No mesh argument: one process runs the step, and MBProx's averages are
`optim.mbprox.pmean` (the identity here). The choices JAX makes for the
FSDP archs (the `sync` variant, bf16 AdamW state and gradient sums) follow
`needs_fsdp`, a copy of `repro/distributed/sharding.py:needs_fsdp`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import mbprox as mbprox_lib
from repro_torch.optim.optimizers import adamw, clip_by_global_norm, sgd
from repro_torch.tree import tree_leaves, tree_map

# Archs whose params+opt do not fit replicated over the data axis: FSDP
# (the JAX package's distributed/sharding.py:FSDP_ARCHS).
FSDP_ARCHS = {"llama4-maverick-400b-a17b", "grok-1-314b"}


def needs_fsdp(cfg) -> bool:
    return cfg.name in FSDP_ARCHS


def make_loss_fn(cfg: ModelConfig, remat: bool = True):
    def loss_fn(params, micro):
        return lm.train_loss(params, cfg, micro, remat=remat)
    return loss_fn


# ----------------------------------------------------------------------------
# Baseline: data-parallel AdamW, gradient accumulated over microbatches.
# Collective profile: one grad all-reduce over data(+pod) per microbatch —
# the "minibatch SGD" communication model of the paper's Table 1.
# ----------------------------------------------------------------------------

def make_baseline_train_step(cfg: ModelConfig):
    loss_fn = make_loss_fn(cfg)
    acc_dtype = torch.bfloat16 if needs_fsdp(cfg) else torch.float32
    opt = adamw(state_dtype=torch.bfloat16 if needs_fsdp(cfg) else None)

    def train_step(params, opt_state, batch, lr):
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                               device=p.device), params)
        n_micro = next(tree_leaves(batch)).shape[0]
        losses = []
        for i in range(n_micro):
            (l, _), g = mbprox_lib.value_and_grad(
                loss_fn, params, tree_map(lambda x: x[i], batch))
            with torch.no_grad():
                grads = tree_map(lambda a, gi: a + gi.to(a.dtype), grads, g)
            losses.append(l)
        with torch.no_grad():
            grads = tree_map(lambda g: g / n_micro, grads)
            grads, gnorm = clip_by_global_norm(grads, 1.0)
            params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, {"loss": torch.stack(losses).mean(),
                                   "gnorm": gnorm}

    return train_step, opt


# ----------------------------------------------------------------------------
# Paper technique: MBProx train step (local MP-DANE form or sync inexact form)
# ----------------------------------------------------------------------------

def default_mbprox_config(cfg: ModelConfig,
                          **overrides) -> mbprox_lib.MBProxConfig:
    variant = "sync" if needs_fsdp(cfg) else "local"
    base = dict(gamma=0.1, inner_lr=0.02, inner_momentum=0.9,
                inner_passes=1, dane_correction=True, variant=variant)
    base.update(overrides)
    return mbprox_lib.MBProxConfig(**base)


def make_mbprox_train_step(cfg: ModelConfig,
                           mp_cfg: Optional[mbprox_lib.MBProxConfig] = None):
    mp_cfg = mp_cfg or default_mbprox_config(cfg)
    step = mbprox_lib.make_mbprox_step(make_loss_fn(cfg), mp_cfg)
    inner_opt = sgd(momentum=mp_cfg.inner_momentum)

    def train_step(params, inner_state, batch, lr):
        return step(params, inner_state, batch, lr)

    return train_step, inner_opt, mp_cfg


# ----------------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig):
    def prefill(params, batch):
        logits, _ = lm.forward(params, cfg, batch, remat=False)
        return logits
    return prefill


def make_decode_step(cfg: ModelConfig):
    def decode(params, state, tokens, pos):
        return lm.decode_step(params, cfg, state, tokens, pos)
    return decode
