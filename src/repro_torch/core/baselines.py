"""Baselines the paper compares against (Table 1 / Figure 2 / Figure 3).

The port of `repro/core/baselines.py`.

  - minibatch_sgd:        distributed minibatch SGD (Dekel et al. 2012)
  - acc_minibatch_sgd:    accelerated minibatch SGD, AC-SA form
                          (Cotter et al. 2011 / Ghadimi & Lan)
  - single_sgd:           single-machine SGD (statistical reference)
  - dsvrg_erm:            DSVRG on the regularized ERM objective (eq. 2)
                          (Lee et al. 2015; the paper's Section 2)
  - emso:                 one-shot-averaged local prox solves (Li et al. 2014)
                          = MP-DANE with correction disabled, K=R=1

The distributed baselines simulate the m machines on one device with the
machine axis written out, as mp_dsvrg / mp_dane do: the reference's
`pmean` over machines is a mean over dim 0. They thread the same
accounting Ledger, charge for charge. Data comes from
`stream.sample_distributed(generator, m, b)` / `stream.sample(generator,
n)` with a torch.Generator on `device`, seeded from `seed`; `device` None
means CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import prox, theory
from repro_torch.core.accounting import Ledger
from repro_torch.core.losses import least_squares
from repro_torch.core.mp_dane import run_mp_dane
from repro_torch.core.mp_dsvrg import _dsvrg_inner
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class BaselineResult:
    w_avg: torch.Tensor
    w_last: torch.Tensor
    ledger: Ledger


def _draw(stream, gen, m, b, dev):
    Xm, ym = stream.sample_distributed(gen, m, b)
    return (torch.as_tensor(Xm, dtype=torch.float32, device=dev),
            torch.as_tensor(ym, dtype=torch.float32, device=dev))


def _global_grad(w, Xm, ym, loss=None):
    """The machines' mean of their minibatch gradients at w (one
    all-reduce): least squares in closed form when `loss` is None."""
    if loss is None:
        r = torch.matmul(Xm, w) - ym                                # (m, b)
        g = torch.matmul(r.unsqueeze(1), Xm).squeeze(1) / Xm.shape[1]
    else:
        g = loss.per_example_grad(w, Xm, ym).mean(1)
    return g.mean(0)


# ----------------------------------------------------------------------------
# Minibatch SGD: w_t = P( w_{t-1} - (1/gamma_t) grad phi_{I_t}(w_{t-1}) )
# ----------------------------------------------------------------------------

def run_minibatch_sgd(stream, spec: theory.ProblemSpec, m: int, b: int,
                      T: int, *, gamma: Optional[float] = None,
                      radius: float = float("inf"), seed: int = 0,
                      loss=None, device: DeviceLike = None) -> BaselineResult:
    """Prop. 13 tuning: gamma = beta + sqrt(4T/(bm)) L / B (bm = total batch)."""
    dev = resolve_device(device)
    bm = b * m
    if gamma is None:
        gamma = spec.beta + (4.0 * T / bm) ** 0.5 * spec.L / spec.B
    ledger = Ledger()
    ledger.hold(1)

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.zeros(stream.dim, device=dev)
    acc = torch.zeros(stream.dim, device=dev)
    for _ in range(T):
        Xm, ym = _draw(stream, gen, m, b, dev)
        w = w - _global_grad(w, Xm, ym, loss) / gamma
        if radius != float("inf"):
            w = prox.project_l2_ball(w, radius)
        acc = acc + w
        ledger.communicate(vectors=1, rounds=1)
        ledger.compute(b)
    return BaselineResult(w_avg=acc / T, w_last=w, ledger=ledger)


# ----------------------------------------------------------------------------
# Accelerated minibatch SGD (AC-SA two-sequence scheme)
# ----------------------------------------------------------------------------

def run_acc_minibatch_sgd(stream, spec: theory.ProblemSpec, m: int, b: int,
                          T: int, *, radius: float = float("inf"),
                          seed: int = 0, step_scale: float = 1.0,
                          device: DeviceLike = None) -> BaselineResult:
    """AC-SA (Ghadimi & Lan): alpha_t = 2/(t+1),
    lambda_t = t/2 * min(1/(2 beta), B sqrt(bm) / (2 L T^{3/2}))."""
    dev = resolve_device(device)
    bm = b * m
    base = min(1.0 / (2.0 * spec.beta),
               step_scale * spec.B * (bm ** 0.5) / (2.0 * spec.L * T ** 1.5))
    ledger = Ledger()
    ledger.hold(2)

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.zeros(stream.dim, device=dev)
    w_ag = torch.zeros(stream.dim, device=dev)
    for t in range(1, T + 1):
        Xm, ym = _draw(stream, gen, m, b, dev)
        alpha = 2.0 / (t + 1.0)
        lam_t = 0.5 * t * base
        w_md = (1 - alpha) * w_ag + alpha * w
        w = w - lam_t * _global_grad(w_md, Xm, ym)
        if radius != float("inf"):
            w = prox.project_l2_ball(w, radius)
        w_ag = (1 - alpha) * w_ag + alpha * w
        ledger.communicate(vectors=1, rounds=1)
        ledger.compute(b)
    return BaselineResult(w_avg=w_ag, w_last=w, ledger=ledger)


# ----------------------------------------------------------------------------
# Single-machine SGD (sample-optimal reference)
# ----------------------------------------------------------------------------

def run_single_sgd(stream, spec: theory.ProblemSpec, n: int, *,
                   radius: float = float("inf"), seed: int = 0,
                   device: DeviceLike = None) -> BaselineResult:
    """One pass over n fresh samples with eta_i = B / (L sqrt(i)), the
    step sizes in float32 as the reference computes them."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    X, y = stream.sample(gen, n)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    etas = spec.B / (spec.L * torch.sqrt(
        torch.arange(1, n + 1, dtype=torch.float32, device=dev)))

    w = torch.zeros(stream.dim, device=dev)
    acc = torch.zeros_like(w)
    for i in range(n):
        w = w - etas[i] * ((torch.dot(w, X[i]) - y[i]) * X[i])
        if radius != float("inf"):
            w = prox.project_l2_ball(w, radius)
        acc = acc + w
    ledger = Ledger()
    ledger.compute(n)
    ledger.hold(1)
    return BaselineResult(w_avg=acc / n, w_last=w, ledger=ledger)


# ----------------------------------------------------------------------------
# DSVRG on regularized ERM (Section 2): fixed dataset, nu = L/(B sqrt(n))
# ----------------------------------------------------------------------------

def run_dsvrg_erm(stream, spec: theory.ProblemSpec, m: int, n: int, *,
                  K: Optional[int] = None, eta_scale: float = 0.3,
                  seed: int = 0, device: DeviceLike = None
                  ) -> BaselineResult:
    """Solves min_w phi_S(w) + nu/2 ||w||^2 on a stored dataset of n samples
    (K defaults to int(log n), log taken in float32 as in the reference).
    Its K inner DSVRG iterations are MP-DSVRG's (`_dsvrg_inner` with
    p = 1): K x (n // m) `svrg_update` launches on the card."""
    dev = resolve_device(device)
    nu = spec.L / (spec.B * n ** 0.5)
    b_loc = n // m
    if K is None:
        K = max(1, int(torch.log(torch.tensor(float(n),
                                              dtype=torch.float32))))
    gen = torch.Generator(device=dev).manual_seed(seed)
    Xm, ym = _draw(stream, gen, m, b_loc, dev)
    gamma_eff = nu  # ridge acts like the prox term with anchor 0
    eta = eta_scale / (spec.beta + gamma_eff)

    w0 = torch.zeros(stream.dim, device=dev)
    w, _ = _dsvrg_inner(least_squares(), w0, w0, Xm, ym, gamma_eff, eta,
                        p=1, K=K, lam=0.0)
    ledger = Ledger()
    ledger.hold(b_loc)                      # must store the local shard
    ledger.communicate(vectors=2 * K, rounds=2 * K)
    ledger.compute(K * (b_loc + b_loc))
    return BaselineResult(w_avg=w, w_last=w, ledger=ledger)


# ----------------------------------------------------------------------------
# EMSO: one-shot averaging of local exact prox solves (Li et al. 2014)
# ----------------------------------------------------------------------------

def run_emso(stream, spec: theory.ProblemSpec, m: int, b: int, T: int,
             *, gamma: Optional[float] = None, seed: int = 0,
             device: DeviceLike = None):
    return run_mp_dane(stream, spec, m, b, T, K=1, R=1, kappa=0.0,
                       gamma=gamma, local_solver="exact", correction=False,
                       seed=seed, device=device)
