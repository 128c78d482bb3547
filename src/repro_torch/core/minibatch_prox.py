"""Minibatch-prox (Section 3): exact and inexact outer loops.

The port of `repro/core/minibatch_prox.py`. This is the analysis-level
algorithm: at step t draw a fresh minibatch I_t of b samples and set

    w_t ~= argmin_w  phi_{I_t}(w) + (gamma_t/2) ||w - w_{t-1}||^2 .

`run_minibatch_prox` supports:
  - exact subproblem solves (closed-form least squares oracle)      [Thm 4/5]
  - inexact solves through any solver meeting the eta_t schedule    [Thm 7/8]
  - weakly convex (constant gamma) and strongly convex (gamma_t = lam(t-1)/2)
  - the averaged outputs of the theorems (uniform / t-weighted)

Distributed execution lives in mp_dsvrg.py / mp_dane.py;
this module is the single-sequence form used to validate the statistical
claims.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import prox, solvers, theory
from repro_torch.core.accounting import Ledger
from repro_torch.core.losses import least_squares, ridge_least_squares
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class ProxResult:
    w_avg: torch.Tensor         # theorem-prescribed averaged predictor
    w_last: torch.Tensor
    iterates: torch.Tensor      # (T, d)
    gammas: torch.Tensor        # (T,)
    ledger: Ledger


def run_minibatch_prox(
    stream,
    spec: theory.ProblemSpec,
    b: int,
    T: int,
    *,
    solver: str = "exact",
    strongly_convex: bool = False,
    lam: float = 0.0,
    gamma_override: Optional[float] = None,
    inner_steps: int = 0,
    inner_epochs: int = 2,
    seed: int = 0,
    radius: float = float("inf"),
    w0: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> ProxResult:
    """Run T iterations of minibatch-prox with minibatch size b.

    solver: 'exact' | 'gd' | 'prox_svrg' | 'saga'
    For strongly_convex=True uses gamma_t = lam (t-1)/2 and t-weighted average
    (Thm 5/8); otherwise constant gamma from Thm 4/7 and uniform average.
    `stream.sample(generator, b)` gives each minibatch (a torch.Generator on
    `device`, seeded from `seed`); the stochastic solvers' keys are the
    reference's, `key, kd, ks = split(key, 3)` per step from
    `prng.PRNGKey(seed)` (kd unused). `device` None means CUDA.
    """
    dev = resolve_device(device)
    d = stream.dim
    w = (torch.zeros(d, device=dev) if w0 is None
         else torch.as_tensor(w0, dtype=torch.float32, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    key = prng.PRNGKey(seed)
    ledger = Ledger()
    ledger.hold(b)  # each machine holds its current minibatch

    iterates = []
    gammas = []
    loss = ridge_least_squares(lam) if lam > 0 else least_squares()

    for t in range(1, T + 1):
        key, _, ks = prng.split(key, 3)
        X, y = stream.sample(gen, b)
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        if strongly_convex:
            gamma_t = theory.gamma_strongly_convex(spec, t)
            gamma_t = max(gamma_t, 1e-8)  # t=1 => pure ERM on the minibatch
        else:
            gamma_t = (gamma_override if gamma_override is not None
                       else theory.gamma_weakly_convex(spec, b, T))
        gammas.append(gamma_t)

        if solver == "exact":
            w_new = prox.exact_lsq_prox(w, X, y, gamma_t, lam=lam)
            ledger.compute(b)  # forming X^T X / X^T y: O(b) vector ops
        elif solver == "gd":
            def grad_fn(wv, X=X, y=y, g=gamma_t, a=w):
                return prox.prox_subproblem_grad(wv, a, X, y, g, lam=lam)
            eta = 1.0 / (spec.beta + lam + gamma_t)
            iters = inner_steps or 64
            w_new = solvers.gd(grad_fn, w, eta, iters=iters)
            ledger.compute(iters * b)
        elif solver == "prox_svrg":
            eta = 0.1 / spec.beta
            w_new = solvers.prox_svrg(
                loss.per_example_grad, ks, w, X, y, eta, gamma_t, w,
                lam=0.0, epochs=inner_epochs, steps=inner_steps or b)
            ledger.compute(inner_epochs * (b + (inner_steps or b)))
        elif solver == "saga":
            eta = 0.3 / spec.beta
            w_new = solvers.saga_linear(
                solvers.lsq_residual, ks, w, X, y, eta, gamma_t, w,
                lam=lam, steps=inner_steps or b)
            ledger.compute(b + (inner_steps or b))
        else:
            raise ValueError(f"unknown solver {solver!r}")

        if radius != float("inf"):
            w_new = prox.project_l2_ball(w_new, radius)
        w = w_new
        iterates.append(w)

    iterates = torch.stack(iterates)
    if strongly_convex:
        t_idx = torch.arange(1, T + 1, dtype=iterates.dtype, device=dev)
        w_avg = (t_idx[:, None] * iterates).sum(0) * 2.0 / (T * (T + 1))
    else:
        w_avg = iterates.mean(0)
    return ProxResult(w_avg=w_avg, w_last=w, iterates=iterates,
                      gammas=torch.tensor(gammas), ledger=ledger)
