"""MP-DANE — Algorithm 2: minibatch-prox + AIDE(catalyst) + inexact DANE.

The port of `repro/core/mp_dane.py`, with the m machines simulated on one
device (the machine axis written out, as in `mp_dsvrg.py`). Three nested
loops: t (minibatch-prox outer), r (AIDE catalyst), k (DANE). Each DANE
iteration: one all-reduce for the global minibatch gradient at z_{k-1}, a
*local* corrected subproblem solve on every machine (the all-machines-busy
variant), and one all-reduce to average the local solutions (eq. 34).

The local subproblem (eq. 33):

  z_k^(i) ~= argmin_z  phi_{I^(i)}(z) + <grad phi_{I_t}(z_{k-1})
                        - grad phi_{I^(i)}(z_{k-1}), z>
                        + gamma/2 ||z - w_{t-1}||^2 + kappa/2 ||z - y_{r-1}||^2

solved by 'exact' (the closed-form quadratic). The 'saga' and 'prox_svrg'
local solvers raise until they are ported (see `solvers.py`).

EMSO (Li et al. 2014) = this algorithm with the gradient correction removed,
K=1, R=1, kappa=0 — exposed via `correction=False` for the baseline table.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import solvers, theory
from repro_torch.core.accounting import Ledger
from repro_torch.core.losses import Loss, least_squares
from repro_torch.device import DeviceLike, resolve_device


def _dane_round(loss: Loss, z_prev, Xm, ym, w_anchor, y_cat, gamma: float,
                kappa: float, lam: float, correction: bool):
    """One inexact-DANE iteration (steps 1-3 of the inner loop) on all m
    machines at once: Xm (m, b, d), ym (m, b); z_prev, w_anchor and y_cat
    are the replicated (d,) vectors. Each machine's exact local solve is
    `solvers.exact_quadratic` on its own batch, batched over machines."""
    m, b, d = Xm.shape
    Xt = Xm.transpose(1, 2)
    if loss.name.startswith("least_squares"):
        r = torch.matmul(Xm, z_prev) - ym
        g_loc = (Xt @ r.unsqueeze(-1)).squeeze(-1) / b + lam * z_prev
    else:
        g_loc = loss.per_example_grad(z_prev, Xm, ym).mean(1) + lam * z_prev
    g_glob = g_loc.mean(0)                             # round 1: gradient avg
    c = (g_glob - g_loc) if correction else torch.zeros_like(g_loc)

    eye = torch.eye(d, dtype=Xm.dtype, device=Xm.device)
    H = Xt @ Xm / b + (lam + gamma + kappa) * eye
    rhs = ((Xt @ ym.unsqueeze(-1)).squeeze(-1) / b - c + gamma * w_anchor
           + kappa * y_cat)
    z_i = torch.linalg.solve(H, rhs)
    return z_i.mean(0)                                 # round 2: solution avg


@dataclasses.dataclass
class MPDANEResult:
    w_avg: torch.Tensor
    w_last: torch.Tensor
    iterates: torch.Tensor
    plan: theory.MPDANEPlan
    ledger: Ledger


def run_mp_dane(stream, spec: theory.ProblemSpec, m: int, b: int, T: int,
                *, K: Optional[int] = None, R: Optional[int] = None,
                kappa: Optional[float] = None, gamma: Optional[float] = None,
                local_solver: str = "exact", correction: bool = True,
                lam: float = 0.0, seed: int = 0,
                loss: Optional[Loss] = None,
                device: DeviceLike = None) -> MPDANEResult:
    """Run Algorithm 2. Defaults follow Theorems 14/16 given n = bmT.

    Only local_solver='exact' is ported ('saga' / 'prox_svrg' raise).
    `stream.sample_distributed(generator, m, b)` gives each outer step's data
    (a torch.Generator on `device`, seeded from `seed`); `device` None means
    CUDA.
    """
    if local_solver in ("saga", "prox_svrg"):
        raise NotImplementedError(solvers.NOT_PORTED.format(local_solver))
    if local_solver != "exact":
        raise ValueError(local_solver)
    dev = resolve_device(device)
    n = b * m * T
    plan = theory.mp_dane_plan(spec, n, m, b, stream.dim)
    K = K if K is not None else plan.K
    R = R if R is not None else plan.R
    kappa = kappa if kappa is not None else plan.kappa
    gamma = gamma if gamma is not None else plan.gamma
    plan = dataclasses.replace(plan, T=T, K=K, R=R, kappa=kappa, gamma=gamma)
    loss = loss or least_squares()

    ledger = Ledger()
    ledger.hold(b)

    # AIDE catalyst loop (eq. 35-36); R=1, kappa=0 => plain DANE. alpha and
    # the momentum are host scalars: alpha_r^2 = (1-alpha_r) alpha_{r-1}^2
    # + q alpha_r, q = gamma/(gamma+kappa).
    q = gamma / (gamma + kappa + 1e-30)
    momenta = []
    alpha_prev = math.sqrt(q)
    for _ in range(R):
        a2 = alpha_prev**2
        alpha = 0.5 * ((q - a2) + math.sqrt((q - a2) ** 2 + 4.0 * a2))
        momenta.append(alpha_prev * (1 - alpha_prev) / (alpha_prev**2
                                                         + alpha))
        alpha_prev = alpha

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.zeros(stream.dim, device=dev)
    iterates = []
    for _ in range(T):
        Xm, ym = stream.sample_distributed(gen, m, b)
        Xm = torch.as_tensor(Xm, dtype=torch.float32, device=dev)
        ym = torch.as_tensor(ym, dtype=torch.float32, device=dev)
        x_prev = y_cat = w
        for beta_mom in momenta:
            x_r = y_cat
            for _ in range(K):
                x_r = _dane_round(loss, x_r, Xm, ym, w, y_cat, gamma, kappa,
                                  lam, correction)
            y_cat = x_r + beta_mom * (x_r - x_prev)
            x_prev = x_r
        w = x_prev
        iterates.append(w)
        rounds = 2 * K * R if correction else 1
        ledger.communicate(vectors=rounds, rounds=rounds)
        ledger.compute(K * R * 2 * b)  # local grad + ~one pass per DANE iter

    iterates = torch.stack(iterates)
    return MPDANEResult(w_avg=iterates.mean(0), w_last=w, iterates=iterates,
                        plan=plan, ledger=ledger)
