"""Local subproblem solvers for minibatch-prox inner loops.

The port of `repro/core/solvers.py`. All solvers target the
(lam + gamma [+ kappa])-strongly-convex subproblem

    f(w) = (1/n) sum_i l(w, xi_i) + <c, w> + (gamma/2)||w - a||^2
           [+ (kappa/2)||w - y||^2]

where `c` is an optional linear correction (DANE) and `a` the prox anchor.
The reference's `lax.scan`s are Python loops here; the step of the
variance-reduced pass is the `svrg_update` kernel.

Solvers:
  - svrg_pass_wr:     one without-replacement variance-reduced pass
                      (Algorithm 1 step 2; Shamir 2016 analysis)
  - gd:               deterministic gradient descent (reference)
  - exact_quadratic:  closed-form solve for least squares (oracle)
  - prox_svrg, saga_linear: not ported yet (they raise; see below)
"""
from __future__ import annotations

import torch

from repro_torch import kernels

# prox_svrg and saga_linear draw their example indices with
# jax.random.randint; a port that does not draw the same indices cannot be
# held to the reference iterate for iterate, so both wait for the threefry
# port (ROADMAP.md, "Open items", item 1).
NOT_PORTED = ("{} draws its example indices with jax.random.randint in the "
              "reference and is not ported yet: it waits for the threefry "
              "port (ROADMAP.md, Open items, item 1)")


# ----------------------------------------------------------------------------
# Without-replacement variance-reduced pass (Algorithm 1, step 2)
# ----------------------------------------------------------------------------

def svrg_pass_wr(per_example_grad, x0, z_anchor, mu, X, y, eta: float,
                 gamma: float, w_prox, lam: float = 0.0, linear_c=None):
    """One pass of x_r <- x_{r-1} - eta * (g(x,xi) - g(z,xi) + mu
                                           + gamma (x - w_prox) [+ lam x + c]).

    `mu` is the full minibatch gradient at the anchor `z_anchor` (computed via
    one all-reduce by the caller). Returns the average iterate (z_k update of
    Algorithm 1 step 3) and the last iterate.

    Each step is one `svrg_update` launch; `lam x` rides in its g_x operand
    and `c` in its mu operand. eta, gamma and lam are Python floats.
    """
    mu_c = mu if linear_c is None else mu + linear_c
    x = acc = x0
    for xs, ys in zip(X, y):
        g_x = per_example_grad(x, xs, ys)
        if lam:
            g_x = g_x + lam * x
        g_z = per_example_grad(z_anchor, xs, ys)
        x = kernels.svrg_update(x, g_x, g_z, mu_c, w_prox, eta, gamma)
        acc = acc + x
    return acc / (X.shape[0] + 1), x


def prox_svrg(*args, **kwargs):
    """Prox-SVRG (Xiao & Zhang 2014) epochs: not ported yet."""
    raise NotImplementedError(NOT_PORTED.format("prox_svrg"))


def saga_linear(*args, **kwargs):
    """SAGA with scalar gradient memory: not ported yet."""
    raise NotImplementedError(NOT_PORTED.format("saga_linear"))


# ----------------------------------------------------------------------------
# Deterministic reference solvers
# ----------------------------------------------------------------------------

def gd(grad_fn, x0, eta: float, iters: int = 100):
    x = x0
    for _ in range(iters):
        x = x - eta * grad_fn(x)
    return x


def exact_quadratic(w_prev, X, y, gamma, lam=0.0, linear_c=None,
                    kappa=0.0, yv=None):
    """Closed-form solve of the (corrected) least-squares prox subproblem;
    stacked machines (m, b, d) are solved as one union batch."""
    if X.ndim == 3:
        X = X.reshape(-1, X.shape[-1])
        y = y.reshape(-1)
    b, d = X.shape
    if linear_c is None:
        linear_c = torch.zeros(d, dtype=X.dtype, device=X.device)
    if yv is None:
        yv = torch.zeros(d, dtype=X.dtype, device=X.device)
    H = X.T @ X / b + (lam + gamma + kappa) * torch.eye(d, dtype=X.dtype,
                                                        device=X.device)
    rhs = X.T @ y / b - linear_c + gamma * w_prev + kappa * yv
    return torch.linalg.solve(H, rhs)
