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
  - prox_svrg:        Xiao & Zhang prox-SVRG epochs (quadratic handled in the
                      proximal step, so iteration complexity depends on beta)
  - saga_linear:      SAGA with O(n) *scalar* gradient memory for linear-model
                      losses (App. E experiments use SAGA)
  - gd:               deterministic gradient descent (reference)
  - exact_quadratic:  closed-form solve for least squares (oracle)
"""
from __future__ import annotations

import torch

from repro_torch import kernels, prng
from repro_torch.core import losses

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


# ----------------------------------------------------------------------------
# Prox-SVRG (Xiao & Zhang 2014) epochs and SAGA for the local DANE subproblem
#
# Both take one machine's X (n, d), y (n,) or a stack of m machines' X
# (m, n, d), y (m, n); x0, a, yv and linear_c are (d,) or, in a stack,
# (d,) or (m, d). In a stack every machine draws the *same* example
# indices: the reference vmaps the solver over machines without mapping
# its key. Indices come from `prng.randint` on the key's device (keys are
# host values, and the index vector is control data: the host loop reads
# it); the step loop is a host loop of small tensor ops and its vectors
# live on X's device. eta, gamma, kappa and lam are Python floats. The
# loss's gradient takes a stack's w as `losses.margin` says.
# ----------------------------------------------------------------------------

def _quad_prox(v, eta, gamma, a, kappa, yv):
    """argmin_w (1/2eta)||w - v||^2 + gamma/2||w-a||^2 + kappa/2||w-yv||^2."""
    return (v + eta * (gamma * a + kappa * yv)) / (1.0 + eta * (gamma + kappa))


def _setup(x0, X, eta, gamma, a, kappa, yv):
    """x0 broadcast over a stack's machines (a fresh tensor), the prox
    step x <- (x - eta g + eta (gamma a + kappa yv)) / (1 + eta (gamma +
    kappa)) as x <- x / div + shift - step g with its constants, and x in
    the form that meets all n rows of X in one gradient."""
    x = x0.expand(X.shape[:-2] + x0.shape[-1:]).clone()
    yv = torch.zeros_like(x0) if yv is None else yv
    div = 1.0 + eta * (gamma + kappa)
    shift = eta * (gamma * a + kappa * yv) / div
    return x, shift, div, eta / div, (
        (lambda w: w) if X.ndim == 2 else (lambda w: w.unsqueeze(-2)))


def _prox_step(x, g, shift, div, step):
    """_quad_prox(x - eta g, ...) in two ops: shift + x / div - step g."""
    return torch.add(shift, x, alpha=1.0 / div).sub_(g, alpha=step)


def prox_svrg(per_example_grad, key, x0, X, y, eta: float, gamma: float, a,
              kappa: float = 0.0, yv=None, linear_c=None, lam: float = 0.0,
              epochs: int = 2, steps: int = 0):
    """Prox-SVRG on f(w) = mean_i l(w,xi_i) + <c,w> + lam/2|w|^2
                           + gamma/2|w-a|^2 + kappa/2|w-yv|^2.

    The smooth part handled by VR gradient steps is the loss (+ the linear
    correction); the quadratic regularizers go through the exact prox, so the
    relevant smoothness is beta (of the loss), matching Lemma 17. Each
    epoch starts from the previous one's average iterate and draws its
    `steps` (0: n) indices with its own key of `split(key, epochs)`;
    returns the last epoch's average iterate. The anchor's per-example
    gradients are formed once an epoch, with mu, as mu - g(z, xi_i) for
    every row (the same terms the reference forms each step).
    """
    n = X.shape[-2]
    x, shift, div, step, rows = _setup(x0, X, eta, gamma, a, kappa, yv)
    xs, ys = X.unbind(-2), y.unbind(-1)        # row i of every machine
    steps = steps or n
    for ek in prng.split(key, epochs):
        g_z = per_example_grad(rows(x), X, y)             # (.., n, d)
        mu = g_z.mean(-2)
        if lam:
            mu = mu + lam * x
        if linear_c is not None:
            mu = mu + linear_c
        corr = (mu.unsqueeze(-2) - g_z).unbind(-2)
        acc = torch.zeros_like(x)
        for i in prng.randint(ek, (steps,), 0, n).tolist():
            g = per_example_grad(x, xs[i], ys[i])
            x = _prox_step(x, g.add_(corr[i]), shift, div, step)
            acc += x
        x = acc / steps
    return x


def lsq_residual(w, x, y):
    """The least-squares scalar gradient w.x - y, for `saga_linear`."""
    return losses.margin(w, x) - y


def saga_linear(scalar_grad, key, x0, X, y, eta: float, gamma: float, a,
                kappa: float = 0.0, yv=None, linear_c=None, lam: float = 0.0,
                steps: int = 0):
    """SAGA for losses with per-example gradient  s(w.x_i, y_i) * x_i.

    Stores only the *scalars* s_i (O(n) floats, not O(nd)) — the memory model
    the paper's experiments rely on. Quadratic terms via exact prox.
    `scalar_grad(w, x, y)` gives s(w.x, y) with w as `losses.margin` takes
    it. The step's (s_new - s_i) x_i is formed once and updates both g and
    g_avg (by / n); g_avg carries the constant correction c with it.
    Returns the mean of the `steps` (0: n) iterates.
    """
    n = X.shape[-2]
    x, shift, div, step, rows = _setup(x0, X, eta, gamma, a, kappa, yv)
    steps = steps or n
    s = scalar_grad(rows(x), X, y)                        # (n,) / (m, n)
    g_avg = (s.unsqueeze(-2) @ X).squeeze(-2) / n
    if linear_c is not None:
        g_avg = g_avg + linear_c
    xs, ys, ss = X.unbind(-2), y.unbind(-1), s.unbind(-1)
    acc = torch.zeros_like(x)
    for i in prng.randint(key, (steps,), 0, n).tolist():
        si = scalar_grad(x, xs[i], ys[i])
        dx = (si - ss[i]).unsqueeze(-1) * xs[i]
        g = dx + g_avg
        if lam:
            g.add_(x, alpha=lam)
        x = _prox_step(x, g, shift, div, step)
        g_avg.add_(dx, alpha=1.0 / n)
        ss[i].copy_(si)
        acc += x
    return acc / steps


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
