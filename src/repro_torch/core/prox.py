"""Proximal operators for minibatch-prox.

The port of `repro/core/prox.py`. The minibatch-prox iterate (paper eq.
(3)) is

    w_t = argmin_{w in Omega}  phi_{I_t}(w) + (gamma_t / 2) ||w - w_{t-1}||^2 .

For least squares this subproblem is a d x d linear solve (the "exact" oracle
used by Theorems 4/5 and the correctness oracles of every inexact solver):

    (X^T X / b + (lam + gamma) I) w = X^T y / b + gamma w_prev   [+ ridge]
"""
from __future__ import annotations

import torch


def _flatten(X, y):
    """Stacked machines (m, b, d) / (m, b) -> the union batch (m*b, d)."""
    if X.ndim == 3:
        return X.reshape(-1, X.shape[-1]), y.reshape(-1)
    return X, y


def exact_lsq_prox(w_prev, X, y, gamma: float, lam: float = 0.0):
    """Closed-form minimizer of the least-squares minibatch-prox subproblem.

    Supports X of shape (b, d) or stacked machines (m, b, d) — the stacked form
    solves the *union* minibatch subproblem (eq. 12) exactly.
    """
    X, y = _flatten(X, y)
    b, d = X.shape
    H = X.T @ X / b + (lam + gamma) * torch.eye(d, dtype=X.dtype,
                                                device=X.device)
    rhs = X.T @ y / b + gamma * w_prev
    return torch.linalg.solve(H, rhs)


def prox_subproblem_value(w, w_prev, X, y, gamma: float, lam: float = 0.0):
    """f_t(w) = phi_{I_t}(w) + gamma/2 ||w - w_prev||^2 (least squares)."""
    X, y = _flatten(X, y)
    r = X @ w - y
    reg = 0.5 * lam * torch.dot(w, w)
    return (0.5 * torch.mean(r * r) + reg
            + 0.5 * gamma * torch.sum((w - w_prev) ** 2))


def prox_subproblem_grad(w, w_prev, X, y, gamma: float, lam: float = 0.0):
    X, y = _flatten(X, y)
    n = X.shape[0]
    return X.T @ (X @ w - y) / n + lam * w + gamma * (w - w_prev)


def project_l2_ball(w, radius: float):
    """P_Omega for Omega = {w : ||w|| <= radius}. radius=inf => identity."""
    norm = torch.linalg.vector_norm(w)
    scale = torch.clamp(radius / torch.clamp(norm, min=1e-30), max=1.0)
    return w * scale


def sgd_equivalence_residual(w_t, w_prev, X, y, gamma: float,
                             lam: float = 0.0):
    """Residual of the implicit-gradient characterization (paper eq. (5)):

        w_t = w_{t-1} - (1/gamma) grad phi_{I_t}(w_t)        (unconstrained)

    Zero iff w_t is the exact prox point. Used by property tests.
    """
    X, y = _flatten(X, y)
    n = X.shape[0]
    g = X.T @ (X @ w_t - y) / n + lam * w_t
    return w_t - (w_prev - g / gamma)
