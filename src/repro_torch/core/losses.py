"""Convex instantaneous losses for distributed stochastic optimization.

The port of `repro/core/losses.py`. The paper's analysis is for least
squares ``l(w, xi) = 0.5 (w^T x - y)^2`` (optionally ridge-regularized to
make it strongly convex); the algorithms apply to any convex loss, so
logistic loss is here too for the App. E experiments.

Every loss exposes:
  value(w, X, y)      mean loss over the batch           (phi_I)
  grad(w, X, y)       mean gradient over the batch       (nabla phi_I)
  per_example_grad    gradient of one example            (for SVRG inner loops)

`value_fn` / `grad_fn` take a batch written out, x (..., d) and y (...),
where the reference `vmap`s a one-example function; one example (x (d,),
y a scalar) is the batch with no leading axes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Loss:
    """A convex instantaneous loss phi(w; x, y) with known constants."""

    name: str
    value_fn: Callable
    grad_fn: Callable
    lam: float = 0.0  # strong convexity of the *instantaneous* loss

    def value(self, w, X, y):
        """Mean loss over a batch. X: (n, d), y: (n,)."""
        return self.value_fn(w, X, y).mean()

    def grad(self, w, X, y):
        """Mean gradient over a batch (one vector op per example)."""
        return self.grad_fn(w, X, y).mean(0)

    def per_example_grad(self, w, x, y):
        return self.grad_fn(w, x, y)


# --------------------------------------------------------------------------
# Least squares:  l(w, (x,y)) = 0.5 (w.x - y)^2
# --------------------------------------------------------------------------

def _lsq_value(w, x, y):
    r = x @ w - y
    return 0.5 * r * r


def _lsq_grad(w, x, y):
    return (x @ w - y).unsqueeze(-1) * x


def least_squares() -> Loss:
    return Loss("least_squares", _lsq_value, _lsq_grad, lam=0.0)


# --------------------------------------------------------------------------
# Ridge-regularized least squares: strongly convex instantaneous loss
#   l(w, xi) = 0.5 (w.x - y)^2 + lam/2 ||w||^2
# --------------------------------------------------------------------------

def ridge_least_squares(lam: float) -> Loss:
    def value(w, x, y):
        return _lsq_value(w, x, y) + 0.5 * lam * torch.dot(w, w)

    def grad(w, x, y):
        return _lsq_grad(w, x, y) + lam * w

    return Loss("ridge_least_squares", value, grad, lam=lam)


# --------------------------------------------------------------------------
# Logistic loss (App. E classification experiments): y in {-1, +1}
# --------------------------------------------------------------------------

def _logistic_value(w, x, y):
    z = -y * (x @ w)
    return torch.logaddexp(torch.zeros_like(z), z)


def _logistic_grad(w, x, y):
    s = torch.sigmoid(-y * (x @ w))
    return (-s * y).unsqueeze(-1) * x


def logistic() -> Loss:
    return Loss("logistic", _logistic_value, _logistic_grad, lam=0.0)


def logistic_ridge(lam: float) -> Loss:
    def value(w, x, y):
        return _logistic_value(w, x, y) + 0.5 * lam * torch.dot(w, w)

    def grad(w, x, y):
        return _logistic_grad(w, x, y) + lam * w

    return Loss("logistic_ridge", value, grad, lam=lam)


# --------------------------------------------------------------------------
# Batched closed forms for least squares (used by exact prox + tests)
# --------------------------------------------------------------------------

def lsq_batch_value(w, X, y):
    r = X @ w - y
    return 0.5 * torch.mean(r * r)


def lsq_batch_grad(w, X, y):
    n = X.shape[0]
    return X.T @ (X @ w - y) / n


def loss_constants(X, y=None, radius: float = None, lam: float = 0.0):
    """Empirical (L, beta) for least squares on a reference sample.

    beta = max_i ||x_i||^2 (per-example smoothness),
    L    = max_i ||x_i|| * (radius * ||x_i|| + |y_i|)  (Lipschitz over the ball
           of radius `radius`); the paper assumes L, beta = O(1).
    """
    norms = torch.linalg.vector_norm(X, dim=1)
    beta = torch.max(norms**2) + lam
    if radius is None:
        radius = 1.0
    if y is None:
        y = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
    L = torch.max(norms * (radius * norms + torch.abs(y))) + lam * radius
    return float(L), float(beta)
