"""The paper's theory, in code.

A copy of `repro/core/theory.py`, which is pure `math` (the port imports
nothing of the JAX package); its plans are held equal to the JAX
package's, field for field, by tests/test_torch_core.py.

Every schedule/parameter the theorems prescribe lives here so that algorithms,
tests and benchmarks share one source of truth:

  - sample complexity n(eps) = O(L^2 B^2 / eps^2)
  - Thm 4  (exact, weakly convex):    gamma = sqrt(8T/b) * L / ||w0 - w*||
  - Thm 5  (exact, strongly convex):  gamma_t = lam (t-1) / 2
  - Thm 7/8 inexactness schedules eta_t
  - Thm 10 (MP-DSVRG): T, gamma, p_i, K
  - Thm 14/16 (MP-DANE): b*, kappa, R, K, theta
  - Table 1 / Table 2 resource model (communication / computation / memory)
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Constants of the stochastic convex problem."""

    L: float          # Lipschitz constant of the instantaneous loss
    beta: float       # smoothness
    B: float          # competitor norm bound / ||w0 - w*||
    lam: float = 0.0  # strong convexity (0 = weakly convex)
    dim: int = 1


def n_eps(spec: ProblemSpec, eps: float) -> int:
    """Min-max optimal sample complexity n(eps) = L^2 B^2 / eps^2."""
    return max(1, int(math.ceil(spec.L**2 * spec.B**2 / eps**2)))


# ----------------------------------------------------------------------------
# Minibatch-prox schedules (Section 3)
# ----------------------------------------------------------------------------

def gamma_weakly_convex(spec: ProblemSpec, b: int, T: int) -> float:
    """Thm 4/7: gamma = sqrt(8 T / b) * L / ||w0 - w*||  (constant over t)."""
    return math.sqrt(8.0 * T / b) * spec.L / spec.B


def gamma_strongly_convex(spec: ProblemSpec, t: int) -> float:
    """Thm 5/8: gamma_t = lam (t - 1) / 2 (t is 1-indexed)."""
    return spec.lam * (t - 1) / 2.0


def eta_schedule_weakly_convex(spec: ProblemSpec, b: int, T: int, t: int,
                               c1: float = 1e-4, c2: float = 1e-4,
                               delta: float = 0.5) -> float:
    """Thm 7 inexactness budget for iteration t (1-indexed)."""
    ratio = T / b
    return (min(c1 * ratio**0.5, c2 * ratio**1.5)
            * spec.L * spec.B / t ** (2 + 2 * delta))


def eta_schedule_strongly_convex(spec: ProblemSpec, b: int, T: int, t: int,
                                 c1: float = 1e-4, c2: float = 1e-4,
                                 delta: float = 0.5) -> float:
    """Thm 8 inexactness budget for iteration t (1-indexed)."""
    ratio = T / b
    return (min(c1 * ratio, c2 * ratio**2)
            * spec.L**2 / (t ** (3 + 2 * delta) * spec.lam))


def rate_bound_weakly_convex(spec: ProblemSpec, b: int, T: int,
                             exact: bool = True) -> float:
    """Thm 4: sqrt(8) L B / sqrt(bT); Thm 7 (c1=c2=1e-4, delta=.5): sqrt(10)."""
    c = math.sqrt(8.0) if exact else math.sqrt(10.0)
    return c * spec.L * spec.B / math.sqrt(b * T)


def rate_bound_strongly_convex(spec: ProblemSpec, b: int, T: int) -> float:
    """Thm 5: 16 L^2 / (lam b (T+1))."""
    return 16.0 * spec.L**2 / (spec.lam * b * (T + 1))


# ----------------------------------------------------------------------------
# MP-DSVRG parameters (Theorem 10)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MPDSVRGPlan:
    T: int            # outer minibatch-prox iterations
    gamma: float      # prox regularization
    K: int            # DSVRG inner iterations per outer step
    p: int            # local batches per machine (memory b, batch size b/p)
    batch: int        # b / p  (stochastic-pass length per inner iteration)

    @property
    def comm_rounds(self) -> int:
        # two communications per inner iteration (gradient avg + broadcast)
        return 2 * self.K * self.T

    def memory_vectors(self, b: int) -> int:
        return b  # each machine holds its current minibatch only

    def computation_vector_ops(self, b: int) -> int:
        # per machine: local gradient (b ops) + 1/m-th of the stochastic pass
        return self.K * self.T * (b + self.batch)


def mp_dsvrg_plan(spec: ProblemSpec, n: int, m: int, b: int,
                  k_multiplier: float = 1.0) -> MPDSVRGPlan:
    """Thm 10: T = n/(bm), gamma = sqrt(8n) L/(bmB), p_i = O(sqrt(n) L/(beta m B)),
    K = O(log n)."""
    T = max(1, n // (b * m))
    gamma = math.sqrt(8.0 * n) * spec.L / (b * m * spec.B)
    # condition number of f_t: (beta + gamma)/gamma; pick batch >= cond number
    cond = (spec.beta + gamma) / gamma
    batch = min(b, max(1, int(math.ceil(cond))))
    p = max(1, b // batch)
    K = max(1, int(math.ceil(k_multiplier * math.log(max(n, 2)))))
    return MPDSVRGPlan(T=T, gamma=gamma, K=K, p=p, batch=b // p)


# ----------------------------------------------------------------------------
# MP-DANE parameters (Theorems 14 / 16)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MPDANEPlan:
    T: int
    gamma: float
    kappa: float      # catalyst regularization (0 below b*)
    R: int            # AIDE (catalyst) rounds
    K: int            # inexact-DANE iterations per round
    theta: float      # local solve accuracy
    b_star: int

    @property
    def comm_rounds(self) -> int:
        # two communications per DANE iteration (gradient avg + solution avg)
        return 2 * self.K * self.R * self.T


def b_star(spec: ProblemSpec, n: int, m: int, d: int) -> int:
    """Critical minibatch size b* = n L^2 / (32 m^2 beta^2 B^2 log(md))."""
    denom = 32.0 * m**2 * spec.beta**2 * spec.B**2 * math.log(max(m * d, 3))
    return max(1, int(n * spec.L**2 / denom))


def mp_dane_plan(spec: ProblemSpec, n: int, m: int, b: int, d: int,
                 k_multiplier: float = 1.0) -> MPDANEPlan:
    T = max(1, n // (b * m))
    gamma = math.sqrt(8.0 * n) * spec.L / (b * m * spec.B)
    bs = b_star(spec, n, m, d)
    if b <= bs:
        kappa, R = 0.0, 1
    else:
        kappa = max(0.0,
                    16.0 * spec.beta * math.sqrt(math.log(max(d * m, 3)) / b)
                    - gamma)
        R = max(1, int(math.ceil(
            math.sqrt((gamma + kappa) / gamma) * math.log(max(n, 2)))))
    K = max(1, int(math.ceil(k_multiplier * math.log(max(n, 2)))))
    return MPDANEPlan(T=T, gamma=gamma, kappa=kappa, R=R, K=K,
                      theta=1.0 / 6.0, b_star=bs)


# ----------------------------------------------------------------------------
# Table 1 / Table 2 resource model (per machine, ignoring constants/logs)
# ----------------------------------------------------------------------------

def table1_resources(method: str, spec: ProblemSpec, n: int, m: int,
                     b: int | None = None) -> dict:
    """Asymptotic resources from the paper's Table 1 (units: vectors)."""
    B = spec.B
    if method == "ideal":
        return dict(samples=n, communication=1, computation=n / m, memory=1)
    if method == "accelerated_gd":
        return dict(samples=n, communication=B**0.5 * n**0.25,
                    computation=B**0.5 * n**1.25 / m, memory=n / m)
    if method == "acc_minibatch_sgd":
        return dict(samples=n, communication=B**0.5 * n**0.25,
                    computation=n / m, memory=1)
    if method == "dane":
        return dict(samples=n, communication=B**2 * m,
                    computation=B**2 * n, memory=n / m)
    if method in ("disco", "aide"):
        return dict(samples=n, communication=B**0.5 * m**0.25,
                    computation=B**0.5 * n / m**0.75, memory=n / m)
    if method == "dsvrg":
        return dict(samples=n, communication=1, computation=n / m, memory=n / m)
    if method == "mp_dsvrg":
        assert b is not None
        return dict(samples=n, communication=n / (m * b),
                    computation=n / m, memory=b)
    if method == "mp_dane":
        assert b is not None
        bs = b_star(spec, n, m, spec.dim)
        if b <= bs:
            return dict(samples=n, communication=n / (m * b),
                        computation=n / m, memory=b)
        return dict(samples=n,
                    communication=B**0.5 * n**0.75 / (m**0.5 * b**0.75),
                    computation=B**0.5 * n**0.75 * b**0.25 / m**0.5, memory=b)
    raise ValueError(f"unknown method {method!r}")
