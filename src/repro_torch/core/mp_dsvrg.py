"""MP-DSVRG — Algorithm 1: minibatch-prox with distributed SVRG inner solver.

The port of `repro/core/mp_dsvrg.py`. The reference writes a per-machine
program against a named machine axis and runs it under
`jax.vmap(axis_name=...)`; here the m machines are simulated on one device
with the machine axis written out: each outer step holds Xm (m, b, d) and
ym (m, b).

Fidelity notes vs. the paper's pseudo-code (as in the reference):
  * Step 1 (global gradient at z_{k-1}) is the mean over machines of the
    local minibatch gradients — one all-reduce round, the paper's
    communication; here one batched product and a mean over the machine
    axis.
  * Step 2: a *single* designated machine j runs the without-replacement
    VR pass. The reference runs the pass on every machine and selects
    machine j's result with a mask and psum; here only machine j's pass
    runs (see `_dsvrg_inner`).
  * Step 3 broadcast of z_k: the one result is the replicated state. The
    running SVRG iterate x is carried alongside z so the hand-off between
    designated machines is well-defined (the paper leaves it implicit).
  * z_k is the average over the pass iterates x_0..x_{|B|} (|B|+1 terms; the
    paper's normalization 1/|B| over |B|+1 terms is treated as a typo).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import solvers, theory
from repro_torch.core.accounting import Ledger
from repro_torch.core.losses import Loss, least_squares
from repro_torch.device import DeviceLike, resolve_device


def _dsvrg_inner(loss: Loss, w_prev, x_init, Xm, ym, gamma: float,
                 eta: float, p: int, K: int, lam: float):
    """K inner DSVRG iterations for the prox subproblem over m machines.

    Xm: (m, b, d), ym: (m, b); each machine's batch splits into p batches
    of size b//p (the last b mod p rows are dropped, as in the reference).
    gamma, eta and lam are Python floats, so the host only enqueues work:
    nothing here waits on the device. Returns (z_K, x_last).
    """
    m, b, _ = Xm.shape
    batch = b // p
    z, x = w_prev, x_init
    for k in range(K):
        # -- step 1: one all-reduce for the exact minibatch gradient at z --
        r = torch.matmul(Xm, z) - ym                                # (m, b)
        g_loc = torch.matmul(r.unsqueeze(1), Xm).squeeze(1) / b + lam * z
        mu = g_loc.mean(0)
        # -- step 2: designated machine j runs the VR pass on batch s --
        # The reference runs this pass on every machine and keeps machine
        # j's result with psum(mask * result) (step 3's broadcast): the
        # other machines add exact zeros, so running machine j's pass alone
        # gives the same numbers and is the paper's algorithm. As there,
        # the pass adds lam * z (inside mu) but no lam * x.
        j = (k // p) % m
        rows = slice((k % p) * batch, (k % p + 1) * batch)
        z, x = solvers.svrg_pass_wr(loss.per_example_grad, x, z, mu,
                                    Xm[j, rows], ym[j, rows], eta, gamma,
                                    w_prev)
    return z, x


@dataclasses.dataclass
class MPDSVRGResult:
    w_avg: torch.Tensor
    w_last: torch.Tensor
    iterates: torch.Tensor
    plan: theory.MPDSVRGPlan
    ledger: Ledger


def run_mp_dsvrg(stream, spec: theory.ProblemSpec, m: int, b: int, T: int,
                 *, K: Optional[int] = None, p: Optional[int] = None,
                 gamma: Optional[float] = None, eta_scale: float = 0.3,
                 lam: float = 0.0, seed: int = 0,
                 loss: Optional[Loss] = None,
                 device: DeviceLike = None) -> MPDSVRGResult:
    """Run Algorithm 1 for T outer iterations, m machines, b samples/machine.

    Parameters default to the Theorem-10 plan computed from (spec, n=bmT).
    `stream.sample_distributed(generator, m, b)` gives each outer step's
    data (a torch.Generator on `device`, seeded from `seed`); `device` None
    means CUDA.
    """
    dev = resolve_device(device)
    n = b * m * T
    plan = theory.mp_dsvrg_plan(spec, n, m, b)
    K = K if K is not None else plan.K
    p = p if p is not None else plan.p
    p = max(1, min(p, b))
    gamma = gamma if gamma is not None else plan.gamma
    plan = dataclasses.replace(plan, T=T, K=K, p=p, gamma=gamma,
                               batch=b // p)
    eta = eta_scale / (spec.beta + gamma + lam)
    loss = loss or least_squares()

    ledger = Ledger()
    ledger.hold(b)

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.zeros(stream.dim, device=dev)
    iterates = []
    for _ in range(T):
        Xm, ym = stream.sample_distributed(gen, m, b)
        Xm = torch.as_tensor(Xm, dtype=torch.float32, device=dev)
        ym = torch.as_tensor(ym, dtype=torch.float32, device=dev)
        w, _ = _dsvrg_inner(loss, w, w, Xm, ym, gamma, eta, p, K, lam)
        iterates.append(w)
        # accounting per Algorithm 1: K inner iters x 2 rounds (grad + bcast)
        ledger.communicate(vectors=2 * K, rounds=2 * K)
        # per machine: local gradient O(b) per inner iter; the designated
        # machine additionally runs b/p stochastic updates
        ledger.compute(K * (b + b // p))

    iterates = torch.stack(iterates)
    return MPDSVRGResult(w_avg=iterates.mean(0), w_last=w,
                         iterates=iterates, plan=plan, ledger=ledger)
