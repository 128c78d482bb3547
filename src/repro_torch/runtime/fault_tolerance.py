"""Fault tolerance for 1000+ node minibatch-prox training (the port of
`repro/runtime/fault_tolerance.py`).

Three mechanisms, all exploiting properties of the paper's algorithm:

1. **Checkpoint/restart** — training state is (params, inner-opt, step).
   Minibatches are redrawn from the seeded stream keyed by the outer step,
   so a restarted job re-samples the SAME minibatch for the interrupted
   outer step (exactly-once semantics) and NO data-pipeline state exists to
   recover. `RestartableLoop` wraps any step function with periodic
   checkpoints (async optionally) and resume.

2. **Straggler mitigation via bounded inexactness** — inner solves use a
   FIXED step budget rather than a convergence test, so a slow worker
   truncates its local solve instead of blocking the sync point. Theorem 7
   quantifies the tolerable suboptimality eta_t; `eta_budget` exposes it so
   deployments can size the step budget.

3. **Failure-domain simulation** — `FailureInjector` kills steps with a
   given probability (used by tests to prove restart converges to the same
   result as an uninterrupted run).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core import theory


@dataclasses.dataclass
class FailureInjector:
    """Deterministic pseudo-random step failures for FT tests."""
    prob: float = 0.0
    seed: int = 0
    _rng: object = None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def maybe_fail(self, step: int):
        if self.prob > 0 and self._rng.random() < self.prob:
            raise RuntimeError(f"injected failure at step {step}")


class RestartableLoop:
    """Checkpointed training loop: run(state) resumes from the latest
    checkpoint and survives (simulated or real) step failures."""

    def __init__(self, ckpt_dir: str, step_fn: Callable,
                 ckpt_every: int = 10,
                 injector: Optional[FailureInjector] = None,
                 async_save: bool = False):
        self.ckpt_dir = ckpt_dir
        self.step_fn = step_fn      # (state, step) -> state
        self.ckpt_every = ckpt_every
        self.injector = injector
        self.async_ckpt = (ckpt_lib.AsyncCheckpointer(ckpt_dir)
                           if async_save else None)

    def run(self, state, n_steps: int):
        restored, start = ckpt_lib.restore(self.ckpt_dir, state)
        if restored is not None:
            state, start = restored, start + 1
        else:
            start = 0
        for step in range(start, n_steps):
            if self.injector is not None:
                self.injector.maybe_fail(step)
            state = self.step_fn(state, step)
            if (step + 1) % self.ckpt_every == 0 or step == n_steps - 1:
                if self.async_ckpt is not None:
                    self.async_ckpt.save(step, state)
                else:
                    ckpt_lib.save(self.ckpt_dir, step, state)
        if self.async_ckpt is not None:
            self.async_ckpt.wait()
        return state


def eta_budget(spec: theory.ProblemSpec, b: int, T: int, t: int,
               strongly_convex: bool = False) -> float:
    """Max tolerable local-solve suboptimality at outer step t (Thm 7/8) —
    the contract a straggler's truncated solve must meet."""
    if strongly_convex:
        return theory.eta_schedule_strongly_convex(spec, b, T, t)
    return theory.eta_schedule_weakly_convex(spec, b, T, t)


def straggler_safe_inner_steps(base_steps: int, time_budget_frac: float
                               ) -> int:
    """Fixed-budget truncation: a worker that has consumed its wall-clock
    budget runs this many inner steps (>=1) and still joins the average."""
    return max(1, int(base_steps * max(0.0, min(1.0, time_budget_frac))))
