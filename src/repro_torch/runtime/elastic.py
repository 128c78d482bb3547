"""Elastic scaling: re-plan the outer schedule when the machine count
changes between (or during) runs (the port of `repro/runtime/elastic.py`).

Minibatch-prox is indifferent to m changing across outer steps — the
schedules (gamma, T) are recomputed from theory.py for the new m, and the
state that must survive is only (params, anchor). Re-sharding that state
onto a new set of devices (the JAX module's `remesh_state`) comes with the
port's distributed layer.
"""
from __future__ import annotations


def rebalance_plan(n_old: int, n_new: int, b: int, T_remaining: int):
    """Recompute the outer schedule when machine count changes: keep the
    total sample budget n = b*m*T constant (paper Thm 10 parameterization).

    Returns (new_b, new_T): we hold per-machine memory b fixed and stretch/
    shrink T so b*m*T is preserved. T rounds UP — flooring silently drops
    up to n_new-1 outer steps' worth of samples whenever b*n_new does not
    divide the remaining budget (e.g. 4 machines -> 3 with b*T_remaining
    odd), and a convergence bound paid for n samples should never run on
    fewer; overshooting by a partial step keeps b*m*T >= the old budget."""
    total = b * n_old * T_remaining
    new_T = max(1, -(-total // (b * n_new)))
    return b, new_T
