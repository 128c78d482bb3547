"""Shared shape-bucketing helpers for the serving engine.

Every jitted dispatch in the runner (batched prefill, multi-token
verify) pads its dynamic extent to a small fixed grid of shapes so the
number of compilations is bounded by the grid, not by the workload.
The grid logic used to live inline in `serving/runner.py` and was
re-derived ad hoc by the bench's shape assertions; it is shared here so
prefill, verify, and the benchmarks agree on one definition.

All helpers deal in plain ints — no device state.
"""
from __future__ import annotations

from typing import List, Optional, Sequence


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def pow2_buckets(max_value: int, start: int = 1) -> List[int]:
    """Powers of two from `start` up to (and covering) `max_value`.

    The last bucket is next_pow2(max_value), so any extent <= max_value
    fits some bucket. start is clamped to a power of two."""
    buckets, b = [], next_pow2(max(start, 1))
    while b < max_value:
        buckets.append(b)
        b *= 2
    buckets.append(next_pow2(max_value))
    return buckets


def width_buckets(max_batch: int) -> List[int]:
    """Batch-width grid: powers of two below `max_batch`, then
    `max_batch` itself (which need not be a power of two)."""
    out, w = [], 1
    while w < max_batch:
        out.append(w)
        w *= 2
    out.append(max_batch)
    return out


def chain_buckets(speculate: int) -> List[int]:
    """Verify chain-length grid for speculative decoding: powers of two
    from 2 up, topping out at EXACTLY speculate + 1 (a full K-token
    draft — the high-acceptance case — must never pad past its own
    maximum). Chains of length 1 go through plain decode instead."""
    if speculate <= 0:
        return []
    return [b for b in width_buckets(speculate + 1) if b >= 2]


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket covering n (the last bucket if none does —
    callers bound n so this is the exact-fit fallback, not overflow)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def normalize_buckets(buckets: Optional[Sequence[int]], max_value: int,
                      start: int = 1) -> List[int]:
    """Sorted unique user-provided buckets, extended so the grid covers
    `max_value`; None/empty yields the default power-of-two grid."""
    if not buckets:
        return pow2_buckets(max_value, start)
    out = sorted(set(int(b) for b in buckets))
    if out[-1] < max_value:
        out.append(next_pow2(max_value))
    return out
