"""JAX's threefry2x32 key stream as torch integer ops.

`PRNGKey`, `split`, `random_bits` and `randint` give the bits of
`jax.random` under its default configuration: the threefry2x32 PRNG with
`jax_threefry_partitionable` on (the default since jax 0.5) and 64-bit
types off (x32 mode). The recipes follow jax 0.9's `jax/_src/prng.py`
(`threefry_seed`, `_threefry2x32_lowering`, `_threefry_split_foldlike`,
`_threefry_random_bits_partitionable`) and `jax/_src/random.py:_randint`.

A key is an int64 tensor of shape (2,) holding two 32-bit words; `split`
gives keys stacked along a leading axis, so `k1, k2, k3 = split(key, 3)`
unpacks as in JAX. Every word is an int64 masked to 32 bits, so the same
code runs on the CPU and on CUDA (uint32 lacks ops on some backends); a
draw lands on its key's device. Keys are values the caller passes down:
nothing here holds state.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """The key of `jax.random.PRNGKey(seed)` in x32 mode: the seed wraps to
    int32, its high word (a logical shift of an int32 by 32) is 0 and its
    low word is the seed's low 32 bits."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the counter pairs (x1, x2) under the key
    words (k1, k2): 20 rounds, the key injected every 4. All int64 holding
    32-bit words; k1, k2 broadcast against x1, x2. Returns two words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]).bitwise_and_(MASK)
    x2 = (x2 + ks[1]).bitwise_and_(MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1.add_(x2).bitwise_and_(MASK)
            t = x2 << r       # rotate left by r: bits past 32 wrap round
            x2 = t.bitwise_or_(t >> 32).bitwise_and_(MASK).bitwise_xor_(x1)
        x1 = x1.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x2 = x2.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return x1, x2


def _hash_iota(key, shape):
    """threefry2x32 of the 64-bit iota over `shape`, split into its high
    and low words (JAX's iota_2x32_shape): the partitionable recipe's
    counters. key (..., 2) hashes for each of its leading entries:
    returns two words of shape (..., *shape)."""
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    words = [w.reshape(w.shape + (1,)) for w in key.unbind(-1)]
    b1, b2 = threefry2x32(*words, count >> 32, count & MASK)
    return (b1.reshape(key.shape[:-1] + shape),
            b2.reshape(key.shape[:-1] + shape))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: num keys, shape (num, 2)."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, bit_width: int, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape)` at 32 bits: words in [0, 2^32), int64.
    A stack of keys (..., 2) draws for each: (..., *shape)."""
    if bit_width != 32:
        raise ValueError(f"random_bits: only 32-bit words are ported, got "
                         f"{bit_width}")
    b1, b2 = _hash_iota(key, tuple(shape))
    return b1.bitwise_xor_(b2)


def _mul32(a, b: int):
    """(a * b) mod 2^32 for words a (a tensor) and b (an int), without an
    int64 product above 2^63: b is applied in two 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` with the default
    int32 dtype: JAX's values (held in an int64 tensor, the dtype torch
    indexes with). The key splits in two, each half draws 32 bits a value,
    and the pair maps into [minval, maxval) by JAX's multiply-mod recipe
    in uint32 arithmetic (biased when the span is not a power of 2, as in
    JAX). minval and maxval are Python ints, clipped to int32 as JAX does;
    maxval <= minval gives minval."""
    shape = tuple(shape)
    # the two halves of split(key) draw in one hash
    higher, lower = random_bits(split(key), 32, shape)
    out_of_range = maxval > _INT32_MAX
    lo = min(max(int(minval), _INT32_MIN), _INT32_MAX)
    hi = min(max(int(maxval), _INT32_MIN), _INT32_MAX)
    span = (hi - lo) & MASK
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK

    def rem(x, n):                     # XLA's unsigned x % 0 is x
        return x % n if n else x

    multiplier = rem(rem(1 << 16, span) ** 2 & MASK, span)
    offset = rem((_mul32(rem(higher, span), multiplier)
                  + rem(lower, span)) & MASK, span)
    out = (lo + offset) & MASK                  # int32 wrap-around
    return torch.where(out > _INT32_MAX, out - (1 << 32), out)
