"""JAX's threefry2x32 key stream as torch integer ops.

`PRNGKey`, `split`, `fold_in`, `random_bits` and `randint` give the bits
of `jax.random` under its default configuration: the threefry2x32 PRNG
with `jax_threefry_partitionable` on (the default since jax 0.5) and
64-bit types off (x32 mode); `uniform`, `normal`, `gumbel` (mode "low",
the default) and `categorical` follow JAX's float recipes on those bits.
The recipes follow jax 0.9's `jax/_src/prng.py` (`threefry_seed`,
`_threefry2x32_lowering`, `_threefry_split_foldlike`, `_threefry_fold_in`,
`_threefry_random_bits_partitionable`) and `jax/_src/random.py`
(`_randint`, `_uniform`, `_normal_real`, `_gumbel`, `categorical`) and
XLA's float32 `erf_inv` (Giles' polynomial).

A key is an int64 tensor of shape (2,) holding two 32-bit words; `split`
gives keys stacked along a leading axis, so `k1, k2, k3 = split(key, 3)`
unpacks as in JAX. Every function that takes a key also takes a stack of
keys (..., 2) and draws for each (what `jax.vmap` over keys gives); a
tensor of seeds gives such a stack from `PRNGKey`. Every word is an int64 masked to 32 bits, so the same
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


def PRNGKey(seed, device="cpu") -> torch.Tensor:
    """The key of `jax.random.PRNGKey(seed)` in x32 mode: the seed wraps to
    int32, its high word (a logical shift of an int32 by 32) is 0 and its
    low word is the seed's low 32 bits. An integer tensor of seeds (a
    negative int32 seed included) gives the stack of their keys, (..., 2),
    on the seeds' device."""
    if isinstance(seed, torch.Tensor):
        lo = seed.to(torch.int64) & MASK
        return torch.stack([torch.zeros_like(lo), lo], dim=-1)
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


def _hash_iota(key, shape, start: int = 0):
    """threefry2x32 of the 64-bit iota over `shape`, split into its high
    and low words (JAX's iota_2x32_shape): the partitionable recipe's
    counters. key (..., 2) hashes for each of its leading entries:
    returns two words of shape (..., *shape). With `start`, the counters
    run from there: the flat elements start .. start + prod(shape) of a
    larger draw."""
    n = math.prod(shape)
    count = torch.arange(start, start + n, dtype=torch.int64,
                         device=key.device)
    words = [w.reshape(w.shape + (1,)) for w in key.unbind(-1)]
    b1, b2 = threefry2x32(*words, count >> 32, count & MASK)
    return (b1.reshape(key.shape[:-1] + shape),
            b2.reshape(key.shape[:-1] + shape))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: num keys, shape (num, 2)."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: threefry2x32 of the counter pair
    (0, data mod 2^32) under the key, whose two words are the new key.
    `data` is an int or an integer tensor that broadcasts against
    key.shape[:-1] (one datum per key of a stack)."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    k1, k2 = key.unbind(-1)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(key: torch.Tensor, bit_width: int, shape,
                start: int = 0) -> torch.Tensor:
    """`jax.random.bits(key, shape)` at 8, 16 or 32 bits: words in
    [0, 2^bit_width), int64 (the partitionable recipe keeps the low bits
    of the 32-bit word). A stack of keys (..., 2) draws for each:
    (..., *shape). With `start`, the flat elements start .. of a larger
    draw from the same key (each element's bits depend on its counter
    alone)."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"random_bits: 8-, 16- and 32-bit words are "
                         f"ported, got {bit_width}")
    b1, b2 = _hash_iota(key, tuple(shape), start)
    bits = b1.bitwise_xor_(b2)
    return bits if bit_width == 32 else bits.bitwise_and_(
        (1 << bit_width) - 1)


# float dtype -> (bits, mantissa bits, the bits of 1.0, the integer type of
# its width)
_FLOAT_BITS = {torch.float32: (32, 23, 0x3F800000, torch.int32),
               torch.bfloat16: (16, 7, 0x3F80, torch.int16),
               torch.float16: (16, 10, 0x3C00, torch.int16)}
# dtypes whose uniform scaling rounds once: the wider type it is done in
_FUSED = {torch.float32: torch.float64, torch.float16: torch.float32}


def uniform(key: torch.Tensor, shape=(), dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0,
            start: int = 0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)`: random bits
    (8 of them where the mantissa is under 8 bits, as bf16's) shifted into
    the mantissa of a float in [1, 2), bit-cast, less 1, then
    `* (maxval - minval) + minval` and `max(minval, .)` in `dtype`. XLA on
    the CPU fuses that multiply-add into one rounding for float32 and
    float16 and rounds bf16 after each op; the port does the same (the
    fused form in a wider type). For [0, 1) and for gumbel's [tiny, 1)
    every form gives the same bits. `start` as in random_bits."""
    nbits, nmant, one, itype = _FLOAT_BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, rng_bits, shape, start)
    fbits = (bits >> (rng_bits - nmant)) | one
    floats = fbits.to(itype).view(dtype) - 1
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    wide = _FUSED.get(dtype)
    if wide is None:
        scaled = floats * (hi - lo) + lo
    else:
        scaled = (floats.to(wide) * (hi - lo).to(wide) + lo.to(wide)).to(dtype)
    return torch.maximum(lo, scaled)


# XLA's float32 log1p on the CPU (its elemental emitter): Cephes' rational
# approximation for |x| < sqrt(2) - 1, else log(1 + x) by the Cephes
# polynomial of XLA's vectorised log, each step of both one fused
# multiply-add where XLA emits one
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w - 2.5 where w = -log1p(-x^2) < 5, else in
# sqrt(w) - 3
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


# float32 arithmetic carried in float64 tensors: every value is a float32
# and every op rounds once to float32 (_r), a fused multiply-add included
# (the float64 product of two float32 values is exact). Only +, -, *, /,
# sqrt and frexp, which IEEE rounds exactly on every device, so a draw has
# the same bits on the CPU and on CUDA.
def _r(x):
    return x.float().double()


def _c(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def _fma(a, b, c):
    return _r(a * b + c)


def _horner(coefs, x):
    p = torch.full_like(x, _c(coefs[0]))
    for c in coefs[1:]:
        p = _fma(p, x, _c(c))
    return p


def _log(a):
    """XLA's vectorised float32 log of a > 0 (float32 values in float64)."""
    m, e = torch.frexp(a.float())
    m, e = m.double(), e.double()
    # m in [0.5, 1), moved to [sqrt(1/2), sqrt(2)) - 1
    low = m < _c(0.707106781186547524)
    x = _r(_r(m - 1) + torch.where(low, m, torch.zeros_like(m)))
    e = e - low.double()
    x2 = _r(x * x)
    x3 = _r(x2 * x)
    p = _LOG_P
    y = _fma(_fma(_c(p[0]), x, _c(p[1])), x, _c(p[2]))
    y1 = _fma(_fma(_c(p[3]), x, _c(p[4])), x, _c(p[5]))
    y2 = _fma(_fma(_c(p[6]), x, _c(p[7])), x, _c(p[8]))
    y = _r(_fma(_fma(y, x3, y1), x3, y2) * x3)
    y = _r(y + _r(e * _c(-2.12194440e-4)))
    x = _r(_r(x - _r(x2 * 0.5)) + y)
    return _r(x + _r(e * 0.693359375))


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p (float32 in, float32 out), in exactly rounded
    operations: XLA's bits on 99.9% of inputs and within 1 ulp on the
    rest, the same bits on every device (torch.log1p is neither);
    log1p(-1) = -inf. For x in (-1, 1], where erfinv takes it."""
    x = x.double()
    x2 = _r(x * x)
    r = _r(_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x))
    small = _r(x + _r(_r(-0.5 * x2) + _r(_r(x * x2) * r)))
    big = _log(_r(x + 1))
    big = torch.where(x == -1, -math.inf, big)
    return torch.where(x.abs() < 0.41421356237309504880, small, big).float()


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv of a float32 tensor: Giles' polynomial, each
    of its steps one fused multiply-add as XLA emits it on the CPU, on
    XLA's log1p (`log1p`), in exactly rounded operations, so the same bits
    on every device. torch.erfinv is another approximation (tens of ulps
    off XLA's near +-1). Within 2 ulps of XLA's erf_inv, bit-equal on all
    but ~1e-4 of the inputs. erfinv(+-1) = +-inf, as XLA gives."""
    w = log1p(-x * x).double().neg()
    small = w < 5
    t = torch.where(small, _r(w - 2.5), _r(_r(torch.sqrt(w)) - 3.0))
    p = torch.where(small, _c(_ERFINV_SMALL[0]), _c(_ERFINV_LARGE[0]))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, t, torch.where(small, _c(cs), _c(cl)))
    out = (p.float() * x)
    return torch.where(x.abs() == 1, x * math.inf, out)   # +-1: +-inf


# elements a normal draw computes at once: the int64 hash and float64
# polynomial temporaries of this many stay near a few hundred MB
NORMAL_CHUNK = 1 << 23


def normal(key: torch.Tensor, shape=(), dtype=torch.float32
           ) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)` for a single key: JAX's
    sqrt(2) * erf_inv(uniform(key, shape, dtype, nextafter(-1, 0), 1)),
    the uniform bit for bit, erf_inv as XLA computes it in float32
    (`erfinv`; for 16-bit dtypes in float32 and rounded), the product in
    `dtype`: float32 values within 2 ulps of JAX's (all but ~2e-5 of them
    bit-equal), 16-bit ones bit-equal, and the same bits on every device.
    Drawn NORMAL_CHUNK elements at a time over the flat counter, which
    gives the bits of one draw of the whole shape (the partitionable
    recipe hashes each element's counter alone)."""
    shape = tuple(shape)
    n = math.prod(shape)
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                               torch.tensor(0.0, dtype=dtype)))
    sqrt2 = torch.tensor(math.sqrt(2), dtype=dtype, device=key.device)
    out = torch.empty(n, dtype=dtype, device=key.device)
    for s in range(0, n, NORMAL_CHUNK):
        m = min(NORMAL_CHUNK, n - s)
        u = uniform(key, (m,), dtype, lo, 1.0, start=s)
        out[s:s + m] = sqrt2 * erfinv(u.float()).to(dtype)
    return out.reshape(shape)


def gumbel(key: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """`jax.random.gumbel(key, shape, dtype)` in its default mode "low":
    -log(-log(u)) of u = uniform(key, shape, dtype, tiny, 1)."""
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` over the last axis, the Gumbel
    max trick: argmax(gumbel(key, ...) + logits). A single key draws the
    noise over the whole of logits; a stack of keys (..., 2) whose leading
    dims lead logits' draws, per key, over the dims that follow (what
    `jax.vmap(categorical)` over keys and rows gives). Returns int64
    indices (the first maximum, as jnp.argmax)."""
    g = gumbel(key, tuple(logits.shape[key.dim() - 1:]), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


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
