"""The port's threefry key stream (repro_torch.prng) held bit for bit to
jax.random on the CPU, as jax is configured here: jax 0.9, the
threefry2x32 PRNG with jax_threefry_partitionable on, 64-bit types off.
The paper core's stochastic solvers draw their example indices with it
(jax.random.randint in the reference), so a port that drew other bits
could not be held to the reference iterate for iterate."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

from repro_torch import prng  # noqa: E402

SEEDS = [0, 1, 2**31 - 1, 2**32 + 5]


def _eq(torch_key_or_draw, jax_array):
    np.testing.assert_array_equal(torch_key_or_draw.numpy(),
                                  np.asarray(jax_array))


def test_configuration_is_the_one_ported():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS + [-1, 12345])
def test_prng_key_matches_jax(seed):
    key = prng.PRNGKey(seed)
    assert key.dtype == torch.int64 and key.shape == (2,)
    _eq(key, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_matches_jax(seed, num):
    got = prng.split(prng.PRNGKey(seed), num)
    assert got.shape == (num, 2)
    _eq(got, jax.random.split(jax.random.PRNGKey(seed), num))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chains_three_deep_match_jax(seed):
    """The key chains of the core's runs: key, kd, ks = split(key, 3), then
    ks into R keys and each of those into K."""
    tk, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for _ in range(3):
        tk, _, tks = prng.split(tk, 3)
        jk, _, jks = jax.random.split(jk, 3)
        _eq(tk, jk)
        for tr, jr in zip(prng.split(tks, 4), jax.random.split(jks, 4)):
            _eq(prng.split(tr, 7), jax.random.split(jr, 7))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (128,), (3, 5), ()])
def test_random_bits_match_jax(seed, shape):
    key = prng.PRNGKey(seed)
    got = prng.random_bits(key, 32, shape)
    assert got.shape == shape
    _eq(got, jax.random.bits(jax.random.PRNGKey(seed), shape))
    # a stack of keys draws each key's bits
    keys = prng.split(key, 3)
    stacked = prng.random_bits(keys, 32, shape)
    for k, row in zip(keys, stacked):
        torch.testing.assert_close(row, prng.random_bits(k, 32, shape),
                                   atol=0, rtol=0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 64, 1000])
@pytest.mark.parametrize("shape", [(1,), (128,), (3, 5)])
def test_randint_matches_jax(seed, n, shape):
    got = prng.randint(prng.PRNGKey(seed), shape, 0, n)
    assert got.shape == shape
    _eq(got, jax.random.randint(jax.random.PRNGKey(seed), shape, 0, n))
    assert int(got.min()) >= 0 and int(got.max()) < n


@pytest.mark.parametrize("lo,hi", [(-5, 7), (3, 3), (10, 2),
                                   (0, 2**31 - 1), (-2**31, 2**31 - 1),
                                   (0, 100003)])
def test_randint_bounds_match_jax(lo, hi):
    """Negative bounds, an empty span (minval back), the whole int32 range
    and a span above 2^16 (JAX's multiplier wraps to 0 in uint32)."""
    for seed in (0, 7):
        _eq(prng.randint(prng.PRNGKey(seed), (256,), lo, hi),
            jax.random.randint(jax.random.PRNGKey(seed), (256,), lo, hi))


def test_draws_follow_the_key_device():
    key = prng.PRNGKey(3, device="meta")
    assert prng.split(key, 3).device.type == "meta"
    assert prng.randint(key, (4,), 0, 9).device.type == "meta"


# ----------------------------------------------------------------------------
# fold_in, batched PRNGKey, uniform, gumbel, categorical: the draws of the
# serving sampler (fold_in(fold_in(PRNGKey(seed), position), tag))
# ----------------------------------------------------------------------------

import jax.numpy as jnp  # noqa: E402

# int32 seeds as the runner carries them (sampling.seed32), negative ones
# among them
SEEDS32 = np.asarray([0, 1, 7, -1, -3, -2**31, 2**31 - 1, 123456789],
                     np.int32)
POSITIONS = np.asarray([0, 1, 5, 100, 3, 2**20, 31, 4095], np.int32)


def _jax_keys(tag):
    return jax.vmap(lambda s, p: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(s), p), tag))(SEEDS32,
                                                             POSITIONS)


def _torch_keys(tag):
    keys = prng.PRNGKey(torch.from_numpy(SEEDS32))
    return prng.fold_in(prng.fold_in(keys, torch.from_numpy(POSITIONS)), tag)


@pytest.mark.parametrize("seed", SEEDS + [-1, -2**31])
@pytest.mark.parametrize("data", [0, 1, 17, 2**31 - 1, 2**32 - 1])
def test_fold_in_matches_jax(seed, data):
    _eq(prng.fold_in(prng.PRNGKey(seed), data),
        jax.random.fold_in(jax.random.PRNGKey(seed), data))


def test_batched_prng_key_over_int32_seeds_matches_jax():
    """A tensor of int32 seeds, negative ones included (seed32 of a seed
    >= 2^31), gives each seed's JAX key."""
    got = prng.PRNGKey(torch.from_numpy(SEEDS32))
    assert got.shape == (len(SEEDS32), 2)
    _eq(got, jax.vmap(jax.random.PRNGKey)(SEEDS32))


@pytest.mark.parametrize("tag", [0, 1])
def test_position_keys_fold_position_then_tag(tag):
    """The sampler's keys: fold_in of the position, then of the tag, in
    that order, over a stack of keys; a position folded per key."""
    _eq(_torch_keys(tag), _jax_keys(tag))
    swapped = prng.fold_in(prng.fold_in(prng.PRNGKey(
        torch.from_numpy(SEEDS32)), tag), torch.from_numpy(POSITIONS))
    assert not torch.equal(swapped, _torch_keys(tag))


@pytest.mark.parametrize("width,dtype", [(8, jnp.uint8), (16, jnp.uint16)])
def test_narrow_random_bits_match_jax(width, dtype):
    for seed in SEEDS:
        _eq(prng.random_bits(prng.PRNGKey(seed), width, (3, 50)),
            np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (3, 50),
                                       dtype)).astype(np.int64))


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
          (torch.float16, jnp.float16)]


def _bits(x):
    """The bit patterns of a float tensor / array, as int64."""
    if isinstance(x, torch.Tensor):
        itype = torch.int32 if x.element_size() == 4 else torch.int16
        return x.view(itype).numpy().astype(np.int64)
    x = np.asarray(x)
    return x.view(np.int32 if x.itemsize == 4 else np.int16).astype(np.int64)


@pytest.mark.parametrize("tdt,jdt", DTYPES)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.1, 3.0), (-2.0, 0.5)])
def test_uniform_bits_match_jax(tdt, jdt, lo, hi):
    """uniform's bits, per key of a stack and for one key over a grid,
    for float32, bf16 (8 random bits) and float16."""
    got = prng.uniform(_torch_keys(1), (300,), tdt, lo, hi)
    want = jax.vmap(lambda k: jax.random.uniform(k, (300,), jdt, lo, hi))(
        _jax_keys(1))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    got = prng.uniform(prng.PRNGKey(9), (4, 33), tdt, lo, hi)
    want = jax.random.uniform(jax.random.PRNGKey(9), (4, 33), jdt, lo, hi)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(got.min()) >= lo and float(got.max()) < hi


def test_scalar_uniform_per_key_matches_jax():
    """The accept uniforms of verify_tokens: one float32 per key."""
    np.testing.assert_array_equal(
        _bits(prng.uniform(_torch_keys(1))),
        _bits(jax.vmap(jax.random.uniform)(_jax_keys(1))))


@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_gumbel_matches_jax(tdt, jdt):
    """gumbel is -log(-log(u)) of uniform(tiny, 1), whose bits equal JAX's
    (checked below). torch's log and XLA's may differ in the last place,
    and near 0 the outer log magnifies that: float32 values within one
    eps of max(|JAX's|, 1), float16 (on no model's path) within 8, the
    share of bit-equal values printed. bf16 is bit-equal."""
    got = prng.gumbel(_torch_keys(0), (2000,), tdt)
    want = jax.vmap(lambda k: jax.random.gumbel(k, (2000,), jdt))(
        _jax_keys(0))
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    err = np.abs(g - w) / (torch.finfo(tdt).eps * np.maximum(np.abs(w), 1))
    print(f"gumbel {tdt}: {np.mean(g == w):.4f} of values bit-equal, "
          f"max {err.max():.2f} eps")
    assert err.max() <= {torch.float32: 1, torch.float16: 8,
                         torch.bfloat16: 0}[tdt]
    u = prng.uniform(_torch_keys(0), (2000,), tdt, torch.finfo(tdt).tiny)
    np.testing.assert_array_equal(
        _bits(u), _bits(jax.vmap(lambda k: jax.random.uniform(
            k, (2000,), jdt, float(jnp.finfo(jdt).tiny)))(_jax_keys(0))))


# normal: sqrt(2) erf_inv(u) of uniform(nextafter(-1, 0), 1), whose bits
# equal JAX's (checked below). The port's erf_inv is XLA's float32
# polynomial on XLA's log1p, each step rounded as XLA rounds it, and gives
# XLA's bits on all but ~1e-4 of its inputs: float32 values within 2 eps
# of max(|JAX's|, 1) (the share of bit-equal ones printed); bf16 and f16
# round the rest away and are bit-equal.
@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                     (torch.bfloat16, jnp.bfloat16),
                                     (torch.float16, jnp.float16)])
@pytest.mark.parametrize("seed,shape", [(0, (4096,)), (3, (37, 129)),
                                        (2**31 - 1, (2, 3, 64))])
def test_normal_matches_jax(tdt, jdt, seed, shape):
    got = prng.normal(prng.PRNGKey(seed), shape, tdt)
    want = jax.random.normal(jax.random.PRNGKey(seed), shape, jdt)
    assert got.shape == shape and got.dtype == tdt
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    err = np.abs(g - w) / (torch.finfo(tdt).eps * np.maximum(np.abs(w), 1))
    print(f"normal {tdt}: {np.mean(g == w):.4f} of values bit-equal, "
          f"max {err.max():.2f} eps")
    assert err.max() <= {torch.float32: 2, torch.float16: 0,
                         torch.bfloat16: 0}[tdt]
    lo = float(jnp.nextafter(jnp.array(-1.0, jdt), jnp.array(0.0, jdt)))
    np.testing.assert_array_equal(
        _bits(prng.uniform(prng.PRNGKey(seed), shape, tdt, lo, 1.0)),
        _bits(jax.random.uniform(jax.random.PRNGKey(seed), shape, jdt, lo,
                                 1.0)))


def test_erfinv_is_xlas_polynomial():
    """prng.erfinv and prng.log1p against XLA's float32 erf_inv and log1p
    over (-1, 1), 1 +- its last floats included: log1p within 1 ulp,
    erf_inv within 2, both bit-equal on all but 1e-3 of the inputs, and
    erf_inv(+-1) = +-inf as XLA gives."""
    from jax._src.lax import special
    x = np.concatenate([
        np.random.default_rng(0).uniform(-1, 1, 200_000),
        1 - np.logspace(-7.2, -1, 500), -1 + np.logspace(-7.2, -1, 500),
        [1.0, -1.0, 0.0]]).astype(np.float32)
    for fn, jfn, x_, lim in ((prng.log1p, jnp.log1p, -x * x, 1),
                             (prng.erfinv, special.erf_inv, x, 2)):
        got = fn(torch.from_numpy(x_)).numpy()
        want = np.asarray(jax.jit(jfn)(x_))
        fin = np.isfinite(want)
        np.testing.assert_array_equal(got[~fin], want[~fin])
        ulps = np.abs(got[fin] - want[fin]) / np.spacing(np.abs(want[fin]))
        assert ulps.max() <= lim
        assert np.mean(got == want) > 0.999


@pytest.mark.parametrize("shape", [(77, 91), (3, 1000)])
def test_normal_chunked_draw_is_the_whole_draw(monkeypatch, shape):
    """A draw taken NORMAL_CHUNK elements at a time over the flat counter
    (what keeps full-width inits in memory) has the bits of one draw."""
    whole = prng.normal(prng.PRNGKey(5), shape)
    monkeypatch.setattr(prng, "NORMAL_CHUNK", 1000)
    chunked = prng.normal(prng.PRNGKey(5), shape)
    assert torch.equal(whole, chunked)
    bf = prng.normal(prng.PRNGKey(5), shape, torch.bfloat16)
    monkeypatch.setattr(prng, "NORMAL_CHUNK", 1 << 23)
    assert torch.equal(bf, prng.normal(prng.PRNGKey(5), shape,
                                       torch.bfloat16))


# categorical: tokens equal wherever JAX's draw leads its runner-up by more
# than this (the noise may differ from JAX's in the last ulp)
UNIT_MARGIN = 1e-5


def _top2_gap(x):
    top = np.sort(np.asarray(x, np.float32), axis=-1)
    return top[..., -1] - top[..., -2]


@pytest.mark.parametrize("V", [8, 256, 5000])
def test_categorical_matches_jax_under_the_margin(V):
    """Per-key rows (the engine's draws) and one key over a batch (the
    JAX generate()'s): the argmax of logits + gumbel equal to JAX's
    wherever JAX's top-2 gap of that sum exceeds UNIT_MARGIN."""
    logits = np.random.default_rng(V).standard_normal(
        (len(SEEDS32), V)).astype(np.float32) * 2
    got = prng.categorical(_torch_keys(0), torch.from_numpy(logits))
    want = jax.vmap(jax.random.categorical)(_jax_keys(0), logits)
    noisy = logits + np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (V,)))(_jax_keys(0)))
    clear = _top2_gap(noisy) > UNIT_MARGIN
    print(f"categorical V={V}: {np.mean(~clear):.4f} of draws under the "
          f"margin")
    np.testing.assert_array_equal(got.numpy()[clear], np.asarray(want)[clear])
    key = jax.random.PRNGKey(5)
    got = prng.categorical(prng.PRNGKey(5), torch.from_numpy(logits))
    want = jax.random.categorical(key, logits)
    noisy = logits + np.asarray(jax.random.gumbel(key, logits.shape))
    clear = _top2_gap(noisy) > UNIT_MARGIN
    np.testing.assert_array_equal(got.numpy()[clear], np.asarray(want)[clear])
