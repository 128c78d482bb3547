"""The port's threefry key stream (repro_torch.prng) held bit for bit to
jax.random on the CPU, as jax is configured here: jax 0.9, the
threefry2x32 PRNG with jax_threefry_partitionable on, 64-bit types off.
The paper core's stochastic solvers draw their example indices with it
(jax.random.randint in the reference), so a port that drew other bits
could not be held to the reference iterate for iterate."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
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
