"""repro_torch.serving.sampling held to repro.serving.sampling: the
request-side config (SamplingParams, resolve, seed32) and the greedy
helpers the port's runner uses, on the same numpy logits."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.serving import sampling as js  # noqa: E402
from repro_torch.serving import sampling as ts  # noqa: E402


def _logits(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32) * 3


def test_sampling_params_and_resolve_match():
    for kw in (dict(), dict(temperature=0.7, top_k=5, seed=3, stop=[7]),
               dict(logprobs=True, max_new_tokens=4, stop=[[1, 2], 9])):
        t, j = ts.SamplingParams(**kw), js.SamplingParams(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for args in ((None, 12, 5, 3), (ts.GREEDY, None, None, 0)):
            got = ts.resolve(t, *args)
            want = js.resolve(j, *args)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(ts.resolve(None, ts.SamplingParams(
        temperature=1.0, seed=4), rid=6)) == dataclasses.asdict(js.resolve(
            None, js.SamplingParams(temperature=1.0, seed=4), rid=6))
    for seed in (0, 1, 2 ** 31, 2 ** 32 + 5, -3):
        assert ts.seed32(seed) == js.seed32(seed)
    with pytest.raises(ValueError):
        ts.SamplingParams(top_p=0.0)


def test_greedy_tokens_and_alternatives_match():
    x = _logits(0, 4, 3, 50)
    tok, lp = ts.greedy_tokens(torch.from_numpy(x))
    jtok, jlp = js.greedy_tokens(jnp.asarray(x))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5,
                               rtol=1e-5)
    ids, lps = ts.top_alternatives(torch.from_numpy(x), 4)
    jids, jlps = js.top_alternatives(jnp.asarray(x), 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(lps.numpy(), np.asarray(jlps), atol=1e-5,
                               rtol=1e-5)


def test_greedy_verify_accept_rule_matches():
    x = _logits(1, 3, 5, 20)
    model = x.argmax(-1).astype(np.int32)
    chain = np.zeros((3, 5), np.int32)
    chain[0, 1:] = model[0, :4]            # all drafts agree
    chain[1, 1:3] = model[1, :2]           # two agree, then a miss
    chain[1, 3] = (model[1, 2] + 1) % 20
    chain[2, 1] = (model[2, 0] + 1) % 20   # first draft rejected
    counts = np.asarray([5, 4, 2], np.int32)
    got = ts.greedy_verify_tokens(torch.from_numpy(x),
                                  torch.from_numpy(chain),
                                  torch.from_numpy(counts))
    want = js.greedy_verify_tokens(jnp.asarray(x), jnp.asarray(chain),
                                   jnp.asarray(counts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    assert got[1].tolist() == [4, 2, 0]


def test_sampled_draws_raise_not_fall_back():
    x = torch.from_numpy(_logits(2, 2, 10))
    z = torch.zeros(2)
    with pytest.raises(NotImplementedError):
        ts.sample_tokens(x, z, z + 1, z, z + 1, z)
    with pytest.raises(NotImplementedError):
        ts.verify_tokens(x[:, None], z[:, None], z, z, z + 1, z, z + 1, z)
