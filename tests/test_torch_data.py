"""repro_torch.data held to repro.data on the CPU: TokenStream batches and
ShardedBatcher.batch_at bit-equal to JAX's (the port's threefry keys),
and the reference's pipeline tests (tests/test_data_pipeline.py) on the
port: determinism, disjoint shards, restart reproducibility, the
prefetcher's order and close."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

from repro.data.pipeline import ShardedBatcher as JBatcher  # noqa: E402
from repro.data.synthetic import TokenStream as JStream  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, ShardedBatcher  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402


def _sample_fn(key, n):
    return prng.uniform(key, (n, 4))


@pytest.mark.parametrize("vocab", [256, 49152])
@pytest.mark.parametrize("seed,batch,seq", [(0, 8, 32), (7, 3, 17)])
def test_token_stream_bit_equal_to_jax(vocab, seed, batch, seq):
    want = JStream(vocab, seq).batch(jax.random.PRNGKey(seed), batch)
    got = TokenStream(vocab, seq).batch(prng.PRNGKey(seed), batch)
    for a, b in zip(got, want):
        assert a.shape == (batch, seq)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("vocab", [256, 49152])
def test_sharded_batcher_bit_equal_to_jax(vocab):
    """batch_at folds (step, shard_index) into PRNGKey(seed) as JAX does."""
    js, ts = JStream(vocab, 16), TokenStream(vocab, 16)
    for shards, index in ((1, 0), (4, 3)):
        jb = JBatcher(js.batch, 8, n_shards=shards, shard_index=index,
                      seed=11)
        tb = ShardedBatcher(ts.batch, 8, n_shards=shards, shard_index=index,
                            seed=11)
        for step in (0, 5, 1000):
            for a, b in zip(tb.batch_at(step), jb.batch_at(step)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_batcher_deterministic():
    b1 = ShardedBatcher(_sample_fn, 8, seed=3)
    b2 = ShardedBatcher(_sample_fn, 8, seed=3)
    for step in (0, 5, 17):
        assert torch.equal(b1.batch_at(step), b2.batch_at(step))
    assert not torch.equal(b1.batch_at(0), b1.batch_at(1))


def test_batcher_shards_disjoint():
    shards = [ShardedBatcher(_sample_fn, 8, n_shards=4, shard_index=i,
                             seed=0) for i in range(4)]
    batches = [s.batch_at(2) for s in shards]
    assert all(b.shape == (2, 4) for b in batches)
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(batches[i], batches[j])


def test_restart_reproducibility():
    b = ShardedBatcher(_sample_fn, 4, seed=9)
    full = list(itertools.islice(iter(b), 6))
    resumed = [b.batch_at(s) for s in range(3, 6)]
    for a, c in zip(full[3:], resumed):
        assert torch.equal(a, c)


def test_prefetcher_order_and_close():
    b = ShardedBatcher(_sample_fn, 4, seed=1)
    direct = list(itertools.islice(iter(b), 5))
    pf = Prefetcher(itertools.islice(iter(b), 5), depth=2)
    fetched = list(pf)
    assert len(fetched) == 5
    for a, c in zip(direct, fetched):
        assert torch.equal(a, c)
    pf.close()


def test_token_stream_is_reproducible_and_learnable():
    t = TokenStream(vocab_size=64, seq_len=8, seed=0)
    a1, a2 = t.batch(prng.PRNGKey(7), 4), t.batch(prng.PRNGKey(7), 4)
    assert torch.equal(a1[0], a2[0]) and torch.equal(a1[1], a2[1])
    toks, targets = t.batch(prng.PRNGKey(8), 64)
    det = (toks * 31 + 7) % 64
    share = float((targets == det).float().mean())
    assert 0.4 < share < 0.65        # the mix is a fair coin (+ 1/64 chance)
