"""repro_torch.serving.sampling held to repro.serving.sampling: the
request-side config (SamplingParams, resolve, seed32), the greedy helpers,
and the sampled draws (warp_logits, sample_tokens, verify_tokens) on the
same numpy logits. Keys and uniforms are JAX's bit for bit; the Gumbel
noise may differ from XLA's in the last ulp, so sampled tokens are held
to JAX's wherever JAX's draw leads its runner-up by more than 1e-5 (the
share under that margin is printed). Then the reference's tiny-vocab
marginal test, and port copies of two reference tests whose faults are
repaired in the copy (ROADMAP, "The reference's four failures")."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.serving import sampling as js  # noqa: E402
from repro_torch.serving import sampling as ts  # noqa: E402
from repro_torch.serving.block_manager import BlockAllocator  # noqa: E402
from repro_torch.serving.bucketing import (chain_buckets,  # noqa: E402
                                           pick_bucket, pow2_buckets)
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

# sampled tokens equal JAX's wherever JAX's warped-plus-noise draw leads
# its runner-up by more than this
UNIT_MARGIN = 1e-5


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


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# per-lane configs of a batch: greedy, top-k, nucleus, both, temperature
# alone, a tight nucleus; seeds include negative int32s (seed32 of seeds
# >= 2^31)
TEMPS = np.asarray([0.0, 0.7, 1.2, 0.9, 1.0, 0.5, 1.5, 0.8], np.float32)
TOPKS = np.asarray([0, 5, 0, 10, 0, 0, 1, 40], np.int32)
TOPPS = np.asarray([1.0, 1.0, 0.9, 0.8, 1.0, 0.3, 1.0, 0.95], np.float32)
SEEDS = np.asarray([0, 11, -5, 7, 2**31 - 1, 3, -2**31, 99], np.int32)


def _jax_noisy(logits, seeds, positions, temps, topks, topps, tag):
    """JAX's warped logits plus the Gumbel noise of its draw, per row."""
    warped = js.warp_logits(jnp.asarray(logits), temps, topks, topps)
    keys = js._keys(jnp.asarray(seeds), jnp.asarray(positions), tag)
    flat = keys.reshape((-1, 2))
    g = jax.vmap(lambda k: jax.random.gumbel(k, (logits.shape[-1],)))(flat)
    return np.asarray(warped) + np.asarray(g).reshape(logits.shape)


def _clear(noisy):
    top = np.sort(noisy, axis=-1)
    return (top[..., -1] - top[..., -2]) > UNIT_MARGIN


@pytest.mark.parametrize("temp", [0.0, 0.6, 1.0, 1.7])
@pytest.mark.parametrize("top_k", [0, 1, 3, 50])
@pytest.mark.parametrize("top_p", [1.0, 0.95, 0.6, 0.1])
def test_warp_logits_grid_matches_jax(temp, top_k, top_p):
    """Masks equal to JAX's except where a token's cumulative mass before
    it lies within 1e-6 of top_p (the cumsum's order may differ from
    XLA's); kept values equal. Rows hold ties at the k-th value, which
    the threshold keeps."""
    x = np.round(np.random.default_rng(3).standard_normal((6, 64)) * 2,
                 1).astype(np.float32)
    B = x.shape[0]
    args = (np.full(B, temp, np.float32), np.full(B, top_k, np.int32),
            np.full(B, top_p, np.float32))
    got = ts.warp_logits(*_t(x, *args)).numpy()
    want = np.asarray(js.warp_logits(jnp.asarray(x), *args))
    xs = -np.sort(-x / (temp if temp > 0 else 1.0), axis=-1)
    ps = np.exp(xs - xs.max(-1, keepdims=True))
    ps /= ps.sum(-1, keepdims=True)
    edge = np.abs(np.cumsum(ps, -1) - ps - top_p) <= 1e-6
    # a token's sorted rank is ambiguous only at the edge: rows with one
    mask_ok = np.isfinite(got) == np.isfinite(want)
    bad_rows = ~mask_ok.all(-1)
    print(f"warp t={temp} k={top_k} p={top_p}: {int(edge.sum())} "
          f"positions at the top-p edge, {int(bad_rows.sum())} rows differ")
    assert not (bad_rows & ~edge.any(-1)).any()
    both = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_array_equal(got[both], want[both])
    if top_k and top_p >= 1.0:
        kth = xs[:, top_k - 1:top_k]
        assert (np.isfinite(got).sum(-1) == (x / (temp or 1.0)
                                             >= kth).sum(-1)).all()


@pytest.mark.parametrize("V", [16, 256])
def test_sample_tokens_match_jax(V):
    x = np.random.default_rng(V).standard_normal(
        (len(TEMPS), V)).astype(np.float32) * 3
    pos = np.asarray([3, 5, 9, 100, 2, 7, 0, 4000], np.int32)
    args = (TEMPS, TOPKS, TOPPS, SEEDS)
    tok, lp = ts.sample_tokens(*_t(x, pos, *args))
    jtok, jlp = js.sample_tokens(jnp.asarray(x), pos, *args)
    clear = _clear(_jax_noisy(x, SEEDS, pos, TEMPS, TOPKS, TOPPS,
                              ts.TAG_SAMPLE)) | (TEMPS == 0)
    print(f"sample_tokens V={V}: {np.mean(~clear):.4f} of draws under the "
          f"margin")
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy()[clear], np.asarray(jtok)[clear])
    np.testing.assert_allclose(lp.numpy()[clear], np.asarray(jlp)[clear],
                               atol=1e-5, rtol=1e-5)
    assert tok[0] == int(x[0].argmax())          # the greedy lane
    # each lane alone draws what it drew in the batch
    for b in range(len(TEMPS)):
        solo, _ = ts.sample_tokens(*_t(x[b:b + 1], pos[b:b + 1],
                                       *(a[b:b + 1] for a in args)))
        assert int(solo[0]) == int(tok[b])


def _verify_inputs(V, T=5):
    rng = np.random.default_rng(V + 1)
    x = (rng.standard_normal((len(TEMPS), T, V)) * 2).astype(np.float32)
    chain = rng.integers(0, V, (len(TEMPS), T)).astype(np.int32)
    chain[:, 1:] = x[:, :-1].argmax(-1)          # drafts the model favours
    chain[1, 2] = (chain[1, 2] + 1) % V          # a miss mid-chain
    chain[3, 1] = (chain[3, 1] + 1) % V          # a first-token miss
    counts = np.asarray([5, 4, 3, 5, 0, 2, 5, 1], np.int32)
    pos = np.asarray([7, 9, 0, 30, 2, 11, 5, 64], np.int32)
    return x, chain, counts, pos


@pytest.mark.parametrize("V", [8, 256])
def test_verify_tokens_match_jax(V):
    """emit, accept and chosen logprobs: accepts equal wherever the accept
    uniform (bit-equal to JAX's) is more than 1e-6 from q(draft); emitted
    tokens equal up to each lane's accepted run wherever JAX's (re)sample
    clears the margin."""
    x, chain, counts, pos = _verify_inputs(V)
    args = (TEMPS, TOPKS, TOPPS, SEEDS)
    emit, acc, lp = ts.verify_tokens(*_t(x, chain, counts, pos, *args))
    jemit, jacc, jlp = (np.asarray(a) for a in js.verify_tokens(
        jnp.asarray(x), jnp.asarray(chain), jnp.asarray(counts),
        jnp.asarray(pos), *args))
    B, T = chain.shape
    seeds_bt = np.broadcast_to(SEEDS[:, None], (B, T))
    pos_bt = pos[:, None] + np.arange(T)[None]
    u = np.asarray(jax.vmap(jax.vmap(jax.random.uniform))(
        js._keys(jnp.asarray(seeds_bt), jnp.asarray(pos_bt), js.TAG_ACCEPT)))
    warped = np.asarray(js.warp_logits(jnp.asarray(x), TEMPS[:, None],
                                       TOPKS[:, None], TOPPS[:, None]))
    draft = np.concatenate([chain[:, 1:], np.zeros((B, 1), np.int32)], 1)
    q = np.exp(np.take_along_axis(np.asarray(jax.nn.log_softmax(
        jnp.asarray(warped), -1)), draft[..., None], -1)[..., 0])
    near = (np.abs(u - q) <= 1e-6) & (TEMPS[:, None] > 0)
    lanes = ~near.any(-1)
    np.testing.assert_array_equal(acc.numpy()[lanes], jacc[lanes])
    noisy = _jax_noisy(x, seeds_bt, pos_bt, TEMPS[:, None], TOPKS[:, None],
                       TOPPS[:, None], js.TAG_SAMPLE)
    for b in np.nonzero(lanes)[0]:
        a = int(jacc[b])
        np.testing.assert_array_equal(emit.numpy()[b, :a], jemit[b, :a])
        if TEMPS[b] == 0 or _clear(noisy[b, a]):
            assert int(emit[b, a]) == int(jemit[b, a])
            np.testing.assert_allclose(lp.numpy()[b, :a + 1],
                                       jlp[b, :a + 1], atol=1e-5, rtol=1e-5)
    # greedy lanes: the argmax compare
    np.testing.assert_array_equal(emit.numpy()[0], x[0].argmax(-1))
    assert acc.dtype == torch.int32 and emit.dtype == torch.int32


def test_verify_residual_all_masked_takes_index_zero():
    """A draft holding all of q's mass (top_k 1 keeps the draft alone):
    the residual is all -inf, whose argmax is index 0 as in JAX; u < 1 =
    q(draft) accepts the draft, so the 0 is never emitted."""
    V = 12
    x = np.zeros((1, 2, V), np.float32)
    x[0, :, 5] = 4.0
    chain = np.asarray([[1, 5]], np.int32)
    args = (np.asarray([0.9], np.float32), np.asarray([1], np.int32),
            np.ones(1, np.float32), np.asarray([4], np.int32))
    warped = ts.warp_logits(torch.from_numpy(x),
                            *(a[:, None] for a in _t(*args[:3])))
    residual = warped.scatter(-1, torch.full((1, 2, 1), 5), float("-inf"))
    assert torch.isinf(residual).all()
    assert int(torch.argmax(residual[0, 0])) == 0 == int(
        jnp.argmax(jnp.full(V, -jnp.inf)))
    emit, acc, _ = ts.verify_tokens(*_t(x, chain, np.asarray([2], np.int32),
                                        np.asarray([3], np.int32), *args))
    jemit, jacc, _ = js.verify_tokens(jnp.asarray(x), jnp.asarray(chain),
                                      jnp.asarray([2]), jnp.asarray([3]),
                                      *args)
    assert int(acc[0]) == int(jacc[0]) == 1
    assert emit[0].tolist() == np.asarray(jemit)[0].tolist()
    assert int(emit[0, 0]) == 5


def test_sampled_draws_raise_not_fall_back():
    """Sampled lanes draw (no raise, no greedy fallback): a hot
    temperature over flat logits gives tokens other than the argmax, and
    the same seeds and positions draw JAX's tokens."""
    x = _logits(2, 2, 10) * 0.01
    z = np.zeros(2, np.int32)
    args = (np.full(2, 5.0, np.float32), z, np.ones(2, np.float32),
            np.asarray([1, 2], np.int32))
    draws = np.stack([ts.sample_tokens(*_t(x, z + p, *args))[0].numpy()
                      for p in range(32)])
    assert (draws != x.argmax(-1)).any()
    want = np.stack([np.asarray(js.sample_tokens(jnp.asarray(x), z + p,
                                                 *args)[0])
                     for p in range(32)])
    np.testing.assert_array_equal(draws, want)
    emit, acc, _ = ts.verify_tokens(*_t(x[:, None], z[:, None], z + 1, z,
                                        *args))
    jemit, jacc, _ = js.verify_tokens(jnp.asarray(x[:, None]),
                                      jnp.asarray(z[:, None]),
                                      jnp.asarray(z + 1), jnp.asarray(z),
                                      *args)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(jemit))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


def _spec_marginal(row_logits, draft_tok, temp, topk, topp, n=16384):
    """Empirical marginal of the token verify_tokens emits at chain index
    0 over n per-request seeds, and the accept flags (the reference's
    tiny-vocab frequency test)."""
    V = row_logits.shape[-1]
    logits = row_logits[None, None].expand(n, 2, V)
    chain = torch.tensor([[1, draft_tok]], dtype=torch.int32).expand(n, 2)
    emit, acc, _ = ts.verify_tokens(
        logits, chain, torch.full((n,), 2, dtype=torch.int32),
        torch.full((n,), 13, dtype=torch.int32), torch.full((n,), temp),
        torch.full((n,), topk, dtype=torch.int32), torch.full((n,), topp),
        torch.arange(n, dtype=torch.int32))
    freq = np.bincount(emit[:, 0].numpy(), minlength=V) / n
    return freq, acc.numpy()


def test_speculative_sampling_preserves_marginal_tiny_vocab():
    """Leviathan accept/reject with a deterministic draft leaves the
    marginal of the emitted token the target distribution: total
    variation < 0.03 over 16k seeds, the draft accepted w.p. q(d) within
    0.02; a draft outside the top-k is always rejected and the marginal
    is the warped target (the limits of tests/test_sampling.py)."""
    V, temp = 8, 0.9
    row = torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(0), 3), (V,))))
    q = torch.softmax(row / temp, -1).numpy()
    d = int(np.argsort(q)[V // 2])
    freq, acc = _spec_marginal(row, d, temp, 0, 1.0)
    assert 0.5 * np.abs(freq - q).sum() < 0.03
    assert abs(acc.astype(bool).mean() - q[d]) < 0.02
    wq = torch.softmax(ts.warp_logits(row[None], torch.tensor([temp]),
                                      torch.tensor([3]),
                                      torch.tensor([1.0]))[0], -1).numpy()
    d_out = int(np.argsort(q)[0])
    assert wq[d_out] == 0.0
    freq, acc = _spec_marginal(row, d_out, temp, 3, 1.0)
    assert acc.sum() == 0
    assert 0.5 * np.abs(freq - wq).sum() < 0.03


# ----------------------------------------------------------------------------
# port copies of the reference's two failing sampling tests, repaired
# ----------------------------------------------------------------------------

class _FakeRunner:
    """Host-only runner stand-in (block accounting needs no device). The
    reference's stand-in lacks `prefill_chunk`, which Scheduler.submit
    reads; this copy has it (0: chunked admission off)."""

    prefill_max_batch = 4
    max_logprobs = 8
    prefill_chunk = 0

    def __init__(self, speculate=8):
        self.prefill_buckets = pow2_buckets(64, start=8)
        self.verify_buckets = chain_buckets(speculate)

    def suffix_bucket(self, n):
        return pick_bucket(n, self.prefill_buckets)

    def chain_bucket(self, n):
        return pick_bucket(n, self.verify_buckets)

    def prefill(self, rows, **kw):
        return (np.full(len(rows), 1, np.int32),
                np.zeros(len(rows), np.float32), None)

    def verify(self, tokens, positions, counts):
        return (np.full(tokens.shape, -1, np.int32),
                np.zeros(tokens.shape[0], np.int32),
                np.zeros(tokens.shape, np.float32), None)

    def commit(self, idx):
        pass

    def copy_block(self, src, dst):
        pass

    def write_table(self, slot, row):
        pass

    def clear_table(self, slot):
        pass

    def set_sampling(self, slot, sp):
        pass

    def clear_sampling(self, slot):
        pass


def _alloc_snapshot(alloc):
    return (alloc.num_free, alloc.num_cached, dict(alloc._ref))


@settings(max_examples=60, deadline=None)
@given(plen=st.integers(1, 18), max_new=st.integers(4, 40),
       consumed=st.integers(0, 8), k=st.integers(1, 8),
       bs=st.integers(2, 5), seed=st.integers(0, 2**34))
def test_rejected_sampled_draft_restores_pools(plen, max_new, consumed,
                                               k, bs, seed):
    """A SAMPLED lane whose whole draft chain is rejected through the
    port scheduler's prepare_verify / consume_verify leaves the allocator
    (refcounts, free list) and the reserved budget as a single-token
    advance would: every block the chain claimed past it comes back."""
    if plen + max_new > 64:
        max_new = 64 - plen
        if max_new < 4:
            return
    consumed = min(consumed, max_new - 3)
    alloc = BlockAllocator(72, block_size=bs)
    sched = Scheduler(alloc, _FakeRunner(), num_slots=2, block_size=bs,
                      max_blocks_per_seq=-(-64 // bs), max_seq_len=64,
                      prefix_cache=False, now_fn=lambda: 0.0, speculate=8)
    sched.submit(Request(rid=0, prompt=np.arange(plen, dtype=np.int32),
                         sampling=ts.SamplingParams(temperature=0.9,
                                                    seed=seed,
                                                    max_new_tokens=max_new)))
    sched.admit()
    s = sched._slots[0]
    assert s is not None and not s.sp.greedy
    for _ in range(consumed):             # walk to a reachable position
        sched._claim_blocks(0, s.pos)
        s.pos += 1
    sched._claim_blocks(0, s.pos)
    k_eff = min(k, max_new - len(s.out) - consumed - 1)
    if k_eff <= 0:
        return
    sched._proposers = [type("P", (), {
        "propose": staticmethod(lambda h, kk: [3] * min(kk, k_eff))})()] * 2
    pre = (_alloc_snapshot(alloc), s.budget + 0, s.n_blocks,
           sched._reserved_budget)
    batch = sched.prepare_verify()
    assert batch is not None
    tokens, positions, counts, active = batch
    out = np.full(tokens.shape, -1, np.int32)        # full rejection
    sched.consume_verify(active, out, np.zeros(tokens.shape[0], np.int32))
    assert sched._slots[0] is s                      # still live
    keep = max((s.pos - 1) // bs + 1, s.prompt_blocks)
    assert s.n_blocks == keep
    grew = s.n_blocks - pre[2]
    assert _alloc_snapshot(alloc)[0] == pre[0][0] - grew
    assert s.budget == pre[1] - grew
    assert sched._reserved_budget == pre[3] - grew
