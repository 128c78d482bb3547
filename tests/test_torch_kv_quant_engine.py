"""The int8 / fp8 engines and the host spill tier of the port held to the
JAX engine on the CPU (split from tests/test_torch_kv_quant.py): the
pinned workload of tests/test_kv_quant.py through both engines with equal
tokens and stats, the tiered engine (the rotating-tenant stream) equal to
JAX's and to the device-only run, host-tier promotion widths on the
bucket grid, and the refusal of an unknown pool dtype."""
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.engine import \
    shared_prefix_requests as jshared  # noqa: E402
from repro.serving.engine import summarize as jsummarize  # noqa: E402
from repro.serving.engine import synthetic_requests as jsynth  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.bucketing import pick_bucket  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.engine import \
    shared_prefix_requests as tshared  # noqa: E402
from repro_torch.serving.engine import summarize as tsummarize  # noqa: E402
from repro_torch.serving.engine import synthetic_requests as tsynth  # noqa: E402

import _torch_models  # noqa: E402

_models = _torch_models.reduced_models
RG = "recurrentgemma-2b"


def _engine_run(E, params, cfg, reqs, summarize, **kw):
    eng = E(params, cfg, **kw)
    done = eng.run(list(reqs))
    stats = summarize(done, max(eng.wall_time, 1e-9), eng)
    return {c.rid: list(map(int, c.tokens)) for c in done}, eng, stats


@pytest.mark.parametrize("arch,kv,speculate", [
    ("smollm-135m", "int8", 0), ("smollm-135m", "fp8", 2),
    (RG, "int8", 2), (RG, "fp8", 0)])
def test_quantized_engine_matches_jax_engine(arch, kv, speculate):
    """The pinned workload of tests/test_kv_quant.py (8 synthetic
    requests, prompts 16-48, 8-16 new tokens) through both engines with
    the same quantized pools: equal tokens, equal prefill / decode /
    speculation stats, and the pool bytes counting the scale tables."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    kw = dict(num_slots=4, block_size=16, max_seq_len=80, kv_dtype=kv,
              speculate=speculate)
    jreqs = jsynth(8, vocab_size=jcfg.vocab_size, prompt_len=(16, 48),
                   max_new=(8, 16), seed=0)
    treqs = tsynth(8, vocab_size=tcfg.vocab_size, prompt_len=(16, 48),
                   max_new=(8, 16), seed=0)
    jtok, jeng, jst = _engine_run(JEngine, jparams, jcfg, jreqs, jsummarize,
                                  **kw)
    ttok, teng, tst = _engine_run(TEngine, tparams, tcfg, treqs, tsummarize,
                                  device="cpu", **kw)
    assert ttok == jtok
    for key in ("prefill", "prefix_cache", "kv", "speculation"):
        if key in jst:
            assert tst[key] == jst[key], key
    assert teng.cache_bytes == tkv.paged_bytes(
        tcfg, teng.allocator.num_blocks, teng.block_size, kv)
    assert tst["kv"]["dtype"] == kv


def _tiered(shared, vocab):
    # 4 rotating system prompts against a slots-only pool: every admission
    # evicts the other prefix chains, so only revival finds a tenant's
    # prefix cached again (tests/test_kv_quant.py:_tiered_reqs)
    return shared(16, vocab_size=vocab, prefix_len=48, suffix_len=(8, 16),
                  max_new=(4, 8), n_prefixes=4, seed=0)


@pytest.mark.parametrize("kv", ["fp16", "int8"])
def test_tiered_engine_matches_jax_and_device_only(kv):
    """The host spill tier on and off, in the port and in JAX: the four
    runs' tokens equal; revivals >= 1, and the tiered run's demotions,
    revivals, cached tokens and kv block equal to JAX's tiered run's."""
    jcfg, jparams, tcfg, tparams = _models()
    kw = dict(num_slots=2, block_size=16, max_seq_len=96, prefix_cache=True,
              num_blocks=13, kv_dtype=kv)
    runs = {}
    for tier in (0, 32):
        runs["j", tier] = _engine_run(
            JEngine, jparams, jcfg, _tiered(jshared, jcfg.vocab_size),
            jsummarize, host_cache_blocks=tier, **kw)
        runs["t", tier] = _engine_run(
            TEngine, tparams, tcfg, _tiered(tshared, tcfg.vocab_size),
            tsummarize, host_cache_blocks=tier, device="cpu", **kw)
    toks = {k: v[0] for k, v in runs.items()}
    assert toks["t", 32] == toks["t", 0] == toks["j", 32] == toks["j", 0]
    _, teng, tst = runs["t", 32]
    _, jeng, jst = runs["j", 32]
    assert teng.allocator.host_revivals >= 1
    assert tst["kv"] == jst["kv"] and tst["prefill"] == jst["prefill"]
    assert (tst["prefill"]["cached_tokens"]
            > runs["t", 0][2]["prefill"]["cached_tokens"])
    assert tst["kv"]["host_pool_bytes"] == 32 * teng.runner.block_bytes
    assert teng.stats().spilled_blocks == teng.allocator.num_spilled
    assert teng.runner.promote_shapes == jeng.runner.promote_shapes


def test_promotion_stays_on_bucket_grid():
    _, _, tcfg, tparams = _models()
    _, eng, _ = _engine_run(
        TEngine, tparams, tcfg, _tiered(tshared, tcfg.vocab_size),
        tsummarize, num_slots=2, block_size=16, max_seq_len=96,
        prefix_cache=True, num_blocks=13, host_cache_blocks=32,
        device="cpu")
    shapes, buckets = eng.runner.promote_shapes, eng.runner.promote_buckets
    assert shapes, "the tiered run never promoted"
    assert shapes <= set(buckets)
    assert all(w == pick_bucket(w, buckets) for w in shapes)


def test_engine_rejects_unknown_kv_dtype():
    _, _, tcfg, tparams = _models()
    with pytest.raises(ValueError, match="kv_dtype"):
        TEngine(tparams, tcfg, num_slots=2, block_size=16, max_seq_len=64,
                kv_dtype="int4", device="cpu")
