"""The port's serving engine held to the JAX engine on the CPU: fixed
request streams (mixed lengths, a shared prefix, a stop token, a
speculate=2 run) through both, step by step, for smollm-135m and the two
recurrent archs (recurrentgemma-2b, rwkv6-3b). Greedy tokens, finish
reasons and the SchedulerStats after every step must be equal, and the
port engine must equal the port's generate() exactly. Sampled requests
(the reference's mixed greedy / top-k / top-p batch, with and without
speculation) run through both engines with equal tokens and stats;
sampled generate() equals JAX's; the serve CLI takes the JAX CLI's
sampling and KV flags. Scripted drafts, the chunked prefill beside a
decoding lane and load_prefill are in tests/test_torch_engine_recurrent.py
(split from this file so that the workers of a parallel run share its
time)."""
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.sampling import \
    SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

import _torch_models  # noqa: E402


_models = _torch_models.reduced_models


@pytest.fixture(scope="module")
def models():
    return _models("smollm-135m")


def _stream(kind, vocab):
    """(prompt, max_new, eos) triples of a fixed request stream."""
    rng = np.random.default_rng(7)
    if kind == "mixed":
        lens = [5, 12, 9, 15, 3, 11]
        return [(rng.integers(0, vocab, n).astype(np.int32), 6 + n % 5, None)
                for n in lens]
    if kind == "shared_prefix":
        prefix = rng.integers(0, vocab, 10).astype(np.int32)
        return [(np.concatenate([prefix, rng.integers(0, vocab, n)
                                 .astype(np.int32)]), 7, None)
                for n in (3, 6, 2, 5, 4)]
    pattern = rng.integers(0, vocab, 4).astype(np.int32)    # repetitive
    return [(np.tile(pattern, 5)[:n], 10, None) for n in (14, 18, 11)]


def _drive(engine, reqs):
    for r in reqs:
        engine.submit(r)
    stats = []
    engine.begin_run()
    while engine.has_work:
        engine.step()
        stats.append(dataclasses.asdict(engine.stats()))
    done = sorted(engine.scheduler.completions, key=lambda c: c.rid)
    engine.scheduler.completions = []
    return done, stats


KW = dict(num_slots=3, block_size=4, max_seq_len=32, prefill_max_batch=2)


RG, RW = "recurrentgemma-2b", "rwkv6-3b"


@pytest.mark.parametrize("arch,kind,speculate", [
    ("smollm-135m", "mixed", 0), ("smollm-135m", "shared_prefix", 0),
    ("smollm-135m", "repetitive", 2), (RG, "mixed", 0), (RG, "repetitive", 2),
    (RW, "mixed", 0), (RW, "repetitive", 2)],
    ids=["mixed-0", "shared_prefix-0", "repetitive-2", f"{RG}-mixed-0",
         f"{RG}-repetitive-2", f"{RW}-mixed-0", f"{RW}-repetitive-2"])
def test_engine_matches_jax_engine_and_generate(arch, kind, speculate):
    """smollm-135m with the prefix cache on; the recurrent archs with it
    off (their state is per slot), as both engines default. The stream
    with speculate=2 verifies n-gram drafts where the model repeats
    itself."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    stream = _stream(kind, jcfg.vocab_size)
    cache = True if arch == "smollm-135m" else None
    if kind == "mixed":     # request 1 stops at its own third token
        p, m, _ = stream[1]
        eos = int(tserve.generate(tparams, tcfg, p[None], m, device="cpu")
                  [0, 2])
        stream[1] = (p, m, eos)
    jeng = JEngine(jparams, jcfg, speculate=speculate, prefix_cache=cache,
                   **KW)
    teng = TEngine(tparams, tcfg, speculate=speculate, prefix_cache=cache,
                   device="cpu", **KW)
    jdone, jstats = _drive(jeng, [JRequest(rid=i, prompt=p, max_new_tokens=m,
                                           eos_id=e)
                                  for i, (p, m, e) in enumerate(stream)])
    tdone, tstats = _drive(teng, [TRequest(rid=i, prompt=p, max_new_tokens=m,
                                           eos_id=e)
                                  for i, (p, m, e) in enumerate(stream)])
    assert tstats == jstats
    assert len(tdone) == len(jdone) == len(stream)
    for tc, jc in zip(tdone, jdone):
        np.testing.assert_array_equal(tc.tokens, jc.tokens)
        assert (tc.finish_reason, tc.cached_tokens, tc.prompt_len) == \
            (jc.finish_reason, jc.cached_tokens, jc.prompt_len)
    assert teng.runner.prefill_shapes == jeng.runner.prefill_shapes
    assert teng.runner.verify_shapes == jeng.runner.verify_shapes
    for tc in tdone:
        p, m, _ = stream[tc.rid]
        want = tserve.generate(tparams, tcfg, p[None], m,
                               device="cpu").numpy()[0]
        np.testing.assert_array_equal(tc.tokens, want[:len(tc.tokens)])
    if kind == "mixed":
        assert tdone[1].finish_reason == "stop"
    if kind == "shared_prefix":
        assert sum(c.cached_tokens for c in tdone) > 0
    if speculate:
        assert teng.runner.verify_dispatches == \
            jeng.runner.verify_dispatches
        # the reduced rwkv6-3b's random weights never repeat a token on
        # this stream, so the n-gram proposer drafts nothing there (the
        # JAX engine neither); its verify path is held to the JAX engine
        # by test_scripted_drafts_match_jax_engine_and_generate
        assert teng.runner.verify_dispatches > 0 or arch == RW


def test_pool_accounting_matches_jax(models):
    jcfg, _, tcfg, _ = models
    assert tkv.paged_bytes(tcfg, 33, 4) == jkv.paged_bytes(jcfg, 33, 4)
    assert tkv.block_bytes(tcfg, 16) == jkv.block_bytes(jcfg, 16)


def test_copy_block_copies_every_pool(models):
    _, _, tcfg, _ = models
    state = tkv.init_paged_state(tcfg, 2, 6, 4, device="cpu")
    for _, st in tkv.lm._layers(state, tcfg):
        st["k"][2].normal_()
        st["v"][2].normal_()
    tkv.copy_block(tcfg, state, 2, 5)
    for _, st in tkv.lm._layers(state, tcfg):
        assert torch.equal(st["k"][5], st["k"][2])
        assert torch.equal(st["v"][5], st["v"][2])


def test_engine_without_device_raises_without_gpu(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, _, tcfg, tparams = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(tparams, tcfg, **KW)


@pytest.mark.parametrize("kwargs", [dict(kv_dtype="int8"),
                                    dict(kv_dtype="fp8"),
                                    dict(host_cache_blocks=4)])
def test_unported_engine_options_raise(models, kwargs):
    """The options that raised before their slice (int8 / fp8 pools, the
    host spill tier) now serve: the shared-prefix stream through both
    engines with the option on, tokens and per-step stats equal."""
    jcfg, jparams, tcfg, tparams = models
    stream = _stream("shared_prefix", jcfg.vocab_size)
    jeng = JEngine(jparams, jcfg, **KW, **kwargs)
    teng = TEngine(tparams, tcfg, device="cpu", **KW, **kwargs)
    jdone, jstats = _drive(jeng, [JRequest(rid=i, prompt=p, max_new_tokens=m)
                                  for i, (p, m, _) in enumerate(stream)])
    tdone, tstats = _drive(teng, [TRequest(rid=i, prompt=p, max_new_tokens=m)
                                  for i, (p, m, _) in enumerate(stream)])
    assert tstats == jstats
    for tc, jc in zip(tdone, jdone):
        np.testing.assert_array_equal(tc.tokens, jc.tokens)
    assert teng.cache_bytes == jeng.cache_bytes


def _sampled_mix(R, SP, vocab, repetitive=False):
    """tests/test_sampling.py:_mixed_requests for either package: greedy,
    top-k, nucleus and explicit temperature-0 lanes in one batch."""
    rng = np.random.default_rng(5)
    if repetitive:
        pat = rng.integers(0, vocab, 5).astype(np.int32)
        prompts = [np.tile(pat, 4)[:16] for _ in range(4)]
    else:
        prompts = [rng.integers(0, vocab, 9).astype(np.int32)
                   for _ in range(4)]
    return [R(rid=0, prompt=prompts[0], max_new_tokens=8),
            R(rid=1, prompt=prompts[1], sampling=SP(
                temperature=0.8, top_k=32, seed=11, max_new_tokens=9)),
            R(rid=2, prompt=prompts[2], sampling=SP(
                temperature=1.2, top_p=0.9, seed=7, max_new_tokens=6)),
            R(rid=3, prompt=prompts[3], sampling=SP(
                temperature=0.0, max_new_tokens=7))]


def test_sampled_requests_raise_not_fall_back(models):
    """A sampled request draws (no raise, no greedy fallback): the JAX
    engine's tokens, which leave the greedy continuation."""
    jcfg, jparams, tcfg, tparams = models
    prompt = np.arange(6, dtype=np.int32)
    sp = dict(temperature=0.8, seed=1, max_new_tokens=8)
    teng = TEngine(tparams, tcfg, device="cpu", **KW)
    got = teng.run([TRequest(rid=0, prompt=prompt,
                             sampling=SamplingParams(**sp))])[0].tokens
    jeng = JEngine(jparams, jcfg, **KW)
    want = jeng.run([JRequest(rid=0, prompt=prompt,
                              sampling=JSamplingParams(**sp))])[0].tokens
    np.testing.assert_array_equal(got, want)
    greedy = tserve.generate(tparams, tcfg, prompt[None], 8,
                             device="cpu").numpy()[0]
    assert not np.array_equal(got, greedy)
    assert teng.runner.sampled_dispatches > 0


@pytest.mark.parametrize("arch,speculate", [
    ("smollm-135m", 0), ("smollm-135m", 4), (RG, 0), (RG, 4), (RW, 0)])
def test_sampled_mixed_batch_matches_jax_engine(arch, speculate):
    """The reference's mixed greedy / top-k / nucleus / temperature-0
    batch (repetitive prompts under speculation, so sampled chains
    verify): tokens and per-step stats equal to the JAX engine's, greedy
    lanes equal to generate(), and each sampled request run alone (and
    beside another request) gives its batched tokens."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    kw = dict(KW, num_slots=4, speculate=speculate)
    rep = bool(speculate)
    jeng = JEngine(jparams, jcfg, **kw)
    teng = TEngine(tparams, tcfg, device="cpu", **kw)
    jdone, jstats = _drive(jeng, _sampled_mix(JRequest, JSamplingParams,
                                              jcfg.vocab_size, rep))
    reqs = _sampled_mix(TRequest, SamplingParams, tcfg.vocab_size, rep)
    tdone, tstats = _drive(teng, reqs)
    assert tstats == jstats
    for tc, jc in zip(tdone, jdone):
        np.testing.assert_array_equal(tc.tokens, jc.tokens)
        np.testing.assert_allclose(tc.logprobs if tc.logprobs is not None
                                   else 0, jc.logprobs if jc.logprobs
                                   is not None else 0, atol=1e-4)
    assert teng.runner.sampled_dispatches == jeng.runner.sampled_dispatches
    assert teng.runner.sampled_dispatches > 0
    out = {c.rid: c.tokens for c in tdone}
    for rid in (0, 3):
        r = reqs[rid]
        want = tserve.generate(tparams, tcfg, r.prompt[None],
                               len(out[rid]), device="cpu").numpy()[0]
        np.testing.assert_array_equal(out[rid], want)
    if speculate and arch == "smollm-135m":
        assert teng.scheduler.proposed_tokens > 0
    for rid in (1, 2):
        solo, _ = _drive(teng, [dataclasses.replace(reqs[rid])])
        np.testing.assert_array_equal(solo[0].tokens, out[rid])
    pair, _ = _drive(teng, [dataclasses.replace(reqs[2]),
                            dataclasses.replace(reqs[0])])
    np.testing.assert_array_equal({c.rid: c.tokens for c in pair}[2], out[2])


@pytest.mark.parametrize("seed", [0, 3])
def test_sampled_generate_matches_jax(seed):
    """generate(temperature > 0) draws JAX generate()'s tokens: the first
    token the argmax, each later one categorical(split key, logits / t)."""
    jcfg, jparams, tcfg, tparams = _models("smollm-135m")
    prompts = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (3, 7)).astype(np.int32)
    want = np.asarray(jgenerate(jparams, jcfg, jax.numpy.asarray(prompts),
                                12, temperature=0.9, seed=seed))
    got = tserve.generate(tparams, tcfg, prompts, 12, temperature=0.9,
                          seed=seed, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    greedy = tserve.generate(tparams, tcfg, prompts, 12, device="cpu")
    assert not np.array_equal(got, greedy.numpy())


class _NextTokens:
    """Proposes generate()'s own next tokens, so every draft of a greedy
    lane is accepted by construction."""

    def __init__(self, prompt, out):
        self.full = list(prompt) + list(out)
        self.n = len(prompt)

    def propose(self, history, k):
        h = list(history)
        if self.n <= len(h) <= len(self.full) and h == self.full[:len(h)]:
            return self.full[len(h):len(h) + k]
        return []


def test_topk_alternative_logprobs_decode_and_verify_paths(models):
    """Port copy of the reference test of the same name: logprobs=k
    carries k alternatives per emitted position through plain decode and
    the verify path, for greedy and sampled lanes, without changing the
    greedy tokens. The reference's n-gram drafts are never accepted on
    its random weights, so its `accepted_tokens > 0` fails; here the
    drafts are generate()'s own next tokens, so acceptance is certain."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(5)
    pat = rng.integers(0, tcfg.vocab_size, 5).astype(np.int32)
    prompt = np.tile(pat, 4)[:16]
    greedy = tserve.generate(tparams, tcfg, prompt[None], 8,
                             device="cpu").numpy()[0]
    kw = dict(num_slots=2, block_size=4, max_seq_len=32, device="cpu")
    for speculate in (0, 3):
        eng = TEngine(tparams, tcfg, speculate=speculate, **kw)
        if speculate:
            eng.scheduler._proposers = [_NextTokens(prompt, greedy)] * 2
        reqs = [TRequest(rid=0, prompt=prompt.copy(),
                         sampling=SamplingParams(max_new_tokens=8,
                                                 logprobs=3)),
                TRequest(rid=1, prompt=prompt.copy(),
                         sampling=SamplingParams(max_new_tokens=8,
                                                 temperature=0.9, seed=11,
                                                 top_k=4, logprobs=2))]
        done = {c.rid: c for c in eng.run(reqs)}
        if speculate:
            assert eng.scheduler.accepted_tokens > 0   # verify path ran
        g = done[0]
        assert g.top_ids.shape == (8, 3) and g.top_logprobs.shape == (8, 3)
        np.testing.assert_array_equal(g.tokens, g.top_ids[:, 0])
        np.testing.assert_allclose(g.logprobs, g.top_logprobs[:, 0],
                                   rtol=1e-5)
        assert (np.diff(g.top_logprobs, axis=1) <= 1e-6).all()
        np.testing.assert_array_equal(g.tokens, greedy)
        s = done[1]
        assert s.top_ids.shape == (8, 2)
        assert (s.logprobs <= s.top_logprobs[:, 0] + 1e-6).all()
    eng = TEngine(tparams, tcfg, speculate=3, **kw)
    eng.scheduler._proposers = [_NextTokens(prompt, greedy)] * 2
    got_ids, final = [], None
    for ev in eng.stream([TRequest(rid=0, prompt=prompt.copy(),
                                   sampling=SamplingParams(
                                       max_new_tokens=8, logprobs=3))]):
        if ev.done:
            final = ev.completion
        else:
            assert len(ev.top_ids) == len(ev.tokens)
            got_ids.extend(ev.top_ids)
    np.testing.assert_array_equal(np.asarray(got_ids, np.int32),
                                  final.top_ids)


def test_serve_cli_runs_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                 "--prompt-len", "6", "10", "--max-new", "2", "4"])
    out = capsys.readouterr().out
    assert '"requests": 3' in out and '"device": "cpu"' in out


@pytest.mark.parametrize("arch", [RG, RW])
def test_serve_cli_engine_serves_recurrent_archs(arch, capsys):
    """--mode engine (the default) serves both recurrent archs, with
    n-gram speculation on."""
    tserve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                 "--slots", "2", "--prompt-len", "6", "10", "--max-new", "2",
                 "5", "--speculate", "2"])
    out = capsys.readouterr().out
    assert '"requests": 3' in out and '"device": "cpu"' in out


@pytest.mark.parametrize("flag", [["--replicas", "2"], ["--autoscale"],
                                  ["--slo-ttft-ms", "100"],
                                  ["--temperature", "0.5"],
                                  ["--flight-recorder", "x.json"]])
def test_serve_cli_later_slice_flags_stop(flag, capsys):
    """The router, autoscaler, SLO and flight-recorder flags stop the CLI;
    --temperature, whose slice has landed, serves sampled requests."""
    if flag[0] == "--temperature":
        tserve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                     "--prompt-len", "6", "--max-new", "2", "4", *flag])
        assert '"sampled_requests": 3' in capsys.readouterr().out
        return
    with pytest.raises(SystemExit, match="not ported"):
        tserve.main(["--device", "cpu", *flag])


@pytest.mark.parametrize("flags", [
    ["--temperature", "0.8", "--top-k", "50", "--top-p", "0.95",
     "--speculate", "4", "--workload", "repetitive", "--logprobs", "2",
     "--stop", "7"],
    ["--workload", "shared-prefix", "--n-prefixes", "4", "--prompt-len",
     "8", "16", "--kv-dtype", "int8", "--host-cache-blocks", "32"],
    ["--kv-dtype", "fp8", "--temperature", "0.7"],
    ["--mode", "naive", "--temperature", "0.7"]])
def test_serve_cli_sampling_and_kv_flags(flags, capsys):
    """The JAX CLI's sampling flags and the quantized / host-tier KV
    options run on the CPU; the kv block names the pool dtype."""
    tserve.main(["--device", "cpu", "--requests", "8", "--slots", "2",
                 "--max-new", "3", "6", *flags])
    out = capsys.readouterr().out
    if "naive" in flags:
        assert "generated (4, 6)" in out
        return
    stats = json.loads(out[out.index("{"):out.rindex("}") + 1])
    kv = flags[flags.index("--kv-dtype") + 1] if "--kv-dtype" in flags \
        else "fp16"
    assert stats["kv"]["dtype"] == kv and stats["requests"] == 8
    if "--host-cache-blocks" in flags:
        assert stats["kv"]["host_revivals"] >= 1
    if "--temperature" in flags:
        assert stats["sampling"]["sampled_requests"] == 8


def test_chip_smoke_refuses_without_gpu_or_repo(tmp_path):
    """chip_smoke.py, run from a directory holding nothing else of the
    repo, exits non-zero and prints no result line: without a CUDA device
    it stops at that check, with one at the missing src/."""
    script = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    alone = shutil.copy(script, tmp_path)
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
