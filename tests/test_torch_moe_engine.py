"""The port's serving engine on the reduced grok-1-314b (MoE on every
layer: 4 experts, top-2, the default capacity factor 1.25) held to the
JAX engine on the CPU, token for token and SchedulerStats step for step:
bucketed prefill, prefix-cache hits, chunked prefill and speculate=4,
where prefills drop token-expert assignments past capacity. Where no
token drops (capacity factor 8), the engine equals the port's generate().
The serve CLI's tokens for --arch grok-1-314b equal the JAX CLI's.

Capacity follows the tokens a call routes (the reference's property): a
bucketed or suffix prefill routes a row's suffix at its bucket length, a
verify its chain, generate() one token at a time. So the engine follows
the JAX engine, not generate(), wherever a prefill drops tokens."""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import StepClock, time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

from repro.launch import serve as jserve  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

import _torch_models  # noqa: E402

GROK = "grok-1-314b"
KW = dict(num_slots=3, block_size=4, max_seq_len=64, prefill_max_batch=2)


def _stream(kind, vocab):
    """(prompt, max_new) pairs. "mixed": six prompts of 3-30 tokens, two
    of them on one 12-token prefix (a prefix hit once the first is
    cached), one of 18 and one of 30 tokens (chunked at prefill_chunk 16,
    which also caps the buckets at 16);
    "repetitive": prompts that repeat a 4-token pattern (drafts the n-gram
    proposer gets right)."""
    rng = np.random.default_rng(11)
    if kind == "mixed":
        prefix = rng.integers(0, vocab, 12).astype(np.int32)
        prompts = [rng.integers(0, vocab, n).astype(np.int32)
                   for n in (9, 15, 30, 3)]
        prompts[1:1] = [np.concatenate([prefix, rng.integers(0, vocab, n)
                                        .astype(np.int32)]) for n in (4, 6)]
        return [(p, 5 + i % 3) for i, p in enumerate(prompts)]
    pattern = rng.integers(0, vocab, 4).astype(np.int32)
    return [(np.tile(pattern, 5)[:n], 10) for n in (14, 18, 11)]


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


@pytest.mark.parametrize("kind,speculate,chunk", [("mixed", 0, 16),
                                                  ("repetitive", 4, None)])
def test_engine_matches_jax_engine(kind, speculate, chunk):
    """Both engines with the prefix cache on over the same stream: equal
    SchedulerStats after every step, equal tokens and finish reasons. The
    mixed stream hits the prefix cache, admits its 18- and 30-token
    prompts in chunks of 16 and drops assignments past capacity in its prefills; the
    repetitive one verifies n-gram drafts (speculate 4)."""
    jcfg, jparams, tcfg, tparams = _torch_models.reduced_models(GROK)
    stream = _stream(kind, jcfg.vocab_size)
    kw = dict(KW, speculate=speculate, prefill_chunk=chunk, prefix_cache=True)
    jeng = JEngine(jparams, jcfg, **kw)
    jdone, jstats = _drive(jeng, [JRequest(rid=i, prompt=p, max_new_tokens=m)
                                  for i, (p, m) in enumerate(stream)])
    teng = TEngine(tparams, tcfg, device="cpu", now_fn=StepClock(), **kw)
    with tmoe.tally() as t:
        tdone, tstats = _drive(teng, [TRequest(rid=i, prompt=p,
                                               max_new_tokens=m)
                                      for i, (p, m) in enumerate(stream)])
    assert tstats == jstats
    assert len(tdone) == len(jdone) == len(stream)
    for a, b in zip(tdone, jdone):
        assert list(a.tokens) == list(b.tokens), a.rid
        assert a.finish_reason == b.finish_reason
    assigned, dropped = t.read()
    assert assigned > 0
    for name in ("prefix_hit_requests", "accepted_tokens"):
        assert getattr(teng.scheduler, name) == getattr(jeng.scheduler, name)
    if kind == "mixed":
        assert dropped > 0 and teng.scheduler.prefix_hit_requests > 0
        # chunks dispatched (the scheduler's round-robin counter)
        assert teng.scheduler._chunk_rr == jeng.scheduler._chunk_rr > 0
    else:
        assert teng.scheduler.accepted_tokens > 0


def test_engine_equals_generate_where_nothing_drops():
    """At capacity factor 8 no prefill drops a token, and the engine (the
    mixed stream: prefix hits, chunks of 16; then speculate 4) equals the
    port's generate() token for token, as the reference's own MoE test
    holds decode to prefill (tests/test_model_invariants.py)."""
    _, _, tcfg, tparams = _torch_models.reduced_models(GROK)
    cfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    stream = _stream("mixed", cfg.vocab_size)
    for speculate in (0, 4):
        eng = TEngine(tparams, cfg, device="cpu", now_fn=StepClock(),
                      speculate=speculate, prefill_chunk=16,
                      prefix_cache=True, **KW)
        with tmoe.tally() as t:
            done, _ = _drive(eng, [TRequest(rid=i, prompt=p, max_new_tokens=m)
                                   for i, (p, m) in enumerate(stream)])
        assert t.read()[1] == 0
        for c, (p, m) in zip(done, stream):
            want = tserve.generate(tparams, cfg, p[None], m, device="cpu")
            assert list(c.tokens) == want[0].tolist(), (speculate, c.rid)


def _sample_line(out):
    return next(ln for ln in out.splitlines() if ln.startswith("sample"))


@pytest.mark.parametrize("mode", ["engine", "naive"])
def test_serve_cli_tokens_match_the_jax_cli(mode, capsys, monkeypatch):
    """`--arch grok-1-314b` (the reduced config, seed 0 weights) through
    both CLIs: the engine's first request's tokens, or the naive batch's
    first row, printed equal."""
    argv = ["--arch", GROK, "--mode", mode, "--requests", "4", "--slots",
            "2", "--max-new", "4", "8"]
    tserve.main(["--device", "cpu", *argv])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    want = capsys.readouterr().out
    if mode == "engine":
        assert _sample_line(got) == _sample_line(want)
    else:
        assert got.strip().splitlines()[-1] == want.strip().splitlines()[-1]
