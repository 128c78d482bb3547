"""The port's engine on the recurrent archs' rollback and admission paths,
held to the JAX engine and to torch generate() on the CPU (split from
tests/test_torch_engine.py): scripted drafts (all accepted, all rejected,
the second token of each draft wrong) run the recurrent rollback through
both engines with equal accepted counts; a chunked prefill beside a
decoding lane, where the JAX engine leaves generate() for the recurrent
archs, must equal generate() here; kv_cache.load_prefill against the JAX
loader and against lm.prefill_paged."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

from repro.models import lm as jlm  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

import _torch_models  # noqa: E402

_models = _torch_models.reduced_models
RG, RW = "recurrentgemma-2b", "rwkv6-3b"


class _ScriptedProposer:
    """Knows each request's true greedy continuation and proposes it
    verbatim ("oracle": every draft accepted), off by one ("adversarial":
    every draft rejected) or with its second token off by one ("partial":
    one token of a longer draft accepted, the state rolled back to a
    mid-chain snapshot)."""

    def __init__(self, scripts, vocab_size, mode):
        self.scripts = scripts        # [(prompt list, expected out list)]
        self.vocab_size = vocab_size
        self.mode = mode

    def propose(self, history, k):
        hist = list(history)
        for prompt, out in self.scripts:
            full = prompt + out
            if (len(prompt) < len(hist) <= len(full)
                    and hist == full[:len(hist)]):
                nxt = full[len(hist):len(hist) + k]
                if self.mode == "adversarial":
                    return [(t + 1) % self.vocab_size for t in nxt]
                if self.mode == "partial" and len(nxt) > 1:
                    nxt[1] = (nxt[1] + 1) % self.vocab_size
                return nxt
        return []


@pytest.mark.parametrize("arch", [RG, RW])
@pytest.mark.parametrize("mode", ["oracle", "adversarial", "partial"])
def test_scripted_drafts_match_jax_engine_and_generate(arch, mode):
    """The four prompts of tests/test_speculative.py's forced accept /
    reject test (2 slots, block 4, speculate 4) with scripted drafts:
    tokens equal to the JAX engine's and to torch generate(), the same
    proposed and accepted counts as the JAX engine, every block back."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (4, 9), 0,
                                            jcfg.vocab_size), np.int32)
    gens = [12, 7, 10, 5]
    want = [tserve.generate(tparams, tcfg, prompts[i][None], gens[i],
                            device="cpu").numpy()[0] for i in range(4)]
    scripts = [([int(t) for t in prompts[i]], [int(t) for t in want[i]])
               for i in range(4)]
    kw = dict(num_slots=2, block_size=4, max_seq_len=32, speculate=4)
    jeng = JEngine(jparams, jcfg, **kw)
    teng = TEngine(tparams, tcfg, device="cpu", **kw)
    done = {}
    for name, eng, req in (("jax", jeng, JRequest), ("torch", teng,
                                                      TRequest)):
        prop = _ScriptedProposer(scripts, jcfg.vocab_size, mode)
        eng.scheduler._proposers = [prop] * eng.num_slots
        free0 = eng.allocator.num_free
        done[name] = sorted(eng.run([req(rid=i, prompt=prompts[i],
                                         max_new_tokens=gens[i])
                                     for i in range(4)]),
                            key=lambda c: c.rid)
        assert eng.allocator.num_free == free0
    for tc, jc in zip(done["torch"], done["jax"]):
        np.testing.assert_array_equal(tc.tokens, jc.tokens)
        np.testing.assert_array_equal(tc.tokens, want[tc.rid])
    js, ts = jeng.scheduler, teng.scheduler
    assert (ts.proposed_tokens, ts.accepted_tokens) == \
        (js.proposed_tokens, js.accepted_tokens)
    assert ts.proposed_tokens > 0
    if mode == "oracle":
        assert ts.accepted_tokens == ts.proposed_tokens
    elif mode == "adversarial":
        assert ts.accepted_tokens == 0
    else:
        assert 0 < ts.accepted_tokens < ts.proposed_tokens


@pytest.mark.parametrize("arch", [RG, RW, "smollm-135m"])
def test_chunked_prefill_beside_decoding_lane_matches_generate(arch):
    """A 30-token prompt admitted in chunks of 8 while a 5-token request
    decodes (2 slots, block 4): the chunked lane sits the decode steps out
    between its chunks. The port's engine keeps its recurrent state there
    and equals torch generate() for both requests. (The JAX engine steps
    every slot's recurrent state and leaves generate() from the chunked
    request's first token on the recurrent archs: ROADMAP, reference
    faults.)"""
    _, _, tcfg, tparams = _models(arch)
    rng = np.random.default_rng(0)
    reqs = [TRequest(rid=0, prompt=rng.integers(0, tcfg.vocab_size, 5)
                     .astype(np.int32), max_new_tokens=20),
            TRequest(rid=1, prompt=rng.integers(0, tcfg.vocab_size, 30)
                     .astype(np.int32), max_new_tokens=6)]
    eng = TEngine(tparams, tcfg, num_slots=2, block_size=4, max_seq_len=64,
                  prefill_buckets=[4, 8], prefill_chunk=8, device="cpu")
    done = eng.run(list(reqs))
    assert len(done) == 2
    assert eng.runner.prefill_dispatches >= 5        # 1 + 4 chunks
    assert eng.steps > 0
    for c in done:
        r = reqs[c.rid]
        want = tserve.generate(tparams, tcfg, r.prompt[None],
                               r.max_new_tokens, device="cpu").numpy()[0]
        np.testing.assert_array_equal(c.tokens, want)


@pytest.mark.parametrize("arch", ["smollm-135m", RG, RW])
def test_load_prefill_matches_jax(arch):
    """kv_cache.load_prefill scatters a batch-1 lm.prefill cache into the
    paged state as the JAX loader does (attention K/V through the table
    row, recurrent state at the slot), and the result equals what
    lm.prefill_paged leaves for the same prompt in the same slot and
    blocks."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    bs, slot, P = 4, 1, 11
    table = np.asarray([5, 2, 7, 0, 0, 0], np.int32)
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, P) \
        .astype(np.int32)
    _, jcache = jlm.prefill(jparams, jcfg, {"tokens": prompt[None]})
    jstate = jkv.load_prefill(jcfg, jkv.init_paged_state(jcfg, 3, 9, bs),
                              jcache, np.int32(slot), table, bs)
    _, tcache = tlm.prefill(tparams, tcfg,
                            {"tokens": torch.from_numpy(prompt[None])})
    tstate = tkv.load_prefill(tcfg, tkv.init_paged_state(tcfg, 3, 9, bs,
                                                         device="cpu"),
                              tcache, slot, table, bs)
    want = convert.from_jax(jax.device_get(jstate), tcfg)
    fused = tkv.init_paged_state(tcfg, 3, 9, bs, device="cpu")
    i32 = torch.int32
    tlm.prefill_paged(tparams, tcfg, fused, torch.from_numpy(prompt[None]),
                      torch.tensor([P], dtype=i32), torch.zeros(1, dtype=i32),
                      torch.from_numpy(table[None]),
                      torch.tensor([slot], dtype=i32))
    for (kind, st), (_, jst), (_, fst) in zip(tlm._layers(tstate, tcfg),
                                              tlm._layers(want, tcfg),
                                              tlm._layers(fused, tcfg)):
        jleaves, fleaves = dict(_flat(jst)), dict(_flat(fst))
        for path, got in _flat(st):
            ref_, pf = jleaves[path], fleaves[path]
            if kind in tkv.ATTN_KINDS:       # the null block is a sink
                got, ref_, pf = got[1:], ref_[1:], pf[1:]
            np.testing.assert_allclose(got.numpy(), ref_.numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=f"{kind} {path}")
            np.testing.assert_allclose(got.numpy(), pf.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=f"{kind} {path}")



def _flat(tree, path=()):
    """(key path, leaf) over nested dicts, whatever their key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree
