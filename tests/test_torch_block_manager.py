"""The port's BlockAllocator (`repro_torch.serving.block_manager`) under
random churn: tests/test_block_manager.py's two hypothesis properties over
the port — refcounts never negative, no double free, no partial grants,
conservation (num_free + live blocks == num_blocks - 1), shared or indexed
blocks never writable in place, and engine-shaped prefix sharing with
copy-on-write in which a match only ever returns blocks whose registered
content equals the prompt's chunk."""
import numpy as np
import pytest

from _torch_cpu import time_limit  # noqa: F401
from repro_torch.serving.block_manager import BlockAllocator

pytestmark = pytest.mark.serving

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                   # property tests degrade gracefully
    def given(*a, **k):               # keep decorators importable
        return pytest.mark.skip(reason="hypothesis not installed")

    def settings(*a, **k):
        return lambda f: f

    class st:                         # noqa: N801 — stand-in namespace
        @staticmethod
        def lists(*a, **k):
            return None

        @staticmethod
        def integers(*a, **k):
            return None


N_BLOCKS = 24


@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=120))
def test_refcount_invariants_under_churn(seeds):
    alloc = BlockAllocator(N_BLOCKS)
    refs = {}                                   # block -> model refcount
    handles = []                                # each: list of held blocks
    for s in seeds:
        op = s % 3
        if op == 0:                             # admit: alloc 0..4 blocks
            got = alloc.alloc(s // 4 % 5)
            if got is not None:
                for b in got:
                    refs[b] = refs.get(b, 0) + 1
                handles.append(got)
        elif op == 1 and handles:               # share one handle's blocks
            h = handles[s // 4 % len(handles)]
            for b in h:
                alloc.incref(b)
                refs[b] += 1
            handles.append(list(h))
        elif op == 2 and handles:               # finish: drop one handle
            h = handles.pop(s // 4 % len(handles))
            alloc.free(h)
            for b in h:
                refs[b] -= 1
                if refs[b] == 0:
                    del refs[b]
        # invariants
        assert all(v > 0 for v in refs.values())
        assert all(alloc.refcount(b) == v for b, v in refs.items())
        assert alloc.num_free + len(refs) == N_BLOCKS - 1  # conservation
        for b, v in refs.items():
            assert alloc.is_writable(b) == (v == 1)
    for h in handles:                           # drain: everything returns
        alloc.free(h)
    assert alloc.num_free == N_BLOCKS - 1
    with pytest.raises(ValueError):
        alloc.decref(1)                         # refcounts never negative


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=80))
def test_prefix_share_cow_invariants(seeds):
    """Engine-shaped churn: admit prompts with shared prefixes through
    match/share/alloc/register, simulate decode writes with the COW rule,
    and check that matches only ever return content-correct blocks and
    that shared blocks are never written in place."""
    bs = 4
    alloc = BlockAllocator(N_BLOCKS, block_size=bs)
    rng_prompts = [np.array(p, np.int32) for p in (
        [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],  # base: 3 full blocks
        [1, 2, 3, 4, 5, 6, 7, 8, 9, 10],  # strict prefix, ends mid-block
        [1, 2, 3, 4, 5, 6, 9],             # diverges inside block 1 (d=2)
        [1, 2, 3, 4],                      # exact one block
        [7, 7, 7, 7, 7],                   # unrelated
    )]
    live = []           # (blocks_held, prompt)
    content = {}        # block -> token chunk it holds (model of device KV)
    for s in seeds:
        op = s % 2
        if op == 0:                              # admit
            prompt = rng_prompts[s // 2 % len(rng_prompts)]
            m = alloc.match_prefix(prompt)
            # every matched block's registered content must equal the
            # prompt's corresponding chunk (content-correct sharing)
            for j, b in enumerate(m.full_blocks):
                np.testing.assert_array_equal(
                    content[b], prompt[j * bs:(j + 1) * bs])
            if m.partial_block is not None:
                f = len(m.full_blocks)
                np.testing.assert_array_equal(
                    content[m.partial_block][:m.partial_len],
                    prompt[f * bs:f * bs + m.partial_len])
            total = -(-(len(prompt) + 2) // bs)  # +2 generated tokens
            alloc.share(m)
            fresh = alloc.alloc(total - len(m.full_blocks))
            if fresh is None:
                alloc.unshare(m)
                continue
            blocks = list(m.full_blocks)
            rest = fresh
            if m.partial_block is not None:
                if m.partial_len == len(prompt) - len(blocks) * bs:
                    blocks.append(m.partial_block)   # lazy COW later
                else:                                 # eager COW now
                    assert not alloc.is_writable(m.partial_block)
                    content[fresh[0]] = content[m.partial_block].copy()
                    alloc.decref(m.partial_block)
                    blocks.append(fresh[0])
                    rest = fresh[1:]
            blocks += rest
            # "prefill": write prompt chunks into writable blocks only
            nfull = len(prompt) // bs
            for j in range(nfull + (1 if len(prompt) % bs else 0)):
                b = blocks[j]
                chunk = prompt[j * bs:(j + 1) * bs]
                if alloc.is_writable(b):
                    content[b] = np.array(chunk, np.int32)
                else:       # shared: content must already be there
                    np.testing.assert_array_equal(
                        content[b][:len(chunk)], chunk)
            alloc.register_prefix(prompt, blocks)
            # "decode": first generated token writes block len(prompt)//bs
            j = len(prompt) // bs
            if j < len(blocks) and not alloc.is_writable(blocks[j]):
                # lazy COW: swap in the reserved private copy (it leaves
                # the table-order list so refs stay one-per-block)
                repl = blocks.pop()
                assert alloc.is_writable(repl)
                content[repl] = content[blocks[j]].copy()
                alloc.decref(blocks[j])
                blocks[j] = repl
            live.append(blocks)
        elif live:                               # finish a sequence
            alloc.free(live.pop(s // 2 % len(live)))
    for blocks in live:
        alloc.free(blocks)
    assert alloc.num_free == N_BLOCKS - 1
