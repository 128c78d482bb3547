"""Priority classes and preempt-resume in the port's engine, the six tests
of tests/test_preemption.py over `repro_torch.serving`: a preempted and
resumed request's output equals an uninterrupted run and torch
`generate()` bit for bit, with the allocator's refcounts and pools
restored exactly (forced preemptions at fixed mid-decode steps, also held
to the JAX engine under the same preemptions; and a hypothesis property
over request mixes and preempt points, at the reference's reduced config
and max_examples); preempt() on an empty engine; the admission order
(class ranking, FCFS within a class, the aging bound that keeps a
low-priority request from starving under a stream of high-priority
arrivals); and the serve CLI's priority flags reaching the engine."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

import _torch_cpu  # noqa: E402

_torch_cpu.share_cores()

pytestmark = pytest.mark.serving

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                   # property tests degrade gracefully
    HAVE_HYPOTHESIS = False

    def given(*a, **k):               # keep decorators importable
        return pytest.mark.skip(reason="hypothesis not installed")

    def settings(*a, **k):
        return lambda f: f

    class st:                         # noqa: N801 — stand-in namespace
        @staticmethod
        def integers(*a, **k):
            return None

        @staticmethod
        def data(*a, **k):
            return None

ARCH = "smollm-135m"
ENGINE = dict(num_slots=2, block_size=4, max_seq_len=48, prefill_max_batch=2)


@pytest.fixture(scope="module")
def smollm():
    cfg = get_config(ARCH).reduced()
    return lm.init_params(0, cfg, device="cpu"), cfg


@pytest.fixture(scope="module")
def engine(smollm):
    params, cfg = smollm
    return ServingEngine(params, cfg, device="cpu", **ENGINE)


_ORACLE = {}


def _oracle(params, cfg, prompt, gen):
    key = (tuple(int(t) for t in prompt), gen)
    if key not in _ORACLE:
        _ORACLE[key] = generate(params, cfg, np.asarray(prompt)[None], gen,
                                device="cpu")[0].numpy()
    return _ORACLE[key]


def _reqs(rng, n, plens, gens, prios, vocab, cls=Request):
    return [cls(rid=i,
                prompt=rng.integers(0, vocab, plens[i]).astype(np.int32),
                max_new_tokens=gens[i], arrival=0.0,
                priority=prios[i]) for i in range(n)]


def _run_with_preempts(eng, reqs, preempt_at):
    """Drive the engine by hand, calling scheduler.preempt() after the
    given step counts (mid-decode: preempt() only evicts a slot past its
    prefill)."""
    eng.reset_prefix_cache()
    baseline_free = eng.allocator.num_free
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
        if steps in preempt_at:
            eng.scheduler.preempt()
        assert steps < 10_000
    done = eng.scheduler.completions
    eng.scheduler.completions = []
    return done, baseline_free


def _assert_clean(eng, baseline_free):
    """Preempt-resume leaves nothing behind: every refcount dropped, the
    reserved-budget ledger balanced, no resume state left, and the free
    and cached-free pools together hold every block again."""
    assert eng.scheduler._resume_state == {}
    assert eng.scheduler._reserved_budget == 0
    assert eng.allocator._ref == {}
    assert eng.allocator.num_free == baseline_free
    assert eng.scheduler.preemptions == eng.scheduler.resumes


def test_preempt_resume_bit_identical_deterministic(engine, smollm):
    """Forced preemptions at fixed mid-decode steps: outputs equal torch
    generate() exactly, the preempt path runs, and the JAX engine under
    the same preemptions gives the same tokens and counts."""
    params, cfg = smollm
    rng = np.random.default_rng(7)
    shape = ([8, 6, 10], [8, 6, 7], [0, 1, 0])
    reqs = _reqs(rng, 3, *shape, cfg.vocab_size)
    engine.scheduler.reset_stats()
    done, base_free = _run_with_preempts(engine, reqs, {2, 4, 7})
    assert engine.scheduler.preemptions >= 1
    assert engine.scheduler.resumes == engine.scheduler.preemptions
    by_rid = {c.rid: c.tokens for c in done}
    assert set(by_rid) == {0, 1, 2}
    for r in reqs:
        want = _oracle(params, cfg, r.prompt, r.max_new_tokens)
        np.testing.assert_array_equal(by_rid[r.rid], want)
    _assert_clean(engine, base_free)

    jcfg = jget(ARCH).reduced()
    jeng = JEngine(convert.to_jax(params, cfg), jcfg, **ENGINE)
    jreqs = _reqs(np.random.default_rng(7), 3, *shape, jcfg.vocab_size,
                  cls=JRequest)
    jeng.scheduler.reset_stats()
    jdone, _ = _run_with_preempts(jeng, jreqs, {2, 4, 7})
    assert jeng.scheduler.preemptions == engine.scheduler.preemptions
    for c in jdone:
        np.testing.assert_array_equal(np.asarray(c.tokens), by_rid[c.rid])


@settings(max_examples=6, deadline=120_000, derandomize=True)
@given(data=st.data())
def test_preempt_resume_property(engine, smollm, data):
    """Any request mix, any preempt points: outputs bit-identical to
    generate() and allocator pools restored exactly."""
    params, cfg = smollm
    n = data.draw(st.integers(2, 4))
    seed = data.draw(st.integers(0, 2**16))
    rng = np.random.default_rng(seed)
    plens = [data.draw(st.integers(5, 12)) for _ in range(n)]
    gens = [data.draw(st.integers(3, 8)) for _ in range(n)]
    prios = [data.draw(st.integers(0, 1)) for _ in range(n)]
    preempt_at = {data.draw(st.integers(1, 24))
                  for _ in range(data.draw(st.integers(1, 3)))}
    reqs = _reqs(rng, n, plens, gens, prios, cfg.vocab_size)
    engine.scheduler.reset_stats()
    done, base_free = _run_with_preempts(engine, reqs, preempt_at)
    by_rid = {c.rid: c.tokens for c in done}
    assert set(by_rid) == set(range(n))
    for r in reqs:
        want = _oracle(params, cfg, r.prompt, r.max_new_tokens)
        np.testing.assert_array_equal(by_rid[r.rid], want)
    _assert_clean(engine, base_free)


def test_preempt_returns_none_on_empty_engine(engine):
    assert not engine.has_work
    assert engine.scheduler.preempt() is None


# ----------------------------------------------------------------------------
# admission-order units (fake clock, no dispatches)
# ----------------------------------------------------------------------------

def _submit_at(sched, clock, t, rid, priority):
    clock[0] = t
    req = Request(rid=rid, prompt=np.arange(6, dtype=np.int32),
                  max_new_tokens=2, priority=priority,
                  sampling=SamplingParams(max_new_tokens=2))
    sched.submit(req)
    return req


def test_priority_ordering_aging_and_fcfs(engine):
    sched = engine.scheduler
    orig_now, orig_aging = sched._now, sched.priority_aging_s
    clock = [0.0]
    sched._now = lambda: clock[0]
    sched.priority_aging_s = 2.0
    try:
        low = _submit_at(sched, clock, 0.0, 900, priority=0)
        _submit_at(sched, clock, 0.05, 901, priority=0)
        _submit_at(sched, clock, 0.1, 902, priority=1)
        # class ranking: the later high-priority request jumps the queue
        assert [r.rid for r in sched._admission_order()] == [902, 900, 901]
        # the aging bound: a request that waited priority_aging_s * gap
        # seconds outranks a fresh arrival `gap` classes above it (a high
        # request that has also waited keeps its head start)
        fresh = _submit_at(sched, clock, 2.5, 903, priority=1)
        assert sched._eff_priority(low, 2.5) > sched._eff_priority(fresh,
                                                                   2.5)
        order = [r.rid for r in sched._admission_order()]
        assert order.index(900) < order.index(903)
        assert order[0] == 902                    # waited high stays top
        # ...but not before the bound: at half of it the class wins
        assert sched._eff_priority(low, 0.9) < 1.0
        # FCFS within a class survives aging (equal classes age equally)
        clock[0] = 50.0
        order = [r.rid for r in sched._admission_order()]
        assert order.index(900) < order.index(901)
    finally:
        sched.take_queued()
        sched._now, sched.priority_aging_s = orig_now, orig_aging


def test_aging_disabled_pins_static_classes(engine):
    sched = engine.scheduler
    orig_now, orig_aging = sched._now, sched.priority_aging_s
    clock = [0.0]
    sched._now = lambda: clock[0]
    sched.priority_aging_s = 0.0
    try:
        low = _submit_at(sched, clock, 0.0, 910, priority=0)
        clock[0] = 1000.0
        _submit_at(sched, clock, 1000.0, 911, priority=1)
        # no aging: an arbitrarily old low-priority request never
        # outranks a higher class (strict-priority mode)
        assert [r.rid for r in sched._admission_order()] == [911, 910]
        assert sched._eff_priority(low, 1e9) == 0.0
    finally:
        sched.take_queued()
        sched._now, sched.priority_aging_s = orig_now, orig_aging


def test_starvation_freedom_under_high_priority_stream(engine, smollm):
    """Integration: a low-priority request submitted into a continuous
    stream of high-priority work still completes, with generate()'s
    tokens (aging lifts it past fresh arrivals instead of letting them
    jump the queue for ever)."""
    params, cfg = smollm
    rng = np.random.default_rng(3)
    low = Request(rid=0, prompt=rng.integers(
        0, cfg.vocab_size, 8).astype(np.int32), max_new_tokens=4,
        arrival=0.0, priority=0)
    highs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, 8).astype(np.int32), max_new_tokens=4,
        arrival=0.0, priority=3) for i in range(1, 7)]
    old_aging = engine.scheduler.priority_aging_s
    engine.scheduler.priority_aging_s = 0.01   # age fast: bound the test
    try:
        engine.reset_prefix_cache()
        engine.submit(low)
        for h in highs[:3]:
            engine.submit(h)
        steps = 0
        done = {}
        while engine.has_work:
            engine.step()
            steps += 1
            if steps <= 3 and steps < len(highs):
                engine.submit(highs[2 + steps])   # keep pressure coming
            done.update((c.rid, c.tokens) for c in
                        engine.scheduler.completions)
            engine.scheduler.completions = []
            assert steps < 5_000
        assert 0 in done
        np.testing.assert_array_equal(
            done[0], _oracle(params, cfg, low.prompt, low.max_new_tokens))
    finally:
        engine.scheduler.priority_aging_s = old_aging


def test_serve_cli_priority_flags_reach_the_engine(monkeypatch):
    """--priorities, --tenant-priorities and --priority-aging, the JAX
    CLI's flags with its defaults: the workloads carry the classes and the
    engine the aging bound."""
    seen = {}
    real = tserve.ServingEngine

    def spy(*a, **k):
        seen["aging"] = k["priority_aging"]
        eng = real(*a, **k)
        real_run = eng.run

        def run(reqs):
            seen.setdefault("prios", set()).update(r.priority for r in reqs)
            return real_run(reqs)

        eng.run = run
        return eng

    monkeypatch.setattr(tserve, "ServingEngine", spy)
    base = ["--device", "cpu", "--requests", "4", "--slots", "2",
            "--prompt-len", "6", "--max-new", "2", "3"]
    tserve.main(base + ["--workload", "bursty", "--priorities", "0", "2",
                        "--priority-aging", "0.5"])
    assert seen["aging"] == 0.5 and seen["prios"] <= {0, 2}
    seen.clear()
    tserve.main(base + ["--workload", "multi-tenant", "--tenants", "2",
                        "--tenant-priorities", "1", "3", "--prefix-len",
                        "4"])
    assert seen["aging"] == 2.0 and seen["prios"] == {1, 3}
