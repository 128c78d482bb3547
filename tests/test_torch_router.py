"""The port's cluster router (`repro_torch.serving.{replica,router}`) on the
CPU: the 17 tests of tests/test_router.py over the port (placement-policy
units over stub replicas, backpressure / FCFS, drain / failover requeue,
stream merging, the SchedulerStats accessor, the multi-tenant generator,
and cluster output equal to one engine's at 1 / 2 / 4 replicas under
every policy, also as a hypothesis property), then parity with the JAX
package: one stream, all arrivals at t=0, through the JAX Router and the
port's at 2 replicas under each policy places every request on the same
replica with the same tokens, and the replica's read-only probe of the
host spill tier (tests/test_kv_quant.py::
test_replica_probe_counts_spilled_tokens_readonly). Engines, replicas and
routers run on one step clock (`_torch_cpu.StepClock`), never the wall
clock; the JAX side runs as its own tests run it."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import StepClock, time_limit  # noqa: E402,F401

_torch_cpu.share_cores()

from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.serving.engine import (Request, ServingEngine,  # noqa: E402
                                        multi_tenant_requests,
                                        shared_prefix_requests)
from repro_torch.serving.replica import Replica, ReplicaSnapshot  # noqa: E402
from repro_torch.serving.router import (POLICIES, Router,  # noqa: E402
                                        normalize_policy, summarize_cluster)
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from repro_torch.serving.scheduler import SchedulerStats  # noqa: E402

import _torch_models  # noqa: E402

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
        def integers(*a, **k):
            return None

        @staticmethod
        def sampled_from(*a, **k):
            return None


# ----------------------------------------------------------------------------
# policy unit tests over stub replicas (no device, no engine)
# ----------------------------------------------------------------------------

class _StubReplica:
    """Duck-typed replica: fixed occupancy + affinity probe results."""

    def __init__(self, rid, *, slots=2, queue=0, active=0, prefix=0,
                 enabled=True, cap=None):
        self.replica_id = rid
        self.enabled = enabled
        self.num_slots = slots
        self.queue_depth = queue
        self.active = active
        self.prefix = prefix
        self.submitted = []
        self.engine = types.SimpleNamespace(runner=types.SimpleNamespace(
            prefill_max_batch=slots if cap is None else cap))

    def snapshot(self):
        return ReplicaSnapshot(
            replica_id=self.replica_id, enabled=self.enabled,
            stats=SchedulerStats(
                queue_depth=self.queue_depth, active_slots=self.active,
                free_slots=self.num_slots - self.active, free_blocks=99,
                cached_blocks=0, indexed_blocks=0, reserved_blocks=0))

    def probe_prefix(self, prompt):
        return self.prefix

    def submit(self, req):
        self.submitted.append(req)
        self.queue_depth += 1

    @property
    def has_work(self):
        return bool(self.submitted)

    def take_queued(self):
        out, self.submitted, self.queue_depth = self.submitted, [], 0
        return out


def _req(rid):
    return Request(rid=rid, prompt=np.arange(4, dtype=np.int32),
                   max_new_tokens=2,
                   sampling=SamplingParams(max_new_tokens=2))


def test_policy_aliases_and_validation():
    assert normalize_policy("rr") == "round-robin"
    assert normalize_policy("prefix") == "prefix-affinity"
    assert normalize_policy("least-loaded") == "least-loaded"
    for p in POLICIES:
        assert normalize_policy(p) == p
    with pytest.raises(ValueError):
        normalize_policy("random")
    with pytest.raises(ValueError):
        Router([], policy="rr")
    with pytest.raises(ValueError):
        Router([_StubReplica(0), _StubReplica(0)])
    with pytest.raises(ValueError):
        Router([_StubReplica(0)], max_queue=0)


def test_round_robin_rotates_and_skips_unavailable():
    reps = [_StubReplica(i, slots=4) for i in range(3)]
    reps[1].enabled = False
    router = Router(reps, policy="rr", max_queue=4)
    for i in range(4):
        router.submit(_req(i))
    assert router.place() == 4
    # rotation 0, (skip 1), 2, 0, 2
    assert [r.rid for r in reps[0].submitted] == [0, 2]
    assert reps[1].submitted == []
    assert [r.rid for r in reps[2].submitted] == [1, 3]
    assert router.placement_of(3) == 2 and router.placement_of(9) is None


def test_least_loaded_uses_slot_plus_queue_occupancy():
    reps = [_StubReplica(0, queue=2, active=1),
            _StubReplica(1, queue=0, active=2),
            _StubReplica(2, queue=1, active=2)]
    router = Router(reps, policy="least-loaded", max_queue=9)
    router.submit(_req(0))
    router.place()
    assert [r.rid for r in reps[1].submitted] == [0]   # load 2 < 3 <= 3
    # ties break to the lowest replica id
    reps_tie = [_StubReplica(0, queue=1), _StubReplica(1, queue=1)]
    router = Router(reps_tie, policy="least-loaded", max_queue=9)
    router.submit(_req(1))
    router.place()
    assert [r.rid for r in reps_tie[0].submitted] == [1]


def test_prefix_affinity_prefers_holder_else_least_loaded():
    reps = [_StubReplica(0, queue=0, prefix=0),
            _StubReplica(1, queue=3, prefix=8),
            _StubReplica(2, queue=1, prefix=8)]
    router = Router(reps, policy="prefix", max_queue=9)
    router.submit(_req(0))
    router.place()
    # both 1 and 2 hold 8 tokens; least-loaded tie-break picks 2
    assert [r.rid for r in reps[2].submitted] == [0]
    # nobody holds the prefix -> pure least-loaded fallback
    for r in reps:
        r.prefix = 0
    router.submit(_req(1))
    router.place()
    assert [r.rid for r in reps[0].submitted] == [1]


def test_prefix_affinity_cold_start_pinning():
    """Zero-match requests sharing a leading block chunk follow the
    router's cold-start pin (the replica where that chunk was first
    placed) instead of scattering least-loaded — the probe takes over
    once the replica actually holds blocks."""
    reps = [_StubReplica(0, slots=8), _StubReplica(1, slots=8)]
    for r in reps:
        r.engine.block_size = 2
    router = Router(reps, policy="prefix", max_queue=8)
    t1 = np.asarray([5, 6, 7, 8], np.int32)
    t2 = np.asarray([9, 9, 7, 8], np.int32)
    for rid, prompt in enumerate([t1, t2, t1, t2, t1]):
        router.submit(Request(rid=rid, prompt=prompt.copy(),
                              max_new_tokens=2,
                              sampling=SamplingParams(max_new_tokens=2)))
    router.place()
    # stub probes return 0 everywhere: tenant 1 pins to its first
    # least-loaded placement (replica 0), tenant 2 to the other, and
    # every repeat follows its pin
    assert [r.rid for r in reps[0].submitted] == [0, 2, 4]
    assert [r.rid for r in reps[1].submitted] == [1, 3]


def test_backpressure_holds_queue_fcfs():
    reps = [_StubReplica(0, slots=2, queue=2, cap=2)]
    router = Router(reps, policy="rr")
    for i in range(3):
        router.submit(_req(i))
    assert router.place() == 0            # replica at its cap
    assert router.has_work and reps[0].submitted == []
    reps[0].queue_depth = 0               # admission drained the queue
    assert router.place() == 2            # cap admits two more, in order
    assert [r.rid for r in reps[0].submitted] == [0, 1]


def test_disable_requeues_unplaced_in_order():
    reps = [_StubReplica(0, slots=4), _StubReplica(1, slots=4)]
    router = Router(reps, policy="rr", max_queue=4)
    for i in range(4):
        router.submit(_req(i))
    router.place()
    assert [r.rid for r in reps[1].submitted] == [1, 3]
    orphans = router.disable(1)
    assert [r.rid for r in orphans] == [1, 3]
    assert router.requeued == 2
    assert router.placement_of(1) is None
    router.place()                        # requeued requests go to 0
    assert [r.rid for r in reps[0].submitted] == [0, 2, 1, 3]
    assert router.placement_of(1) == 0
    router.enable(1)
    router.submit(_req(9))
    router.place()
    assert [r.rid for r in reps[1].submitted] == [9]


# ----------------------------------------------------------------------------
# real-engine cluster: identity, streaming, drain, telemetry
# ----------------------------------------------------------------------------

# one step clock for every engine, replica and router of this module
CLOCK = StepClock()
_ENGINE_KW = dict(num_slots=2, block_size=4, max_seq_len=48,
                  prefill_max_batch=2, speculate=2, device="cpu",
                  now_fn=CLOCK)


@pytest.fixture(scope="module")
def smollm():
    """The reduced smollm-135m at the JAX package's PRNGKey(0) weights,
    in the port's layout."""
    _, _, cfg, params = _torch_models.reduced_models("smollm-135m")
    return params, cfg


@pytest.fixture(scope="module")
def replicas4(smollm):
    params, cfg = smollm
    return [Replica(params, cfg, replica_id=i, **_ENGINE_KW)
            for i in range(4)]


@pytest.fixture(scope="module")
def single_engine(smollm):
    params, cfg = smollm
    return ServingEngine(params, cfg, **_ENGINE_KW)


def _router(replicas, **kw):
    return Router(replicas, now_fn=CLOCK, **kw)


def _workload(cfg, n=8, seed=0, sampling=None):
    return multi_tenant_requests(n, vocab_size=cfg.vocab_size,
                                 n_tenants=2, prefix_len=12,
                                 suffix_len=(1, 5), max_new=(2, 5),
                                 sampling=sampling, seed=seed)


def _generate(params, cfg, req):
    return generate(params, cfg, np.asarray(req.prompt)[None],
                    req.max_new_tokens, device="cpu")[0].numpy()


def test_cluster_bit_identical_and_blocks_restored(smollm, replicas4,
                                                   single_engine):
    """Every policy, 2 replicas: cluster completions are bit-identical
    to the single-replica engine run AND to generate(); every replica's
    block pool fully restores (shared blocks may idle cached-free)."""
    params, cfg = smollm
    reqs = _workload(cfg, seed=3)
    expect = {c.rid: c.tokens for c in single_engine.run(list(reqs))}
    for policy in POLICIES:
        router = _router(replicas4[:2], policy=policy)
        done = router.run(list(reqs))
        assert len(done) == len(reqs)
        for c in done:
            np.testing.assert_array_equal(c.tokens, expect[c.rid])
        for rep in router.replicas:
            alloc = rep.engine.allocator
            assert alloc.num_free == alloc.num_blocks - 1
    r = reqs[0]
    np.testing.assert_array_equal(expect[r.rid], _generate(params, cfg, r))


def test_cluster_stream_merges_replica_events(smollm, replicas4):
    """stream() over 2 replicas: per-request token chunks concatenate to
    exactly the run() output, one done event per request, callbacks
    restored afterwards."""
    params, cfg = smollm
    reqs = _workload(cfg, seed=4)
    router = _router(replicas4[:2], policy="least-loaded")
    chunks = {r.rid: [] for r in reqs}
    finals = {}
    for ev in router.stream(list(reqs)):
        if ev.done:
            assert ev.rid not in finals
            finals[ev.rid] = ev.completion
        else:
            assert ev.rid not in finals
            chunks[ev.rid].extend(ev.tokens)
    assert set(finals) == {r.rid for r in reqs}
    expect = {c.rid: c.tokens for c in router.run(list(reqs))}
    for r in reqs:
        np.testing.assert_array_equal(np.asarray(chunks[r.rid], np.int32),
                                      expect[r.rid])
    for rep in router.replicas:
        assert rep.scheduler.on_event is None


def test_cluster_drain_failover_requeues_and_completes(smollm, replicas4):
    """Disabling a replica mid-flight requeues its queued-but-unplaced
    requests onto the survivors; its admitted requests finish in place;
    every output stays bit-identical to generate()."""
    params, cfg = smollm
    reqs = _workload(cfg, n=8, seed=5)
    router = _router(replicas4[:2], policy="rr", max_queue=2)
    for rep in router.replicas:
        rep.begin_run()
    for r in reqs:
        router.submit(r)
    router.place()
    victim = router.replicas[1]
    assert victim.placed > 0
    victim.step()                         # admit (sticky) some to slots
    router.place()                        # refill the victim's queue
    queued_before = victim.snapshot().queue_depth
    assert queued_before > 0              # there IS a backlog to fail over
    active_on_victim = victim.snapshot().active_slots
    assert active_on_victim > 0           # and admitted work that stays
    orphans = router.disable(1)
    assert len(orphans) == queued_before
    assert router.requeued == len(orphans) > 0
    assert victim.snapshot().queue_depth == 0
    while router.has_work:
        router.place()
        for rep in router.replicas:
            if rep.has_work:
                rep.step()
    done, vdone = [], []
    for rep in router.replicas:
        batch = rep.take_completions()
        if rep is victim:
            vdone = batch
        done.extend(batch)
    assert len(done) == len(reqs)
    assert {c.rid for c in done} == {r.rid for r in reqs}
    for c in done:
        np.testing.assert_array_equal(c.tokens,
                                      _generate(params, cfg, reqs[c.rid]))
    # the drained replica completed exactly the requests it kept (its
    # admitted slots), nothing from the failed-over backlog
    assert len(vdone) == victim.placed
    assert victim.placed <= len(reqs) - len(orphans)
    for rep in router.replicas:
        alloc = rep.engine.allocator
        assert alloc.num_free == alloc.num_blocks - 1
    router.enable(1)


def test_run_preserves_presubmitted_requests(smollm, replicas4):
    """A request submit()ed directly to the router before run() drains
    with that run instead of being dropped — the same semantics as
    submitting to a ServingEngine ahead of run()."""
    _, cfg = smollm
    reqs = _workload(cfg, n=4, seed=8)
    router = _router(replicas4[:2], policy="least-loaded")
    router.submit(reqs[0])
    done = router.run(list(reqs[1:]))
    assert {c.rid for c in done} == {r.rid for r in reqs}


def test_all_replicas_disabled_raises(smollm, replicas4):
    _, cfg = smollm
    router = _router(replicas4[:2], policy="rr")
    router.disable(0)
    router.disable(1)
    with pytest.raises(RuntimeError):
        router.run(_workload(cfg, n=2, seed=6))
    router.enable(0)
    router.enable(1)


def test_summarize_cluster_and_snapshot_telemetry(smollm, replicas4):
    params, cfg = smollm
    reqs = _workload(cfg, n=6, seed=7)
    router = _router(replicas4[:2], policy="prefix")
    for rep in router.replicas:
        rep.reset_prefix_cache()
    done = router.run(list(reqs))
    stats = summarize_cluster(done, router.wall_time, router)
    cl = stats["cluster"]
    assert cl["policy"] == "prefix-affinity" and cl["replicas"] == 2
    assert sum(cl["placed"]) == len(reqs)
    assert cl["prompt_tokens"] == sum(len(r.prompt) for r in reqs)
    assert cl["cached_prompt_tokens"] > 0        # tenants re-hit prefixes
    assert stats["requests"] == len(reqs) and stats["tokens_per_s"] > 0
    per = cl["per_replica"]
    assert [p["replica"] for p in per] == [0, 1]
    assert all(p["warm_blocks"] >= 0 for p in per)
    snap = router.replicas[0].snapshot()
    assert snap.active_slots == 0 and snap.queue_depth == 0
    assert snap.load == 0 and snap.enabled


def test_scheduler_stats_accessor_lifecycle(smollm):
    """The structured occupancy accessor: queue/slot/block numbers track
    submit -> admit -> completion without poking scheduler internals."""
    params, cfg = smollm
    eng = ServingEngine(params, cfg, num_slots=2, block_size=4,
                        max_seq_len=32, device="cpu", now_fn=CLOCK)
    s0 = eng.stats()
    assert s0.queue_depth == 0 and s0.active_slots == 0
    assert s0.free_slots == 2 and s0.reserved_blocks == 0
    assert s0.free_blocks == eng.allocator.num_blocks - 1
    reqs = [Request(rid=i, prompt=np.arange(8, dtype=np.int32),
                    max_new_tokens=4) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    assert eng.stats().queue_depth == 3
    eng.scheduler.admit()
    s1 = eng.stats()
    assert s1.active_slots == 2 and s1.free_slots == 0
    assert s1.queue_depth == 1                   # third request waits
    assert s1.free_blocks < s0.free_blocks       # prompt blocks bound
    assert s1.reserved_blocks > 0                # generation budget held
    assert s1.load == 3
    eng.run([])                                  # drain the live slots
    s2 = eng.stats()
    assert s2.active_slots == 0 and s2.queue_depth == 0
    assert s2.free_blocks == s0.free_blocks and s2.reserved_blocks == 0


def test_multi_tenant_workload_generator():
    reqs = multi_tenant_requests(24, vocab_size=100, n_tenants=3,
                                 prefix_len=16, suffix_len=(2, 6),
                                 max_new=(2, 4), seed=1)
    prefixes = {r.prompt[:16].tobytes() for r in reqs}
    assert len(prefixes) == 3                    # three live tenants
    # interleaved arrivals: the first few requests span > 1 tenant
    assert len({r.prompt[:16].tobytes() for r in reqs[:4]}) > 1
    assert all(18 <= len(r.prompt) <= 22 for r in reqs)
    # per-tenant prefix lengths from a range land in different buckets
    ranged = multi_tenant_requests(12, vocab_size=100, n_tenants=4,
                                   prefix_len=(8, 32), suffix_len=2,
                                   max_new=(2, 3), seed=2)
    assert len({len(r.prompt) for r in ranged}) > 1
    # sampling stamps per-request seeds
    sampled = multi_tenant_requests(4, vocab_size=100, n_tenants=2,
                                    sampling=SamplingParams(
                                        temperature=0.8, seed=5), seed=3)
    assert [r.sampling.seed for r in sampled] == [5, 6, 7, 8]


# ----------------------------------------------------------------------------
# property: cluster outputs are bit-identical across replica counts and
# policies (the distributed form of batch-composition independence)
# ----------------------------------------------------------------------------

def test_cluster_outputs_invariant_one_two_four_replicas(smollm, replicas4,
                                                         single_engine):
    """Deterministic slice of the property below (runs even without
    hypothesis): one mixed greedy+sampled multi-tenant workload,
    bit-identical to the single engine across 1 vs 2 vs 4 replicas and
    all three policies, every replica's blocks back after each run."""
    _, cfg = smollm
    reqs = multi_tenant_requests(5, vocab_size=cfg.vocab_size,
                                 n_tenants=2, prefix_len=(6, 14),
                                 suffix_len=(1, 4), max_new=(2, 4),
                                 sampling=SamplingParams(temperature=0.9,
                                                         top_k=4, seed=13),
                                 seed=13)
    reqs[0].sampling = SamplingParams(max_new_tokens=3)    # greedy lane
    expect = {c.rid: c.tokens for c in single_engine.run(list(reqs))}
    for policy in POLICIES:
        for count in (1, 2, 4):
            router = _router(replicas4[:count], policy=policy)
            done = router.run(list(reqs))
            assert len(done) == len(reqs), (policy, count)
            for c in done:
                np.testing.assert_array_equal(c.tokens, expect[c.rid],
                                              err_msg=f"{policy}/{count}")
            for rep in router.replicas:
                alloc = rep.engine.allocator
                assert alloc.num_free == alloc.num_blocks - 1


@settings(max_examples=5, deadline=None, database=None)
@given(seed=st.integers(0, 2**20), n=st.integers(3, 6),
       n_tenants=st.integers(1, 3),
       policy=st.sampled_from(["rr", "least-loaded", "prefix"]),
       temperature=st.sampled_from([0.0, 0.9]))
def test_cluster_outputs_invariant_to_replica_count(smollm, replicas4,
                                                    single_engine, seed, n,
                                                    n_tenants, policy,
                                                    temperature):
    """Property: per-request outputs are bit-identical across 1 vs 2 vs
    4 replicas and across all three policies — greedy and sampled
    lanes, with speculation enabled throughout."""
    _, cfg = smollm
    sampling = (None if temperature == 0.0 else
                SamplingParams(temperature=temperature, top_k=4,
                               seed=seed))
    reqs = multi_tenant_requests(n, vocab_size=cfg.vocab_size,
                                 n_tenants=n_tenants, prefix_len=(6, 14),
                                 suffix_len=(1, 4), max_new=(2, 4),
                                 sampling=sampling, seed=seed)
    expect = {c.rid: c.tokens for c in single_engine.run(list(reqs))}
    for count in (1, 2, 4):
        router = _router(replicas4[:count], policy=policy)
        done = router.run(list(reqs))
        assert len(done) == len(reqs)
        for c in done:
            np.testing.assert_array_equal(c.tokens, expect[c.rid])


# ----------------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_replicas():
    """Two JAX replicas on the reduced smollm's PRNGKey(0) weights, with
    the engine settings of the port's replicas."""
    pytest.importorskip("jax")
    from repro.serving.replica import Replica as JReplica
    jcfg, jparams, _, _ = _torch_models.reduced_models("smollm-135m")
    kw = {k: v for k, v in _ENGINE_KW.items() if k not in ("device",
                                                           "now_fn")}
    return [JReplica(jparams, jcfg, replica_id=i, **kw) for i in range(2)]


@pytest.mark.parametrize("policy", ["rr", "least-loaded", "prefix"])
def test_router_places_as_jax_router(smollm, replicas4, jax_replicas,
                                     policy):
    """One multi-tenant stream (8 requests over 3 tenants, all at t=0)
    through the JAX Router and the port's, 2 replicas each, cold prefix
    caches: every request lands on the same replica with the same
    tokens, and the per-replica placement and cached-prompt counts
    agree."""
    from repro.serving.engine import \
        multi_tenant_requests as jmulti_tenant  # noqa: E402
    from repro.serving.router import Router as JRouter
    from repro.serving.router import summarize_cluster as jsummarize
    _, cfg = smollm
    kw = dict(vocab_size=cfg.vocab_size, n_tenants=3, prefix_len=12,
              suffix_len=(1, 5), max_new=(2, 5), seed=11)
    treqs = multi_tenant_requests(8, **kw)
    jreqs = jmulti_tenant(8, **kw)
    for a, b in zip(treqs, jreqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.arrival, a.max_new_tokens) == (0.0, b.max_new_tokens)
    for rep in replicas4[:2] + jax_replicas:
        rep.reset_prefix_cache()
    jrouter = JRouter(jax_replicas, policy=policy)
    jdone = {c.rid: c.tokens for c in jrouter.run(jreqs)}
    trouter = _router(replicas4[:2], policy=policy)
    tdone = {c.rid: c.tokens for c in trouter.run(treqs)}
    assert set(tdone) == set(jdone) == {r.rid for r in treqs}
    for r in treqs:
        assert trouter.placement_of(r.rid) == jrouter.placement_of(r.rid)
        np.testing.assert_array_equal(tdone[r.rid], np.asarray(jdone[r.rid]))
    tcl = summarize_cluster(list(), 1.0, trouter)["cluster"]
    jcl = jsummarize(list(), 1.0, jrouter)["cluster"]
    for key in ("policy", "placed", "prompt_tokens", "cached_prompt_tokens",
                "requeued"):
        assert tcl[key] == jcl[key], key
    assert min(tcl["placed"]) > 0          # both replicas took requests


def test_replica_probe_counts_spilled_tokens_readonly():
    """tests/test_kv_quant.py's probe test on the port: after a run that
    demotes prefix blocks to the host tier, probe_prefix sees the
    spilled prefix without reviving anything, and the snapshot reports
    the allocator's spilled blocks."""
    _, _, cfg, params = _torch_models.reduced_models("smollm-135m")

    def reqs():
        return shared_prefix_requests(16, vocab_size=cfg.vocab_size,
                                      prefix_len=48, suffix_len=(8, 16),
                                      max_new=(4, 8), n_prefixes=4, seed=0)

    rep = Replica(params, cfg, num_slots=2, block_size=16, max_seq_len=96,
                  prefix_cache=True, num_blocks=13, host_cache_blocks=32,
                  device="cpu", now_fn=StepClock())
    rep.engine.run(reqs())
    rev0 = rep.engine.allocator.host_revivals
    probe = rep.probe_prefix(reqs()[0].prompt)
    assert probe >= 48                       # sees the spilled prefix
    assert rep.engine.allocator.host_revivals == rev0  # probe is read-only
    assert rep.snapshot().spilled_blocks == rep.engine.allocator.num_spilled
    assert rep.snapshot().spilled_blocks > 0
