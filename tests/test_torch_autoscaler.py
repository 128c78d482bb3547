"""The port's autoscaler (`repro_torch.serving.autoscaler`) on the CPU: the
19 tests of tests/test_autoscaler.py over the port (the
AutoscaleController state machine over synthetic stat series — scale-out
latency bound, hysteresis / no flapping, cooldown spacing, min / max
clamps — the Autoscaler lifecycle over a real Router with stub replicas —
standby activation, drain + reclaim, per-run reset, elastic membership
guards — and the bursty / multi-tenant generators), then parity with the
JAX package (one synthetic occupancy series through both controllers:
equal decisions at every sample) and an autoscaled cluster of real
engines on a step clock (`_torch_cpu.StepClock`): a burst at t=0 scales
out, every request completes with the single engine's tokens, and every
replica's blocks come back."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import StepClock, time_limit  # noqa: E402,F401

_torch_cpu.share_cores()

from repro_torch.serving.autoscaler import (Autoscaler,  # noqa: E402
                                            AutoscaleController,
                                            AutoscalePolicy)
from repro_torch.serving.replica import ReplicaSnapshot  # noqa: E402
from repro_torch.serving.router import Router  # noqa: E402
from repro_torch.serving.scheduler import SchedulerStats  # noqa: E402

import _torch_models  # noqa: E402

pytestmark = pytest.mark.serving


# ----------------------------------------------------------------------------
# controller units over synthetic series
# ----------------------------------------------------------------------------

def _policy(**kw):
    base = dict(min_replicas=1, max_replicas=4, queue_high=2.0,
                queue_low=1.0, high_window_s=0.1, low_window_s=0.2,
                cooldown_s=0.0)
    base.update(kw)
    return AutoscalePolicy(**base)


def test_policy_validation():
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=0)
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        AutoscalePolicy(queue_high=1.0, queue_low=1.0)


def test_scale_out_latency_bound():
    """Sustained pressure must convert to a scale-out within one sample
    period past the high window — the reaction-time guarantee."""
    ctl = AutoscaleController(_policy())
    fired = None
    for i in range(20):
        t = i * 0.02
        if ctl.observe(t, queue_depth=10, active_slots=2,
                       n_replicas=1) == "out":
            fired = t
            break
    assert fired is not None
    assert 0.1 <= fired <= 0.12 + 1e-9


def test_no_decision_on_oscillating_series():
    """A queue that blips above the threshold but never SUSTAINS it must
    never scale — the window resets on every dip (anti-flapping)."""
    ctl = AutoscaleController(_policy(high_window_s=0.1, low_window_s=9.0))
    for i in range(200):
        qd = 10 if i % 2 == 0 else 0
        # 0.05s samples: each high stretch lasts < high_window_s
        assert ctl.observe(i * 0.05, qd, 2, 1) is None


def test_decision_consumes_window_and_cooldown_spaces_decisions():
    """Back-to-back scale-outs under constant pressure are spaced by at
    least cooldown AND a fresh sustain window each."""
    ctl = AutoscaleController(_policy(cooldown_s=0.25))
    fired = []
    for i in range(100):
        t = i * 0.02
        if ctl.observe(t, 10, 2, 1) == "out":
            fired.append(t)
    assert len(fired) >= 2
    gaps = np.diff(fired)
    assert (gaps >= 0.25 - 1e-9).all()
    assert (gaps >= 0.1 - 1e-9).all()       # window re-accumulates too


def test_min_max_clamps():
    ctl = AutoscaleController(_policy(max_replicas=2))
    # at the ceiling: sustained pressure never scales out
    for i in range(30):
        assert ctl.observe(i * 0.02, 10, 2, 2) is None
    ctl = AutoscaleController(_policy())
    # at the floor: sustained idleness never scales in
    for i in range(30):
        assert ctl.observe(i * 0.02, 0, 0, 1) is None


def test_scale_in_after_sustained_idle_and_hysteresis_band():
    ctl = AutoscaleController(_policy())
    fired = None
    for i in range(30):
        t = i * 0.02
        if ctl.observe(t, 0, 0, 2) == "in":
            fired = t
            break
    assert fired is not None and fired >= 0.2 - 1e-9
    # load in the hysteresis band (between low and high): no decision
    ctl = AutoscaleController(_policy())
    for i in range(50):
        # per-replica queue 1.5: above queue_low, below queue_high
        assert ctl.observe(i * 0.02, 3, 0, 2) is None


def test_reset_clears_accumulated_windows():
    ctl = AutoscaleController(_policy())
    ctl.observe(0.0, 10, 2, 1)
    ctl.reset()
    # window restarts: nothing fires until a full fresh window elapses
    assert ctl.observe(0.09, 10, 2, 1) is None
    assert ctl.observe(0.19, 10, 2, 1) == "out"


# ----------------------------------------------------------------------------
# Autoscaler lifecycle over a real Router with stub replicas
# ----------------------------------------------------------------------------

class _StubReplica:
    """Duck-typed replica with settable occupancy + lifecycle spies."""

    def __init__(self, rid, *, slots=2, queue=0, active=0, enabled=True):
        self.replica_id = rid
        self.enabled = enabled
        self.num_slots = slots
        self.queue_depth = queue
        self.active = active
        self.submitted = []
        self.begin_runs = 0
        self.cache_resets = 0
        self.engine = types.SimpleNamespace(
            block_size=4,
            runner=types.SimpleNamespace(prefill_max_batch=slots))
        self.scheduler = types.SimpleNamespace(on_event=None,
                                               preemptions=0, resumes=0)

    def snapshot(self):
        return ReplicaSnapshot(
            replica_id=self.replica_id, enabled=self.enabled,
            stats=SchedulerStats(
                queue_depth=self.queue_depth, active_slots=self.active,
                free_slots=self.num_slots - self.active, free_blocks=99,
                cached_blocks=0, indexed_blocks=0, reserved_blocks=0))

    def probe_prefix(self, prompt):
        return 0

    def submit(self, req):
        self.submitted.append(req)
        self.queue_depth += 1

    @property
    def has_work(self):
        return bool(self.submitted) or self.active > 0

    def take_queued(self):
        out, self.submitted, self.queue_depth = self.submitted, [], 0
        return out

    def take_completions(self):
        return []

    def begin_run(self, t0=None):
        self.begin_runs += 1

    def align_clock(self, t0):
        pass

    def reset_prefix_cache(self):
        self.cache_resets += 1


def _autoscaled_pair():
    base = _StubReplica(0)
    standby = _StubReplica(1)
    router = Router([base], policy="least-loaded")
    asc = Autoscaler(router, policy=_policy(max_replicas=2,
                                            cooldown_s=0.0),
                     standby=[standby])
    return base, standby, router, asc


def test_autoscaler_attaches_and_rejects_duplicate_ids():
    base, standby, router, asc = _autoscaled_pair()
    assert router.autoscaler is asc
    with pytest.raises(ValueError):
        Autoscaler(Router([_StubReplica(0)]), standby=[_StubReplica(0)])


def test_scale_out_activates_standby_then_drain_and_reclaim():
    base, standby, router, asc = _autoscaled_pair()
    base.queue_depth, base.active = 6, 2
    assert asc.tick(0.0) is None                  # window accumulating
    assert asc.tick(0.11) == "out"
    assert standby in router.replicas and standby.enabled
    assert asc.scale_out_events == 1 and not asc._standby
    # burst passes: both replicas idle -> drain the ADDED one
    base.queue_depth = base.active = 0
    assert asc.tick(0.2) is None                  # low window accumulating
    assert asc.tick(0.45) == "in"
    assert not standby.enabled and asc.scale_in_events == 1
    assert standby in router.replicas             # still draining
    # drained stub has no work -> reclaimed to standby, cache dropped
    resets = standby.cache_resets
    assert asc.tick(0.5) is None
    assert standby not in router.replicas
    assert asc._standby == [standby] and asc.reclaims == 1
    assert standby.cache_resets == resets + 1
    assert [e["event"] for e in asc.events] == ["scale-out", "scale-in",
                                                "reclaim"]


def test_draining_replica_with_work_is_not_reclaimed():
    base, standby, router, asc = _autoscaled_pair()
    base.queue_depth, base.active = 6, 2
    asc.tick(0.0)
    asc.tick(0.11)                                # scale-out
    standby.active = 1                            # running a lane
    base.queue_depth = base.active = 0
    asc.tick(0.2)
    asc.tick(0.45)                                # scale-in -> draining
    asc.tick(0.5)
    assert standby in router.replicas and asc.reclaims == 0
    standby.active = 0                            # lane finished
    asc.tick(0.55)
    assert standby not in router.replicas and asc.reclaims == 1


def test_scale_out_cancels_drain_before_touching_standby():
    base, standby, router, asc = _autoscaled_pair()
    base.queue_depth, base.active = 6, 2
    asc.tick(0.0)
    asc.tick(0.11)                                # out: standby joins
    standby.active = 1                            # keeps it draining
    base.queue_depth = base.active = 0
    asc.tick(0.2)
    asc.tick(0.45)                                # in: standby drains
    assert not standby.enabled
    base.queue_depth, base.active = 6, 2          # pressure returns
    standby.queue_depth = 0
    asc.tick(0.5)
    assert asc.tick(0.61) == "out"
    assert standby.enabled                        # drain cancelled,
    assert asc._standby == []                     # no pool churn


def test_skipped_scale_out_when_no_capacity_source():
    base = _StubReplica(0)
    router = Router([base])
    asc = Autoscaler(router, policy=_policy(max_replicas=2,
                                            cooldown_s=0.0))
    base.queue_depth, base.active = 6, 2
    asc.tick(0.0)
    assert asc.tick(0.11) is None
    assert asc.skipped_scale_outs == 1 and asc.scale_out_events == 0


def test_spawn_factory_used_when_standby_empty():
    base = _StubReplica(0)
    router = Router([base])
    spawned = []

    def spawn(rid):
        rep = _StubReplica(rid)
        spawned.append(rep)
        return rep

    asc = Autoscaler(router, policy=_policy(max_replicas=2,
                                            cooldown_s=0.0), spawn=spawn)
    base.queue_depth, base.active = 6, 2
    asc.tick(0.0)
    assert asc.tick(0.11) == "out"
    assert spawned and spawned[0].replica_id == 1   # fresh unique id
    assert spawned[0] in router.replicas


def test_begin_run_retires_added_replicas_and_reenables_base():
    base, standby, router, asc = _autoscaled_pair()
    base.queue_depth, base.active = 6, 2
    asc.tick(0.0)
    asc.tick(0.11)                                # standby joined
    base.enabled = False                          # e.g. drained last run
    asc.begin_run(0.0)
    assert router.replicas == [base] and base.enabled
    assert asc._standby == [standby]
    assert standby.begin_runs >= 1                # clean telemetry
    assert asc.scale_out_events == 0 and asc.events == []
    assert asc.summary()["standby_replicas"] == 1


def test_router_membership_guards():
    base, standby, router, asc = _autoscaled_pair()
    with pytest.raises(RuntimeError):
        router.remove_replica(0)                  # never the last one
    base.queue_depth, base.active = 6, 2
    asc.tick(0.0)
    asc.tick(0.11)
    with pytest.raises(ValueError):
        router.add_replica(_StubReplica(1))       # duplicate id
    base.active = 1
    base.queue_depth = 0
    with pytest.raises(RuntimeError):
        router.remove_replica(0)                  # still has work
    with pytest.raises(KeyError):
        router.remove_replica(7)


def test_bursty_workload_reproducible_and_actually_bursty():
    from repro_torch.serving.engine import bursty_requests
    kw = dict(vocab_size=100, base_rate=1.0, burst_rate=200.0,
              burst_every=100.0, burst_len=0.1, priorities=(0, 1, 2))
    a = bursty_requests(40, seed=5, **kw)
    b = bursty_requests(40, seed=5, **kw)
    assert all(np.array_equal(x.prompt, y.prompt) and
               x.arrival == y.arrival and x.priority == y.priority
               for x, y in zip(a, b))                 # seeded
    arr = np.array([r.arrival for r in a])
    assert (np.diff(arr) > 0).all()                    # strictly ordered
    # the burst is real: ~burst_rate*burst_len arrivals land inside the
    # window, the rest trickle at base_rate (so they span seconds)
    assert (arr <= 0.1).sum() >= 12
    assert arr[-1] > 5.0
    assert {r.priority for r in a} <= {0, 1, 2}
    c = bursty_requests(40, seed=6, **kw)
    assert any(x.arrival != y.arrival for x, y in zip(a, c))


def test_bursty_workload_weights_and_validation():
    from repro_torch.serving.engine import bursty_requests
    reqs = bursty_requests(16, vocab_size=50, priorities=(0, 5),
                           priority_weights=(0.0, 1.0), seed=0)
    assert all(r.priority == 5 for r in reqs)
    with pytest.raises(ValueError):
        bursty_requests(4, vocab_size=50, priorities=(0, 1),
                        priority_weights=(1.0,))
    with pytest.raises(ValueError):
        bursty_requests(4, vocab_size=50, base_rate=0.0)


def test_multi_tenant_priority_mix_keeps_rng_stream():
    """tenant_priorities stamps classes per tenant WITHOUT consuming
    extra rng draws — committed bench records depend on the stream."""
    from repro_torch.serving.engine import multi_tenant_requests
    base = multi_tenant_requests(12, vocab_size=50, n_tenants=3, seed=3)
    pri = multi_tenant_requests(12, vocab_size=50, n_tenants=3, seed=3,
                                tenant_priorities=[2, 0, 1])
    assert all(np.array_equal(x.prompt, y.prompt) and
               x.arrival == y.arrival and
               x.max_new_tokens == y.max_new_tokens
               for x, y in zip(base, pri))
    assert {r.priority for r in base} == {0}
    assert {r.priority for r in pri} <= {0, 1, 2}
    assert any(r.priority > 0 for r in pri)
    # weights skew traffic: all mass on tenant 0 -> one shared prefix
    skew = multi_tenant_requests(12, vocab_size=50, n_tenants=3, seed=3,
                                 tenant_weights=[1.0, 0.0, 0.0],
                                 tenant_priorities=[4, 0, 0])
    assert all(r.priority == 4 for r in skew)
    with pytest.raises(ValueError):
        multi_tenant_requests(4, vocab_size=50, n_tenants=3,
                              tenant_priorities=[1])
    with pytest.raises(ValueError):
        multi_tenant_requests(4, vocab_size=50, n_tenants=3,
                              tenant_weights=[0.5, 0.5])


def test_summary_shape():
    _, _, _, asc = _autoscaled_pair()
    s = asc.summary()
    assert s["policy"]["max_replicas"] == 2
    assert s["enabled_replicas"] == 1 and s["standby_replicas"] == 1
    for key in ("scale_out_events", "scale_in_events", "reclaims",
                "skipped_scale_outs", "events"):
        assert key in s


# ----------------------------------------------------------------------------
# parity with the JAX package, and a real autoscaled cluster
# ----------------------------------------------------------------------------

def _series(n=400, seed=0):
    """A synthetic occupancy series (t, queue_depth, active_slots,
    n_replicas): bursts of queue pressure, idle stretches and blips,
    sampled at uneven steps, with the replica count following the
    decisions of the controller that reads it."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.uniform(0.005, 0.04))
        phase = (i // 40) % 4
        if phase == 0:                  # burst
            qd, act = int(rng.integers(4, 14)), 2
        elif phase == 1:                # blips around the high band
            qd, act = int(rng.integers(0, 6)), int(rng.integers(0, 3))
        elif phase == 2:                # idle
            qd, act = 0, int(rng.integers(0, 2))
        else:                           # the hysteresis band
            qd, act = int(rng.integers(1, 4)), int(rng.integers(0, 3))
        out.append((t, qd, act))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cooldown", [0.0, 0.25])
def test_controller_decisions_equal_jax(seed, cooldown):
    """AutoscaleController fed one synthetic series in both packages (the
    replica count moved by each side's own decisions): the same decision
    at every sample, scale-outs and scale-ins both among them."""
    jax_autoscaler = pytest.importorskip("repro.serving.autoscaler")
    kw = dict(min_replicas=1, max_replicas=4, queue_high=2.0,
              queue_low=1.0, high_window_s=0.1, low_window_s=0.2,
              cooldown_s=cooldown)
    t_ctl = AutoscaleController(AutoscalePolicy(**kw))
    j_ctl = jax_autoscaler.AutoscaleController(
        jax_autoscaler.AutoscalePolicy(**kw))
    n_t = n_j = 1
    decisions = []
    for t, qd, act in _series(seed=seed):
        a = t_ctl.observe(t, qd, act, n_t)
        b = j_ctl.observe(t, qd, act, n_j)
        assert a == b, (t, qd, act, a, b)
        n_t += {"out": 1, "in": -1}.get(a, 0)
        n_j += {"out": 1, "in": -1}.get(b, 0)
        decisions.append(a)
    assert "out" in decisions and "in" in decisions


def test_autoscaled_cluster_scales_out_with_single_engine_tokens():
    """A burst of 12 requests at t=0 on a 1-replica cluster with two
    standby stacks, on a step clock (10 ms a reading, ~3 readings a
    cluster sweep, so the 0.1 s high window spans a few sweeps): at least one
    scale-out, every request completes with the single engine's tokens,
    every replica (standby included) has all its blocks back, and
    summary() records the events. A second run retires the added
    replicas first and repeats the first run's tokens."""
    from repro_torch.serving.engine import ServingEngine, bursty_requests
    from repro_torch.serving.replica import Replica
    from repro_torch.serving.router import summarize_cluster
    _, _, cfg, params = _torch_models.reduced_models("smollm-135m")
    clock = StepClock(0.01)
    kw = dict(num_slots=2, block_size=4, max_seq_len=48,
              prefill_max_batch=2, device="cpu", now_fn=clock)

    def reqs():
        out = bursty_requests(12, vocab_size=cfg.vocab_size, base_rate=1.0,
                              burst_rate=100.0, prompt_len=(8, 16),
                              max_new=(3, 6), seed=4)
        for r in out:
            r.arrival = 0.0
        return out

    want = {c.rid: c.tokens.tolist()
            for c in ServingEngine(params, cfg, **kw).run(reqs())}
    replicas = [Replica(params, cfg, replica_id=i, **kw) for i in range(3)]
    router = Router(replicas[:1], policy="least-loaded", now_fn=clock)
    asc = Autoscaler(router, policy=AutoscalePolicy(
        min_replicas=1, max_replicas=3, cooldown_s=0.05),
        standby=replicas[1:])
    for run in range(2):
        done = router.run(reqs())
        assert {c.rid: c.tokens.tolist() for c in done} == want, run
        assert asc.scale_out_events >= 1, run
        s = asc.summary()
        assert s["scale_out_events"] == asc.scale_out_events
        assert [e["event"] for e in s["events"]][0] == "scale-out"
        for rep in replicas:
            alloc = rep.engine.allocator
            assert alloc.num_free == alloc.num_blocks - 1
        stats = summarize_cluster(done, router.wall_time, router)
        assert stats["cluster"]["autoscaler"]["scale_out_events"] >= 1
        assert sum(r.placed for r in replicas) == len(want)
