"""The port's SLO layer beyond the quantile sketch's bound (that is in
tests/test_torch_slo.py), on the CPU: tests/test_slo.py's other tests over
`repro_torch.serving` — the sketch's clamps, reset and dump; burn-rate
window semantics; SLOSignal's scaling decisions; the flight recorder's
bounded ring and anomaly detectors; the diurnal generator; the v2 / v1
metrics-dump schema and the trace's flight-recorder block; deadline
validation; and through the engine, on a step clock
(`_torch_cpu.StepClock`): the bit-identity gate (tracker, armed shedder
and recorder on, nothing shed: tokens unchanged), shedding of hopeless
deadlines, EDF deferral that changes no token, the metrics dump's
sketches, diurnal traffic. Then parity with the JAX package: SLOTracker
burn rates, breaches and snapshot within 1e-12 of JAX's on one
completion series (quantiles through the port's repaired bucket point,
exactly the JAX midpoint times 4 gamma / (1 + gamma)^2), SLOSignal's
decisions equal on one series, and one engine run's exports valid under
both packages' validators at schema v1 and v2."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import StepClock, time_limit  # noqa: E402,F401

_torch_cpu.share_cores()

from repro_torch.serving.engine import (ServingEngine,  # noqa: E402
                                        diurnal_requests, summarize,
                                        synthetic_requests)
from repro_torch.serving.observability import (  # noqa: E402
    METRICS_SCHEMA, METRICS_SCHEMAS, FlightRecorder, Observability,
    metrics_dump, to_perfetto, validate_metrics_dump, validate_trace_events)
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from repro_torch.serving.slo import (QuantileSketch, SLOPolicy,  # noqa: E402
                                     SLOSignal, SLOTracker)

import _torch_models  # noqa: E402

pytestmark = pytest.mark.serving


# ----------------------------------------------------------------------------
# the sketch beyond its bound, policy + burn-rate windows
# ----------------------------------------------------------------------------

def test_sketch_clamps_and_memory_is_fixed():
    sk = QuantileSketch(0.01, min_value=1e-3, max_value=10.0)
    n_buckets = len(sk.counts)
    for v in (-1.0, 0.0, 1e-9, 5.0, 100.0, 1e9):
        sk.observe(v)
    assert len(sk.counts) == n_buckets       # never grows
    assert sk.quantile(0.0) == sk.min_value  # floor clamp
    assert sk.quantile(1.0) <= 10.0 * (1 + 0.01) * 2  # ceiling clamp
    with pytest.raises(ValueError):
        sk.quantile(1.5)
    with pytest.raises(ValueError):
        QuantileSketch(0.0)
    with pytest.raises(ValueError):
        QuantileSketch(0.01, min_value=2.0, max_value=1.0)


def test_sketch_empty_reset_and_dump():
    sk = QuantileSketch(0.01)
    assert sk.quantile(0.5) is None and sk.mean == 0.0
    sk.observe(1.0)
    sk.observe(3.0)
    assert sk.mean == 2.0
    d = sk.to_dict()
    assert d["count"] == 2 and d["sum"] == 4.0
    assert sum(c for _, c in d["buckets"]) == 2
    sk.reset()
    assert sk.count == 0 and sk.quantile(0.5) is None


def test_policy_validation_and_class_objectives():
    p = SLOPolicy(ttft_objective_ms=100.0, class_ttft_ms=((2, 50.0),))
    assert p.ttft_objective_s(0) == 0.1
    assert p.ttft_objective_s(2) == 0.05
    assert p.latency_objective_s() is None
    for bad in (dict(ttft_objective_ms=0),
                dict(class_ttft_ms=((1, -5.0),)),
                dict(latency_objective_ms=0.0),
                dict(error_budget=0.0), dict(error_budget=1.0),
                dict(fast_window_s=2.0, slow_window_s=1.0)):
        with pytest.raises(ValueError):
            SLOPolicy(**bad)


def test_burn_rate_math_and_idle_semantics():
    tr = SLOTracker(SLOPolicy(ttft_objective_ms=200.0, error_budget=0.1,
                              fast_window_s=0.25, slow_window_s=1.0))
    # cold: no observation ever -> no burn defined (None, not 0)
    assert tr.burn_rate(0.0, 1.0) is None
    assert tr.tick(0.0) == (None, None)
    # half the observations breach -> fraction 0.5 -> burn 5.0 at
    # budget 0.1
    for i in range(20):
        t = i * 0.05
        breached = tr.observe_ttft(t, 0.5 if i % 2 else 0.01)
        assert breached == bool(i % 2)
    assert tr.burn_rate(0.95, 1.0) == pytest.approx(5.0)
    assert tr.breaches["ttft"] == 10
    fast, slow = tr.tick(0.95)
    assert slow == pytest.approx(5.0)
    assert tr.peak_burn["slow"] == pytest.approx(5.0)
    # idle after traffic: the window drains to burn 0.0, never None
    assert tr.burn_rate(60.0, 1.0) == 0.0
    tr.reset()
    assert tr.burn_rate(61.0, 1.0) is None   # reset forgets `ever` too
    assert tr.breaches["ttft"] == 0 and tr.peak_burn["fast"] == 0.0


def test_tracker_quantiles_per_class_and_merged():
    tr = SLOTracker(SLOPolicy(ttft_objective_ms=100.0))
    for _ in range(50):
        tr.observe_ttft(0.0, 0.01, priority=0)    # fast class
        tr.observe_ttft(0.0, 1.0, priority=1)     # slow class
    assert tr.ttft_quantile(0.5, priority=0) == pytest.approx(0.01,
                                                              rel=0.02)
    assert tr.ttft_quantile(0.5, priority=1) == pytest.approx(1.0,
                                                              rel=0.02)
    # merged across classes: the median straddles both populations
    assert tr.ttft_quantile(0.25) == pytest.approx(0.01, rel=0.02)
    assert tr.ttft_quantile(0.75) == pytest.approx(1.0, rel=0.02)
    assert tr.ttft_quantile(0.5, priority=9) is None
    rows = tr.sketch_rows()
    assert {r["name"] for r in rows} == {"slo_ttft_sketch"}
    assert {r["labels"]["priority"] for r in rows} == {0, 1}
    snap = tr.snapshot()
    assert snap["observed"]["ttft"] == 100
    assert snap["ttft_p50_ms"] is not None


def test_latency_objective_only_feeds_window_when_declared():
    tr = SLOTracker(SLOPolicy(ttft_objective_ms=100.0))
    assert tr.observe_latency(0.0, 99.0) is False    # no objective
    assert tr.burn_rate(0.0, 1.0, metric="latency") is None
    tr2 = SLOTracker(SLOPolicy(ttft_objective_ms=100.0,
                               latency_objective_ms=50.0))
    assert tr2.observe_latency(0.0, 0.2) is True
    assert tr2.breaches["latency"] == 1


# ----------------------------------------------------------------------------
# the burn-rate autoscale signal
# ----------------------------------------------------------------------------

def _signal(**kw):
    from repro_torch.serving.autoscaler import AutoscalePolicy
    slo = SLOPolicy(ttft_objective_ms=100.0, error_budget=0.1)
    tr = SLOTracker(slo)
    asp = AutoscalePolicy(min_replicas=1, max_replicas=3,
                          high_window_s=0.1, low_window_s=0.2,
                          cooldown_s=kw.pop("cooldown_s", 0.0))
    return tr, SLOSignal(tr, asp, **kw)


def test_slo_signal_scales_out_on_sustained_burn():
    tr, sig = _signal()
    fired = None
    for i in range(30):
        t = i * 0.02
        tr.observe_ttft(t, 0.5)       # every request breaches
        if sig.observe(t, 0, 0, 1) == "out":
            fired = t
            break
    assert fired is not None and fired >= 0.1


def test_slo_signal_cold_cluster_never_scales():
    tr, sig = _signal()
    for i in range(30):
        assert sig.observe(i * 0.02, 99, 2, 1) is None  # queue ignored


def test_slo_signal_scales_in_when_burn_well_under_budget():
    tr, sig = _signal()
    tr.observe_ttft(0.0, 0.01)        # healthy traffic, burn 0
    fired = None
    for i in range(40):
        t = i * 0.02
        if sig.observe(t, 0, 0, 2) == "in":
            fired = t
            break
    assert fired is not None and fired >= 0.2
    # at the floor the same series never scales in
    tr2, sig2 = _signal()
    tr2.observe_ttft(0.0, 0.01)
    for i in range(40):
        assert sig2.observe(i * 0.02, 0, 0, 1) is None


def test_slo_signal_cooldown_and_reset():
    tr, sig = _signal(cooldown_s=0.3)
    fired = []
    for i in range(60):
        t = i * 0.02
        tr.observe_ttft(t, 0.5)
        if sig.observe(t, 0, 0, 1) == "out":
            fired.append(t)
    assert len(fired) >= 2
    assert (np.diff(fired) >= 0.3 - 1e-9).all()
    sig.reset()
    assert sig._above_since is None and sig._last_decision == -math.inf
    with pytest.raises(ValueError):
        SLOSignal(tr, sig.policy, scale_out_burn=0.2, scale_in_burn=0.5)


# ----------------------------------------------------------------------------
# flight recorder, diurnal workload, schemas
# ----------------------------------------------------------------------------

def test_flight_recorder_ring_bounded_and_dump_valid(tmp_path):
    fr = FlightRecorder(capacity=8)
    for i in range(40):
        fr.append("instant", {"name": f"e{i}", "cat": "step",
                              "t": float(i), "pid": 0, "tid": 0,
                              "args": {}})
    fr.breach(40.0, "ttft_breach", rid=7, ttft_ms=500.0)
    doc = fr.dump(str(tmp_path / "flight.json"))
    assert validate_trace_events(doc) == []
    meta = doc["otherData"]["flight_recorder"]
    assert meta["capacity"] == 8 and meta["events"] == 8
    assert meta["dropped"] == 41 - 8
    assert [a["reason"] for a in meta["anomalies"]] == ["ttft_breach"]
    on_disk = json.loads((tmp_path / "flight.json").read_text())
    assert validate_trace_events(on_disk) == []
    assert fr.dumps == 1
    fr.reset()
    assert fr.appended == 0 and not fr.anomalies


def test_flight_recorder_storm_and_thrash_detectors(tmp_path):
    fr = FlightRecorder(preempt_storm=3, evict_thrash=16, window_s=1.0,
                        dump_path=str(tmp_path / "a.json"))
    fr.note_preempt(0.0)
    fr.note_preempt(0.1)
    assert not fr.anomalies                  # below threshold
    fr.note_preempt(0.2)                     # 3 within the window
    assert [a["reason"] for a in fr.anomalies] == ["preempt_storm"]
    assert (tmp_path / "a.json").exists()    # anomaly triggered a dump
    # detector re-arms: the window cleared on firing
    fr.note_preempt(0.3)
    assert len(fr.anomalies) == 1
    # eviction thrash works on counter deltas (skips resets backwards)
    fr.note_evictions(2.0, 4)
    fr.note_evictions(2.1, 0)                # counter reset: ignored
    fr.note_evictions(2.2, 9)                # delta 9: 4+9 < 16
    assert len(fr.anomalies) == 1
    fr.note_evictions(2.3, 16)               # delta 7: 4+9+7 >= 16
    assert [a["reason"] for a in fr.anomalies] == ["preempt_storm",
                                                   "eviction_thrash"]


def test_observability_feeds_recorder_ring():
    fr = FlightRecorder(capacity=16)
    obs = Observability()
    obs.recorder = fr
    obs.begin_run()
    obs.span(1, "step", "step", 0.0, 1.0)
    obs.instant(1, "evt", "step", 1.5)
    assert fr.appended == 2
    doc = fr.to_perfetto()
    assert validate_trace_events(doc) == []
    names = {e["name"] for e in doc["traceEvents"]
             if e.get("ph") in ("X", "i")}
    assert {"step", "evt"} <= names


def test_diurnal_reproducible_ordered_and_actually_diurnal():
    kw = dict(vocab_size=100, rate_min=1.0, rate_max=100.0, period=4.0,
              priorities=(0, 1))
    a = diurnal_requests(200, seed=7, **kw)
    b = diurnal_requests(200, seed=7, **kw)
    assert all(np.array_equal(x.prompt, y.prompt) and
               x.arrival == y.arrival and x.priority == y.priority
               for x, y in zip(a, b))
    arr = np.array([r.arrival for r in a])
    assert (np.diff(arr) > 0).all()
    # the sinusoid starts at the trough and peaks at period/2: far more
    # arrivals land in the mid-cycle half than in the edges
    phase = arr % 4.0
    mid = ((phase > 1.0) & (phase < 3.0)).sum()
    edge = len(arr) - mid
    assert mid > 2 * edge
    c = diurnal_requests(200, seed=8, **kw)
    assert any(x.arrival != y.arrival for x, y in zip(a, c))


def test_diurnal_weights_and_validation():
    reqs = diurnal_requests(16, vocab_size=50, priorities=(0, 3),
                            priority_weights=(0.0, 1.0), seed=0)
    assert all(r.priority == 3 for r in reqs)
    with pytest.raises(ValueError):
        diurnal_requests(4, vocab_size=50, rate_min=0.0)
    with pytest.raises(ValueError):
        diurnal_requests(4, vocab_size=50, rate_min=5.0, rate_max=1.0)
    with pytest.raises(ValueError):
        diurnal_requests(4, vocab_size=50, segments=1)
    with pytest.raises(ValueError):
        diurnal_requests(4, vocab_size=50, priorities=(0, 1),
                         priority_weights=(1.0,))


def test_metrics_schema_v2_and_v1_back_compat():
    assert METRICS_SCHEMA.endswith("/v2")
    assert len(METRICS_SCHEMAS) == 2
    base = {"counters": [], "gauges": [], "histograms": [], "series": []}
    for schema in METRICS_SCHEMAS:           # both generations validate
        assert validate_metrics_dump({"schema": schema, **base}) == []
    assert validate_metrics_dump({"schema": "repro.serving.metrics/v3",
                                  **base}) != []
    good_sketch = {"name": "slo_ttft_sketch", "labels": {"priority": 0},
                   "rel_err": 0.01, "min_value": 1e-5, "max_value": 3600.0,
                   "count": 3, "sum": 1.5, "buckets": [[4, 1], [9, 2]]}
    doc = {"schema": METRICS_SCHEMA, **base, "sketches": [good_sketch]}
    assert validate_metrics_dump(doc) == []
    for corrupt in ({"rel_err": 1.5}, {"count": -1}, {"buckets": [[1]]},
                    {"buckets": [[0, 5]]},    # counts no longer sum
                    {"name": 7}, {"labels": "x"}):
        bad = {**good_sketch, **corrupt}
        assert validate_metrics_dump(
            {"schema": METRICS_SCHEMA, **base, "sketches": [bad]}) != []
    assert validate_metrics_dump(
        {"schema": METRICS_SCHEMA, **base, "slo": "not-a-dict"}) != []


def test_trace_flight_recorder_block_validation():
    base = {"displayTimeUnit": "ms", "otherData": {},
            "traceEvents": []}
    good = {**base, "otherData": {
        "flight_recorder": {"capacity": 8, "events": 3, "dropped": 0,
                            "anomalies": [{"t": 1.0,
                                           "reason": "ttft_breach",
                                           "args": {}}]}}}
    assert validate_trace_events(good) == []
    for corrupt in ({"capacity": -1}, {"events": "x"},
                    {"anomalies": [{"t": "late"}]},
                    {"anomalies": [{"reason": 7, "t": 0.0}]}):
        bad = {**base, "otherData": {"flight_recorder": {
            "capacity": 8, "events": 0, "dropped": 0, "anomalies": [],
            **corrupt}}}
        assert validate_trace_events(bad) != []


def test_sampling_params_deadline_validation():
    assert SamplingParams().deadline_ms is None
    assert SamplingParams(deadline_ms=250.0).deadline_ms == 250.0
    with pytest.raises(ValueError):
        SamplingParams(deadline_ms=0.0)
    with pytest.raises(ValueError):
        SamplingParams(deadline_ms=-10.0)


# ----------------------------------------------------------------------------
# end-to-end on a step clock: shed/defer on a real engine + the
# bit-identity gate
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The reduced smollm-135m at the JAX package's PRNGKey(0) weights,
    in the port's layout."""
    _, _, cfg, params = _torch_models.reduced_models("smollm-135m")
    return params, cfg


KW = dict(num_slots=2, block_size=8, max_seq_len=48, prefill_max_batch=2,
          device="cpu")


def _engine(params, cfg, **kw):
    """An engine on its own step clock: 1 ms a reading."""
    return ServingEngine(params, cfg, now_fn=StepClock(), **KW, **kw)


def _reqs(cfg, n=8, deadline_ms=None, seed=0):
    reqs = synthetic_requests(n, vocab_size=cfg.vocab_size,
                              prompt_len=(8, 16), max_new=(3, 6),
                              seed=seed)
    if deadline_ms is not None:
        for i, r in enumerate(reqs):
            d = deadline_ms[i] if isinstance(deadline_ms, (list, tuple)) \
                else deadline_ms
            r.sampling = SamplingParams(deadline_ms=d)
    return reqs


def test_slo_engine_bit_identity_when_nothing_sheds(tiny):
    """The universal gate, SLO edition: tracker on, shedder ARMED,
    recorder on, generous deadlines — outputs must be bit-identical to
    the plain engine."""
    params, cfg = tiny
    want = {c.rid: c.tokens.tolist()
            for c in _engine(params, cfg).run(_reqs(cfg))}
    obs = Observability(recorder=FlightRecorder())
    tr = SLOTracker(SLOPolicy(ttft_objective_ms=100.0))
    eng = _engine(params, cfg, obs=obs, slo_tracker=tr, slo_shed=True)
    done = eng.run(_reqs(cfg, deadline_ms=60000.0))
    assert {c.rid: c.tokens.tolist() for c in done} == want
    assert eng.scheduler.shed_requests == 0
    assert tr.snapshot()["observed"]["ttft"] == len(want)
    # the tracker saw completions too: latency for every one
    assert tr.snapshot()["observed"]["latency"] == len(want)


def test_slo_engine_sheds_hopeless_deadlines(tiny):
    params, cfg = tiny
    tr = SLOTracker(SLOPolicy(ttft_objective_ms=50.0))
    eng = _engine(params, cfg, slo_tracker=tr, slo_shed=True)
    # alternate generous / impossible deadlines: the impossible ones
    # shed (zero tokens, finish_reason 'shed'), the rest decode whole
    deadlines = [60000.0 if i % 2 == 0 else 0.01 for i in range(10)]
    done = eng.run(_reqs(cfg, n=10, deadline_ms=deadlines))
    shed = [c for c in done if c.finish_reason == "shed"]
    kept = [c for c in done if c.finish_reason != "shed"]
    assert len(done) == 10 and len(shed) >= 1
    assert eng.scheduler.shed_requests == len(shed)
    assert all(len(c.tokens) == 0 and c.t_done >= c.arrival for c in shed)
    assert all(len(c.tokens) > 0 for c in kept)
    # on the step clock every impossible deadline has passed at the first
    # admission, and no generous one is ever near
    assert {c.rid for c in shed} == {i for i in range(10) if i % 2}
    stats = summarize(done, eng.wall_time, eng)
    assert stats["requests"] == len(kept)
    assert stats["shed_requests"] == len(shed)
    assert stats["slo"]["shed_requests"] == len(shed)


def test_slo_admission_defers_by_slack_without_changing_tokens(tiny):
    """Deadline-slack ordering inside a priority class reorders
    admission (deferral telemetry) but — batch-composition
    independence — never changes any request's tokens."""
    params, cfg = tiny
    want = {c.rid: c.tokens.tolist()
            for c in _engine(params, cfg).run(_reqs(cfg))}
    tr = SLOTracker(SLOPolicy(ttft_objective_ms=100.0))
    eng = _engine(params, cfg, slo_tracker=tr, slo_shed=True)
    # all generous (nothing sheds) but strictly REVERSED slack order:
    # the baseline FCFS order inverts, so every non-tightest request
    # slips behind its deadline-blind position at least once
    deadlines = [60000.0 - 1000.0 * i for i in range(8)]
    done = eng.run(_reqs(cfg, deadline_ms=deadlines))
    assert {c.rid: c.tokens.tolist() for c in done} == want
    assert eng.scheduler.shed_requests == 0
    assert eng.scheduler.deferrals >= 1


def test_slo_metrics_dump_carries_sketches(tiny):
    params, cfg = tiny
    obs = Observability()
    tr = SLOTracker(SLOPolicy(ttft_objective_ms=100.0))
    eng = _engine(params, cfg, obs=obs, slo_tracker=tr)
    obs.slo = tr
    eng.run(_reqs(cfg))
    doc = metrics_dump(obs)
    assert validate_metrics_dump(doc) == []
    assert {r["name"] for r in doc["sketches"]} >= {"slo_ttft_sketch"}
    assert doc["slo"]["observed"]["ttft"] == 8
    gauges = {g["name"] for g in doc["gauges"]}
    assert {"slo_burn_rate_fast_gauge", "slo_burn_rate_slow_gauge"} \
        <= gauges


def test_diurnal_workload_runs_through_engine(tiny):
    params, cfg = tiny
    reqs = diurnal_requests(6, vocab_size=cfg.vocab_size, rate_min=50.0,
                            rate_max=400.0, period=0.5, prompt_len=(8, 12),
                            max_new=(2, 4), seed=0)
    eng = _engine(params, cfg)
    done = eng.run(reqs)
    assert len(done) == 6 and all(len(c.tokens) > 0 for c in done)
    # every request waited for its arrival on the engine's clock
    assert all(c.t_admit >= c.arrival for c in done)


# ----------------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------------

def _completion_series(seed=3, n=300, healthy=0.05):
    """One completion series: (t, ttft_s, latency_s, tpot_s, priority),
    t rising unevenly over ~6 s, TTFTs log-normal about `healthy` with a
    slow stretch (about 0.3 s, over every objective) in the middle."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.exponential(0.02))
        slow = 100 <= i < 180
        ttft = float(rng.lognormal(math.log(0.3 if slow else healthy),
                                   0.6))
        out.append((t, ttft, ttft + float(rng.uniform(0.05, 0.5)),
                    float(rng.uniform(0.005, 0.05)),
                    int(rng.integers(0, 3))))
    return out


def _trackers():
    from repro.serving import slo as jslo
    kw = dict(ttft_objective_ms=100.0, class_ttft_ms=((2, 60.0),),
              latency_objective_ms=400.0, error_budget=0.1,
              fast_window_s=0.25, slow_window_s=1.0)
    return SLOTracker(SLOPolicy(**kw)), jslo.SLOTracker(jslo.SLOPolicy(**kw))


def test_slo_tracker_matches_jax():
    """One completion series through the port's SLOTracker and JAX's:
    every breach verdict equal, burn rates (both windows, TTFT and
    latency) and the run peaks within 1e-12 at every tick, and the
    snapshot equal but for its quantiles. Those come from the same
    sketch bucket in both: the port reports U * 2 / (1 + gamma) (the
    repaired point, tests/test_torch_slo.py), JAX the midpoint
    (L + U) / 2, so port = JAX * 4 gamma / (1 + gamma)^2 within 1e-12."""
    pytest.importorskip("jax")
    tr, jtr = _trackers()
    for t, ttft, lat, tpot, prio in _completion_series():
        assert tr.observe_ttft(t, ttft, priority=prio) == \
            jtr.observe_ttft(t, ttft, priority=prio)
        assert tr.observe_latency(t, lat, priority=prio) == \
            jtr.observe_latency(t, lat, priority=prio)
        tr.observe_tpot(t, tpot, priority=prio)
        jtr.observe_tpot(t, tpot, priority=prio)
        for a, b in zip(tr.tick(t), jtr.tick(t)):
            assert (a is None) == (b is None)
            if a is not None:
                assert abs(a - b) <= 1e-12
        for metric in ("ttft", "latency"):
            for window in (0.25, 1.0, 5.0):
                a = tr.burn_rate(t + 0.1, window, metric=metric)
                b = jtr.burn_rate(t + 0.1, window, metric=metric)
                assert (a is None) == (b is None)
                if a is not None:
                    assert abs(a - b) <= 1e-12
    assert tr.breaches == jtr.breaches and tr.breaches["ttft"] > 0
    for k in tr.peak_burn:
        assert abs(tr.peak_burn[k] - jtr.peak_burn[k]) <= 1e-12
    gamma = QuantileSketch(tr.rel_err).gamma
    factor = 4 * gamma / (1 + gamma) ** 2
    for metric in ("ttft", "latency", "tpot"):
        for prio in (None, 0, 1, 2):
            for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                a = tr.quantile(metric, q, priority=prio)
                b = jtr.quantile(metric, q, priority=prio)
                assert abs(a - b * factor) <= 1e-12 * b, (metric, prio, q)
    snap, jsnap = tr.snapshot(), jtr.snapshot()
    quantiles = ("ttft_p50_ms", "ttft_p99_ms", "latency_p99_ms")
    assert set(snap) == set(jsnap)
    for key in set(snap) - set(quantiles):
        assert snap[key] == jsnap[key], key
    for key in quantiles:
        metric, q = key.split("_p")[0], int(key.split("_p")[1][:2]) / 100
        assert snap[key] == round(tr.quantile(metric, q) * 1e3, 3)
    rows = {(r["name"], tuple(sorted(r["labels"].items()))): r
            for r in tr.sketch_rows()}
    jrows = {(r["name"], tuple(sorted(r["labels"].items()))): r
             for r in jtr.sketch_rows()}
    assert rows == jrows


def test_slo_signal_decisions_match_jax():
    """SLOSignal over the port's tracker and JAX's, fed the same
    completions and occupancy samples, replica count following each
    side's decisions: the same decision at every sample, with
    scale-outs and scale-ins among them."""
    pytest.importorskip("jax")
    from repro.serving import autoscaler as jasc
    from repro.serving import slo as jslo
    from repro_torch.serving.autoscaler import AutoscalePolicy
    kw = dict(min_replicas=1, max_replicas=3, high_window_s=0.1,
              low_window_s=0.2, cooldown_s=0.15)
    tr, jtr = _trackers()
    sig = SLOSignal(tr, AutoscalePolicy(**kw))
    jsig = jslo.SLOSignal(jtr, jasc.AutoscalePolicy(**kw))
    n_t = n_j = 1
    decisions = []
    for t, ttft, lat, _, prio in _completion_series(seed=5, n=400,
                                                    healthy=0.01):
        tr.observe_ttft(t, ttft, priority=prio)
        jtr.observe_ttft(t, ttft, priority=prio)
        a = sig.observe(t, 3, 2, n_t)
        b = jsig.observe(t, 3, 2, n_j)
        assert a == b, (t, a, b)
        n_t += {"out": 1, "in": -1}.get(a, 0)
        n_j += {"out": 1, "in": -1}.get(b, 0)
        decisions.append(a)
    assert "out" in decisions and "in" in decisions


def test_exports_valid_under_both_packages_validators(tiny, tmp_path):
    """One traced engine run with the SLO tracker and the flight
    recorder: its trace, its flight-recorder dump and its metrics dump
    (schema v2, with sketches; and the same dump restated as v1, without
    the v2 sections) are valid under the port's validators and the JAX
    package's, and one corrupted dump is refused by both."""
    pytest.importorskip("jax")
    from repro.serving import observability as jobs
    params, cfg = tiny
    fr = FlightRecorder(capacity=64)
    obs = Observability(recorder=fr, sample_interval=0.0)
    tr = SLOTracker(SLOPolicy(ttft_objective_ms=20.0))
    eng = _engine(params, cfg, obs=obs, slo_tracker=tr)
    eng.run(_reqs(cfg, n=6))
    trace = json.loads(json.dumps(to_perfetto(obs)))
    dump = json.loads(json.dumps(fr.dump(str(tmp_path / "flight.json"))))
    v2 = json.loads(json.dumps(metrics_dump(obs)))
    assert v2["schema"] == METRICS_SCHEMA and v2["sketches"]
    v1 = {k: v for k, v in v2.items() if k not in ("sketches", "slo")}
    v1["schema"] = METRICS_SCHEMAS[0]
    for validate_trace, validate_metrics in (
            (validate_trace_events, validate_metrics_dump),
            (jobs.validate_trace_events, jobs.validate_metrics_dump)):
        assert validate_trace(trace) == []
        assert validate_trace(dump) == []
        assert validate_metrics(v2) == []
        assert validate_metrics(v1) == []
        bad = json.loads(json.dumps(v2))
        bad["sketches"][0]["count"] += 1     # bucket counts no longer sum
        assert validate_metrics(bad) != []
