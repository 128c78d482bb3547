"""The port's observability layer (`repro_torch.serving.observability`) on
the CPU: the 20 tests of tests/test_observability.py over the port —
metrics-registry units, the validators, tracing invariants (spans nest
and never overlap per slot, monotonic timestamps on the shared clock),
counter reconciliation against Completion totals, the bit-identity gate
with tracing on, exporter schema validity, per-slot speculative
acceptance telemetry, replica-scoped cluster traces, summarize's
degenerate-run guards, and scripts/bench_compare.py over records built
from the port's summarize(). Engines and routers run on a step clock
(`_torch_cpu.StepClock`)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import StepClock, time_limit  # noqa: E402,F401

_torch_cpu.share_cores()

from repro_torch.serving.engine import (ServingEngine, summarize,  # noqa: E402
                                        synthetic_requests)
from repro_torch.serving.observability import (  # noqa: E402
    DISPATCH_TID, NULL_OBS, Histogram, MetricsRegistry, Observability,
    metrics_dump, to_perfetto, validate_metrics_dump, validate_trace_events)
from repro_torch.serving.replica import Replica  # noqa: E402
from repro_torch.serving.router import Router, summarize_cluster  # noqa: E402
from repro_torch.serving.scheduler import Completion  # noqa: E402

import _torch_models  # noqa: E402

pytestmark = pytest.mark.serving


# ----------------------------------------------------------------------------
# registry units (no engine needed)
# ----------------------------------------------------------------------------

def test_registry_instruments():
    reg = MetricsRegistry()
    c = reg.counter("reqs_total", replica=1)
    c.inc()
    c.inc(3)
    assert reg.counter("reqs_total", replica=1) is c     # same object
    assert reg.counter("reqs_total", replica=2) is not c
    reg.counter("reqs_total", replica=2).inc(5)
    assert reg.total("reqs_total") == 9
    g = reg.gauge("depth")
    g.set(7)
    assert reg.gauges_named("depth") == {(): 7.0}
    h = reg.histogram("lens", [0, 1, 2])
    for v in (0, 1, 1, 2, 99):
        h.observe(v)
    assert h.counts == [1, 2, 1, 1]                      # overflow bucket
    assert h.count == 5 and h.mean == pytest.approx(103 / 5)


def test_registry_reset_keeps_references():
    """Per-run reset zeroes instruments IN PLACE: references layers
    cached at construction must stay live across begin_run."""
    reg = MetricsRegistry()
    c, g = reg.counter("a"), reg.gauge("b")
    h = reg.histogram("c", [1.0])
    c.inc(4); g.set(2); h.observe(0.5)
    reg.series.append({"t": 0.0})
    reg.reset()
    assert c.value == 0 and g.value == 0.0 and h.count == 0
    assert reg.series == []
    c.inc()
    assert reg.counter("a") is c and reg.total("a") == 1


def test_histogram_rejects_bad_bounds():
    with pytest.raises(ValueError):
        Histogram([])
    with pytest.raises(ValueError):
        Histogram([2, 1])
    with pytest.raises(ValueError):
        Histogram([1, 1])


def test_null_obs_is_inert():
    obs = NULL_OBS
    assert not obs.enabled
    assert obs.scoped(3) is obs
    c = obs.counter("x")
    c.inc(10)
    assert c.value == 0
    obs.histogram("h", [1]).observe(5)
    obs.gauge("g").set(1)
    assert obs.step("decode", 0, 1) == {}
    obs.annotate_step(a=1)
    obs.begin_run()


def test_scoped_views_share_storage():
    root = Observability()
    v1, v2 = root.scoped(1), root.scoped(2)
    v1.counter("n").inc()
    v2.counter("n").inc(2)
    assert root.registry.total("n") == 3
    v1.span(0, "s", "request", 0.0, 1.0)
    v2.span(0, "s", "request", 1.0, 2.0)
    assert [s["pid"] for s in root.spans] == [1, 2]


# ----------------------------------------------------------------------------
# validators
# ----------------------------------------------------------------------------

def test_validate_trace_events_catches_malformed():
    assert validate_trace_events([]) != []
    assert validate_trace_events({"traceEvents": "nope"}) != []
    bad = {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 0, "tid": 0, "ts": 1.0},  # no dur
        {"ph": "b", "name": "q", "pid": 0, "tid": 0, "ts": 0.0,
         "id": 7},                                     # non-string id
        {"ph": "e", "name": "q2", "pid": 0, "tid": 0, "ts": 0.0,
         "id": "9"},                                   # end w/o begin
        {"ph": "X", "name": "neg", "pid": 0, "tid": 0, "ts": -1.0,
         "dur": 1.0},                                  # negative ts
    ]}
    errs = validate_trace_events(bad)
    assert any("dur" in e for e in errs)
    assert any("string id" in e for e in errs)
    assert any("end without begin" in e for e in errs)
    assert any("non-negative ts" in e for e in errs)
    good = {"traceEvents": [
        {"ph": "X", "name": "a", "cat": "c", "pid": 0, "tid": 0,
         "ts": 0.0, "dur": 2.0},
        {"ph": "b", "name": "q", "cat": "queue", "pid": 0, "tid": 0,
         "ts": 0.0, "id": "1"},
        {"ph": "e", "name": "q", "cat": "queue", "pid": 0, "tid": 0,
         "ts": 1.0, "id": "1"},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "replica 0"}},
    ]}
    assert validate_trace_events(good) == []


def test_validate_metrics_dump_catches_malformed():
    assert validate_metrics_dump([]) != []
    assert validate_metrics_dump({"schema": "wrong"}) != []
    doc = {"schema": "repro.serving.metrics/v1",
           "counters": [{"name": "a", "labels": {}, "value": 1}],
           "gauges": [], "series": [{"t": 0.5}],
           "histograms": [{"name": "h", "labels": {}, "bounds": [1],
                           "counts": [0, 0], "sum": 0.0, "count": 0}]}
    assert validate_metrics_dump(doc) == []
    doc["histograms"][0]["counts"] = [0]              # wrong bucket count
    assert validate_metrics_dump(doc) != []


# ----------------------------------------------------------------------------
# end-to-end engine tracing
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The reduced smollm-135m at the JAX package's PRNGKey(0) weights,
    in the port's layout."""
    _, _, cfg, params = _torch_models.reduced_models("smollm-135m")
    return params, cfg


def _reqs(cfg, n=6, seed=3):
    return synthetic_requests(n, vocab_size=cfg.vocab_size,
                              prompt_len=(8, 20), max_new=(3, 8),
                              seed=seed)


# one step clock (1 ms a reading) for every engine and router here
CLOCK = StepClock()
KW = dict(num_slots=2, block_size=8, max_seq_len=64, prefill_max_batch=2,
          speculate=3, device="cpu", now_fn=CLOCK)


@pytest.fixture(scope="module")
def traced_run(tiny):
    """One traced engine run shared by the invariant tests below (and an
    untraced reference run of the identical workload)."""
    params, cfg = tiny
    reqs = _reqs(cfg)
    ref = ServingEngine(params, cfg, **KW).run(list(reqs))
    obs = Observability(sample_interval=0.0)
    eng = ServingEngine(params, cfg, obs=obs, **KW)
    done = eng.run(list(reqs))
    return obs, eng, done, ref, reqs


def test_trace_on_output_bit_identical(traced_run):
    """The zero-cost contract's other half: recording must never change
    what the engine produces."""
    _, _, done, ref, _ = traced_run
    by_rid = {c.rid: c.tokens for c in ref}
    assert {c.rid for c in done} == set(by_rid)
    for c in done:
        np.testing.assert_array_equal(c.tokens, by_rid[c.rid])


def test_counters_reconcile_with_completions(traced_run):
    obs, eng, done, _, reqs = traced_run
    assert obs.registry.total("tokens_emitted_total") == sum(
        len(c.tokens) for c in done)
    assert obs.registry.total("scheduler_submitted_total") == len(reqs)
    assert obs.registry.total("scheduler_admitted_total") == len(reqs)
    assert obs.registry.total("scheduler_finished_total") == len(done)
    assert obs.registry.total("prompt_tokens_total") == sum(
        len(r.prompt) for r in reqs)
    assert obs.registry.total("spec_proposed_total") == \
        eng.scheduler.proposed_tokens
    assert obs.registry.total("spec_accepted_total") == \
        eng.scheduler.accepted_tokens
    # dispatch counters match the runner's own telemetry
    assert obs.registry.total("prefill_dispatches_total") == \
        eng.runner.prefill_dispatches
    assert obs.registry.total("verify_dispatches_total") == \
        eng.runner.verify_dispatches


def test_request_spans_cover_lifecycle(traced_run):
    """Every request gets an outer span whose prefill/decode phase
    children nest inside it, plus an async queue span."""
    obs, _, done, _, _ = traced_run
    outer = {s["args"]["rid"]: s for s in obs.spans
             if s["cat"] == "request"}
    assert set(outer) == {c.rid for c in done}
    for c in done:
        s = outer[c.rid]
        assert s["t0"] == pytest.approx(c.t_admit)
        assert s["t1"] == pytest.approx(c.t_done)
        assert s["args"]["generated"] == len(c.tokens)
        assert s["args"]["finish_reason"] == c.finish_reason
    phase = [s for s in obs.spans if s["cat"] == "phase"]
    for p in phase:
        parents = [s for s in outer.values()
                   if s["tid"] == p["tid"]
                   and s["t0"] - 1e-9 <= p["t0"]
                   and p["t1"] <= s["t1"] + 1e-9]
        assert parents, f"phase span {p} has no enclosing request span"
    qspans = {a["id"] for a in obs.asyncs}
    assert qspans == {c.rid for c in done}


def test_spans_never_overlap_per_slot(traced_run):
    """Request spans on one slot track are serialized by construction:
    a slot runs one request at a time, so spans must not overlap."""
    obs, _, _, _, _ = traced_run
    for tid in {s["tid"] for s in obs.spans if s["cat"] == "request"}:
        spans = sorted((s for s in obs.spans
                        if s["cat"] == "request" and s["tid"] == tid),
                       key=lambda s: s["t0"])
        for a, b in zip(spans, spans[1:]):
            assert a["t1"] <= b["t0"] + 1e-9, (a, b)


def test_timestamps_monotonic_and_ordered(traced_run):
    """Every span sits on one shared run clock: nonnegative, t0 <= t1,
    and dispatch steps strictly ordered (the engine is sequential)."""
    obs, _, _, _, _ = traced_run
    for s in obs.spans:
        assert 0.0 <= s["t0"] <= s["t1"]
    steps = [s for s in obs.spans if s["tid"] == DISPATCH_TID]
    assert steps, "no dispatch step records"
    for a, b in zip(steps, steps[1:]):
        assert a["t1"] <= b["t0"] + 1e-9
    ts = [row["t"] for row in obs.registry.series]
    assert ts == sorted(ts)


def test_step_records_carry_dispatch_detail(traced_run):
    obs, eng, _, _, _ = traced_run
    steps = [s for s in obs.spans if s["tid"] == DISPATCH_TID]
    kinds = {s["name"] for s in steps}
    assert "prefill" in kinds
    assert kinds <= {"prefill", "decode", "verify"}
    prefills = [s for s in steps if s["name"] == "prefill"]
    assert all("bucket" in s["args"] and "batch" in s["args"]
               for s in prefills)
    # the FIRST dispatch of each jit variant is flagged (compile
    # attribution); later dispatches of the same shape are not
    assert prefills[0]["args"]["first_dispatch"] is True
    by_bucket = {}
    for s in prefills:
        by_bucket.setdefault(tuple(s["args"]["bucket"]), []).append(s)
    for group in by_bucket.values():
        assert group[0]["args"]["first_dispatch"] is True
        assert all(not g["args"]["first_dispatch"] for g in group[1:])
    verifies = [s for s in steps if s["name"] == "verify"]
    assert all("accept_lens" in s["args"] for s in verifies)


def test_exports_valid_and_json_serializable(traced_run, tmp_path):
    obs, _, _, _, _ = traced_run
    trace = to_perfetto(obs)
    assert validate_trace_events(trace) == []
    md = metrics_dump(obs)
    assert validate_metrics_dump(md) == []
    p = tmp_path / "trace.json"
    p.write_text(json.dumps(trace))
    assert validate_trace_events(json.loads(p.read_text())) == []
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
    assert {"process_name", "thread_name"} <= names


def test_per_slot_acceptance_telemetry(traced_run):
    """ROADMAP item 4's signal: per-slot accept-length histograms and a
    rolling acceptance-rate gauge, recorded but not acted on."""
    obs, eng, _, _, _ = traced_run
    hists = obs.registry.histograms_named("verify_accept_len_hist")
    per_slot = {k: h for k, h in hists.items() if k}       # slot-labeled
    glob = hists.get((), None)
    if eng.scheduler.proposed_tokens == 0:
        pytest.skip("workload drafted nothing")
    assert glob is not None and glob.count > 0
    assert sum(h.count for h in per_slot.values()) == glob.count
    rates = eng.scheduler.slot_acceptance_rates()
    for i, rate in enumerate(rates):
        if rate is not None:
            assert 0.0 <= rate <= 1.0
            g = obs.registry.gauges_named("spec_accept_rate")
            assert (("slot", i),) in g


def test_cluster_trace_scopes_replicas(tiny):
    params, cfg = tiny
    reqs = _reqs(cfg, n=6, seed=5)
    ref = ServingEngine(params, cfg, **KW).run(list(reqs))
    obs = Observability(sample_interval=0.0)
    reps = [Replica(params, cfg, replica_id=i, obs=obs, **KW)
            for i in range(2)]
    router = Router(reps, policy="least-loaded", obs=obs, now_fn=CLOCK)
    done = router.run(list(reqs))
    by_rid = {c.rid: c.tokens for c in ref}
    for c in done:
        np.testing.assert_array_equal(c.tokens, by_rid[c.rid])
    assert obs.registry.total("router_placed_total") == len(reqs)
    assert obs.registry.total("tokens_emitted_total") == sum(
        len(c.tokens) for c in done)
    trace = to_perfetto(obs)
    assert validate_trace_events(trace) == []
    pids = {e["pid"] for e in trace["traceEvents"] if e["ph"] != "M"}
    assert pids == {0, 1}
    # replica-labeled instruments, one set per replica that emitted
    emitted = {k for (n, k) in obs.registry._counters
               if n == "tokens_emitted_total"}
    assert emitted == {(), (("replica", 1),)}
    # router stamped queue + routing times onto every request
    for r in reqs:
        assert r.trace is not None and "routed" in r.trace
        assert r.trace["queued"] <= r.trace["routed"]
    sc = summarize_cluster(done, router.wall_time, router)
    assert sc["cluster"]["replicas"] == 2


# ----------------------------------------------------------------------------
# summarize degenerate-run guards
# ----------------------------------------------------------------------------

def _completion(rid=0, n=3, t_done=1.0):
    return Completion(rid=rid, prompt_len=4,
                      tokens=np.arange(n, dtype=np.int32), arrival=0.0,
                      t_admit=0.1, t_first_token=0.2, t_done=t_done,
                      cached_tokens=0, finish_reason="length")


def test_summarize_zero_wall_clock():
    stats = summarize([_completion()], 0.0)
    assert stats["tokens_per_s"] == 0.0
    assert np.isfinite(stats["ttft_p50_ms"])
    stats = summarize([], -1.0)
    assert stats["tokens_per_s"] == 0.0 and stats["requests"] == 0


def test_summarize_single_and_empty_completions():
    one = summarize([_completion(n=1)], 2.0)
    assert one["requests"] == 1
    assert one["ttft_p50_ms"] == one["ttft_p99_ms"]    # percentile collapse
    assert np.isfinite(one["tpot_p50_ms"])
    empty = summarize([], 2.0)
    assert empty == {"requests": 0, "generated_tokens": 0, "wall_s": 2.0,
                     "tokens_per_s": 0.0}


def test_summarize_cluster_degenerate(tiny):
    params, cfg = tiny
    reps = [Replica(params, cfg, replica_id=0, **KW)]
    router = Router(reps, now_fn=CLOCK)
    stats = summarize_cluster([], 0.0, router)
    assert stats["tokens_per_s"] == 0.0
    assert stats["cluster"]["placed"] == [0]
    assert stats["cluster"]["prompt_tokens"] == 0


# ----------------------------------------------------------------------------
# bench_compare over the port's records
# ----------------------------------------------------------------------------

def _bench_record(tps=100.0, p99=50.0):
    """A serving-bench-shaped record whose engine block is the port's
    summarize() of fixed completions, scaled to the given numbers."""
    done = [_completion(rid=i, n=4, t_done=1.0 + i) for i in range(4)]
    engine = summarize(done, 4.0)
    engine.update(tokens_per_s=tps, ttft_p99_ms=p99)
    return {"arch": "a", "workload": "uniform",
            "meta": {"schema": "repro.serving.bench/v1", "git_rev": "x"},
            "engine": engine, "baseline": {"tokens_per_s": 10.0},
            "speedup": tps / 10.0}


def test_bench_compare_flags_regressions():
    import sys
    sys.path.insert(0, "scripts")
    try:
        from bench_compare import compare
    finally:
        sys.path.pop(0)
    old = _bench_record()
    ok = compare(old, _bench_record(tps=95.0), threshold=0.10)
    assert ok["ok"] and not ok["regressions"]
    bad = compare(old, _bench_record(tps=80.0), threshold=0.10)
    assert not bad["ok"]
    assert [r["metric"] for r in bad["regressions"]] == [
        "engine.tokens_per_s", "speedup"]
    lat = compare(old, _bench_record(p99=80.0), threshold=0.10)
    assert [r["metric"] for r in lat["regressions"]] == [
        "engine.ttft_p99_ms"]           # higher latency = regression
    faster = compare(old, _bench_record(tps=150.0), threshold=0.10)
    assert faster["ok"] and faster["improvements"]
    with pytest.raises(ValueError):
        compare(old, {**_bench_record(), "workload": "mixed"})
    with pytest.raises(ValueError):
        compare(old, {**_bench_record(), "meta": {"schema": "other"}})
