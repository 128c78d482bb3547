"""Serving observability: metrics registry, request-lifecycle tracing,
and exporters (Chrome/Perfetto trace_event JSON + metrics-dump JSON).

The telemetry layer every serving component publishes into (kernels'
dispatch records come via the runner; scheduler, block manager, engine,
replica, and router each have their own instruments). The source
paper's tradeoff — communication vs memory vs computation — is only
navigable with measurements; this module records the signals the
control loops above the engine (SLO autoscaling, adaptive speculation
length) will steer by.

Four pieces:

  * `MetricsRegistry` — labeled counters, gauges, and fixed-bucket
    histograms (e.g. `scheduler_admitted_total{replica=0}`,
    `blocks_cached_gauge`, `verify_accept_len_hist{slot=3}`). Layers
    resolve their instruments ONCE at construction and call
    `inc`/`set`/`observe` on the hot path; the registry also holds the
    periodic `SchedulerStats`-derived time series (`series`) that an
    autoscaler would consume.
  * `Observability` — the recorder handle threaded through the stack.
    Collects trace spans on the SHARED engine/cluster clock: per-slot
    request-lifecycle spans (queued -> routed -> admitted -> prefill ->
    decode -> done), per-dispatch step records (kind, batch, bucket,
    emitted tokens, prefix-cache hits, accept lengths, and a
    `first_dispatch` flag so jit-compile stalls are attributable
    separately from steady-state steps), and async queue spans.
    `scoped(replica)` returns a view sharing all storage but stamping a
    replica label/track id — how a cluster's replicas publish into one
    recorder.
  * exporters — `to_perfetto()` renders the trace as Chrome
    `trace_event` JSON (one process per replica, one thread track per
    slot plus a `dispatch` track; open in https://ui.perfetto.dev),
    `metrics_dump()` renders the registry as a schema-versioned JSON
    document, and `validate_trace_events` / `validate_metrics_dump`
    check both formats (the CI gate).
  * `FlightRecorder` — an always-on bounded ring buffer of the most
    recent trace events (steady-state cost: one deque append per
    event, no export, no device sync) that dumps a schema-valid
    Perfetto trace when an anomaly fires — a TTFT-objective breach, a
    preemption storm, or eviction thrash — or on demand. The black box
    for tail-latency forensics: when something goes wrong you get the
    last `capacity` events leading up to it without having paid for
    full tracing all along.

The default recorder is `NULL_OBS`: every method is a no-op and
`enabled` is False, so layers guard their bookkeeping behind one
attribute check and the off path costs nothing. Recording never
touches device dispatch — with observability on, engine outputs stay
bit-identical to the recorder-off run (gated in serving_bench and
tests/test_observability.py).
"""
from __future__ import annotations

import copy
import json
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# trace_event thread id of the per-replica dispatch track (slot tracks
# use tid == slot index; any real slot count stays far below this)
DISPATCH_TID = 1000
# thread id of the flight-recorder anomaly track
FLIGHT_TID = 95

# current metrics-dump schema (v2 added the optional `sketches` and
# `slo` sections for the SLO layer's quantile sketches / burn-rate
# accounting); v1 documents remain valid
METRICS_SCHEMA = "repro.serving.metrics/v2"
METRICS_SCHEMAS = ("repro.serving.metrics/v1", METRICS_SCHEMA)
TRACE_SCHEMA = "repro.serving.trace_event/v1"


# ----------------------------------------------------------------------------
# instruments
# ----------------------------------------------------------------------------

class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-written value (occupancy, rates)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed-bucket histogram: counts[i] counts observations <=
    bounds[i]; counts[-1] is the overflow bucket (> bounds[-1])."""

    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = tuple(float(b) for b in bounds)
        if not self.bounds or list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing and non-empty: {bounds!r}")
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.total += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0


class _NullInstrument:
    """No-op counter/gauge/histogram — what NULL_OBS hands out so hot
    paths can hold one instrument reference unconditionally."""

    __slots__ = ()
    value = 0
    counts: List[int] = []
    total = 0.0
    count = 0
    mean = 0.0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def reset(self) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Labeled instruments + the stats time series. Instruments are
    keyed (name, sorted labels); resolving the same key returns the
    same object, so layers can cache references at construction and
    `reset()` (per run) zeroes values IN PLACE without invalidating
    them."""

    def __init__(self):
        self._counters: Dict[tuple, Counter] = {}
        self._gauges: Dict[tuple, Gauge] = {}
        self._histograms: Dict[tuple, Histogram] = {}
        self.series: List[Dict[str, Any]] = []

    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        if key not in self._counters:
            self._counters[key] = Counter()
        return self._counters[key]

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        if key not in self._gauges:
            self._gauges[key] = Gauge()
        return self._gauges[key]

    def histogram(self, name: str, bounds: Sequence[float],
                  **labels) -> Histogram:
        key = (name, _label_key(labels))
        if key not in self._histograms:
            self._histograms[key] = Histogram(bounds)
        return self._histograms[key]

    def total(self, name: str) -> int:
        """Sum of a counter across every label set (e.g. all replicas)."""
        return sum(c.value for (n, _), c in self._counters.items()
                   if n == name)

    def gauges_named(self, name: str) -> Dict[tuple, float]:
        return {k[1]: g.value for k, g in self._gauges.items()
                if k[0] == name}

    def histograms_named(self, name: str) -> Dict[tuple, Histogram]:
        return {k[1]: h for k, h in self._histograms.items()
                if k[0] == name}

    def reset(self) -> None:
        """Zero every instrument in place and drop the series (per-run
        telemetry); cached instrument references stay valid."""
        for group in (self._counters, self._gauges, self._histograms):
            for inst in group.values():
                inst.reset()
        self.series.clear()

    def to_dict(self) -> Dict[str, Any]:
        def rows(group, extra):
            out = []
            for (name, labels), inst in sorted(group.items()):
                row = {"name": name, "labels": dict(labels)}
                row.update(extra(inst))
                out.append(row)
            return out

        return {
            "counters": rows(self._counters,
                             lambda c: {"value": c.value}),
            "gauges": rows(self._gauges, lambda g: {"value": g.value}),
            "histograms": rows(self._histograms, lambda h: {
                "bounds": list(h.bounds), "counts": list(h.counts),
                "sum": h.total, "count": h.count}),
            "series": list(self.series),
        }


# ----------------------------------------------------------------------------
# the flight recorder
# ----------------------------------------------------------------------------

class FlightRecorder:
    """Always-on bounded ring of recent trace events with anomaly-
    triggered dumps — the serving stack's black box.

    Attach one via `Observability(recorder=...)`: every span / instant
    / async event the recorder handle sees is ALSO appended to the ring
    (same dict objects, so later `annotate_step` mutations are visible
    in the dump), and the ring's `deque(maxlen=capacity)` keeps memory
    bounded no matter how long the run is. Steady-state cost is one
    append per event — no export, no serialization, no device sync.

    Anomaly triggers, each recording an entry in `anomalies`, an
    instant on the FLIGHT_TID track, and (when `dump_path` is set and
    the rate limit allows) a schema-valid Perfetto dump of the ring:

      * `breach()` — called by the scheduler when a request's TTFT (or
        e2e latency) lands past its SLO objective
      * preemption storm — `note_preempt()` saw `preempt_storm`
        preemptions inside `window_s`
      * eviction thrash — `note_evictions()` saw `evict_thrash`
        cache evictions inside `window_s`

    Detector state rides the run clock (deterministic, no wall time);
    `min_dump_interval_s` keeps a sustained incident from rewriting the
    dump file every event.
    """

    def __init__(self, capacity: int = 4096, *,
                 dump_path: Optional[str] = None,
                 preempt_storm: int = 8, evict_thrash: int = 64,
                 window_s: float = 1.0,
                 min_dump_interval_s: float = 0.5):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.dump_path = dump_path
        self.preempt_storm = int(preempt_storm)
        self.evict_thrash = int(evict_thrash)
        self.window_s = float(window_s)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.ring: deque = deque(maxlen=self.capacity)
        self.anomalies: deque = deque(maxlen=256)
        self.appended = 0       # over all time; dropped = appended - len(ring)
        self.dumps = 0
        self._preempts: deque = deque()         # preemption timestamps
        self._evict_events: deque = deque()     # (t, delta) eviction rows
        self._evict_last = 0
        self._last_dump = float("-inf")

    # -- the hot path ----------------------------------------------------

    def append(self, kind: str, rec: Dict[str, Any]) -> None:
        """Ring append (kind is "span" / "instant" / "async"); the ONLY
        per-event cost of an attached recorder."""
        self.ring.append((kind, rec))
        self.appended += 1

    # -- anomaly triggers ------------------------------------------------

    def breach(self, t: float, reason: str, **args) -> None:
        """Record an anomaly (and dump the ring, rate-limited)."""
        self.anomalies.append({"t": t, "reason": reason, "args": args})
        self.append("instant", {"pid": 0, "tid": FLIGHT_TID,
                                "name": f"anomaly:{reason}",
                                "cat": "flight", "t": t, "args": args})
        if self.dump_path is not None \
                and t - self._last_dump >= self.min_dump_interval_s:
            self._last_dump = t
            self.dump(self.dump_path)

    def note_preempt(self, t: float) -> None:
        """Feed from the scheduler's preempt path: `preempt_storm`
        preemptions inside `window_s` is an anomaly."""
        self._preempts.append(t)
        while self._preempts and self._preempts[0] < t - self.window_s:
            self._preempts.popleft()
        if len(self._preempts) >= self.preempt_storm:
            n = len(self._preempts)
            self._preempts.clear()      # re-arm, don't re-fire per event
            self.breach(t, "preempt_storm", preemptions=n,
                        window_s=self.window_s)

    def note_evictions(self, t: float, total: int) -> None:
        """Feed from the engine step loop with the allocator's
        cumulative eviction counter; `evict_thrash` evictions inside
        `window_s` is an anomaly."""
        delta = total - self._evict_last
        self._evict_last = total
        if delta > 0:
            self._evict_events.append((t, delta))
        while self._evict_events \
                and self._evict_events[0][0] < t - self.window_s:
            self._evict_events.popleft()
        recent = sum(d for _, d in self._evict_events)
        if recent >= self.evict_thrash:
            self._evict_events.clear()  # re-arm
            self.breach(t, "eviction_thrash", evictions=recent,
                        window_s=self.window_s)

    # -- export ----------------------------------------------------------

    def to_perfetto(self) -> Dict[str, Any]:
        """The ring as a schema-valid Perfetto trace_event document
        (same renderer as the full-trace exporter), with a
        `flight_recorder` summary in otherData."""
        spans = [r for k, r in self.ring if k == "span"]
        instants = [r for k, r in self.ring if k == "instant"]
        asyncs = [r for k, r in self.ring if k == "async"]
        return _render_trace(spans, instants, asyncs, other={
            "flight_recorder": {
                "capacity": self.capacity,
                "events": len(self.ring),
                "dropped": self.appended - len(self.ring),
                "anomalies": list(self.anomalies),
            }})

    def dump(self, path: Optional[str] = None) -> Dict[str, Any]:
        doc = self.to_perfetto()
        path = path if path is not None else self.dump_path
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        self.dumps += 1
        return doc

    def reset(self) -> None:
        self.ring.clear()
        self.anomalies.clear()
        self.appended = 0
        self.dumps = 0
        self._preempts.clear()
        self._evict_events.clear()
        self._evict_last = 0
        self._last_dump = float("-inf")


# ----------------------------------------------------------------------------
# the recorder handle
# ----------------------------------------------------------------------------

class Observability:
    """Recorder threaded through every serving layer. One instance (or
    a `scoped(replica)` view of it) is shared by a whole engine stack;
    a cluster shares one root across all replicas so every span sits on
    one clock and every instrument carries its replica label.

    sample_interval   minimum seconds between SchedulerStats time-series
                      samples (0 = record every engine step).
    recorder          optional `FlightRecorder`: every span / instant /
                      async event is also ring-appended (shared dict
                      objects — cheap, bounded, dump-on-anomaly).
    """

    enabled = True

    def __init__(self, *, sample_interval: float = 0.05,
                 recorder: Optional[FlightRecorder] = None):
        self.registry = MetricsRegistry()
        self.sample_interval = float(sample_interval)
        self.replica = 0
        self.recorder = recorder
        self.slo = None         # optional SLOTracker (set by engine/serve)
        # trace storage (shared across scoped views)
        self.spans: List[Dict[str, Any]] = []     # complete spans
        self.instants: List[Dict[str, Any]] = []  # point events
        self.asyncs: List[Dict[str, Any]] = []    # queue-phase spans
        # mutable cells shared by every scoped view
        self._last_sample = [None]                # [Optional[float]]
        self._last_step: List[Optional[Dict[str, Any]]] = [None]

    # -- scoping ---------------------------------------------------------

    def scoped(self, replica: int) -> "Observability":
        """A view for one replica: shares the registry and all trace
        storage, stamps `replica` on tracks and instrument labels."""
        view = copy.copy(self)
        view.replica = replica
        return view

    def _labels(self, labels: Dict[str, Any]) -> Dict[str, Any]:
        if self.replica:
            labels.setdefault("replica", self.replica)
        return labels

    # -- instruments (replica label folded in) ---------------------------

    def counter(self, name: str, **labels) -> Counter:
        return self.registry.counter(name, **self._labels(labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self.registry.gauge(name, **self._labels(labels))

    def histogram(self, name: str, bounds: Sequence[float],
                  **labels) -> Histogram:
        return self.registry.histogram(name, bounds,
                                       **self._labels(labels))

    # -- trace spans -----------------------------------------------------

    def span(self, tid: int, name: str, cat: str, t0: float, t1: float,
             **args) -> Dict[str, Any]:
        rec = {"pid": self.replica, "tid": tid, "name": name, "cat": cat,
               "t0": t0, "t1": t1, "args": args}
        self.spans.append(rec)
        if self.recorder is not None:
            self.recorder.append("span", rec)
        return rec

    def instant(self, tid: int, name: str, cat: str, t: float,
                **args) -> None:
        rec = {"pid": self.replica, "tid": tid, "name": name, "cat": cat,
               "t": t, "args": args}
        self.instants.append(rec)
        if self.recorder is not None:
            self.recorder.append("instant", rec)

    def async_span(self, name: str, cat: str, aid: int, t0: float,
                   t1: float, **args) -> None:
        """A span that may overlap others (queue residency): rendered as
        Perfetto async b/e pairs keyed by `aid`."""
        rec = {"pid": self.replica, "name": name, "cat": cat,
               "id": aid, "t0": t0, "t1": t1, "args": args}
        self.asyncs.append(rec)
        if self.recorder is not None:
            self.recorder.append("async", rec)

    # -- dispatch step records -------------------------------------------

    def step(self, kind: str, t0: float, t1: float,
             **args) -> Dict[str, Any]:
        """One device dispatch (prefill / decode / verify) as a span on
        this replica's dispatch track. The record is kept open for
        `annotate_step` — the scheduler adds what the runner cannot know
        (emitted token counts, accept lengths)."""
        rec = self.span(DISPATCH_TID, kind, "dispatch", t0, t1, **args)
        self._last_step[0] = rec
        return rec

    def annotate_step(self, **args) -> None:
        rec = self._last_step[0]
        if rec is not None:
            rec["args"].update(args)

    # -- SchedulerStats time series --------------------------------------

    def sample_stats(self, t: float, stats) -> None:
        """Record occupancy gauges from a SchedulerStats snapshot and,
        subject to `sample_interval` throttling, append a time-series
        sample — the feed an SLO autoscaler consumes."""
        self.gauge("queue_depth_gauge").set(stats.queue_depth)
        self.gauge("active_slots_gauge").set(stats.active_slots)
        self.gauge("blocks_free_gauge").set(stats.free_blocks)
        self.gauge("blocks_cached_gauge").set(stats.cached_blocks)
        self.gauge("blocks_reserved_gauge").set(stats.reserved_blocks)
        spilled = getattr(stats, "spilled_blocks", 0)
        self.gauge("blocks_spilled_gauge").set(spilled)
        preempted = getattr(stats, "preempted", 0)
        self.gauge("preempted_gauge").set(preempted)
        last = self._last_sample[0]
        if last is not None and t - last < self.sample_interval:
            return
        self._last_sample[0] = t
        self.registry.series.append({
            "t": t, "replica": self.replica,
            "queue_depth": stats.queue_depth,
            "active_slots": stats.active_slots,
            "free_slots": stats.free_slots,
            "free_blocks": stats.free_blocks,
            "cached_blocks": stats.cached_blocks,
            "reserved_blocks": stats.reserved_blocks,
            "spilled_blocks": spilled,
            "preempted": preempted,
        })

    # -- lifecycle -------------------------------------------------------

    def begin_run(self) -> None:
        """Per-run reset (mirrors the engine's telemetry semantics):
        drop trace data and zero instruments, keeping instrument
        references valid. Shared storage resets once even when every
        replica's begin_run calls it."""
        self.registry.reset()
        self.spans.clear()
        self.instants.clear()
        self.asyncs.clear()
        self._last_sample[0] = None
        self._last_step[0] = None
        if self.recorder is not None:
            self.recorder.reset()


class _NullObservability(Observability):
    """The zero-cost default: `enabled` is False (layers skip their
    bookkeeping) and every method is a no-op, so an unguarded call
    costs one dynamic dispatch and records nothing."""

    enabled = False
    recorder = None
    slo = None

    def __init__(self):  # no storage at all
        pass

    def scoped(self, replica: int) -> "Observability":
        return self

    def counter(self, name: str, **labels):
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels):
        return _NULL_INSTRUMENT

    def histogram(self, name: str, bounds: Sequence[float], **labels):
        return _NULL_INSTRUMENT

    def span(self, *a, **k):
        return {}

    def instant(self, *a, **k):
        pass

    def async_span(self, *a, **k):
        pass

    def step(self, *a, **k):
        return {}

    def annotate_step(self, **k):
        pass

    def sample_stats(self, *a, **k):
        pass

    def begin_run(self) -> None:
        pass


NULL_OBS = _NullObservability()


# ----------------------------------------------------------------------------
# exporters
# ----------------------------------------------------------------------------

def _us(t: float) -> float:
    return round(t * 1e6, 3)


def _track_name(tid: int) -> str:
    if tid == DISPATCH_TID:
        return "dispatch"
    if tid == FLIGHT_TID:
        return "flight-recorder"
    return f"slot {tid}"


def _render_trace(spans: Sequence[Dict[str, Any]],
                  instants: Sequence[Dict[str, Any]],
                  asyncs: Sequence[Dict[str, Any]],
                  other: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Render span/instant/async records as a Chrome/Perfetto
    `trace_event` document: one process per replica (pid), one thread
    per slot track plus the dispatch track (tid), complete ("X") spans
    for slot residency / lifecycle phases / dispatches, async ("b"/"e")
    spans for queue residency, and metadata naming every track.
    Timestamps are microseconds on the shared run clock. Shared by the
    full-trace exporter and the flight recorder's ring dumps."""
    events: List[Dict[str, Any]] = []
    tracks = set()
    for s in spans:
        tracks.add((s["pid"], s["tid"]))
        events.append({"name": s["name"], "cat": s["cat"], "ph": "X",
                       "ts": _us(s["t0"]),
                       "dur": max(_us(s["t1"]) - _us(s["t0"]), 0.0),
                       "pid": s["pid"], "tid": s["tid"],
                       "args": s["args"]})
    for i in instants:
        tracks.add((i["pid"], i["tid"]))
        events.append({"name": i["name"], "cat": i["cat"], "ph": "i",
                       "ts": _us(i["t"]), "s": "t", "pid": i["pid"],
                       "tid": i["tid"], "args": i["args"]})
    for a in asyncs:
        base = {"name": a["name"], "cat": a["cat"],
                "id": str(a["id"]), "pid": a["pid"], "tid": 0}
        events.append({**base, "ph": "b", "ts": _us(a["t0"]),
                       "args": a["args"]})
        events.append({**base, "ph": "e", "ts": _us(a["t1"])})
    for pid in sorted({p for p, _ in tracks} | {a["pid"]
                                                for a in asyncs}):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"replica {pid}"}})
    for pid, tid in sorted(tracks):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": _track_name(tid)}})
    other_data = {"schema": TRACE_SCHEMA}
    if other:
        other_data.update(other)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other_data}


def to_perfetto(obs: Observability) -> Dict[str, Any]:
    """The full recorded trace as a Perfetto document (see
    `_render_trace` for the layout)."""
    return _render_trace(obs.spans, obs.instants, obs.asyncs)


def metrics_dump(obs: Observability) -> Dict[str, Any]:
    """The registry (plus time series) as a schema-versioned document;
    with an SLOTracker attached (`obs.slo`), also the per-(metric,
    class) quantile sketches and the SLO summary (v2 sections)."""
    doc = {"schema": METRICS_SCHEMA}
    doc.update(obs.registry.to_dict())
    slo = getattr(obs, "slo", None)
    if slo is not None:
        doc["sketches"] = slo.sketch_rows()
        doc["slo"] = slo.snapshot()
    return doc


def export_trace(obs: Observability, path: str) -> Dict[str, Any]:
    doc = to_perfetto(obs)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def export_metrics(obs: Observability, path: str) -> Dict[str, Any]:
    doc = metrics_dump(obs)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


# ----------------------------------------------------------------------------
# schema validation (the CI gate)
# ----------------------------------------------------------------------------

def validate_trace_events(doc: Any) -> List[str]:
    """Errors that would make `doc` invalid Chrome trace_event JSON
    (empty list = loads in Perfetto). Checks the envelope, per-phase
    required fields, and numeric/orderable timestamps."""
    errs: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document must be an object with a traceEvents list"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    open_async: Dict[tuple, int] = {}
    for n, ev in enumerate(events):
        where = f"traceEvents[{n}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            errs.append(f"{where}: missing ph")
            continue
        if not isinstance(ev.get("name"), str):
            errs.append(f"{where}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errs.append(f"{where}: missing integer {key}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: ph={ph} needs a non-negative ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: complete event needs dur >= 0")
        elif ph in ("b", "e"):
            if not isinstance(ev.get("id"), str):
                errs.append(f"{where}: async event needs a string id")
            else:
                key = (ev.get("cat"), ev["id"], ev.get("pid"))
                open_async[key] = open_async.get(key, 0) + (
                    1 if ph == "b" else -1)
                if open_async[key] < 0:
                    errs.append(f"{where}: async end without begin "
                                f"for id {ev['id']}")
        elif ph == "i":
            if ev.get("s") not in (None, "t", "p", "g"):
                errs.append(f"{where}: instant scope must be t/p/g")
        elif ph not in ("B", "E", "C"):
            errs.append(f"{where}: unsupported phase {ph!r}")
    for key, depth in open_async.items():
        if depth != 0:
            errs.append(f"async span id {key[1]} left open")
    fr = (doc.get("otherData") or {}).get("flight_recorder") \
        if isinstance(doc.get("otherData"), dict) else None
    if fr is not None:
        if not isinstance(fr, dict):
            errs.append("otherData.flight_recorder must be an object")
        else:
            for key in ("capacity", "events", "dropped"):
                if not isinstance(fr.get(key), int) or fr[key] < 0:
                    errs.append(f"flight_recorder.{key} must be a "
                                f"non-negative integer")
            if not isinstance(fr.get("anomalies"), list):
                errs.append("flight_recorder.anomalies must be a list")
            else:
                for n, a in enumerate(fr["anomalies"]):
                    if not (isinstance(a, dict)
                            and isinstance(a.get("t"), (int, float))
                            and isinstance(a.get("reason"), str)):
                        errs.append(f"flight_recorder.anomalies[{n}]: "
                                    f"needs numeric t and string reason")
    return errs


def validate_metrics_dump(doc: Any) -> List[str]:
    """Errors that would make `doc` an invalid metrics dump (empty list
    = valid). Accepts every schema generation in METRICS_SCHEMAS — v1
    documents (no sketch/SLO sections) stay valid under the v2
    validator; the v2-only sections are validated when present."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["document must be an object"]
    if doc.get("schema") not in METRICS_SCHEMAS:
        errs.append(f"schema must be one of {METRICS_SCHEMAS!r}, "
                    f"got {doc.get('schema')!r}")
    for section in ("counters", "gauges", "histograms", "series"):
        if not isinstance(doc.get(section), list):
            errs.append(f"{section} must be a list")
    for kind in ("counters", "gauges"):
        for n, row in enumerate(doc.get(kind) or []):
            if not (isinstance(row, dict) and isinstance(row.get("name"),
                                                         str)
                    and isinstance(row.get("labels"), dict)
                    and isinstance(row.get("value"), (int, float))):
                errs.append(f"{kind}[{n}]: needs name/labels/value")
    for n, row in enumerate(doc.get("histograms") or []):
        if not (isinstance(row, dict) and isinstance(row.get("name"), str)
                and isinstance(row.get("labels"), dict)):
            errs.append(f"histograms[{n}]: needs name/labels")
            continue
        bounds, counts = row.get("bounds"), row.get("counts")
        if not (isinstance(bounds, list) and isinstance(counts, list)
                and len(counts) == len(bounds) + 1):
            errs.append(f"histograms[{n}]: counts must have "
                        f"len(bounds) + 1 buckets")
        if not isinstance(row.get("count"), int):
            errs.append(f"histograms[{n}]: needs an integer count")
    for n, row in enumerate(doc.get("series") or []):
        if not (isinstance(row, dict)
                and isinstance(row.get("t"), (int, float))):
            errs.append(f"series[{n}]: needs a numeric t")
    # v2 optional sections
    if "sketches" in doc:
        if not isinstance(doc["sketches"], list):
            errs.append("sketches must be a list")
        else:
            for n, row in enumerate(doc["sketches"]):
                where = f"sketches[{n}]"
                if not (isinstance(row, dict)
                        and isinstance(row.get("name"), str)
                        and isinstance(row.get("labels"), dict)):
                    errs.append(f"{where}: needs name/labels")
                    continue
                if not (isinstance(row.get("rel_err"), (int, float))
                        and 0 < row["rel_err"] < 1):
                    errs.append(f"{where}: rel_err must be in (0, 1)")
                if not (isinstance(row.get("count"), int)
                        and row["count"] >= 0):
                    errs.append(f"{where}: needs a non-negative count")
                if not isinstance(row.get("sum"), (int, float)):
                    errs.append(f"{where}: needs a numeric sum")
                buckets = row.get("buckets")
                if not isinstance(buckets, list):
                    errs.append(f"{where}: buckets must be a list")
                else:
                    for b in buckets:
                        if not (isinstance(b, list) and len(b) == 2
                                and all(isinstance(x, int) and x >= 0
                                        for x in b)):
                            errs.append(f"{where}: buckets must be "
                                        f"[index, count] integer pairs")
                            break
                    if isinstance(row.get("count"), int) \
                            and sum(b[1] for b in buckets
                                    if isinstance(b, list) and len(b) == 2
                                    and isinstance(b[1], int)) \
                            != row["count"]:
                        errs.append(f"{where}: bucket counts must sum "
                                    f"to count")
    if "slo" in doc and not isinstance(doc["slo"], dict):
        errs.append("slo must be an object")
    return errs
