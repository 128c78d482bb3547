"""SLO layer: streaming latency sketches, burn rates, and the
burn-rate autoscale signal — the measurement half of closed-loop
serving control.

The source paper's minibatch-prox argument is a time-budget argument:
do the statistically right amount of work per round given the costs
you actually observe. This module gives the serving stack the observed
side of that loop. Three pieces:

  * `QuantileSketch` — a bounded-memory streaming quantile estimator:
    a fixed log-spaced-bucket histogram (the DDSketch bucket layout)
    whose bucket representatives pin every quantile estimate within a
    declared RELATIVE error bound of the exact order statistic. With
    gamma = (1 + rel_err) / (1 - rel_err), bucket i covers
    (min_value * gamma^(i-1), min_value * gamma^i] and reports
    min_value * gamma^i * 2 / (1 + gamma), whose relative error against
    either edge is (gamma-1)/(gamma+1) = rel_err, so
    |estimate - exact| <= rel_err * exact for any value
    in (min_value, max_value] — tested against numpy's exact
    nearest-rank quantile on adversarial distributions. Memory is
    FIXED at construction (the bucket array), never grows with the
    stream, and two sketches with the same config merge by adding
    counts (exactly — the estimator is a counting histogram).

  * `SLOPolicy` + `SLOTracker` — declared objectives (per-priority-
    class TTFT, a global e2e latency objective, an error budget) and
    the live accounting against them: per-(metric, class) sketches for
    TTFT / TPOT / e2e latency plus time-bucketed good/bad windows that
    yield the multi-window BURN RATE, the SRE alerting quantity:

        burn(now, W) = (bad fraction over the last W seconds)
                       / error_budget

    burn == 1 means the service is spending its error budget exactly
    at the sustainable rate; burn > 1 over the FAST window catches an
    active incident quickly, while the SLOW window filters blips —
    the classic multi-window burn-rate alert, here feeding actuators
    instead of a pager.

  * `SLOSignal` — the burn-rate alternative to the queue-depth
    `AutoscaleController`: same observe(t, queue_depth, active_slots,
    n_replicas) -> 'out' / 'in' / None interface (drop-in for
    `Autoscaler(..., controller=...)`), but the decision input is the
    tracker's TTFT burn rate — scale out on sustained burn > 1 of the
    TTFT objective, scale in on sustained burn well below budget —
    with the same sustain-window + cooldown hysteresis so it cannot
    flap. Queue depth is ignored by design: this signal scales on what
    users experience, not on what the queue looks like.

The scheduler's shed / defer admission decisions (serving/scheduler.py)
read the SAME tracker: the live TTFT estimate (`ttft_quantile(0.5)`)
prices a queued request's expected wait against its deadline. All of
this is measurement-side only — nothing here touches device dispatch,
and with no tracker attached every hook costs one `is not None` check.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serving.observability import NULL_OBS, Observability

# trace_event track for SLO control-plane instants (shed / defer /
# breach markers). Slot tracks use tid == slot index, the autoscaler
# uses CONTROL_TID = 90 — keep clear of both.
SLO_TID = 91


# ----------------------------------------------------------------------------
# streaming quantile sketch
# ----------------------------------------------------------------------------

class QuantileSketch:
    """Bounded-memory streaming quantiles with a pinned relative-error
    bound (log-spaced buckets, DDSketch layout).

    rel_err     guaranteed bound: for any q and any stream of values in
                (min_value, max_value], |quantile(q) - exact| <=
                rel_err * exact, where `exact` is the nearest-rank
                order statistic (numpy.quantile method='inverted_cdf')
    min_value   absolute floor: values at or below it collapse into
                bucket 0 and report min_value (the bound is absolute,
                not relative, down there — pick it below any latency
                you care to distinguish)
    max_value   ceiling: larger values clamp into the top bucket

    Memory is fixed at construction: ceil(log_gamma(max/min)) + 1
    integer buckets (~1000 for microseconds-to-an-hour at 1%), never
    grows with the stream.
    """

    __slots__ = ("rel_err", "min_value", "max_value", "gamma",
                 "_log_gamma", "counts", "count", "total")

    def __init__(self, rel_err: float = 0.01, *, min_value: float = 1e-5,
                 max_value: float = 3600.0):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        if not 0.0 < min_value < max_value:
            raise ValueError("need 0 < min_value < max_value")
        self.rel_err = float(rel_err)
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self.gamma)
        n = int(math.ceil(math.log(max_value / min_value)
                          / self._log_gamma)) + 1
        self.counts = [0] * n
        self.count = 0
        self.total = 0.0

    def _index(self, v: float) -> int:
        if v <= self.min_value:
            return 0
        i = int(math.ceil(math.log(v / self.min_value) / self._log_gamma))
        return min(i, len(self.counts) - 1)

    def _value(self, i: int) -> float:
        if i <= 0:
            return self.min_value
        # the point of (L, U] = (min * gamma^(i-1), min * gamma^i] whose
        # relative error against either edge is (gamma-1)/(gamma+1) ==
        # rel_err (the pinned bound): U * 2 / (1 + gamma). The arithmetic
        # midpoint (L + U) / 2 is off by (gamma-1)/2 > rel_err against a
        # value just above L.
        return self.min_value * (self.gamma ** i) * 2.0 / (1.0 + self.gamma)

    def observe(self, v: float) -> None:
        self.counts[self._index(v)] += 1
        self.count += 1
        self.total += v

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile estimate (None on an empty sketch):
        the representative point of the bucket holding the ceil(q*n)-th
        ordered observation — within rel_err of the exact order
        statistic."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = max(1, int(math.ceil(q * self.count)))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self._value(i)
        return self._value(len(self.counts) - 1)   # unreachable

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Add another sketch's counts into this one (exact — the
        merged sketch equals the sketch of the concatenated streams).
        Configs must match bucket-for-bucket."""
        if (other.rel_err != self.rel_err
                or other.min_value != self.min_value
                or other.max_value != self.max_value):
            raise ValueError("cannot merge sketches with different "
                             "rel_err/min_value/max_value")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        return self

    def reset(self) -> None:
        self.counts = [0] * len(self.counts)
        self.count = 0
        self.total = 0.0

    def to_dict(self) -> Dict:
        """Sparse dump row (metrics-dump `sketches` section): only the
        occupied buckets, as [index, count] pairs."""
        return {"rel_err": self.rel_err, "min_value": self.min_value,
                "max_value": self.max_value, "count": self.count,
                "sum": self.total,
                "buckets": [[i, c] for i, c in enumerate(self.counts)
                            if c]}


# ----------------------------------------------------------------------------
# policy + burn-rate windows
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Declared service-level objectives.

    ttft_objective_ms     TTFT target: a request whose first token
                          lands later than this is a BAD event
    class_ttft_ms         per-priority-class TTFT overrides as
                          ((priority, objective_ms), ...) pairs —
                          classes not listed use ttft_objective_ms
    latency_objective_ms  e2e latency target (None = no e2e objective)
    error_budget          allowed BAD fraction: burn rate is the
                          observed bad fraction divided by this
    fast_window_s         burn-rate detection window (incident-fast)
    slow_window_s         burn-rate confirmation window (blip filter);
                          also how long window history is retained
    """
    ttft_objective_ms: float = 200.0
    class_ttft_ms: Tuple[Tuple[int, float], ...] = ()
    latency_objective_ms: Optional[float] = None
    error_budget: float = 0.1
    fast_window_s: float = 0.25
    slow_window_s: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "class_ttft_ms",
                           tuple((int(p), float(o))
                                 for p, o in self.class_ttft_ms))
        if self.ttft_objective_ms <= 0:
            raise ValueError("ttft_objective_ms must be > 0")
        for p, o in self.class_ttft_ms:
            if o <= 0:
                raise ValueError(f"class {p}: objective must be > 0")
        if self.latency_objective_ms is not None \
                and self.latency_objective_ms <= 0:
            raise ValueError("latency_objective_ms must be > 0")
        if not 0.0 < self.error_budget < 1.0:
            raise ValueError("error_budget must be in (0, 1)")
        if not 0.0 < self.fast_window_s < self.slow_window_s:
            raise ValueError("need 0 < fast_window_s < slow_window_s")

    def ttft_objective_s(self, priority: int = 0) -> float:
        for p, o in self.class_ttft_ms:
            if p == priority:
                return o / 1e3
        return self.ttft_objective_ms / 1e3

    def latency_objective_s(self, priority: int = 0) -> Optional[float]:
        if self.latency_objective_ms is None:
            return None
        return self.latency_objective_ms / 1e3


class _BurnWindow:
    """Time-bucketed good/bad event counts for windowed burn rates:
    a deque of [bucket_t0, total, bad] rows at `bucket_s` granularity,
    pruned past `keep_s` — bounded memory for any stream length."""

    __slots__ = ("bucket_s", "keep_s", "_rows", "ever")

    def __init__(self, bucket_s: float, keep_s: float):
        self.bucket_s = float(bucket_s)
        self.keep_s = float(keep_s)
        self._rows: Deque[List[float]] = deque()
        self.ever = 0                 # observations over all time

    def observe(self, t: float, bad: bool) -> None:
        b0 = math.floor(t / self.bucket_s) * self.bucket_s
        if not self._rows or self._rows[-1][0] < b0:
            self._rows.append([b0, 0, 0])
        self._rows[-1][1] += 1
        self._rows[-1][2] += int(bad)
        self.ever += 1
        self._prune(t)

    def _prune(self, now: float) -> None:
        edge = now - self.keep_s - self.bucket_s
        while self._rows and self._rows[0][0] < edge:
            self._rows.popleft()

    def fraction(self, now: float, window_s: float) -> Optional[float]:
        """Bad fraction over [now - window_s, now]; 0.0 for an idle
        window once anything was ever observed (no traffic = no budget
        spent), None before the first observation ever."""
        self._prune(now)
        lo = now - window_s
        total = bad = 0
        for t0, n, b in self._rows:
            if t0 + self.bucket_s > lo:
                total += n
                bad += b
        if total == 0:
            return 0.0 if self.ever else None
        return bad / total

    def reset(self) -> None:
        self._rows.clear()
        self.ever = 0


class SLOTracker:
    """Live SLO accounting: per-(metric, priority-class) quantile
    sketches plus burn-rate windows against an `SLOPolicy`.

    One tracker is shared by every consumer of the same objectives —
    the scheduler feeds it observations (TTFT at first token, TPOT and
    e2e latency at completion) and reads the live TTFT estimate for
    shed/defer admission; `SLOSignal` reads burn rates for scaling; a
    cluster's replicas share one tracker so burn is cluster-wide.

    observe_* return True when the observation breached its objective
    (the caller's hook for breach counters / flight-recorder triggers).
    """

    METRICS = ("ttft", "tpot", "latency")

    def __init__(self, policy: SLOPolicy, *, rel_err: float = 0.01,
                 bucket_s: float = 0.05):
        self.policy = policy
        self.rel_err = float(rel_err)
        self.bucket_s = float(bucket_s)
        self._sketches: Dict[Tuple[str, int], QuantileSketch] = {}
        keep = policy.slow_window_s
        self._windows = {m: _BurnWindow(bucket_s, keep)
                         for m in ("ttft", "latency")}
        self.breaches = {"ttft": 0, "latency": 0}
        self.peak_burn = {"fast": 0.0, "slow": 0.0}

    def _sketch(self, metric: str, priority: int) -> QuantileSketch:
        key = (metric, int(priority))
        sk = self._sketches.get(key)
        if sk is None:
            sk = self._sketches[key] = QuantileSketch(self.rel_err)
        return sk

    # -- feeding ---------------------------------------------------------

    def observe_ttft(self, t: float, value_s: float,
                     priority: int = 0) -> bool:
        self._sketch("ttft", priority).observe(value_s)
        bad = value_s > self.policy.ttft_objective_s(priority)
        self._windows["ttft"].observe(t, bad)
        if bad:
            self.breaches["ttft"] += 1
        return bad

    def observe_latency(self, t: float, value_s: float,
                        priority: int = 0) -> bool:
        self._sketch("latency", priority).observe(value_s)
        obj = self.policy.latency_objective_s(priority)
        bad = obj is not None and value_s > obj
        if obj is not None:
            self._windows["latency"].observe(t, bad)
            if bad:
                self.breaches["latency"] += 1
        return bad

    def observe_tpot(self, t: float, value_s: float,
                     priority: int = 0) -> None:
        self._sketch("tpot", priority).observe(value_s)

    # -- reading ---------------------------------------------------------

    def quantile(self, metric: str, q: float,
                 priority: Optional[int] = None) -> Optional[float]:
        """Quantile estimate in seconds for one class, or across every
        class (priority=None, sketches merged); None with no data."""
        if priority is not None:
            sk = self._sketches.get((metric, int(priority)))
            return sk.quantile(q) if sk is not None else None
        merged: Optional[QuantileSketch] = None
        for (m, _), sk in self._sketches.items():
            if m != metric or sk.count == 0:
                continue
            if merged is None:
                merged = QuantileSketch(self.rel_err)
            merged.merge(sk)
        return merged.quantile(q) if merged is not None else None

    def ttft_quantile(self, q: float,
                      priority: Optional[int] = None) -> Optional[float]:
        return self.quantile("ttft", q, priority)

    def burn_rate(self, now: float, window_s: float,
                  metric: str = "ttft") -> Optional[float]:
        """(bad fraction over the last window_s) / error_budget; 0.0
        for idle windows after any traffic, None before any."""
        frac = self._windows[metric].fraction(now, window_s)
        if frac is None:
            return None
        return frac / self.policy.error_budget

    def tick(self, now: float) -> Tuple[Optional[float], Optional[float]]:
        """The control-loop read: TTFT burn over the policy's fast and
        slow windows, with run peaks recorded (what the bench gates
        on: peak fast burn > 1 during the burst)."""
        fast = self.burn_rate(now, self.policy.fast_window_s)
        slow = self.burn_rate(now, self.policy.slow_window_s)
        if fast is not None:
            self.peak_burn["fast"] = max(self.peak_burn["fast"], fast)
        if slow is not None:
            self.peak_burn["slow"] = max(self.peak_burn["slow"], slow)
        return fast, slow

    # -- lifecycle / export ----------------------------------------------

    def reset(self) -> None:
        for sk in self._sketches.values():
            sk.reset()
        for w in self._windows.values():
            w.reset()
        self.breaches = {"ttft": 0, "latency": 0}
        self.peak_burn = {"fast": 0.0, "slow": 0.0}

    def sketch_rows(self) -> List[Dict]:
        """Metrics-dump `sketches` section: one row per (metric,
        class) sketch, sparse-bucket encoded."""
        rows = []
        for (metric, prio), sk in sorted(self._sketches.items()):
            if sk.count == 0:
                continue
            row = {"name": f"slo_{metric}_sketch",
                   "labels": {"priority": prio}}
            row.update(sk.to_dict())
            rows.append(row)
        return rows

    def snapshot(self) -> Dict:
        """The summary block a bench record embeds: policy, breach
        counts, peak burn, and headline quantile estimates (ms)."""
        def q_ms(metric, q):
            v = self.quantile(metric, q)
            return round(v * 1e3, 3) if v is not None else None

        return {
            "policy": dataclasses.asdict(self.policy),
            "sketch_rel_err": self.rel_err,
            "observed": {m: sum(sk.count
                                for (mm, _), sk in self._sketches.items()
                                if mm == m)
                         for m in self.METRICS},
            "breaches": dict(self.breaches),
            "peak_burn": {k: round(v, 3)
                          for k, v in self.peak_burn.items()},
            "ttft_p50_ms": q_ms("ttft", 0.5),
            "ttft_p99_ms": q_ms("ttft", 0.99),
            "latency_p99_ms": q_ms("latency", 0.99),
        }


# ----------------------------------------------------------------------------
# the burn-rate autoscale signal
# ----------------------------------------------------------------------------

class SLOSignal:
    """Burn-rate-driven scaling decisions: a drop-in alternative to the
    queue-depth `AutoscaleController` (same observe() contract, same
    sustain-window + cooldown hysteresis), selectable per run via
    `Autoscaler(..., controller=SLOSignal(...))`.

    scale out   TTFT burn over the policy's FAST window above
                `scale_out_burn` (default 1.0: spending budget faster
                than sustainable) sustained for `high_window_s`
    scale in    TTFT burn over the SLOW window below `scale_in_burn`
                (default 0.25: well under budget) sustained for
                `low_window_s` — the slow window plus the lower
                threshold is the hysteresis band

    The AutoscalePolicy supplies replica bounds, sustain windows, and
    the cooldown; its queue_high/queue_low bands are ignored — this
    signal scales on observed user latency, not queue shape. Before
    any completion lands, burn is undefined and no decision fires (a
    cold cluster scales on nothing)."""

    kind = "slo-burn-rate"

    def __init__(self, tracker: SLOTracker, policy, *,
                 scale_out_burn: float = 1.0, scale_in_burn: float = 0.25,
                 obs: Observability = NULL_OBS):
        if not 0.0 <= scale_in_burn < scale_out_burn:
            raise ValueError("need 0 <= scale_in_burn < scale_out_burn "
                             "(the hysteresis band)")
        self.tracker = tracker
        self.policy = policy
        self.scale_out_burn = float(scale_out_burn)
        self.scale_in_burn = float(scale_in_burn)
        self._obs = obs or NULL_OBS
        self._g_fast = self._obs.gauge("slo_burn_rate_fast_gauge")
        self._g_slow = self._obs.gauge("slo_burn_rate_slow_gauge")
        self.reset()

    def reset(self) -> None:
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_decision = float("-inf")

    def observe(self, t: float, queue_depth: float, active_slots: float,
                n_replicas: int) -> Optional[str]:
        """Same contract as AutoscaleController.observe — queue/slot
        occupancy are accepted (the Autoscaler feeds them) but the
        decision reads only the tracker's burn rates."""
        p = self.policy
        fast, slow = self.tracker.tick(t)
        self._g_fast.set(fast or 0.0)
        self._g_slow.set(slow or 0.0)
        if fast is not None and fast > self.scale_out_burn:
            if self._above_since is None:
                self._above_since = t
        else:
            self._above_since = None
        if slow is not None and slow < self.scale_in_burn:
            if self._below_since is None:
                self._below_since = t
        else:
            self._below_since = None
        cool = (t - self._last_decision) >= p.cooldown_s
        if (self._above_since is not None
                and n_replicas < p.max_replicas and cool
                and t - self._above_since >= p.high_window_s):
            self._last_decision = t
            self._above_since = None
            return "out"
        if (self._below_since is not None
                and n_replicas > p.min_replicas and cool
                and t - self._below_since >= p.low_window_s):
            self._last_decision = t
            self._below_since = None
            return "in"
        return None
