"""Autoscaler: the policy layer that closes the telemetry->control loop
(PyTorch port of `repro.serving.autoscaler`, host code copied).

The sixth layer of the serving stack (autoscaler -> router -> replicas
-> scheduler -> block manager -> runner), and the first one that ACTS
on the signals the observability layer records instead of only
recording them. It consumes the same per-replica `SchedulerStats`
occupancy feed that `Observability.sample_stats` publishes as the
metrics time series (queue depth, slot occupancy, block supply on the
shared cluster clock) and drives replica lifecycle through the router:

  scale-out   sustained per-replica queue depth above `queue_high` for
              `high_window_s` seconds -> activate a replica: first
              cancel a drain in progress, else take one from the
              STANDBY pool (a previously-built engine stack whose pools
              are allocated and whose kernels are loaded — activation
              costs one list append, not a build), else call the
              `spawn` factory. Mid-run joiners adopt the cluster clock
              without touching shared telemetry (Router.add_replica).
  scale-in    sustained per-replica load (queue + active slots) at or
              below `queue_low` for `low_window_s` seconds while more
              than `min_replicas` are enabled -> drain the least-loaded
              replica: `Router.disable` requeues its unadmitted
              requests onto the cluster queue; lanes already running
              finish where they are (preempted lanes' resume requests
              stay — their cached KV is replica-local).
  reclaim     a draining replica that has fully emptied is removed from
              the router (its completions are held for `run()`), its
              prefix cache dropped, and its engine stack parked back in
              the standby pool, warm for the next burst.

Hysteresis comes from the separate high/low thresholds plus the
sustain windows; `cooldown_s` spaces decisions so one burst cannot
flap the cluster. Every decision lands as observability counters
(`autoscaler_scale_out_total` / `autoscaler_scale_in_total` /
`autoscaler_reclaimed_total`), a replica-count gauge, and a trace
instant on the control track.

`AutoscaleController` is the pure decision core: feed it
(t, queue_depth, active_slots, n_replicas) samples — live snapshots or
a recorded stats series — and it returns 'out' / 'in' / None. The
policy unit tests drive it over synthetic series; `Autoscaler.tick`
wires it to a live Router.

Because every request's realization is batch-composition independent,
scaling events never change outputs: on the CPU an autoscaled run is
bit-identical to a fixed-size run of the same workload; on a GPU its
tokens differ only where bf16 GEMMs of another batch width round a
top-2 tie the other way (chip_smoke.py holds them to the margin rule).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

from repro_torch.serving.observability import NULL_OBS, Observability
from repro_torch.serving.replica import Replica

# trace track for control-plane instants (request lanes use slot ids,
# dispatches use DISPATCH_TID=99 — keep clear of both)
CONTROL_TID = 90


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Knobs for the scale-out/scale-in state machine.

    queue_high     per-enabled-replica QUEUE depth at or above which
                   pressure accumulates toward a scale-out
    queue_low      per-enabled-replica LOAD (queue + active slots) at or
                   below which idleness accumulates toward a scale-in;
                   keep queue_low < queue_high + slots or the fresh
                   post-scale-out equilibrium re-triggers a scale-in
                   (that gap IS the hysteresis band)
    high_window_s  seconds the high signal must sustain before scaling
                   out (absorbs one-step blips)
    low_window_s   seconds the low signal must sustain before scaling
                   in (longer than high: adding capacity is cheap and
                   urgent, removing it is neither)
    cooldown_s     minimum seconds between any two decisions
    """
    min_replicas: int = 1
    max_replicas: int = 4
    queue_high: float = 2.0
    queue_low: float = 1.0
    high_window_s: float = 0.1
    low_window_s: float = 0.4
    cooldown_s: float = 0.25

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.queue_low >= self.queue_high:
            raise ValueError("need queue_low < queue_high (hysteresis)")


class AutoscaleController:
    """The pure policy core: a hysteresis + cooldown state machine over
    an occupancy sample stream. Stateless about WHAT a replica is —
    testable over synthetic stats series, replayable over a recorded
    metrics dump."""

    kind = "queue-depth"

    def __init__(self, policy: AutoscalePolicy):
        self.policy = policy
        self.reset()

    def reset(self) -> None:
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_decision = float("-inf")

    def observe(self, t: float, queue_depth: float, active_slots: float,
                n_replicas: int) -> Optional[str]:
        """Feed one occupancy sample (cluster totals at time `t`,
        monotone across calls); returns 'out', 'in', or None. A
        decision consumes its accumulated window, so the signal must
        sustain AGAIN before the next same-direction decision — with
        the cooldown, that is the no-flapping guarantee."""
        p = self.policy
        n = max(int(n_replicas), 1)
        q_per = queue_depth / n
        load_per = (queue_depth + active_slots) / n
        if q_per >= p.queue_high:
            if self._above_since is None:
                self._above_since = t
        else:
            self._above_since = None
        if load_per <= p.queue_low:
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


class Autoscaler:
    """Elastic replica lifecycle over a Router (see module docstring).

    standby   pre-built Replicas to activate on scale-out (warm —
              the recommended source; build max_replicas stacks up
              front and hand the router only min_replicas)
    spawn     optional factory `replica_id -> Replica` used when the
              standby pool is empty (a cold spawn allocates its pools
              and pays first-call costs — cuBLAS handles, kernel loads
              — on its first dispatches: fine for capacity, bad for
              p99)
    controller  alternative decision core implementing the same
              `observe(t, queue_depth, active_slots, n_replicas)` /
              `reset()` contract — e.g. `slo.SLOSignal`, which scales
              on TTFT burn rate instead of the queue-depth bands.
              Default: `AutoscaleController(policy)`.

    Construction attaches to the router: `Router._drive` ticks the
    autoscaler once per sweep and calls `begin_run` at run start.
    """

    def __init__(self, router, *, policy: Optional[AutoscalePolicy] = None,
                 standby: Sequence[Replica] = (),
                 spawn: Optional[Callable[[int], Replica]] = None,
                 controller=None,
                 obs: Observability = NULL_OBS):
        self.router = router
        self.policy = policy or AutoscalePolicy()
        self.controller = (controller if controller is not None
                           else AutoscaleController(self.policy))
        self._standby: List[Replica] = list(standby)
        self._spawn = spawn
        ids = [r.replica_id for r in router.replicas]
        ids += [r.replica_id for r in self._standby]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids {sorted(ids)}")
        self._next_id = max(ids) + 1
        self._draining: set = set()    # replica ids disabled, emptying
        self._added: set = set()       # ids the autoscaler activated
        self._obs = obs or NULL_OBS
        self._c_out = self._obs.counter("autoscaler_scale_out_total")
        self._c_in = self._obs.counter("autoscaler_scale_in_total")
        self._c_reclaimed = self._obs.counter("autoscaler_reclaimed_total")
        self._g_replicas = self._obs.gauge("autoscaler_replicas_gauge")
        self.scale_out_events = 0
        self.scale_in_events = 0
        self.reclaims = 0
        self.skipped_scale_outs = 0    # decision with no source to add
        self.events: List[dict] = []   # [{'t','event','replica'}, ...]
        router.autoscaler = self

    # -- lifecycle ---------------------------------------------------------

    def begin_run(self, t0: float) -> None:
        """Per-run reset, called by Router._drive BEFORE the base
        replicas' begin_run: retire every autoscaled replica to standby
        (clean telemetry, cold prefix cache, aligned clock — registry
        resets here are pre-run, so nothing is lost), cancel drains,
        re-enable the base set, and zero the event log."""
        for rid in sorted(self._added):
            try:
                rep = self.router.remove_replica(rid)
            except (KeyError, RuntimeError):
                continue              # already gone, or still has work
            rep.begin_run(t0)
            rep.reset_prefix_cache()
            self._standby.append(rep)
        self._added.clear()
        self._draining.clear()
        for rep in self.router.replicas:
            rep.enabled = True
        for rep in self._standby:
            rep.begin_run(t0)
            rep.reset_prefix_cache()
        self.controller.reset()
        self.scale_out_events = 0
        self.scale_in_events = 0
        self.reclaims = 0
        self.skipped_scale_outs = 0
        self.events = []

    # -- the control loop --------------------------------------------------

    def _enabled(self) -> List[Replica]:
        return [r for r in self.router.replicas if r.enabled]

    def tick(self, now: float) -> Optional[str]:
        """One control-loop iteration on the cluster clock: reclaim any
        drained replicas, sample occupancy, act on the controller's
        decision. Returns the action taken ('out'/'in'/None)."""
        for rid in sorted(self._draining):
            rep = next((r for r in self.router.replicas
                        if r.replica_id == rid), None)
            if rep is None:
                self._draining.discard(rid)
                continue
            if rep.has_work:
                continue
            self.router.remove_replica(rid)
            rep.reset_prefix_cache()
            self._standby.append(rep)
            self._draining.discard(rid)
            self._added.discard(rid)
            self.reclaims += 1
            self._c_reclaimed.inc()
            self._event(now, "reclaim", rid)
        enabled = self._enabled()
        qd = len(self.router._queue) + sum(
            r.snapshot().queue_depth for r in enabled)
        act = sum(r.snapshot().active_slots for r in enabled)
        decision = self.controller.observe(now, qd, act, len(enabled))
        if decision == "out":
            return self._scale_out(now)
        if decision == "in":
            return self._scale_in(now)
        return None

    def _scale_out(self, now: float) -> Optional[str]:
        if self._draining:
            # cheapest capacity: cancel a drain in progress
            rid = min(self._draining)
            self.router.enable(rid)
            self._draining.discard(rid)
        elif self._standby:
            rep = self._standby.pop()
            self.router.add_replica(rep)
            self._added.add(rep.replica_id)
            rid = rep.replica_id
        elif self._spawn is not None:
            rep = self._spawn(self._next_id)
            self._next_id += 1
            self.router.add_replica(rep)
            self._added.add(rep.replica_id)
            rid = rep.replica_id
        else:
            self.skipped_scale_outs += 1
            return None
        self.scale_out_events += 1
        self._c_out.inc()
        self._g_replicas.set(len(self._enabled()))
        self._event(now, "scale-out", rid)
        return "out"

    def _scale_in(self, now: float) -> Optional[str]:
        # drain the least-loaded enabled replica; prefer one the
        # autoscaler added (the base set is the steady-state cluster)
        cands = [r for r in self._enabled()
                 if r.replica_id not in self._draining]
        if len(cands) <= self.policy.min_replicas:
            return None
        added = [r for r in cands if r.replica_id in self._added]
        pool = added or cands
        victim = min(pool, key=lambda r: (r.snapshot().load,
                                          -r.replica_id))
        self.router.disable(victim.replica_id)
        self._draining.add(victim.replica_id)
        self.scale_in_events += 1
        self._c_in.inc()
        self._g_replicas.set(len(self._enabled()))
        self._event(now, "scale-in", victim.replica_id)
        return "in"

    def _event(self, now: float, kind: str, rid: int) -> None:
        self.events.append({"t": round(now, 4), "event": kind,
                            "replica": rid})
        if self._obs.enabled:
            self._obs.instant(CONTROL_TID, kind, "autoscale", now,
                              replica=rid,
                              enabled=len(self._enabled()),
                              standby=len(self._standby))

    # -- reporting ---------------------------------------------------------

    def summary(self) -> dict:
        """The record a bench embeds: policy, event counts, event log."""
        return {
            "policy": dataclasses.asdict(self.policy),
            "signal": getattr(self.controller, "kind", "queue-depth"),
            "enabled_replicas": len(self._enabled()),
            "standby_replicas": len(self._standby),
            "draining_replicas": len(self._draining),
            "scale_out_events": self.scale_out_events,
            "scale_in_events": self.scale_in_events,
            "reclaims": self.reclaims,
            "skipped_scale_outs": self.skipped_scale_outs,
            "events": self.events,
        }
