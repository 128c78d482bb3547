"""Router: a multi-replica serving cluster over a cluster-wide queue
(PyTorch port of `repro.serving.router`).

The layer ABOVE the engine (router -> replicas -> scheduler ->
block manager -> runner). Where the engine applies the paper's tradeoff
within one machine (hold a batch, synchronize at coarse boundaries),
the router applies its distributed form across machines: replicas run
fully locally — their own queues, slots, paged pools, prefix caches —
and the only cluster-wide communication is the placement decision per
request and the completion coming back, the intermittent-communication
regime of the distributed designs in PAPERS.md.

Responsibilities:

  * cluster-wide near-FCFS queue + backpressure — requests enter the
    router's queue; `place()` moves them onto replicas only while the
    target's own queue is shallower than `max_queue` (deep enough to
    keep bucketed prefill batched, shallow enough that placement waits
    for fresh occupancy/affinity signals instead of committing the
    whole backlog blind). A request whose target is at capacity HOLDS
    its place in line, but requests within a bounded window behind it
    may pass when their own target has room (a held request waits for
    capacity, not ordering — without the jump, one full sticky home
    would idle every other replica); per-replica bucketed admission
    still reorders locally.
  * pluggable placement policies —
      'round-robin'      rotate over enabled replicas with room
      'least-loaded'     min slot+queue occupancy (ReplicaSnapshot.load)
      'prefix-affinity'  max `probe_prefix` (the BlockAllocator
                         content-hash probe): route a request to the
                         replica already holding its prompt prefix.
                         The probe only sees PREFILLED prompts, so
                         zero-match requests consult the router's own
                         cold-start pin first — the replica where a
                         request sharing this prompt's leading
                         block-size chunk was last placed (placement
                         log only; no replica state) — and fall back
                         to least-loaded when there is no pin either.
                         Without the pin, every placement issued while
                         a tenant's first prefill is still in flight
                         scatters that tenant blindly; with it, a
                         tenant is pinned from its very first
                         placement and the probe takes over once
                         blocks register.
    Ties always break to least-loaded then lowest replica id, so
    placement is deterministic for a deterministic arrival order.
  * sticky placement — once placed, a request lives and dies on its
    replica (all its paged/recurrent state is local); the one exception
    is drain/failover below.
  * drain / failover — `disable(replica_id)` stops new placement AND
    pulls the replica's queued-but-unadmitted requests back into the
    cluster queue head (original order) to requeue elsewhere; requests
    already in slots finish where they are (the replica keeps stepping
    until drained). `enable` brings it back.
  * cluster run()/stream() — the engine loop lifted one level: open-loop
    arrivals feed the cluster queue, every replica with work advances
    one step per cluster iteration, and per-replica StreamEvents merge
    into one stream. All replicas share one clock origin so latency
    telemetry is comparable.

Because every request's realization is batch-composition independent
(position-keyed sampling, argmax greedy — see serving/sampling.py),
cluster output is BIT-IDENTICAL to a single-replica run of the same
workload for every policy and replica count on the CPU; only placement,
timing, and cache-hit telemetry change. On a GPU, placement changes
each engine's prefill and decode batch, and cuBLAS's bf16 GEMMs are not
batch-invariant across M: there a cluster's tokens equal a single
engine's up to divergences where the top-2 logit gap is within bf16
rounding.

The port's one addition: `now_fn=`, the cluster clock (default
time.perf_counter). Give the replicas' engines the same callable; an
injected clock (a test's step clock) is never slept on.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import (Callable, Deque, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

from repro_torch.serving.engine import summarize
from repro_torch.serving.observability import NULL_OBS, Observability
from repro_torch.serving.replica import Replica
from repro_torch.serving.scheduler import Completion, Request, StreamEvent

POLICIES = ("round-robin", "least-loaded", "prefix-affinity")

_POLICY_ALIASES = {
    "rr": "round-robin", "round-robin": "round-robin",
    "ll": "least-loaded", "least-loaded": "least-loaded",
    "prefix": "prefix-affinity", "prefix-affinity": "prefix-affinity",
}


def normalize_policy(policy: str) -> str:
    """Canonical policy name for a CLI alias ('rr', 'prefix', ...)."""
    try:
        return _POLICY_ALIASES[policy]
    except KeyError:
        raise ValueError(f"unknown router policy {policy!r} "
                         f"(available: {sorted(_POLICY_ALIASES)})")


class Router:
    """Cluster-wide request queue + placement over `replicas`.

    max_queue    per-replica cap on placed-but-unadmitted requests;
                 None derives min(num_slots, prefill_max_batch) per
                 replica (>= 1 — an idle enabled replica always
                 accepts, so placement cannot deadlock while any
                 replica is enabled).
    jump_window  how many queued requests behind a held head `place()`
                 may consider (near-FCFS; None derives 2x the cluster's
                 total queue caps).
    now_fn       the cluster clock (default time.perf_counter); the
                 replicas' engines must read the same one.
    """

    def __init__(self, replicas: Sequence[Replica], *,
                 policy: str = "least-loaded",
                 max_queue: Optional[int] = None,
                 jump_window: Optional[int] = None,
                 obs: Observability = NULL_OBS,
                 now_fn: Optional[Callable[[], float]] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids {ids}")
        self.replicas = list(replicas)
        self.policy = normalize_policy(policy)
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._max_queue = max_queue
        self._jump_window = jump_window
        self._queue: Deque[Request] = deque()
        self._placement: Dict[int, int] = {}   # rid -> replica_id (sticky)
        self._rr = 0                           # round-robin cursor
        # cold-start pins: leading block-size token chunk -> replica_id
        # (prefix-affinity only; see module docstring). Chunk length =
        # the smallest replica block size: the granularity at which the
        # authoritative match_prefix probe can ever match. LRU-bounded:
        # workloads without shared prefixes would otherwise grow one
        # entry per distinct prompt head for the life of the run.
        self._pins: "OrderedDict[tuple, int]" = OrderedDict()
        self._max_pins = 4096
        self._chunk_len = max(1, min(
            getattr(r.engine, "block_size", 16) for r in self.replicas))
        # probe memo: rid -> (prefill epoch, {replica_id: score}). The
        # content-hash probe can only change when some replica's prefill
        # registered new blocks, so a held request is NOT re-probed on
        # every cluster step while nothing prefilled.
        self._probe_memo: Dict[int, Tuple[int, Dict[int, int]]] = {}
        self.requeued = 0                      # drained/failed-over
        self.wall_time = 0.0
        self._obs = obs or NULL_OBS
        self._clock = now_fn or time.perf_counter
        self._t0: Optional[float] = None       # cluster clock origin
        self._c_placed = {
            r.replica_id: self._obs.counter("router_placed_total",
                                            replica=r.replica_id)
            for r in self.replicas}
        self._c_requeued = self._obs.counter("router_requeued_total")
        # completions already collected from replicas REMOVED mid-run
        # (autoscaler scale-in) — merged back by run()
        self._done: List[Completion] = []
        # the active stream() event sink, propagated onto replicas
        # added mid-run so an elastic cluster streams seamlessly
        self._event_sink = None
        # attached by Autoscaler.attach(); ticked once per _drive sweep
        self.autoscaler = None

    def _now(self) -> float:
        """Seconds on the cluster clock (0.0 before the first run)."""
        return (self._clock() - self._t0
                if self._t0 is not None else 0.0)

    # ------------------------------------------------------------------
    # queue + placement
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue on the CLUSTER queue (placement happens in place())."""
        if self._obs.enabled:
            if req.trace is None:
                req.trace = {}
            req.trace.setdefault("queued", self._now())
        self._queue.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(r.has_work for r in self.replicas)

    def placement_of(self, rid: int) -> Optional[int]:
        """Replica id a request is (sticky-)placed on, or None."""
        return self._placement.get(rid)

    def _by_id(self, replica_id: int) -> Replica:
        for r in self.replicas:
            if r.replica_id == replica_id:
                return r
        raise KeyError(replica_id)

    def _cap(self, rep: Replica) -> int:
        if self._max_queue is not None:
            return self._max_queue
        batch = getattr(rep.engine.runner, "prefill_max_batch",
                        rep.num_slots)
        return max(1, min(rep.num_slots, batch))

    def _accepts(self, rep: Replica, snap) -> bool:
        return snap.enabled and snap.queue_depth < self._cap(rep)

    def _snaps(self) -> Dict[int, "object"]:
        return {r.replica_id: r.snapshot() for r in self.replicas}

    def _pick(self, req: Request, snaps=None) -> Optional[Replica]:
        """Target replica for `req` under the policy, or None when every
        enabled replica is at its backpressure cap. `snaps` lets a
        place() sweep reuse one set of replica snapshots across the
        whole scan (occupancy only changes when something is placed)."""
        if snaps is None:
            snaps = self._snaps()
        avail = [r for r in self.replicas
                 if self._accepts(r, snaps[r.replica_id])]
        if not avail:
            return None

        def least_loaded(cands):
            return min(cands, key=lambda r: (snaps[r.replica_id].load,
                                             r.replica_id))

        if self.policy == "round-robin":
            for _ in range(len(self.replicas)):
                r = self.replicas[self._rr % len(self.replicas)]
                self._rr += 1
                if r in avail:
                    return r
            return None                   # unreachable: avail is nonempty
        if self.policy == "least-loaded":
            return least_loaded(avail)
        # prefix-affinity: the replica whose BlockAllocator already holds
        # the longest prefix of this prompt; no holder yet -> follow the
        # cold-start pin (where this leading chunk was last placed);
        # no pin either -> least-loaded, and pin the choice. Affinity is
        # STICKY under backpressure: when the home replica (holder or
        # pin) is enabled but momentarily at its queue cap, the request
        # WAITS at the cluster-queue head rather than overflowing onto a
        # replica that would recompute the whole prefix — the home's
        # queue drains every admission round, so the hold is bounded.
        chunk = self._chunk(req.prompt)
        enabled = [r for r in self.replicas if snaps[r.replica_id].enabled]
        by_id = self._probe(req)
        scores = [(by_id[r.replica_id], r) for r in enabled]
        best = max(s for s, _ in scores)
        if best > 0:
            homes = [r for s, r in scores if s == best]
            in_avail = [r for r in homes if r in avail]
            if not in_avail:
                return None               # hold for the holder(s)
            pick = least_loaded(in_avail)
        else:
            pinned = self._pins.get(chunk) if chunk else None
            home = next((r for r in enabled if r.replica_id == pinned),
                        None)
            if home is not None:
                if home not in avail:
                    return None           # hold for the pinned home
                pick = home
            else:
                pick = least_loaded(avail)
        if chunk:
            self._pins[chunk] = pick.replica_id
            self._pins.move_to_end(chunk)
            while len(self._pins) > self._max_pins:
                self._pins.popitem(last=False)        # LRU
        return pick

    def _chunk(self, prompt) -> Optional[tuple]:
        """Leading block-size chunk of a prompt (the pin key), or None
        when the prompt has no fully-cacheable leading chunk."""
        if len(prompt) <= self._chunk_len:
            return None
        return tuple(int(t) for t in prompt[:self._chunk_len])

    def _probe(self, req: Request) -> Dict[int, int]:
        """Per-replica affinity scores for `req`, memoized on the
        cluster prefill epoch (the probe can only change when a prefill
        registers new blocks) so held requests cost nothing to rescan."""
        epoch = sum(getattr(r.engine.runner, "prefill_dispatches", 0)
                    for r in self.replicas)
        hit = self._probe_memo.get(req.rid)
        if hit is not None and hit[0] == epoch:
            return hit[1]
        scores = {r.replica_id: r.probe_prefix(req.prompt)
                  for r in self.replicas}
        self._probe_memo[req.rid] = (epoch, scores)
        return scores

    def place(self) -> int:
        """Move requests from the cluster queue onto replicas
        (near-FCFS, policy-picked, backpressured). A held request keeps
        its place in line; requests within `jump_window` behind it may
        pass when their own target has room. Returns #placed."""
        window = (self._jump_window if self._jump_window is not None
                  else 2 * sum(self._cap(r) for r in self.replicas))
        placed = 0
        snaps = self._snaps()
        while self._queue:
            target = None
            for i, req in enumerate(self._queue):
                if i > window:
                    break
                rep = self._pick(req, snaps)
                if rep is not None:
                    target = (i, req, rep)
                    break
            if target is None:
                break                     # everything in-window is held
            i, req, rep = target
            del self._queue[i]
            if self._obs.enabled:
                if req.trace is None:
                    req.trace = {}
                req.trace["routed"] = self._now()
            self._c_placed[rep.replica_id].inc()
            rep.submit(req)
            self._placement[req.rid] = rep.replica_id
            self._probe_memo.pop(req.rid, None)
            # only the chosen replica's occupancy changed this sweep
            snaps[rep.replica_id] = rep.snapshot()
            placed += 1
        return placed

    # ------------------------------------------------------------------
    # drain / failover
    # ------------------------------------------------------------------

    def disable(self, replica_id: int) -> List[Request]:
        """Drain a replica: stop placing onto it and pull its queued-but-
        unadmitted requests back to the FRONT of the cluster queue (in
        their original order) so `place()` requeues them elsewhere.
        Requests already admitted to slots keep running to completion —
        the replica still steps until it empties. Returns the requeued
        requests."""
        rep = self._by_id(replica_id)
        rep.enabled = False
        orphans = rep.take_queued()
        for r in reversed(orphans):
            self._queue.appendleft(r)
            self._placement.pop(r.rid, None)
        self.requeued += len(orphans)
        self._c_requeued.inc(len(orphans))
        return orphans

    def enable(self, replica_id: int) -> None:
        self._by_id(replica_id).enabled = True

    # ------------------------------------------------------------------
    # elastic membership (the autoscaler's levers)
    # ------------------------------------------------------------------

    def add_replica(self, rep: Replica) -> None:
        """Join a replica to the cluster, enabled, mid-run or between
        runs. Mid-run joiners adopt the cluster clock WITHOUT a
        begin_run (which would wipe the shared metrics registry) and
        inherit the active stream() event sink."""
        if any(r.replica_id == rep.replica_id for r in self.replicas):
            raise ValueError(f"replica {rep.replica_id} already joined")
        self.replicas.append(rep)
        rep.enabled = True
        if rep.replica_id not in self._c_placed:
            self._c_placed[rep.replica_id] = self._obs.counter(
                "router_placed_total", replica=rep.replica_id)
        self._chunk_len = max(1, min(
            getattr(r.engine, "block_size", 16) for r in self.replicas))
        if self._t0 is not None:
            rep.align_clock(self._t0)
        if self._event_sink is not None:
            rep.scheduler.on_event = self._event_sink

    def remove_replica(self, replica_id: int) -> Replica:
        """Detach a DRAINED replica (scale-in): its completions are
        held for run() and its engine stack returns to the caller
        (the autoscaler's standby pool keeps it warm). Refuses to
        remove a replica that still has work or the last one."""
        rep = self._by_id(replica_id)
        if rep.has_work:
            raise RuntimeError(
                f"replica {replica_id} still has work — disable() it "
                f"and let it drain before removing")
        if len(self.replicas) == 1:
            raise RuntimeError("cannot remove the last replica")
        self.replicas.remove(rep)
        self._done.extend(rep.take_completions())
        if self._event_sink is not None:
            rep.scheduler.on_event = None
        self._chunk_len = max(1, min(
            getattr(r.engine, "block_size", 16) for r in self.replicas))
        return rep

    # ------------------------------------------------------------------
    # cluster run / stream
    # ------------------------------------------------------------------

    def _drive(self, requests: Sequence[Request]) -> Iterator[None]:
        """The cluster loop: open-loop arrivals into the cluster queue,
        place, then one engine step per replica-with-work per iteration
        (round-robin stepping keeps replicas advancing together without
        any cross-replica synchronization). Yields after every sweep so
        `stream` can drain events."""
        pending = sorted(requests, key=lambda r: r.arrival)
        idx = 0
        t0 = self._clock()
        self._t0 = t0
        # per-run state resets; the cluster queue is NOT cleared —
        # requests already submit()ed directly keep their place and
        # drain with this run (matching ServingEngine.run semantics)
        self._placement.clear()
        self._pins.clear()
        self._probe_memo.clear()
        self._rr = 0
        self.requeued = 0
        self._done = []
        if self.autoscaler is not None:
            # retire autoscaled replicas to standby FIRST so only the
            # base set gets begin_run (and one shared registry reset)
            self.autoscaler.begin_run(t0)
        for rep in self.replicas:
            rep.begin_run(t0)
        while idx < len(pending) or self.has_work:
            now = self._clock() - t0
            while idx < len(pending) and pending[idx].arrival <= now:
                self.submit(pending[idx])
                idx += 1
            self.place()
            if self.autoscaler is not None:
                self.autoscaler.tick(now)
            stepped = False
            for rep in self.replicas:
                if rep.has_work:
                    rep.step()
                    stepped = True
            if stepped:
                yield
                continue
            if self._queue and not any(r.enabled for r in self.replicas):
                raise RuntimeError(
                    f"{len(self._queue)} requests queued but every "
                    f"replica is disabled — enable() one or drain the "
                    f"queue")
            if (idx < len(pending)           # idle until the next arrival
                    and self._clock is time.perf_counter):
                time.sleep(min(pending[idx].arrival - now, 0.05))
        self.wall_time = self._clock() - t0

    def run(self, requests: Sequence[Request]) -> List[Completion]:
        """Drain `requests` across the cluster and return the merged
        completions (blocking). Outputs are bit-identical to a
        single-replica run of the same workload — only placement and
        timing differ."""
        for _ in self._drive(requests):
            pass
        done: List[Completion] = list(self._done)   # scaled-in replicas
        for rep in self.replicas:
            done.extend(rep.take_completions())
        done.sort(key=lambda c: c.t_done)
        return done

    def stream(self, requests: Sequence[Request]) -> Iterator[StreamEvent]:
        """Drain `requests`, merging every replica's StreamEvents into
        one stream (token events as each replica's steps land them,
        then a done event per request). Token-for-token equivalent to
        `run()`. Like ServingEngine.stream, the generator must be
        consumed to exhaustion."""
        buf: List[StreamEvent] = []
        prev = {rep.replica_id: rep.scheduler.on_event
                for rep in self.replicas}
        self._event_sink = buf.append        # added replicas inherit it
        for rep in self.replicas:
            rep.scheduler.on_event = self._event_sink
        try:
            for _ in self._drive(requests):
                while buf:
                    yield buf.pop(0)
            while buf:
                yield buf.pop(0)
            self._done = []
            for rep in self.replicas:
                rep.take_completions()
        finally:
            self._event_sink = None
            for rep in self.replicas:
                rep.scheduler.on_event = prev.get(rep.replica_id)


def summarize_cluster(completions: Sequence[Completion], wall: float,
                      router: Router) -> Dict:
    """Cluster telemetry: the engine-level latency/throughput stats over
    the merged completions plus a `cluster` block — placement counts,
    per-replica occupancy/prefill/cache numbers, and the cluster-wide
    cached-token total the policy benchmarks compare."""
    stats = summarize(completions, wall)
    per = []
    for rep in router.replicas:
        sched, runner = rep.scheduler, rep.engine.runner
        snap = rep.snapshot()
        per.append({
            "replica": rep.replica_id,
            "enabled": rep.enabled,
            "placed": rep.placed,
            "steps": rep.engine.steps,
            "prefill_dispatches": runner.prefill_dispatches,
            "prompt_tokens": sched.prompt_tokens,
            "cached_prompt_tokens": sched.cached_prompt_tokens,
            "prefix_hit_requests": sched.prefix_hit_requests,
            "preemptions": sched.preemptions,
            "resumes": sched.resumes,
            "shed": sched.shed_requests,
            "deferrals": sched.deferrals,
            "warm_blocks": snap.cached_blocks,
            "indexed_blocks": snap.indexed_blocks,
        })
    stats["cluster"] = {
        "policy": router.policy,
        "replicas": len(router.replicas),
        "requeued": router.requeued,
        "placed": [p["placed"] for p in per],
        "prompt_tokens": sum(p["prompt_tokens"] for p in per),
        "cached_prompt_tokens": sum(p["cached_prompt_tokens"]
                                    for p in per),
        "preemptions": sum(p["preemptions"] for p in per),
        "resumes": sum(p["resumes"] for p in per),
        "shed_requests": sum(p["shed"] for p in per),
        "deferrals": sum(p["deferrals"] for p in per),
        "per_replica": per,
    }
    if router.autoscaler is not None:
        stats["cluster"]["autoscaler"] = router.autoscaler.summary()
    return stats
