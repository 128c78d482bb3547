"""Scheduler: queue, admission policy, request lifecycle, unified stop
handling, eviction, and the propose/accept/rollback half of
speculative decoding.

The top layer of the serving engine (scheduler -> block manager ->
runner). It owns every request-level decision and no device state:

  * per-request SamplingParams — `submit` resolves each request's
    sampling config (request sampling > engine default, legacy
    max_new_tokens / eos_id folded in), tracks it per slot, and hands
    it to the runner as data (the runner mirrors it to the device as
    (num_slots,) arrays, so batches freely mix greedy, sampled, and
    speculative-sampled lanes in ONE dispatch).
  * unified stop handling — eos and multi-token stop sequences are one
    code path: a resolved list of stop token sequences per slot,
    scanned over the generated output after every emission (matching
    never spans into the prompt). A stop landing mid-speculative-chain
    truncates the accepted run at the stop and rolls the rest back —
    recurrent state commits at the truncated length and the chain's
    unused block claims are freed.
  * priority queue with bucketed batch formation — admission orders
    the queue by (effective priority desc, submit order), where
    effective priority is the request's static class plus an aging
    boost (+1 class per `priority_aging_s` seconds waited, so a
    low-priority request overtakes class p+k after at most
    k * priority_aging_s seconds — the starvation bound; equal-class
    traffic stays FCFS). The head request's prefix-cache match picks
    its suffix-length bucket, then further queued requests in the SAME
    bucket join (bounded queue-jumping: other buckets keep their
    place) until slots, blocks, or the prefill batch width run out.
    The whole group is admitted in ONE `runner.prefill` dispatch.
  * preemption with bit-identical resume — when a waiting request's
    static class outranks a running lane's and admission is blocked
    (no free lane, or the pool can't cover the reservation),
    `preempt()` evicts the weakest running lane: every FULL block of
    its prompt+generated KV is published in the prefix index first, so
    the teardown decrefs park them in the cached-free pool instead of
    losing them, and a resume request (prompt' = the tokens whose KV
    was already computed) re-enters the queue at the original class
    and submit order. Resume is a plain re-admission: the full blocks
    come back as prefix-cache hits, the partial tail recomputes, and
    the resumed prefill's sampled token — keyed by position exactly
    like the decode step it replays — is asserted equal to the token
    captured at preemption, then suppressed (never re-emitted). A
    preempted-then-resumed request is bit-identical to an
    uninterrupted run.
  * incremental block allocation under a conservative budget —
    admission allocates only the prompt's blocks and RESERVES (but does
    not bind) the ceil((prompt + max_new) / block_size) remainder as a
    per-slot budget; generation claims physical blocks lazily as
    positions cross block boundaries and a draft chain claims the
    blocks its tokens would write up front. The global reserved-budget
    counter keeps admission honest (a live sequence can always claim
    its full budget — no deadlock), while unclaimed blocks stay in the
    allocator's pools, so cached prefix blocks survive longer under
    pressure than with bind-everything-at-admission.
  * prefix sharing + copy-on-write — matched full blocks are shared by
    refcount; a partially-matched (first divergent) block is shared and
    then copied before its first write: eagerly at admission when the
    prompt itself diverges mid-block, lazily at the first decode step
    when the whole prompt was cached and only generation writes into it.
  * speculative decoding — each slot owns an n-gram draft proposer
    (serving/draft.py) over its prompt + generated history.
    `prepare_verify` assembles per-lane draft chains [pending, d1..dk],
    claims the blocks the chain would write, and pads to the runner's
    verify bucket; `consume_verify` takes the runner's emitted tokens
    and accept counts (greedy compare or Leviathan accept/reject — see
    serving/sampling.py), commits recurrent state at the accepted (and
    stop-truncated) length through the runner, and frees exactly the
    blocks a rejected suffix had claimed (the allocator returns to its
    pre-draft state — property-tested).
  * lifecycle + eviction + streaming — finished sequences
    (max_new_tokens or a stop hit) are evicted: their table row is
    nulled, their lane freed, every block reference dropped, and their
    unclaimed budget released. Every emission and completion fires the
    optional `on_event` callback (the engine's `stream()` source).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.block_manager import (NULL_BLOCK, BlockAllocator,
                                         PrefixMatch)
from repro_torch.serving.draft import make_proposer
from repro_torch.serving.observability import NULL_OBS, Observability
from repro_torch.serving.runner import ModelRunner, PrefillRow
from repro_torch.serving.sampling import SamplingParams, resolve
from repro_torch.serving.slo import SLO_TID, SLOTracker


@dataclasses.dataclass
class Request:
    """One serving request. `sampling` carries the decoding config;
    `max_new_tokens` / `eos_id` are the legacy per-request fields and
    stay honored (merged into the resolved SamplingParams at submit —
    the resolved config is written back to `sampling`, and
    `max_new_tokens` is back-filled, so both views agree downstream)."""
    rid: int
    prompt: np.ndarray            # (P,) int32 token ids
    max_new_tokens: Optional[int] = None
    arrival: float = 0.0          # seconds on the engine clock (open loop)
    eos_id: Optional[int] = None
    sampling: Optional[SamplingParams] = None
    priority: int = 0             # scheduling class: higher admits first
    #                               and may preempt strictly lower classes
    trace: Optional[Dict[str, float]] = None
    # lifecycle timestamps on the shared run clock, stamped only while
    # observability tracing is on (router stamps 'queued'/'routed', the
    # scheduler stamps 'queued' for un-routed requests); None by default
    # so the recorder-off path carries no per-request cost


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: np.ndarray            # (n_generated,) int32
    arrival: float
    t_admit: float
    t_first_token: float
    t_done: float
    cached_tokens: int = 0        # prompt tokens served from the prefix cache
    finish_reason: str = "length"  # 'length' | 'stop' | 'shed' (an SLO
    #                               shed: never admitted, tokens empty)
    logprobs: Optional[np.ndarray] = None   # (n_generated,) float32 if
    #                               SamplingParams.logprobs was requested
    top_ids: Optional[np.ndarray] = None       # (n_generated, k) int32 and
    top_logprobs: Optional[np.ndarray] = None  # (n_generated, k) float32:
    #                               the k alternative tokens per emitted
    #                               position (SamplingParams.logprobs=k)


@dataclasses.dataclass
class StreamEvent:
    """One increment of a streaming completion: `tokens` newly emitted
    for `rid` (several at once under speculation), then a final event
    with done=True carrying the Completion (and no new tokens)."""
    rid: int
    tokens: List[int]
    logprobs: Optional[List[float]] = None
    top_ids: Optional[List[List[int]]] = None       # per new token: the k
    top_logprobs: Optional[List[List[float]]] = None  # alternatives
    done: bool = False
    completion: Optional[Completion] = None


@dataclasses.dataclass(frozen=True)
class SchedulerStats:
    """Structured occupancy snapshot — the telemetry a replica router
    places on (queue + slot load, allocator block supply) without
    poking scheduler internals."""
    queue_depth: int              # submitted, not yet admitted
    active_slots: int             # lanes currently decoding
    free_slots: int
    free_blocks: int              # allocatable (free + evictable cached)
    cached_blocks: int            # cached-free blocks holding warm prefixes
    indexed_blocks: int           # blocks published in the prefix index
    reserved_blocks: int          # reserved-but-unbound generation budget
    spilled_blocks: int = 0       # host-tier block payloads (spill tier)
    preempted: int = 0            # evicted lanes awaiting resume (their
    #                               resume requests also count in
    #                               queue_depth — load sees them once)

    @property
    def load(self) -> int:
        """Slot + queue occupancy — the least-loaded routing signal."""
        return self.queue_depth + self.active_slots


@dataclasses.dataclass
class _Slot:
    req: Request
    sp: SamplingParams            # resolved sampling config
    stops: List[List[int]]        # resolved stop token sequences
    table_row: np.ndarray         # (max_blocks,) int32, NULL padded
    pos: int                      # position of the next token to feed
    pending: int                  # token to feed at `pos`
    out: List[int]
    hist: List[int]               # prompt + generated (proposer input)
    t_admit: float
    t_first: float
    cached: int                   # prefix-cache hit tokens at admission
    n_blocks: int                 # bound physical blocks (row prefix)
    prompt_blocks: int            # blocks covering the prompt (floor)
    budget: int                   # reserved-but-unbound blocks remaining
    cow_block: Optional[int]      # reserved private copy for the shared
    cow_index: int = -1           # first-divergent block (lazy COW)
    lps: Optional[List[float]] = None   # chosen-token logprobs if asked
    alts: Optional[List[Tuple[List[int], List[float]]]] = None
    #                             # per-position top-k (ids, logprobs)
    stopped: bool = False         # a stop sequence completed
    # chunked prefill (prompts longer than the largest prefill bucket):
    # next uncomputed prompt position while the admission is still being
    # prefilled chunk-by-chunk, -1 once prefill is complete. A slot with
    # prefill_pos >= 0 holds its blocks/budget but sits out decode and
    # verify dispatches until its final chunk lands the first token.
    prefill_pos: int = -1
    prefill_chunks: int = 0       # chunks dispatched so far
    prefill_chunks_total: int = 0


@dataclasses.dataclass
class _Plan:
    """A reserved admission: prompt blocks held, budget reserved, table
    row built, ready for one row of a batched prefill dispatch."""
    req: Request
    table_row: np.ndarray
    slot: int
    cached: int
    n_blocks: int
    budget: int
    cow_block: Optional[int]
    cow_index: int
    t_admit: float

    @property
    def suffix_len(self) -> int:
        return len(self.req.prompt) - min(self.cached,
                                          len(self.req.prompt) - 1)


@dataclasses.dataclass
class _ResumeState:
    """Everything a preempted lane needs to continue exactly where it
    stopped, keyed by rid while its resume request waits in the queue.
    The KV itself is NOT here — it sits in the cached-free pool (full
    blocks, published at preemption) until the resume admission revives
    it as a prefix match."""
    req: Request                  # the ORIGINAL request object
    sp: SamplingParams            # resolved sampling (original max_new)
    stops: List[List[int]]
    out: List[int]
    hist: List[int]
    pos: int                      # next position to feed at resume
    pending: int                  # token to feed there (already emitted)
    t_admit: float                # original admission time (TTFT keeps)
    t_first: float
    cached: int                   # original admission cache-hit tokens
    lps: Optional[List[float]]
    alts: Optional[List[Tuple[List[int], List[float]]]]


class Scheduler:
    """Request lifecycle over a BlockAllocator and a ModelRunner."""

    def __init__(self, allocator: BlockAllocator, runner: ModelRunner, *,
                 num_slots: int, block_size: int, max_blocks_per_seq: int,
                 max_seq_len: int, prefix_cache: bool,
                 now_fn: Callable[[], float], speculate: int = 0,
                 draft: str = "ngram", ngram: int = 3,
                 default_sampling: Optional[SamplingParams] = None,
                 priority_aging_s: float = 2.0,
                 slo_tracker: Optional[SLOTracker] = None,
                 slo_shed: bool = False,
                 obs: Observability = NULL_OBS):
        self.allocator = allocator
        self.runner = runner
        self._obs = obs or NULL_OBS
        # SLO layer (optional): the tracker receives TTFT / e2e latency
        # / TPOT observations and prices queued requests' expected wait;
        # slo_shed additionally enables deadline-aware admission (EDF
        # slack ordering + shed-on-hopeless). Shedding is OPT-IN: with
        # it off, deadlines are informational and admission order is
        # untouched, so every bit-identity gate is unaffected.
        self.slo = slo_tracker
        self.slo_shed = bool(slo_shed)
        # instruments resolved once (no-ops when obs is off)
        self._c_submitted = self._obs.counter("scheduler_submitted_total")
        self._c_admitted = self._obs.counter("scheduler_admitted_total")
        self._c_finished = {
            r: self._obs.counter("scheduler_finished_total", reason=r)
            for r in ("length", "stop", "shed")}
        self._c_shed = self._obs.counter("slo_shed_total")
        self._c_deferred = self._obs.counter("slo_deferred_total")
        self._c_ttft_breach = self._obs.counter("slo_ttft_breach_total")
        self._c_lat_breach = self._obs.counter("slo_latency_breach_total")
        self._c_tokens = self._obs.counter("tokens_emitted_total")
        self._c_prompt = self._obs.counter("prompt_tokens_total")
        self._c_cached = self._obs.counter("cached_prompt_tokens_total")
        self._c_proposed = self._obs.counter("spec_proposed_total")
        self._c_accepted = self._obs.counter("spec_accepted_total")
        self._c_preempted = self._obs.counter("scheduler_preempted_total")
        self._c_resumed = self._obs.counter("scheduler_resumed_total")
        self.num_slots = num_slots
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.max_seq_len = max_seq_len
        self.prefix_cache = prefix_cache
        self._now = now_fn
        self.speculate = max(0, speculate)
        self.priority_aging_s = float(priority_aging_s)
        self.default_sampling = default_sampling or SamplingParams()
        # one proposer per lane: drafting is per-sequence state-free
        # today (n-gram lookup), but the ownership point is the seam a
        # stateful draft-model proposer will need
        self._proposers = [make_proposer(draft, ngram=ngram)
                           for _ in range(num_slots)] if speculate else []
        # per-slot acceptance telemetry (the signal ROADMAP's adaptive
        # speculation length will steer by — recorded, not acted on):
        # an accept-length histogram per slot plus a rolling acceptance
        # rate over the last `_accept_window` verify dispatches
        if self.speculate and self._obs.enabled:
            bounds = list(range(self.speculate + 1))
            self._h_accept = self._obs.histogram("verify_accept_len_hist",
                                                 bounds)
            self._h_accept_slot = [
                self._obs.histogram("verify_accept_len_hist", bounds,
                                    slot=i) for i in range(num_slots)]
            self._g_accept_rate = [
                self._obs.gauge("spec_accept_rate", slot=i)
                for i in range(num_slots)]
            self._accept_window = [deque(maxlen=32)
                                   for _ in range(num_slots)]
        else:
            self._accept_window = []
        self._last_proposed: Dict[int, int] = {}
        self._queue: Deque[Request] = deque()
        self._slots: List[Optional[_Slot]] = [None] * num_slots
        self._reserved_budget = 0     # sum of live slots' budgets
        self._chunk_rr = 0            # round-robin over chunked prefills
        self._submit_seq = 0          # FCFS tiebreak within a priority
        # rid -> _ResumeState for preempted lanes whose resume request
        # is waiting in the queue (take_queued never migrates these:
        # their cached KV lives on THIS replica's allocator)
        self._resume_state: Dict[int, _ResumeState] = {}
        self.completions: List[Completion] = []
        self.on_event: Optional[Callable[[StreamEvent], None]] = None
        self.reset_stats()

    def reset_stats(self) -> None:
        self.prompt_tokens = 0
        self.cached_prompt_tokens = 0
        self.prefix_hit_requests = 0
        self.proposed_tokens = 0      # draft tokens sent to verify
        self.accepted_tokens = 0      # draft tokens accepted
        self.greedy_requests = 0      # submitted with temperature == 0
        self.sampled_requests = 0     # submitted with temperature > 0
        self.preemptions = 0          # lanes evicted by preempt()
        self.resumes = 0              # preempted lanes re-admitted
        self.shed_requests = 0        # SLO-shed before admission
        self.deferrals = 0            # requests EDF-deferred at least once

    # ------------------------------------------------------------------
    # queue
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Validate, resolve the request's SamplingParams (request >
        engine default, legacy max_new_tokens/eos_id merged in), and
        enqueue. The resolved config is written back onto the request
        so every later stage reads one authoritative view."""
        sp = resolve(req.sampling, self.default_sampling,
                     max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
                     rid=req.rid)
        req.sampling = sp
        req.max_new_tokens = sp.max_new_tokens
        if len(req.prompt) + sp.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new "
                f"{len(req.prompt) + sp.max_new_tokens} exceeds "
                f"max_seq_len {self.max_seq_len}")
        top = self.runner.prefill_buckets[-1]
        if not self.runner.prefill_chunk and len(req.prompt) > top:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"exceeds the largest prefill bucket {top} and chunked "
                f"admission is disabled — enable it (prefill_chunk > 0, "
                f"serve.py --prefill-chunk) or widen --prefill-buckets")
        cap = getattr(self.runner, "max_logprobs", None)
        if cap is not None and sp.logprobs > cap:
            raise ValueError(
                f"request {req.rid}: logprobs={sp.logprobs} exceeds the "
                f"runner's max_logprobs {cap} (the compiled top-k width)")
        if sp.greedy:
            self.greedy_requests += 1
        else:
            self.sampled_requests += 1
        # admission-order stamps (object attributes, not dataclass
        # fields: a Request resubmitted after drain/failover re-stamps)
        req._seq = self._submit_seq
        req._t_submit = self._now()
        self._submit_seq += 1
        if self._obs.enabled:
            self._c_submitted.inc()
            if req.trace is None:
                req.trace = {}
            req.trace.setdefault("queued", self._now())
        self._queue.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def stats(self) -> SchedulerStats:
        """Occupancy snapshot (see SchedulerStats): what a router needs
        to place load, and what serving telemetry reports."""
        active = sum(1 for s in self._slots if s is not None)
        return SchedulerStats(
            queue_depth=len(self._queue),
            active_slots=active,
            free_slots=self.num_slots - active,
            free_blocks=self.allocator.num_free,
            cached_blocks=self.allocator.num_cached,
            indexed_blocks=self.allocator.num_indexed,
            reserved_blocks=self._reserved_budget,
            spilled_blocks=getattr(self.allocator, "num_spilled", 0),
            preempted=len(self._resume_state))

    def slot_acceptance_rates(self) -> List[Optional[float]]:
        """Rolling per-slot draft acceptance rate (accepted/proposed over
        the last 32 verify dispatches), None for slots with no verify
        history yet. The signal an adaptive speculation-length policy
        would consume; requires observability to be on."""
        out: List[Optional[float]] = [None] * self.num_slots
        for i, win in enumerate(self._accept_window):
            prop = sum(p for p, _ in win)
            if prop > 0:
                out[i] = sum(a for _, a in win) / prop
        return out

    def take_queued(self) -> List[Request]:
        """Pull every queued-but-unadmitted request out of the queue, in
        order (drain/failover: the router requeues them on another
        replica). Admitted requests keep their slots and run to
        completion. The submit-time greedy/sampled counters are rolled
        back so this scheduler's stats count only work it kept. Resume
        requests for preempted lanes STAY: their cached KV and resume
        state live on this replica's allocator, so migrating them would
        turn a warm resume into a cold (and state-less) restart."""
        out = []
        kept: Deque[Request] = deque()
        for r in self._queue:
            if r.rid in self._resume_state:
                kept.append(r)
                continue
            out.append(r)
            if r.sampling.greedy:
                self.greedy_requests -= 1
            else:
                self.sampled_requests -= 1
        self._queue = kept
        return out

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _match(self, req: Request) -> PrefixMatch:
        if not self.prefix_cache:
            return PrefixMatch([], None, 0)
        return self.allocator.match_prefix(req.prompt)

    def _reserve(self, req: Request, slot: int,
                 match: PrefixMatch) -> Optional[_Plan]:
        """Share the matched prefix blocks, allocate the prompt's
        remaining blocks, reserve the generation budget, build the
        table row. Returns None (nothing held) if the pool is short."""
        P = len(req.prompt)
        bs = self.block_size
        total = -(-(P + req.sampling.max_new_tokens) // bs)
        n_prompt = -(-P // bs)
        budget = total - n_prompt
        f = len(match.full_blocks)
        # the admission gate is still conservative (the FULL extent must
        # be coverable) so an admitted request can never deadlock — but
        # only the prompt blocks are bound now; the rest stays a budget.
        # Matched blocks parked in the cached-free pool count as
        # allocatable supply in num_free, yet share() is about to revive
        # them — charge for those too, or the reserved-budget invariant
        # (num_free >= _reserved_budget, what makes _claim_blocks
        # infallible) breaks under a tight pool.
        revived = sum(1 for b in match.blocks()
                      if self.allocator.refcount(b) == 0)
        if (total - f + revived
                > self.allocator.num_free - self._reserved_budget):
            return None
        self.allocator.share(match)       # revive + hold before alloc
        fresh = self.allocator.alloc(n_prompt - f)
        if fresh is None:                 # unreachable given the gate
            self.allocator.unshare(match)
            return None
        row = np.full(self.max_blocks_per_seq, NULL_BLOCK, np.int32)
        row[:f] = match.full_blocks
        cached = f * bs + match.partial_len
        cow_block, cow_index = None, -1
        rest = fresh
        if match.partial_block is not None:
            if match.partial_len == P - f * bs:
                # whole prompt cached up to this block: keep sharing it;
                # generation's first write will trigger the lazy copy
                row[f] = match.partial_block
                cow_block, cow_index = fresh[0], f
            else:
                # prompt diverges mid-block: copy now, prefill writes it
                self.runner.copy_block(match.partial_block, fresh[0])
                self.allocator.decref(match.partial_block)
                row[f] = fresh[0]
            rest = fresh[1:]
            row[f + 1:f + 1 + len(rest)] = rest
        else:
            row[f:f + len(fresh)] = fresh
        self._reserved_budget += budget
        self.prompt_tokens += P
        self.cached_prompt_tokens += min(cached, P - 1)
        self._c_prompt.inc(P)
        self._c_cached.inc(min(cached, P - 1))
        if cached > 0:
            self.prefix_hit_requests += 1
            self.allocator.touch(match.full_blocks)
        return _Plan(req=req, table_row=row, slot=slot, cached=cached,
                     n_blocks=n_prompt, budget=budget, cow_block=cow_block,
                     cow_index=cow_index, t_admit=self._now())

    def _defer_for_group_prefix(self, req: Request, match: PrefixMatch,
                                plans: List[_Plan]) -> bool:
        """True when `req`'s prompt shares MORE full prefix blocks with
        a groupmate already in `plans` than the index currently matches:
        admitting it in this same dispatch would recompute a prefix that
        registers the moment the group's prefill lands (rows of one
        batched dispatch cannot read blocks their groupmates are about
        to write). Deferring it to the NEXT group — formed later in this
        very admit() call, after `_dispatch` registered the blocks —
        turns those tokens into cache hits instead."""
        if not self.prefix_cache:
            return False
        bs = self.block_size
        matched = match.tokens(bs)
        a = req.prompt
        for p in plans:
            b = p.req.prompt
            m = min(len(a), len(b))
            eq = np.asarray(a[:m]) == np.asarray(b[:m])
            shared = int(eq.argmin()) if not eq.all() else m
            if (shared // bs) * bs > matched:
                return True
        return False

    def _eff_priority(self, req: Request, now: float) -> float:
        """Effective ADMISSION priority: the static class plus an aging
        boost of one class per `priority_aging_s` seconds waited, so a
        class-p request behind class p+k traffic overtakes it after at
        most k * priority_aging_s seconds (the starvation bound).
        Equal-class traffic stays FCFS (older = bigger boost). Aging
        raises admission rank only — never eviction rights (see
        `_preempt_below`). priority_aging_s <= 0 disables aging."""
        if self.priority_aging_s <= 0:
            return float(req.priority)
        waited = max(now - getattr(req, "_t_submit", now), 0.0)
        return req.priority + waited / self.priority_aging_s

    def _admission_order(self) -> List[Request]:
        now = self._now()

        def base_key(r):
            return (-self._eff_priority(r, now), getattr(r, "_seq", 0))

        if not self.slo_shed:
            return sorted(self._queue, key=base_key)

        # deadline-aware ordering (slo_shed only): within an (aged)
        # priority class, earliest-deadline-first by slack — a request
        # whose deadline is tight admits ahead of comfortable or
        # deadline-free groupmates (those are the DEFERRED ones; class
        # boundaries and the aging starvation bound still hold at
        # integer-class granularity, and deadline-free traffic keeps
        # FCFS among itself)
        def slo_key(r):
            dl = self._abs_deadline(r)
            slack = dl - now if dl is not None else float("inf")
            return (-int(self._eff_priority(r, now)), slack,
                    getattr(r, "_seq", 0))

        order = sorted(self._queue, key=slo_key)
        baseline = sorted(self._queue, key=base_key)
        pos = {id(r): i for i, r in enumerate(baseline)}
        for i, r in enumerate(order):
            # count each request's FIRST slip behind its deadline-blind
            # position — the defer-below-deadline decision, visible as
            # a counter + trace instant
            if i > pos[id(r)] and not getattr(r, "_deferred", False):
                r._deferred = True
                self.deferrals += 1
                self._c_deferred.inc()
                if self._obs.enabled:
                    self._obs.instant(SLO_TID, "defer", "slo", now,
                                      rid=r.rid)
        return order

    # ------------------------------------------------------------------
    # SLO admission: deadlines, shed-on-hopeless, breach observation
    # ------------------------------------------------------------------

    @staticmethod
    def _abs_deadline(req: Request) -> Optional[float]:
        """Absolute first-token deadline on the run clock, or None.
        `deadline_ms` is relative to the request's ARRIVAL (queue wait
        counts against the budget, as a user would account it)."""
        sp = req.sampling
        if sp is None or sp.deadline_ms is None:
            return None
        return req.arrival + sp.deadline_ms / 1e3

    def _shed_hopeless(self) -> None:
        """Shed queued (never-admitted) requests that cannot make their
        deadline: already past it, or past it once the tracker's live
        median TTFT is added to `now`. A shed is a terminal Completion
        (finish_reason "shed", no tokens) plus a counter and a trace
        instant — the caller gets a definitive answer now instead of a
        uselessly late one, and the freed work protects everyone else's
        objective. Resume requests are never shed: their lane already
        produced (and streamed) tokens."""
        if not self.slo_shed or not self._queue:
            return
        now = self._now()
        est = self.slo.ttft_quantile(0.5) if self.slo is not None else None
        kept: Deque[Request] = deque()
        for r in self._queue:
            dl = None if r.rid in self._resume_state \
                else self._abs_deadline(r)
            if dl is not None and (now > dl
                                   or (est is not None
                                       and now + est > dl)):
                self._shed(r, now, dl, est)
            else:
                kept.append(r)
        self._queue = kept

    def _shed(self, req: Request, now: float, deadline: float,
              est: Optional[float]) -> None:
        comp = Completion(
            rid=req.rid, prompt_len=len(req.prompt),
            tokens=np.zeros(0, np.int32), arrival=req.arrival,
            t_admit=now, t_first_token=now, t_done=now,
            finish_reason="shed")
        self.completions.append(comp)
        self.shed_requests += 1
        self._c_shed.inc()
        self._c_finished["shed"].inc()
        if self._obs.enabled:
            self._obs.instant(
                SLO_TID, "shed", "slo", now, rid=req.rid,
                waited_ms=round((now - req.arrival) * 1e3, 3),
                deadline_ms=round((deadline - req.arrival) * 1e3, 3),
                est_ttft_ms=(round(est * 1e3, 3)
                             if est is not None else None))
        if self.on_event is not None:
            self.on_event(StreamEvent(rid=req.rid, tokens=[], done=True,
                                      completion=comp))

    def _observe_ttft(self, s: "_Slot") -> None:
        """Feed the tracker when a (non-resume) lane lands its first
        token; an objective breach bumps the counter and triggers the
        flight recorder."""
        ttft = max(s.t_first - s.req.arrival, 0.0)
        if self.slo.observe_ttft(s.t_first, ttft, s.req.priority):
            self._c_ttft_breach.inc()
            fr = self._obs.recorder
            if fr is not None:
                obj = self.slo.policy.ttft_objective_s(s.req.priority)
                fr.breach(s.t_first, "ttft_breach", rid=s.req.rid,
                          ttft_ms=round(ttft * 1e3, 3),
                          objective_ms=round(obj * 1e3, 3))

    def _preempt_below(self, priority: int) -> bool:
        """Evict the weakest running lane whose STATIC class is strictly
        below `priority` (lowest class first, most recently admitted
        first within a class — oldest work is disturbed last). Static
        compare: an aged low-priority request earns admission rank, not
        the right to evict. Returns True when a lane was preempted."""
        top = self.runner.prefill_buckets[-1]
        cands = [i for i, s in enumerate(self._slots)
                 if s is not None and s.prefill_pos < 0
                 and s.req.priority < priority
                 # without chunked admission a resume whose recompute
                 # suffix outgrew the bucket grid could never re-admit
                 # (cached blocks may be evicted meanwhile) — skip it
                 and (self.runner.prefill_chunk or s.pos <= top)]
        if not cands:
            return False
        victim = min(cands, key=lambda i: (self._slots[i].req.priority,
                                           -self._slots[i].t_admit))
        return self.preempt(victim) is not None

    def admit(self) -> None:
        """Form same-bucket groups from the queue — scanned in
        (effective priority desc, submit order), see `_eff_priority` —
        and admit each group in one batched prefill dispatch, while
        lanes and blocks last. A request whose prefix overlaps a
        groupmate's beyond what the cache already holds is deferred one
        group (see `_defer_for_group_prefix`) so it shares blocks
        instead of recomputing them. When the top waiting class
        outranks a running lane and admission is blocked — every lane
        busy, or the pool can't cover the head request's reservation —
        the weakest strictly-lower lane is preempted (KV parked in the
        cached-free pool, resume queued; see `preempt`) and admission
        retries.

        A prompt whose suffix exceeds the largest prefill bucket is
        routed to chunked admission instead: its blocks and budget are
        reserved now, but the prefill itself runs one fixed-budget
        chunk per engine step (`prefill_step`), interleaved with decode
        dispatches so running lanes aren't starved during a long
        admission. With chunking disabled (prefill_chunk=0) the same
        suffix is rejected with an actionable error (suffix_bucket)
        rather than falling through to an oversized jit variant."""
        self._shed_hopeless()
        # rids preempted below in this call for a higher waiting class. In
        # aged order such a victim (older than the requests it made room
        # for) may come first, take its lane back and be preempted again,
        # without end: the reference's admit loops so once a step outlasts
        # priority_aging_s (src/repro/serving/scheduler.py). This call does
        # not admit them again; every other admission is the reference's.
        evicted: set = set()
        while True:
            if self._queue and not self._free_slots():
                top = max(r.priority for r in self._queue)
                if not self._preempt_below(top):
                    return
                evicted.add(self._queue[-1].rid)   # preempt queued it last
            free = self._free_slots()
            if not free or not self._queue:
                return
            cap = min(len(free), self.runner.prefill_max_batch)
            plans: List[_Plan] = []
            bucket = None
            chunked = False
            taken: set = set()            # id() of admitted requests
            order = [r for r in self._admission_order()
                     if r.rid not in evicted]
            j = 0
            while j < len(order) and len(plans) < cap:
                req = order[j]
                match = self._match(req)  # peek: takes no references
                if self._defer_for_group_prefix(req, match, plans):
                    j += 1
                    continue
                suf = len(req.prompt) - min(
                    match.tokens(self.block_size), len(req.prompt) - 1)
                if (self.runner.prefill_chunk
                        and suf > self.runner.prefill_buckets[-1]):
                    if plans:             # needs its own admission
                        j += 1
                        continue
                    plan = self._reserve(req, free[0], match)
                    if plan is None:
                        if self._preempt_below(req.priority):
                            continue      # blocks freed; retry the head
                        break             # pool exhausted; retry later
                    taken.add(id(req))
                    self._begin_chunked(plan)
                    chunked = True
                    break                 # slot map changed; reform
                b = self.runner.suffix_bucket(suf)
                if bucket is not None and b != bucket:
                    j += 1
                    continue
                plan = self._reserve(req, free[len(plans)], match)
                if plan is None:
                    if not plans and self._preempt_below(req.priority):
                        continue          # blocks freed; retry the head
                    break                 # pool exhausted; retry later
                taken.add(id(req))
                plans.append(plan)
                bucket = b
                j += 1
            if taken:
                # skipped requests keep their queue positions: the
                # queue itself stays in submit order (take_queued and
                # drain preserve FCFS), only the admitted leave it
                self._queue = deque(r for r in self._queue
                                    if id(r) not in taken)
            if plans:
                self._dispatch(plans)
            elif not chunked:
                return

    def _dispatch(self, plans: List[_Plan]) -> None:
        rows = [PrefillRow(tokens=np.asarray(p.req.prompt, np.int32),
                           cached_len=p.cached, slot=p.slot,
                           table_row=p.table_row,
                           sampling=p.req.sampling) for p in plans]
        first, lp, alt = self.runner.prefill(rows)  # blocks: TTFT covers it
        t_first = self._now()
        self._c_admitted.inc(len(plans))
        for i, (p, tok, tok_lp) in enumerate(zip(plans, first, lp)):
            P = len(p.req.prompt)
            sp = p.req.sampling
            if self.prefix_cache:
                self.allocator.register_prefix(
                    p.req.prompt, [int(b) for b in p.table_row])
            self.runner.write_table(p.slot, p.table_row)
            self.runner.set_sampling(p.slot, sp)
            stops = [list(s) for s in sp.stop]
            s = _Slot(
                req=p.req, sp=sp, stops=stops, table_row=p.table_row,
                pos=P, pending=int(tok), out=[],
                hist=[int(t) for t in p.req.prompt],
                t_admit=p.t_admit, t_first=t_first, cached=p.cached,
                n_blocks=p.n_blocks, prompt_blocks=p.n_blocks,
                budget=p.budget, cow_block=p.cow_block,
                cow_index=p.cow_index,
                lps=[] if sp.logprobs else None,
                alts=[] if sp.logprobs else None)
            self._slots[p.slot] = s
            rec = self._resume_state.pop(p.req.rid, None)
            if rec is not None:
                self._resume_slot(p.slot, s, rec, int(tok))
                continue
            if self.slo is not None:
                self._observe_ttft(s)
            if self._stop_cut(s, [int(tok)]) is not None:
                s.stopped = True
            self._emit(s, [int(tok)], [float(tok_lp)],
                       self._slice_alt(s, alt, i))
            self._maybe_finish(p.slot)

    # ------------------------------------------------------------------
    # chunked prefill (long-context admission)
    # ------------------------------------------------------------------

    def _begin_chunked(self, plan: _Plan) -> None:
        """Claim a lane for a long prompt WITHOUT prefilling it: blocks
        and budget are already reserved by `_reserve`; the prefill runs
        one `runner.prefill_chunk`-token chunk per `prefill_step` call.
        The slot sits out decode/verify (prefill_pos >= 0) until the
        final chunk lands its first token."""
        p = plan
        P = len(p.req.prompt)
        sp = p.req.sampling
        # NOTE: the runner's persistent table row stays NULL until the
        # final chunk lands (prefill dispatches carry their table row
        # per-row): decode/verify steps running between chunks write
        # their inactive-lane junk to the null sink, exactly like an
        # evicted slot — writing the real row now would let them
        # corrupt this prompt's block 0.
        self.runner.set_sampling(p.slot, sp)
        self._c_admitted.inc()
        start = min(p.cached, P - 1)
        chunk = self.runner.prefill_chunk
        s = _Slot(
            req=p.req, sp=sp, stops=[list(ss) for ss in sp.stop],
            table_row=p.table_row, pos=P, pending=-1, out=[],
            hist=[int(t) for t in p.req.prompt],
            t_admit=p.t_admit, t_first=0.0, cached=p.cached,
            n_blocks=p.n_blocks, prompt_blocks=p.n_blocks,
            budget=p.budget, cow_block=p.cow_block,
            cow_index=p.cow_index,
            lps=[] if sp.logprobs else None,
            alts=[] if sp.logprobs else None,
            prefill_pos=start,
            prefill_chunks_total=-(-(P - start) // chunk))
        self._slots[p.slot] = s

    def prefill_step(self) -> bool:
        """Advance ONE in-flight chunked prefill by one chunk (round-
        robin across slots so concurrent long admissions share the
        step budget fairly). Each chunk is a resumed suffix prefill:
        the previous chunks' KV already sit in this slot's pool blocks,
        so cached_len picks up exactly where they stopped. The sampled
        token of a non-final chunk is discarded (its logits sit mid-
        prompt); the final chunk emits the real first token. Returns
        True when a chunk was dispatched."""
        pending = [i for i, s in enumerate(self._slots)
                   if s is not None and s.prefill_pos >= 0]
        if not pending:
            return False
        i = pending[self._chunk_rr % len(pending)]
        self._chunk_rr += 1
        s = self._slots[i]
        P = len(s.req.prompt)
        c = s.prefill_pos
        clen = min(self.runner.prefill_chunk, P - c)
        final = c + clen == P
        row = PrefillRow(tokens=np.asarray(s.req.prompt[:c + clen],
                                           np.int32),
                         cached_len=c, slot=i, table_row=s.table_row,
                         sampling=s.sp)
        first, lp, alt = self.runner.prefill(
            [row], resume=s.prefill_chunks > 0,
            chunk=(s.prefill_chunks, s.prefill_chunks_total))
        s.prefill_chunks += 1
        if not final:
            s.prefill_pos = c + clen
            return True
        if self.prefix_cache:
            self.allocator.register_prefix(
                s.req.prompt, [int(b) for b in s.table_row])
        self.runner.write_table(i, s.table_row)
        s.prefill_pos = -1
        rec = self._resume_state.pop(s.req.rid, None)
        if rec is not None:               # a resume whose recompute
            self._resume_slot(i, s, rec, int(first[0]))   # went chunked
            return True
        s.pending = int(first[0])
        s.t_first = self._now()
        if self.slo is not None:
            self._observe_ttft(s)
        if self._stop_cut(s, [s.pending]) is not None:
            s.stopped = True
        self._emit(s, [s.pending], [float(lp[0])],
                   self._slice_alt(s, alt, 0))
        self._maybe_finish(i)
        return True

    # ------------------------------------------------------------------
    # preemption + bit-identical resume
    # ------------------------------------------------------------------

    def preempt(self, slot_id: Optional[int] = None) -> Optional[int]:
        """Evict a running lane mid-generation, keeping its computed KV
        warm: every FULL block of prompt+generated KV (positions
        0..pos-1 = hist[:pos]) is published in the prefix index FIRST,
        so the teardown decrefs park those blocks in the cached-free
        pool instead of freeing them blind. A resume request — prompt'
        = hist[:pos], the tokens whose KV was already computed, at the
        ORIGINAL class and submit order — re-enters the queue, and the
        original outputs/timestamps stash in `_resume_state` until its
        re-admission restores them (`_resume_slot`). Resume is then a
        plain admission: full blocks come back as prefix-cache hits and
        only the partial tail block (plus the last position, which
        `_reserve` always recomputes) costs prefill; if pressure
        evicted the parked blocks meanwhile, resume just recomputes
        more — still bit-identical, never wrong.

        With slot_id None the weakest lane is chosen: lowest static
        class first, most recently admitted within a class. Lanes still
        mid-chunked-prefill are not preemptible (no first token yet),
        nor — without chunked admission — lanes whose recompute suffix
        outgrew the prefill bucket grid. Returns the evicted slot id,
        or None when no lane is preemptible."""
        if slot_id is None:
            top = self.runner.prefill_buckets[-1]
            cands = [i for i, s in enumerate(self._slots)
                     if s is not None and s.prefill_pos < 0
                     and (self.runner.prefill_chunk or s.pos <= top)]
            if not cands:
                return None
            slot_id = min(cands,
                          key=lambda i: (self._slots[i].req.priority,
                                         -self._slots[i].t_admit))
        s = self._slots[slot_id]
        if s is None or s.prefill_pos >= 0:
            return None
        # KV exists for positions 0..pos-1; park the full blocks
        if self.prefix_cache:
            self.allocator.register_prefix(
                np.asarray(s.hist[:s.pos], np.int32),
                [int(b) for b in s.table_row])
        self._resume_state[s.req.rid] = _ResumeState(
            req=s.req, sp=s.sp, stops=s.stops, out=s.out, hist=s.hist,
            pos=s.pos, pending=s.pending, t_admit=s.t_admit,
            t_first=s.t_first, cached=s.cached, lps=s.lps, alts=s.alts)
        # the resume request's budget math matches the uninterrupted
        # run: ceil((pos + remaining) / bs) == ceil((P + max_new) / bs)
        remaining = len(s.req.prompt) + s.sp.max_new_tokens - s.pos
        resume = Request(
            rid=s.req.rid, prompt=np.asarray(s.hist[:s.pos], np.int32),
            arrival=s.req.arrival,
            sampling=dataclasses.replace(s.sp,
                                         max_new_tokens=remaining),
            priority=s.req.priority, trace=s.req.trace)
        resume._seq = getattr(s.req, "_seq", 0)
        resume._t_submit = getattr(s.req, "_t_submit", self._now())
        # teardown mirrors _maybe_finish (no Completion): indexed
        # blocks park cached-free, the rest return to the free list
        for b in s.table_row:
            if b != NULL_BLOCK:
                self.allocator.decref(int(b))
        if s.cow_block is not None:       # reserved but never written
            self.allocator.decref(s.cow_block)
        self._reserved_budget -= s.budget
        self.runner.clear_table(slot_id)
        self._slots[slot_id] = None
        self._queue.append(resume)
        self.preemptions += 1
        self._c_preempted.inc()
        fr = self._obs.recorder
        if fr is not None:                # preemption-storm detection
            fr.note_preempt(self._now())
        if self._obs.enabled:
            self._obs.instant(slot_id, "preempt", "scheduler",
                              self._now(), rid=s.req.rid, pos=s.pos,
                              generated=len(s.out),
                              priority=s.req.priority)
        return slot_id

    def _resume_slot(self, slot_id: int, s: _Slot, rec: _ResumeState,
                     tok: int) -> None:
        """Re-arm a freshly admitted resume lane with its pre-preemption
        identity: original request/sampling (so the max_new finish check
        and Completion fields see the uninterrupted view), accumulated
        outputs, and timestamps (TTFT is unchanged by preemption). The
        recomputed token is NOT re-emitted — it was already emitted
        before the preemption; position-keyed sampling makes the resume
        prefill (keyed at pos-1, like the dispatch it replays) land the
        very same token, which is asserted: it IS the bit-identity
        invariant."""
        assert s.pos == rec.pos, (s.pos, rec.pos)
        assert tok == rec.pending, (
            f"resume replay diverged for rid {rec.req.rid}: "
            f"recomputed {tok} != pending {rec.pending} at {rec.pos}")
        s.req = rec.req
        s.sp = rec.sp
        s.stops = rec.stops
        s.out = rec.out
        s.hist = rec.hist
        s.pending = rec.pending
        s.t_admit = rec.t_admit
        s.t_first = rec.t_first
        s.cached = rec.cached
        s.lps = rec.lps
        s.alts = rec.alts
        self.resumes += 1
        self._c_resumed.inc()
        if self._obs.enabled:
            self._obs.instant(slot_id, "resume", "scheduler",
                              self._now(), rid=rec.req.rid, pos=rec.pos,
                              generated=len(rec.out))

    # ------------------------------------------------------------------
    # emission + unified stop handling (eos == a one-token stop seq)
    # ------------------------------------------------------------------

    @staticmethod
    def _slice_alt(s: _Slot, alt, row: int, positions=None):
        """Per-request view of a runner alt side output: the request's
        own k columns (k = sp.logprobs <= the compiled width) at `row`
        (and each of `positions` for the (B, T, K) verify layout).
        None when the request didn't ask or the dispatch carried none."""
        if alt is None or not s.sp.logprobs:
            return None
        ids, lps = alt
        k = s.sp.logprobs
        if positions is None:
            return [(ids[row, :k].tolist(), lps[row, :k].tolist())]
        return [(ids[row, t, :k].tolist(), lps[row, t, :k].tolist())
                for t in positions]

    def _emit(self, s: _Slot, tokens: List[int],
              lps: Optional[List[float]] = None,
              alts: Optional[List[Tuple[List[int],
                                        List[float]]]] = None) -> None:
        """Append generated tokens to the output AND the proposer
        history in one place (hist == prompt + out is the proposer's
        input invariant), record logprobs / top-k alternatives if the
        request asked, and fire the streaming callback."""
        s.out.extend(tokens)
        s.hist.extend(tokens)
        self._c_tokens.inc(len(tokens))
        if s.lps is not None and lps is not None:
            s.lps.extend(lps)
        have_alt = s.alts is not None and alts is not None
        if have_alt:
            s.alts.extend(alts)
        if self.on_event is not None:
            self.on_event(StreamEvent(
                rid=s.req.rid, tokens=list(tokens),
                logprobs=list(lps) if (s.lps is not None and lps) else None,
                top_ids=[a[0] for a in alts] if have_alt else None,
                top_logprobs=[a[1] for a in alts] if have_alt else None))

    def _stop_cut(self, s: _Slot, new_tokens: List[int]) -> Optional[int]:
        """Earliest 1-based index into `new_tokens` at which a stop
        sequence completes, scanning the GENERATED output only (s.out,
        not yet extended, plus the candidate tokens); None if no stop
        fires. Stop sequences may span previously emitted tokens and
        the new chunk, but never reach into the prompt."""
        if not s.stops:
            return None
        longest = max(len(ss) for ss in s.stops)
        # the last (longest-1) already-emitted tokens are the only old
        # context a newly-completing stop can reach back into
        tail = s.out[-(longest - 1):] if longest > 1 else []
        window = tail + list(new_tokens)
        base = len(tail)
        for j in range(1, len(new_tokens) + 1):
            end = base + j
            for ss in s.stops:
                L = len(ss)
                if L <= len(s.out) + j and window[end - L:end] == ss:
                    return j
        return None

    # ------------------------------------------------------------------
    # incremental block claim / release (the draft reservation)
    # ------------------------------------------------------------------

    def _claim_blocks(self, slot_id: int, last_pos: int) -> int:
        """Bind physical blocks so the table covers a write at
        `last_pos`, drawing them from the slot's reserved budget.
        Cannot fail: admission guaranteed the budget, and the global
        reserved counter kept later admissions from eating it.
        Returns the number of blocks claimed."""
        s = self._slots[slot_id]
        need = last_pos // self.block_size + 1
        claimed = 0
        while s.n_blocks < need:
            got = self.allocator.alloc(1)
            assert got is not None and s.budget > 0, \
                "block budget invariant violated"
            s.table_row[s.n_blocks] = got[0]
            s.n_blocks += 1
            s.budget -= 1
            self._reserved_budget -= 1
            claimed += 1
        if claimed:
            self.runner.write_table(slot_id, s.table_row)
        return claimed

    def _trim_blocks(self, slot_id: int, last_pos: int) -> int:
        """Release bound blocks past the last committed write at
        `last_pos` back to the allocator and return them to the slot's
        budget — the rollback of `_claim_blocks` for a rejected draft
        suffix. Never trims into the prompt. Returns #blocks freed."""
        s = self._slots[slot_id]
        keep = max(last_pos // self.block_size + 1, s.prompt_blocks)
        freed = 0
        while s.n_blocks > keep:
            s.n_blocks -= 1
            self.allocator.decref(int(s.table_row[s.n_blocks]))
            s.table_row[s.n_blocks] = NULL_BLOCK
            s.budget += 1
            self._reserved_budget += 1
            freed += 1
        if freed:
            self.runner.write_table(slot_id, s.table_row)
        return freed

    def _fire_cow(self, slot_id: int) -> None:
        """A slot about to write into a still-shared first-divergent
        block swaps in its reserved private copy first (lazy COW)."""
        s = self._slots[slot_id]
        if s.cow_block is None:
            return
        old = int(s.table_row[s.cow_index])
        self.runner.copy_block(old, s.cow_block)
        self.allocator.decref(old)
        s.table_row[s.cow_index] = s.cow_block
        self.runner.write_table(slot_id, s.table_row)
        s.cow_block = None

    # ------------------------------------------------------------------
    # decode-side lifecycle
    # ------------------------------------------------------------------

    def prepare_decode(self):
        """Assemble the plain one-token decode batch; fire pending lazy
        copy-on-writes and claim the block each lane's write needs.
        Returns (tokens, positions, active slot ids) or None when no
        lane is active. Lanes mid-way through a chunked prefill
        (prefill_pos >= 0) have no first token yet and sit out."""
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.prefill_pos < 0]
        if not active:
            return None
        tokens = np.zeros(self.num_slots, np.int32)
        positions = np.zeros(self.num_slots, np.int32)
        for i in active:
            s = self._slots[i]
            self._fire_cow(i)
            self._claim_blocks(i, s.pos)
            tokens[i] = s.pending
            positions[i] = s.pos
        return tokens, positions, active

    def consume(self, active: List[int], next_tok: np.ndarray,
                lp: Optional[np.ndarray] = None, alt=None) -> None:
        """Advance each active lane with its sampled token; finish and
        evict lanes that hit max_new_tokens or a stop sequence."""
        if self._obs.enabled:
            self._obs.annotate_step(active=len(active),
                                    emitted=len(active))
        for i in active:
            s = self._slots[i]
            tok = int(next_tok[i])
            s.pos += 1
            s.pending = tok
            if self._stop_cut(s, [tok]) is not None:
                s.stopped = True
            self._emit(s, [tok],
                       [float(lp[i])] if lp is not None else None,
                       self._slice_alt(s, alt, i))
            self._maybe_finish(i)

    # ------------------------------------------------------------------
    # speculative decoding: propose -> verify -> accept / rollback
    # ------------------------------------------------------------------

    def prepare_verify(self):
        """Assemble a verify batch of per-lane draft chains
        [pending, d_1 .. d_k] (k from each lane's proposer, capped so
        the chain can never emit past max_new_tokens), claim the blocks
        each chain would write, and pad to the runner's chain bucket.
        Returns (tokens (num_slots, T), positions, counts, active) — or
        None when no lane proposed anything, so the engine falls back
        to the plain decode dispatch at zero overhead. Lanes mid-way
        through a chunked prefill sit out (see prepare_decode)."""
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.prefill_pos < 0]
        if not active:
            return None
        drafts: Dict[int, List[int]] = {}
        max_chain = 1
        for i in active:
            s = self._slots[i]
            k = min(self.speculate, s.sp.max_new_tokens - len(s.out) - 1)
            d = self._proposers[i].propose(s.hist, k) if k > 0 else []
            # clamp: the propose(history, k) seam must not let an
            # over-eager proposer overflow the chain bucket, emit past
            # max_new_tokens, or outrun the block budget
            drafts[i] = list(d)[:max(k, 0)]
            max_chain = max(max_chain, 1 + len(drafts[i]))
        if max_chain == 1:
            return None
        T = self.runner.chain_bucket(max_chain)
        tokens = np.zeros((self.num_slots, T), np.int32)
        positions = np.zeros(self.num_slots, np.int32)
        counts = np.zeros(self.num_slots, np.int32)
        for i in active:
            s = self._slots[i]
            chain = [s.pending] + drafts[i]
            self._fire_cow(i)
            self._claim_blocks(i, s.pos + len(chain) - 1)
            tokens[i, :len(chain)] = chain
            positions[i] = s.pos
            counts[i] = len(chain)
            self.proposed_tokens += len(drafts[i])
            self._c_proposed.inc(len(drafts[i]))
        if self._obs.enabled:
            self._last_proposed = {i: len(drafts[i]) for i in active}
        return tokens, positions, counts, active

    def consume_verify(self, active: List[int], out_tok: np.ndarray,
                       accept: np.ndarray,
                       lp: Optional[np.ndarray] = None, alt=None) -> None:
        """Accept/rollback after a verify dispatch. out_tok: (num_slots,
        T) emitted tokens at every chain position (model argmax for
        greedy lanes; accepted drafts + the residual-resampled
        correction or bonus for sampled lanes); accept: (num_slots,)
        accepted draft counts, both computed on-device. Per lane: take
        the accepted run plus the one correction/bonus token, truncate
        it at the first completed stop sequence, commit recurrent state
        at the truncated length through the runner, free the blocks a
        rejected (or stop-cut) suffix claimed, advance, and finish
        lanes that hit max_new_tokens or a stop."""
        commit_idx = np.zeros(self.num_slots, np.int32)
        plan: Dict[int, tuple] = {}
        for i in active:
            s = self._slots[i]
            a = int(accept[i])
            emitted = [int(out_tok[i, t]) for t in range(a + 1)]
            lps = ([float(lp[i, t]) for t in range(a + 1)]
                   if lp is not None else None)
            cut = self._stop_cut(s, emitted)
            if cut is not None:
                emitted = emitted[:cut]
                if lps is not None:
                    lps = lps[:cut]
            plan[i] = (emitted, lps, cut is not None)
            commit_idx[i] = len(emitted)
            # accepted = drafts that actually materialized as output
            # (drafts agreeing past a truncating stop don't count)
            acc = len(emitted) - 1
            self.accepted_tokens += acc
            self._c_accepted.inc(acc)
            if self._obs.enabled and self._accept_window:
                self._h_accept.observe(acc)
                self._h_accept_slot[i].observe(acc)
                win = self._accept_window[i]
                win.append((self._last_proposed.get(i, 0), acc))
                prop_sum = sum(p for p, _ in win)
                if prop_sum > 0:
                    self._g_accept_rate[i].set(
                        sum(a for _, a in win) / prop_sum)
        if self._obs.enabled:
            self._obs.annotate_step(
                active=len(active),
                emitted=sum(len(plan[i][0]) for i in active),
                accept_lens=[len(plan[i][0]) - 1 for i in active])
        # restore recurrent slot state at each lane's accepted
        # (stop-truncated) length BEFORE host bookkeeping (a no-op for
        # pure-attention archs)
        self.runner.commit(commit_idx)
        for i in active:
            emitted, lps, stopped = plan[i]
            s = self._slots[i]
            if stopped:
                s.stopped = True
            self._emit(s, emitted, lps,
                       self._slice_alt(s, alt, i, range(len(emitted))))
            s.pos += len(emitted)
            s.pending = emitted[-1]
            # rejected suffix: free exactly the blocks it claimed
            self._trim_blocks(i, s.pos - 1)
            self._maybe_finish(i)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _maybe_finish(self, slot_id: int) -> None:
        s = self._slots[slot_id]
        done = s.stopped or len(s.out) >= s.sp.max_new_tokens
        if not done:
            return
        completion = Completion(
            rid=s.req.rid, prompt_len=len(s.req.prompt),
            tokens=np.asarray(s.out, np.int32), arrival=s.req.arrival,
            t_admit=s.t_admit, t_first_token=s.t_first,
            t_done=self._now(),
            cached_tokens=min(s.cached, len(s.req.prompt) - 1),
            finish_reason="stop" if s.stopped else "length",
            logprobs=(np.asarray(s.lps, np.float32)
                      if s.lps is not None else None),
            top_ids=(np.asarray([a[0] for a in s.alts], np.int32)
                     if s.alts is not None else None),
            top_logprobs=(np.asarray([a[1] for a in s.alts], np.float32)
                          if s.alts is not None else None))
        self.completions.append(completion)
        self._c_finished[completion.finish_reason].inc()
        if self.slo is not None:
            lat = max(completion.t_done - completion.arrival, 0.0)
            if self.slo.observe_latency(completion.t_done, lat,
                                        s.req.priority):
                self._c_lat_breach.inc()
                fr = self._obs.recorder
                if fr is not None:
                    fr.breach(completion.t_done, "latency_breach",
                              rid=completion.rid,
                              latency_ms=round(lat * 1e3, 3))
            n = len(completion.tokens)
            if n > 1:
                self.slo.observe_tpot(
                    completion.t_done,
                    (completion.t_done - s.t_first) / (n - 1),
                    s.req.priority)
        if self._obs.enabled:
            trace = s.req.trace or {}
            t_q = trace.get("queued", s.req.arrival)
            rid = completion.rid
            self._obs.async_span(
                f"req {rid} queued", "queue", rid, t_q, s.t_admit,
                routed="routed" in trace)
            self._obs.span(
                slot_id, f"req {rid}", "request", s.t_admit,
                completion.t_done, rid=rid,
                prompt_len=completion.prompt_len,
                cached_tokens=completion.cached_tokens,
                generated=len(completion.tokens),
                finish_reason=completion.finish_reason)
            self._obs.span(slot_id, "prefill", "phase",
                           s.t_admit, s.t_first)
            self._obs.span(slot_id, "decode", "phase",
                           s.t_first, completion.t_done)
        for b in s.table_row:
            if b != NULL_BLOCK:
                self.allocator.decref(int(b))
        if s.cow_block is not None:       # reserved but never written
            self.allocator.decref(s.cow_block)
        self._reserved_budget -= s.budget
        self.runner.clear_table(slot_id)
        self._slots[slot_id] = None
        if self.on_event is not None:
            self.on_event(StreamEvent(rid=completion.rid, tokens=[],
                                      done=True, completion=completion))
