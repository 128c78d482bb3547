"""Continuous-batching serving engine: a thin facade over three layers.

The paper's tradeoff — hold a batch, amortize fixed costs over it, pay
synchronization only at coarse boundaries — applied to inference. The
engine composes:

  scheduler.Scheduler      queue, admission policy, request lifecycle,
                           per-request SamplingParams + unified stop
                           handling, eviction, copy-on-write
                           orchestration, draft proposers +
                           speculative accept/rollback, streaming
  block_manager.BlockAllocator
                           refcounted physical blocks + content-hash
                           prefix index (shared prompt blocks, COW)
  runner.ModelRunner       bucketed batched prefill / decode /
                           multi-token verify dispatch (eager PyTorch
                           launching the port's CUDA kernels), device
                           block tables

Request lifecycle:
  queued -> admitted (prompt blocks bound, generation blocks reserved
  as a budget; cached prefix blocks shared by refcount; the prompt
  suffix prefilled in ONE batched dispatch together with other
  same-bucket prompts; first token sampled from the prefill logits
  with the request's own SamplingParams)
  -> decoding (one lane of the batched decode_step_paged per
  iteration — or, with speculate=K, of a batched K-token verify whose
  accepted prefix advances several tokens per dispatch and whose
  rejected suffix rolls back positions, recurrent state, and block
  claims) -> finished (max_new_tokens or a stop sequence) -> evicted
  (block refs dropped — shared prompt blocks stay warm for future
  hits).

Sampling is PER REQUEST (`Request.sampling = SamplingParams(...)`):
one engine step freely mixes greedy, sampled, and speculative-sampled
lanes in a single dispatch, and a request's realization is a pure
function of (its seed, its positions) — bit-identical whether it runs
alone or batched with anything else (see serving/sampling.py). Greedy
lanes stay bit-identical to `generate()` with speculation on or off;
sampled lanes under speculation preserve the target distribution via
Leviathan accept/reject with residual resampling.

`run()` blocks and returns completions; `stream()` is a generator of
incremental `StreamEvent`s (new tokens per request as they land, then
a done event carrying the Completion).

Prefix caching shares immutable prompt blocks across sequences and is
available for pure-attention block patterns; recurrent mixers (rwkv /
rec) carry dense per-slot state that is not block-structured, so the
engine auto-disables it there (requesting it explicitly raises).
Bucketed prefill works for every architecture: right-padded rows are
length-masked (see models/lm.py) so recurrent final states stay exact.

PyTorch port: a copy of `repro.serving.engine` against the torch runner.
`ServingEngine` gains `device=` (default CUDA; without a GPU it raises
unless device="cpu" is given). Ported in this slice: greedy requests over
attention-only architectures with kv_dtype "fp16"; sampled requests, the
quantized pools and the host spill tier raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.block_manager import BlockAllocator
from repro_torch.serving.kv_cache import ATTN_KINDS
from repro_torch.serving.observability import NULL_OBS, Observability
from repro_torch.serving.runner import ModelRunner
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import (Completion, Request, Scheduler,
                                     SchedulerStats, StreamEvent)
from repro_torch.serving.slo import SLOPolicy, SLOTracker


class ServingEngine:
    """Continuous-batching engine over a paged KV cache.

    num_slots          decode-batch width (lanes)
    block_size         tokens per physical KV block
    num_blocks         pool size; default sizes the pool to num_slots
                       sequences of max_seq_len (plus the null block)
    max_seq_len        hard per-sequence cap (prompt + generated)
    sampling           engine-default SamplingParams for requests that
                       carry none (per-request Request.sampling wins)
    prefix_cache       None = auto (on for pure-attention patterns)
    prefill_buckets    suffix-length buckets for batched prefill
                       (default: powers of two up to max_seq_len)
    prefill_max_batch  max prompts per prefill dispatch
    prefill_chunk      chunked-admission budget: a prompt whose suffix
                       exceeds the largest prefill bucket is admitted
                       chunk-by-chunk, one `prefill_chunk`-token chunk
                       per engine step, interleaved with decode so
                       running lanes aren't starved (None = default
                       2048, rounded to a bucket; 0 disables — such
                       prompts are then rejected at submit)
    speculate          max draft tokens per verify dispatch (0 = off);
                       composes with any SamplingParams — greedy lanes
                       use the argmax-compare accept rule (output
                       bit-identical to generate()), sampled lanes use
                       distribution-preserving accept/reject
    draft              draft proposer kind ('ngram': prompt lookup)
    ngram              longest n-gram the proposer tries to match
    max_logprobs       static top-k width compiled for the alternative-
                       logprob side output (SamplingParams.logprobs=k
                       must have k <= this)
    kv_dtype           KV pool precision: "fp16" (the activation dtype —
                       bit-identical default), "int8" or "fp8"
                       (quantized pools with per-(token, head) scale
                       side-tables — see serving/kv_cache.py)
    host_cache_blocks  capacity of the host-RAM spill tier (0 = off):
                       evicted cached blocks demote to a host LRU of
                       that many block payloads and revive on prefix
                       hit instead of being recomputed
    priority_aging     seconds of queue wait worth one priority class
                       at admission (starvation bound for low-priority
                       requests under priority scheduling; <= 0
                       disables aging — strict class order)
    slo_policy         declared SLO objectives (slo.SLOPolicy): builds
                       an SLOTracker fed TTFT / e2e latency / TPOT
                       observations (quantile sketches + burn rates)
    slo_tracker        pre-built SLOTracker to feed instead (how a
                       cluster shares ONE tracker across replicas —
                       burn rate is then cluster-wide); wins over
                       slo_policy
    device             where the model and pools live (default CUDA)
    slo_shed           enable deadline-aware admission: requests whose
                       `SamplingParams.deadline_ms` cannot be met are
                       shed (finish_reason "shed") and admission
                       orders by deadline slack within a class. OFF by
                       default — with it off, outputs are untouched by
                       the SLO layer (measurement only)

    temperature / seed are DEPRECATED engine-wide knobs, kept as a
    back-compat shim: they map to a default SamplingParams (with a
    DeprecationWarning). Prefer per-request Request.sampling.
    """

    def __init__(self, params, cfg: ModelConfig, *, num_slots: int = 8,
                 block_size: int = 16, max_seq_len: int = 512,
                 num_blocks: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None,
                 temperature: Optional[float] = None,
                 seed: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 prefill_max_batch: int = 4,
                 prefill_chunk: Optional[int] = None, speculate: int = 0,
                 draft: str = "ngram", ngram: int = 3,
                 max_logprobs: int = 8, kv_dtype: str = "fp16",
                 host_cache_blocks: int = 0,
                 priority_aging: float = 2.0,
                 slo_policy: Optional[SLOPolicy] = None,
                 slo_tracker: Optional[SLOTracker] = None,
                 slo_shed: bool = False,
                 obs: Observability = NULL_OBS,
                 device=None):
        if cfg.frontend != "none":
            raise NotImplementedError(
                "serving engine currently supports text LMs only")
        if temperature is not None or seed is not None:
            warnings.warn(
                "engine-level temperature=/seed= are deprecated: pass "
                "sampling=SamplingParams(...) for an engine default, or "
                "set Request.sampling per request",
                DeprecationWarning, stacklevel=2)
            if sampling is None:
                sampling = SamplingParams(temperature=temperature or 0.0,
                                          seed=seed or 0)
        self.default_sampling = sampling or SamplingParams()
        attn_only = all(k in ATTN_KINDS
                        for k in cfg.block_pattern + cfg.prefix_pattern)
        if prefix_cache and not attn_only:
            raise ValueError(
                "prefix caching requires a pure-attention block pattern "
                "(recurrent state is per-slot, not block-structured)")
        self.prefix_cache = attn_only if prefix_cache is None \
            else bool(prefix_cache)
        self.cfg = cfg
        self.num_slots = num_slots
        self.block_size = block_size
        self.max_blocks_per_seq = -(-max_seq_len // block_size)
        self.max_seq_len = max_seq_len
        if num_blocks is None:
            num_blocks = 1 + num_slots * self.max_blocks_per_seq

        self.speculate = max(0, speculate)
        self.draft = draft
        self.kv_dtype = kv_dtype
        self.host_cache_blocks = max(0, int(host_cache_blocks))
        if self.host_cache_blocks:
            raise NotImplementedError(
                "host_cache_blocks > 0: the host KV spill tier is not "
                "ported yet (a later slice)")
        self.obs = obs or NULL_OBS
        if slo_tracker is not None:
            self.slo = slo_tracker
        elif slo_policy is not None:
            self.slo = SLOTracker(slo_policy)
        else:
            self.slo = None
        self.slo_shed = bool(slo_shed)
        self._g_burn_fast = self.obs.gauge("slo_burn_rate_fast_gauge")
        self._g_burn_slow = self.obs.gauge("slo_burn_rate_slow_gauge")
        self._t0 = time.perf_counter()  # engine clock origin (reset by run)
        # runner first: the allocator's host spill tier moves payloads
        # through the runner's fetch/upload callbacks
        self.runner = ModelRunner(
            params, cfg, num_slots=num_slots, block_size=block_size,
            num_blocks=num_blocks,
            max_blocks_per_seq=self.max_blocks_per_seq,
            prefill_buckets=prefill_buckets,
            prefill_max_batch=prefill_max_batch,
            prefill_chunk=prefill_chunk, speculate=self.speculate,
            max_logprobs=max_logprobs, kv_dtype=kv_dtype, obs=self.obs,
            now_fn=self._now, device=device)
        self.allocator = BlockAllocator(
            num_blocks, block_size=block_size, obs=self.obs,
            host_cache_blocks=self.host_cache_blocks,
            fetch_block=self.runner.fetch_block,
            store_blocks=self.runner.upload_blocks)
        self.scheduler = Scheduler(
            self.allocator, self.runner, num_slots=num_slots,
            block_size=block_size,
            max_blocks_per_seq=self.max_blocks_per_seq,
            max_seq_len=max_seq_len, prefix_cache=self.prefix_cache,
            now_fn=self._now, speculate=self.speculate, draft=draft,
            ngram=ngram, default_sampling=self.default_sampling,
            priority_aging_s=priority_aging, slo_tracker=self.slo,
            slo_shed=self.slo_shed, obs=self.obs)
        self.cache_bytes = self.runner.cache_bytes
        self.steps = 0                # decode+verify iterations executed
        self.busy_lane_steps = 0      # sum of active lanes over iterations

    # ------------------------------------------------------------------
    # facade
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def stats(self) -> SchedulerStats:
        """Structured occupancy snapshot (queue depth, slot occupancy,
        allocator free/cached block counts) — what a replica router
        reads to place load."""
        return self.scheduler.stats()

    def _now(self) -> float:
        """Seconds on the engine clock (fresh reading — timestamps must be
        taken AFTER the blocking device work they account for)."""
        return time.perf_counter() - self._t0

    def begin_run(self, t0: Optional[float] = None) -> None:
        """Reset the engine clock and per-run telemetry counters. `t0`
        (a time.perf_counter reading) lets a cluster router give every
        replica one shared clock origin so timestamps are comparable
        across replicas; None starts the clock now."""
        self._t0 = time.perf_counter() if t0 is None else t0
        self.steps = 0
        self.busy_lane_steps = 0
        self.scheduler.reset_stats()      # telemetry is per run
        self.runner.reset_stats()
        self.allocator.cache_evictions = 0
        self.allocator.host_demotions = 0
        self.allocator.host_revivals = 0
        self.obs.begin_run()
        if self.slo is not None:
            self.slo.reset()          # shared trackers reset idempotently
            if self.obs.enabled:
                self.obs.slo = self.slo   # metrics_dump emits v2 sections
        if self.obs.enabled:
            # static pool-capacity gauges (instruments reset per run)
            self.obs.gauge("kv_device_bytes_gauge").set(self.cache_bytes)
            self.obs.gauge("kv_host_bytes_gauge").set(
                self.host_cache_blocks * self.runner.block_bytes)

    def align_clock(self, t0: float) -> None:
        """Adopt a cluster clock origin WITHOUT resetting telemetry —
        what a replica activated mid-run needs (begin_run would wipe
        the cluster's shared metrics registry mid-flight)."""
        self._t0 = t0

    def reset_prefix_cache(self) -> None:
        """Drop cached prompt blocks (e.g. between benchmark runs)."""
        self.allocator.reset_prefix_cache()

    def step(self) -> None:
        """One engine iteration: admit, then one batched decode or
        verify step. With speculation on, lanes whose proposers drafted
        anything go through one multi-token verify dispatch (propose ->
        verify -> accept/rollback); when nothing was proposed the
        iteration falls back to the plain decode dispatch, so idle
        proposers cost nothing. A long prompt mid-chunked-admission
        advances by exactly one prefill chunk per iteration, BEFORE the
        decode/verify dispatch, so running lanes keep emitting tokens
        throughout a long admission instead of stalling behind it."""
        self.scheduler.admit()
        self.scheduler.prefill_step()
        if self.obs.enabled:
            # occupancy time series (sampled post-admission so queue
            # depth and slot occupancy reflect this step's batch)
            self.obs.sample_stats(self._now(), self.scheduler.stats())
        if self.slo is not None:
            # burn-rate tick on the run clock (records the run peaks
            # the bench gates on; gauges are no-ops with obs off)
            fast, slow = self.slo.tick(self._now())
            self._g_burn_fast.set(fast or 0.0)
            self._g_burn_slow.set(slow or 0.0)
        fr = self.obs.recorder
        if fr is not None:            # eviction-thrash detection
            fr.note_evictions(self._now(), self.allocator.cache_evictions)
        if self.speculate:
            vb = self.scheduler.prepare_verify()
            if vb is not None:
                tokens, positions, counts, active = vb
                emit, accept, lp, alt = self.runner.verify(
                    tokens, positions, counts)
                self.steps += 1
                self.busy_lane_steps += len(active)
                self.scheduler.consume_verify(active, emit, accept, lp,
                                              alt)
                return
        batch = self.scheduler.prepare_decode()
        if batch is None:
            return
        tokens, positions, active = batch
        next_tok, lp, alt = self.runner.decode(tokens, positions)
        self.steps += 1
        self.busy_lane_steps += len(active)
        self.scheduler.consume(active, next_tok, lp, alt)

    def _drive(self, requests: Sequence[Request]) -> Iterator[None]:
        """The engine loop as a generator (open loop: each request
        enters the queue at its arrival offset on the engine clock);
        yields after every step so `stream` can drain events."""
        pending = sorted(requests, key=lambda r: r.arrival)
        idx = 0
        self.begin_run()
        while idx < len(pending) or self.has_work:
            now = self._now()
            while idx < len(pending) and pending[idx].arrival <= now:
                self.submit(pending[idx])
                idx += 1
            if not self.has_work:
                # idle until the next arrival
                time.sleep(min(pending[idx].arrival - now, 0.05))
                continue
            self.step()
            yield
        self.wall_time = self._now()

    def run(self, requests: Sequence[Request]) -> List[Completion]:
        """Drain `requests` and return completions (blocking)."""
        for _ in self._drive(requests):
            pass
        done, self.scheduler.completions = self.scheduler.completions, []
        return done

    def stream(self, requests: Sequence[Request]) -> Iterator[StreamEvent]:
        """Drain `requests`, yielding incremental StreamEvents: new
        tokens per request as each engine step lands them (several at
        once under speculation), then a done event carrying the
        request's Completion. Equivalent token-for-token to `run()`.

        The generator must be consumed to exhaustion: abandoning it
        mid-stream leaves the undrained requests live in their slots
        (holding blocks), and a later `run()`/`stream()` on this engine
        will keep stepping them and fold their Completions into its own
        results — there is no per-request cancel today."""
        buf: List[StreamEvent] = []
        prev = self.scheduler.on_event
        self.scheduler.on_event = buf.append
        try:
            for _ in self._drive(requests):
                while buf:
                    yield buf.pop(0)
            while buf:
                yield buf.pop(0)
            self.scheduler.completions = []
        finally:
            self.scheduler.on_event = prev


# ----------------------------------------------------------------------------
# synthetic open-loop traffic + telemetry
# ----------------------------------------------------------------------------

def _sample_lengths(rng, spec: Union[int, Tuple[int, int]], n: int):
    """Fixed length (int) or uniform-inclusive mixed lengths (lo, hi)."""
    if isinstance(spec, (tuple, list)):
        lo, hi = spec
        return rng.integers(lo, hi + 1, n)
    return np.full(n, int(spec))


def _arrivals(rng, n: int, rate: float):
    if np.isinf(rate):
        return np.zeros(n)
    return np.cumsum(rng.exponential(1.0 / rate, n))


def _per_request(sampling: Optional[SamplingParams], i: int):
    """Stamp request i with its own PRNG stream (seed + i) so sampled
    workloads stay reproducible AND per-request independent."""
    if sampling is None:
        return None
    return dataclasses.replace(sampling, seed=sampling.seed + i)


def synthetic_requests(n: int, *, vocab_size: int,
                       prompt_len: Union[int, Tuple[int, int]] = 64,
                       max_new: tuple = (8, 32), rate: float = float("inf"),
                       sampling: Optional[SamplingParams] = None,
                       seed: int = 0) -> List[Request]:
    """Open-loop workload: Poisson arrivals at `rate` req/s (inf = all at
    t=0), random prompts, uniform generation lengths in `max_new`.
    `prompt_len` may be an int (fixed) or a (lo, hi) range (mixed-length
    traffic — exercises the prefill length buckets). `sampling` stamps
    every request with that config (per-request seeds derived as
    sampling.seed + i); None leaves requests greedy."""
    rng = np.random.default_rng(seed)
    arrivals = _arrivals(rng, n, rate)
    plens = _sample_lengths(rng, prompt_len, n)
    lo, hi = max_new
    return [Request(
        rid=i,
        prompt=rng.integers(0, vocab_size, int(plens[i])).astype(np.int32),
        max_new_tokens=int(rng.integers(lo, hi + 1)),
        arrival=float(arrivals[i]),
        sampling=_per_request(sampling, i)) for i in range(n)]


def shared_prefix_requests(n: int, *, vocab_size: int, prefix_len: int = 48,
                           suffix_len: Union[int, Tuple[int, int]] = (4, 16),
                           max_new: tuple = (8, 32), n_prefixes: int = 1,
                           rate: float = float("inf"),
                           sampling: Optional[SamplingParams] = None,
                           seed: int = 0) -> List[Request]:
    """Shared-prefix workload: every prompt is one of `n_prefixes` common
    system prompts of `prefix_len` tokens followed by a random per-request
    suffix — the canonical prefix-cache scenario (identical prompt-prefix
    blocks shared across sequences, copy-on-write at the divergence)."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab_size, prefix_len).astype(np.int32)
                for _ in range(max(n_prefixes, 1))]
    arrivals = _arrivals(rng, n, rate)
    slens = _sample_lengths(rng, suffix_len, n)
    lo, hi = max_new
    out = []
    for i in range(n):
        suffix = rng.integers(0, vocab_size, int(slens[i])).astype(np.int32)
        out.append(Request(
            rid=i,
            prompt=np.concatenate([prefixes[i % len(prefixes)], suffix]),
            max_new_tokens=int(rng.integers(lo, hi + 1)),
            arrival=float(arrivals[i]),
            sampling=_per_request(sampling, i)))
    return out


def multi_tenant_requests(n: int, *, vocab_size: int, n_tenants: int = 4,
                          prefix_len: Union[int, Tuple[int, int]] = 48,
                          suffix_len: Union[int, Tuple[int, int]] = (4, 16),
                          max_new: tuple = (8, 32),
                          rate: float = float("inf"),
                          tenant_priorities: Optional[Sequence[int]] = None,
                          tenant_weights: Optional[Sequence[float]] = None,
                          sampling: Optional[SamplingParams] = None,
                          seed: int = 0) -> List[Request]:
    """Multi-tenant workload: `n_tenants` distinct shared system prompts
    (tenants), each request drawn to a random tenant so tenant traffic
    INTERLEAVES, followed by a random per-request suffix. `prefix_len`
    may be an int or a (lo, hi) range (per-tenant prompt lengths — lands
    tenants in different prefill buckets).

    This is the workload that separates prefix-affinity routing from
    round-robin: every tenant's prefix is cacheable, but only on
    replicas that already served that tenant — an affinity router pins
    each tenant to the replica holding its blocks, while round-robin
    re-prefills each tenant's prefix once per replica it touches.

    Per-tenant SLO mixes: `tenant_priorities[k]` stamps tenant k's
    requests with that scheduler priority class (an interactive tenant
    outranks — and may preempt — a batch tenant), and `tenant_weights`
    skews how much traffic each tenant sends. Both default to off, in
    which case the rng draw sequence is byte-identical to the
    pre-priority generator (committed bench records depend on it)."""
    rng = np.random.default_rng(seed)
    plens = _sample_lengths(rng, prefix_len, max(n_tenants, 1))
    prefixes = [rng.integers(0, vocab_size, int(p)).astype(np.int32)
                for p in plens]
    if tenant_weights is not None:
        w = np.asarray(tenant_weights, dtype=float)
        if len(w) != len(prefixes):
            raise ValueError("need one tenant_weights entry per tenant")
        tenants = rng.choice(len(prefixes), size=n, p=w / w.sum())
    else:
        tenants = rng.integers(0, len(prefixes), n)
    if tenant_priorities is not None and \
            len(tenant_priorities) != len(prefixes):
        raise ValueError("need one tenant_priorities entry per tenant")
    arrivals = _arrivals(rng, n, rate)
    slens = _sample_lengths(rng, suffix_len, n)
    lo, hi = max_new
    out = []
    for i in range(n):
        suffix = rng.integers(0, vocab_size, int(slens[i])).astype(np.int32)
        tenant = int(tenants[i])
        out.append(Request(
            rid=i,
            prompt=np.concatenate([prefixes[tenant], suffix]),
            max_new_tokens=int(rng.integers(lo, hi + 1)),
            arrival=float(arrivals[i]),
            priority=(int(tenant_priorities[tenant])
                      if tenant_priorities is not None else 0),
            sampling=_per_request(sampling, i)))
    return out


def bursty_requests(n: int, *, vocab_size: int, base_rate: float = 4.0,
                    burst_rate: float = 64.0, burst_every: float = 2.0,
                    burst_len: float = 0.25,
                    prompt_len: Union[int, Tuple[int, int]] = (8, 24),
                    max_new: tuple = (8, 32),
                    priorities: Sequence[int] = (0,),
                    priority_weights: Optional[Sequence[float]] = None,
                    sampling: Optional[SamplingParams] = None,
                    seed: int = 0) -> List[Request]:
    """Bursty (diurnal) workload: arrivals follow a two-state modulated
    Poisson process — every `burst_every` seconds the rate switches to
    `burst_rate` for `burst_len` seconds, then falls back to
    `base_rate`. The cycle starts IN a burst, so a queue piles up at
    t=0 and then drains into a sparse tail: exactly the shape that
    makes a fixed-size cluster pay p99 TTFT during the spike while
    sitting idle between spikes — the autoscaler's motivating traffic.

    Arrival times are drawn by exact inversion of the inhomogeneous
    Poisson integral (piecewise-constant rate), so the process is
    seeded and reproducible like every other generator here. Each
    request's priority class is drawn from `priorities` (uniformly, or
    by `priority_weights`) — mix classes to exercise preemption under
    burst pressure."""
    if base_rate <= 0 or burst_rate <= 0:
        raise ValueError("rates must be positive")
    rng = np.random.default_rng(seed)

    def _advance(t: float, e: float) -> float:
        # spend exponential mass `e` walking forward through the
        # piecewise-constant rate profile
        while True:
            phase = t % burst_every
            in_burst = phase < burst_len
            r = burst_rate if in_burst else base_rate
            edge = burst_len if in_burst else burst_every
            dt = edge - phase              # time left in this state
            if e <= r * dt:
                return t + e / r
            e -= r * dt
            t += dt

    arrivals = []
    t = 0.0
    for _ in range(n):
        t = _advance(t, rng.exponential(1.0))
        arrivals.append(t)
    if priority_weights is not None:
        w = np.asarray(priority_weights, dtype=float)
        if len(w) != len(priorities):
            raise ValueError("need one priority_weights entry per class")
        pidx = rng.choice(len(priorities), size=n, p=w / w.sum())
    else:
        pidx = rng.integers(0, len(priorities), n)
    plens = _sample_lengths(rng, prompt_len, n)
    lo, hi = max_new
    return [Request(
        rid=i,
        prompt=rng.integers(0, vocab_size, int(plens[i])).astype(np.int32),
        max_new_tokens=int(rng.integers(lo, hi + 1)),
        arrival=float(arrivals[i]),
        priority=int(priorities[int(pidx[i])]),
        sampling=_per_request(sampling, i)) for i in range(n)]


def diurnal_requests(n: int, *, vocab_size: int, rate_min: float = 1.0,
                     rate_max: float = 32.0, period: float = 8.0,
                     segments: int = 32,
                     prompt_len: Union[int, Tuple[int, int]] = (8, 24),
                     max_new: tuple = (8, 32),
                     priorities: Sequence[int] = (0,),
                     priority_weights: Optional[Sequence[float]] = None,
                     sampling: Optional[SamplingParams] = None,
                     seed: int = 0) -> List[Request]:
    """Diurnal workload: a seeded piecewise-sinusoidal rate profile —
    the smooth day/night traffic shape, compressed to a `period` an SLO
    autoscaler can ride within one run. The rate sweeps

        rate(t) = rate_min + (rate_max - rate_min)
                  * (1 - cos(2*pi*t / period)) / 2

    starting at the TROUGH (rate_min at t=0, peak at period/2), so a
    run opens calm, climbs into saturation, and relaxes again —
    exercising scale-out on the rising edge and scale-in on the falling
    one, without bursty_requests' step discontinuities.

    The sinusoid is discretized into `segments` piecewise-constant
    steps per period (rate = the segment-midpoint value) and arrivals
    are drawn by the same exact inversion of the inhomogeneous Poisson
    integral bursty_requests uses — seeded and reproducible. Priority
    classes mix exactly as there."""
    if rate_min <= 0 or rate_max < rate_min:
        raise ValueError("need 0 < rate_min <= rate_max")
    if period <= 0 or segments < 2:
        raise ValueError("need period > 0 and segments >= 2")
    rng = np.random.default_rng(seed)
    seg = period / segments
    rates = [rate_min + (rate_max - rate_min)
             * (1.0 - math.cos(2.0 * math.pi * (k + 0.5) / segments))
             / 2.0 for k in range(segments)]

    def _advance(t: float, e: float) -> float:
        # spend exponential mass `e` walking forward through the
        # piecewise-constant discretization (segment-index walk, so
        # float edges can't strand t at a boundary)
        k = int(t // seg)
        while True:
            r = rates[k % segments]
            dt = (k + 1) * seg - t
            if dt > 0 and e <= r * dt:
                return t + e / r
            e -= r * max(dt, 0.0)
            t = (k + 1) * seg
            k += 1

    arrivals = []
    t = 0.0
    for _ in range(n):
        t = _advance(t, rng.exponential(1.0))
        arrivals.append(t)
    if priority_weights is not None:
        w = np.asarray(priority_weights, dtype=float)
        if len(w) != len(priorities):
            raise ValueError("need one priority_weights entry per class")
        pidx = rng.choice(len(priorities), size=n, p=w / w.sum())
    else:
        pidx = rng.integers(0, len(priorities), n)
    plens = _sample_lengths(rng, prompt_len, n)
    lo, hi = max_new
    return [Request(
        rid=i,
        prompt=rng.integers(0, vocab_size, int(plens[i])).astype(np.int32),
        max_new_tokens=int(rng.integers(lo, hi + 1)),
        arrival=float(arrivals[i]),
        priority=int(priorities[int(pidx[i])]),
        sampling=_per_request(sampling, i)) for i in range(n)]


def long_document_requests(n: int, *, vocab_size: int,
                           prompt_len: Union[int, Tuple[int, int]] = 4096,
                           max_new: tuple = (4, 16),
                           rate: float = float("inf"),
                           sampling: Optional[SamplingParams] = None,
                           seed: int = 0) -> List[Request]:
    """Long-document workload: few requests, each carrying a prompt far
    longer than any prefill bucket — summarization / document-QA style
    traffic. This is the workload chunked admission exists for: each
    prompt is split into fixed-budget chunks across successive engine
    steps (peak score materialization stays bounded by the chunk
    budget) while any already-running lanes keep decoding between
    chunks. Prompts are random tokens (content-free, like the other
    synthetic workloads); `prompt_len` may be an int or (lo, hi)."""
    rng = np.random.default_rng(seed)
    arrivals = _arrivals(rng, n, rate)
    plens = _sample_lengths(rng, prompt_len, n)
    lo, hi = max_new
    return [Request(
        rid=i,
        prompt=rng.integers(0, vocab_size, int(plens[i])).astype(np.int32),
        max_new_tokens=int(rng.integers(lo, hi + 1)),
        arrival=float(arrivals[i]),
        sampling=_per_request(sampling, i)) for i in range(n)]


def repetitive_requests(n: int, *, vocab_size: int, period: int = 6,
                        prompt_len: Union[int, Tuple[int, int]] = 48,
                        max_new: tuple = (16, 32),
                        rate: float = float("inf"),
                        sampling: Optional[SamplingParams] = None,
                        seed: int = 0) -> List[Request]:
    """Repetitive-text workload: each prompt tiles a short random
    pattern of `period` tokens — the canonical n-gram (prompt-lookup)
    speculation scenario: the proposer finds the recurring n-gram in
    the prompt/generated history and drafts its continuation."""
    rng = np.random.default_rng(seed)
    arrivals = _arrivals(rng, n, rate)
    plens = _sample_lengths(rng, prompt_len, n)
    lo, hi = max_new
    out = []
    for i in range(n):
        pattern = rng.integers(0, vocab_size, period).astype(np.int32)
        reps = -(-int(plens[i]) // period)
        out.append(Request(
            rid=i,
            prompt=np.tile(pattern, reps)[:int(plens[i])],
            max_new_tokens=int(rng.integers(lo, hi + 1)),
            arrival=float(arrivals[i]),
            sampling=_per_request(sampling, i)))
    return out


def _rate(count: float, wall: float) -> float:
    """count/wall as a rate, well-defined for degenerate runs: a zero or
    negative wall clock (e.g. a run whose work all landed inside one
    clock tick) reports 0.0 instead of a nonsense near-infinite rate."""
    return round(count / wall, 2) if wall > 0 else 0.0


def summarize(completions: Sequence[Completion], wall: float,
              engine: Optional[ServingEngine] = None) -> Dict:
    """Throughput / latency telemetry over a finished run. Well-defined
    for degenerate inputs: empty completion lists, a single completion
    (percentiles collapse to that value), and zero wall clock. Shed
    requests (finish_reason == "shed") produced no tokens and carry a
    synthetic t_first_token, so they are excluded from the latency
    percentiles and counted separately."""
    shed = [c for c in completions if c.finish_reason == "shed"]
    if shed:
        # only rebind when sheds happened: records from shed-free runs
        # stay byte-identical to pre-SLO ones
        completions = [c for c in completions
                       if c.finish_reason != "shed"]
    if not completions:
        stats = {"requests": 0, "generated_tokens": 0,
                 "wall_s": round(wall, 4), "tokens_per_s": 0.0}
        if shed:
            stats["shed_requests"] = len(shed)
        if engine is not None:
            stats["kv_cache_mb"] = round(engine.cache_bytes / 2**20, 2)
        return stats
    gen = sum(len(c.tokens) for c in completions)
    ttft = np.array([c.t_first_token - c.arrival for c in completions])
    lat = np.array([c.t_done - c.arrival for c in completions])
    per_tok = np.array([(c.t_done - c.t_first_token)
                        / max(len(c.tokens) - 1, 1) for c in completions])
    stats = {
        "requests": len(completions),
        "generated_tokens": gen,
        "wall_s": round(wall, 4),
        "tokens_per_s": _rate(gen, wall),
        "ttft_p50_ms": round(float(np.percentile(ttft, 50)) * 1e3, 2),
        "ttft_p95_ms": round(float(np.percentile(ttft, 95)) * 1e3, 2),
        "ttft_p99_ms": round(float(np.percentile(ttft, 99)) * 1e3, 2),
        "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "latency_p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 2),
        "latency_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
        "tpot_p50_ms": round(float(np.percentile(per_tok, 50)) * 1e3, 2),
        "tpot_p95_ms": round(float(np.percentile(per_tok, 95)) * 1e3, 2),
        "tpot_p99_ms": round(float(np.percentile(per_tok, 99)) * 1e3, 2),
    }
    if engine is not None:
        stats["kv_cache_mb"] = round(engine.cache_bytes / 2**20, 2)
        if engine.steps:
            stats["decode_steps"] = engine.steps
            stats["slot_occupancy"] = round(
                engine.busy_lane_steps / (engine.steps * engine.num_slots),
                3)
        sched, runner = engine.scheduler, engine.runner
        if sched.sampled_requests:
            # greedy-only records stay byte-identical to pre-sampling
            # runs: the block appears only when a request sampled
            stats["sampling"] = {
                "sampled_requests": sched.sampled_requests,
                "greedy_requests": sched.greedy_requests,
                "sampled_dispatches": runner.sampled_dispatches,
                "stop_finishes": sum(
                    1 for c in completions if c.finish_reason == "stop"),
            }
        stats["prefill"] = {
            "dispatches": runner.prefill_dispatches,
            "shapes": len(runner.prefill_shapes),
            "buckets": (len(runner.prefill_buckets)
                        * len(runner.width_buckets)),
            "prompt_tokens": sched.prompt_tokens,
            "computed_tokens": runner.prefill_computed_tokens,
            "cached_tokens": sched.cached_prompt_tokens,
            "padded_tokens": runner.prefill_padded_tokens,
            # analytic peak score-tile bytes of the largest prefill
            # dispatch (the memory chunked admission bounds): with the
            # streamed attention path this stays flat past attn_chunk
            # no matter how long the prompt is
            "chunk_budget": runner.prefill_chunk,
            "peak_score_bytes": runner.prefill_peak_score_bytes,
        }
        snap = engine.stats()             # structured occupancy accessor
        stats["prefix_cache"] = {
            "enabled": engine.prefix_cache,
            "hit_requests": sched.prefix_hit_requests,
            "block_copies": runner.block_copies,
            "evictions": engine.allocator.cache_evictions,
            # blocks still holding reusable prefix KV after the run
            "warm_blocks": snap.cached_blocks,
        }
        stats["kv"] = {
            "dtype": engine.kv_dtype,
            "device_pool_bytes": engine.cache_bytes,
            "host_cache_blocks": engine.host_cache_blocks,
            "host_pool_bytes": (engine.host_cache_blocks
                                * engine.runner.block_bytes),
            "spilled_blocks": snap.spilled_blocks,
            "host_demotions": engine.allocator.host_demotions,
            "host_revivals": engine.allocator.host_revivals,
        }
        if engine.speculate:
            dispatches = engine.steps      # decode + verify iterations
            stats["speculation"] = {
                "enabled": True,
                "k": engine.speculate,
                "draft": engine.draft,
                "verify_dispatches": runner.verify_dispatches,
                "verify_shapes": len(runner.verify_shapes),
                "verify_buckets": len(runner.verify_buckets),
                # chain slots dispatched vs true chain tokens: the gap
                # is bucket-padding waste (verify compute scales with
                # it — the term that erodes the spec win at high slots)
                "verify_chain_tokens": runner.verify_chain_tokens,
                "verify_padded_tokens": runner.verify_padded_tokens,
                "proposed_tokens": sched.proposed_tokens,
                "accepted_tokens": sched.accepted_tokens,
                "acceptance_rate": round(
                    sched.accepted_tokens / max(sched.proposed_tokens, 1),
                    3),
                # each request's first token comes from its prefill
                # dispatch, not a decode/verify one — exclude it
                "tokens_per_dispatch": round(
                    max(gen - len(completions), 0) / max(dispatches, 1),
                    3),
            }
        if getattr(engine, "slo", None) is not None:
            stats["slo"] = engine.slo.snapshot()
            stats["slo"]["shed_requests"] = sched.shed_requests
            stats["slo"]["deferrals"] = sched.deferrals
    if shed:
        stats["shed_requests"] = len(shed)
    return stats
