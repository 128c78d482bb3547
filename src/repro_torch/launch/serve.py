"""Serving CLI and the reference `generate()` (PyTorch port of
`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --requests 32 --slots 8 --prompt-len 24 64 --max-new 8 32

    # shared-prefix traffic with prefix caching, n-gram speculation:
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --workload shared-prefix --prefix-len 48 --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --workload repetitive --speculate 4 --max-new 16 32

    # on a machine without a GPU:
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

    # the recurrent archs, recurrentgemma-2b (RG-LRU + local attention) and
    # rwkv6-3b (RWKV6), through the engine (slot-indexed recurrent state;
    # the prefix cache stays off for them) or the fixed-batch generate():
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch rwkv6-3b --full-width --workload repetitive --speculate 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch rwkv6-3b --full-width --mode naive

    # the MoE archs (top-k capacity-routed experts): grok-1-314b, and
    # llama4-maverick-400b-a17b (MoE every second layer), reduced:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama4-maverick-400b-a17b --mode naive

    # the frontends' archs, paligemma-3b (text generate() on its backbone)
    # and musicgen-medium (4 EnCodec codebooks a token), through the fixed
    # batch only; the engine refuses them, as the JAX engine does:
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch musicgen-medium --mode naive --device cpu

    # sampled decoding (per-request threefry streams, JAX's draws) with
    # stop tokens and top-k logprobs; int8 / fp8 KV pools with the host
    # spill tier:
    PYTHONPATH=src python -m repro_torch.launch.serve --temperature 0.8 \
        --top-k 50 --top-p 0.95 --speculate 4 --logprobs 2 --stop 7
    PYTHONPATH=src python -m repro_torch.launch.serve --workload \
        shared-prefix --n-prefixes 4 --kv-dtype int8 --host-cache-blocks 32

    # a cluster: a router over N engine stacks on one device (each with its
    # own pools and prefix cache; one copy of the weights), and elastic
    # autoscaling over warm standby stacks:
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 \
        --router prefix --workload multi-tenant --tenants 4
    PYTHONPATH=src python -m repro_torch.launch.serve --workload bursty \
        --autoscale --min-replicas 1 --max-replicas 3 --priorities 0 1

    # the SLO layer: a TTFT objective (latency sketches, burn rates),
    # deadline shedding, burn-rate autoscaling and the flight recorder:
    PYTHONPATH=src python -m repro_torch.launch.serve --workload diurnal \
        --slo-ttft-ms 100 --slo-shed --deadline-ms 500 \
        --autoscale --slo-autoscale --flight-recorder flight.json

The CLI serves the `.reduced()` config (like the JAX CLI) through the
engine (`--mode engine`, the default: one engine, or a router over
`--replicas` engines, or an autoscaled cluster) or generate()'s fixed
batch (`--mode naive`); `--full-width` serves the published config. The
engine serves smollm-135m, recurrentgemma-2b, rwkv6-3b, the MoE archs
(grok-1-314b, llama4-maverick-400b-a17b) and the other attention-only
archs, greedy or sampled, on activation-dtype or
int8 / fp8 pools, with or without the host spill tier; not the
frontends' archs (paligemma-3b, musicgen-medium), which `--mode naive`
serves. The weights are
cast to the compute dtype once, before any engine is built, so every
replica of a cluster runs on one device copy of them.

`generate()` is the reference path: it primes a dense KV cache one token
at a time and decodes a fixed batch in lockstep; the engine's greedy
output must equal it token for token, except for an MoE arch where a
prefill drops tokens past capacity: the engine routes a prompt's suffix
at its bucket length, generate() one token at a time (capacity 1), as
in the JAX package, whose engine the port's follows. Sampled, it draws as the JAX
`generate()` does: one `split` of the key a step, then
`categorical(sub, logits / temperature)`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.device import resolve_device, to_device
from repro_torch.models import lm
from repro_torch.serving.engine import (ServingEngine, bursty_requests,
                                        diurnal_requests,
                                        long_document_requests,
                                        multi_tenant_requests,
                                        repetitive_requests,
                                        shared_prefix_requests, summarize,
                                        synthetic_requests)
from repro_torch.serving.autoscaler import Autoscaler, AutoscalePolicy
from repro_torch.serving.observability import (NULL_OBS, FlightRecorder,
                                               Observability,
                                               export_metrics, export_trace,
                                               validate_metrics_dump,
                                               validate_trace_events)
from repro_torch.serving.replica import Replica
from repro_torch.serving.router import Router, summarize_cluster
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.slo import SLOPolicy, SLOSignal, SLOTracker


@torch.inference_mode()
def generate(params, cfg, prompts, gen_len: int, *, temperature: float = 0.0,
             seed: int = 0, device=None, return_margins: bool = False):
    """prompts: (B, P) int (an array, list or tensor), or (B, P,
    n_codebooks) for an audio model. Decode with a dense KV cache primed
    token by token from the prompt: greedy, or with temperature > 0
    sampled as the JAX `generate()` samples (the first token is the
    prompt's argmax; each later one splits the key of PRNGKey(seed) and
    draws categorical(sub, logits / temperature), over every codebook at
    once for audio). Returns (B, gen_len) int32 tokens ((B, gen_len,
    n_codebooks) for audio) on the device; with return_margins also the
    float32 top-1 minus top-2 logit gap of the step that chose each token
    (one a codebook for audio), of the tokens' shape. A vision model
    generates from text alone, as in the JAX package. Runs on `device`
    (default CUDA; raises without a GPU unless device="cpu" is given)."""
    dev = resolve_device(device)
    params = lm.cast_params(to_device(params, dev), cfg)
    prompts = torch.as_tensor(prompts, device=dev)
    B, P = prompts.shape[:2]
    state = lm.init_decode_state(cfg, B, P + gen_len + 1, device=dev)
    logits = None
    for pos in range(P):
        logits, state = lm.decode_step(params, cfg, state, prompts[:, pos],
                                       pos)
    out, margins = [], []
    key = prng.PRNGKey(seed, device=dev)
    for i in range(gen_len):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        margins.append(top2[..., 0] - top2[..., 1])
        if temperature > 0 and i > 0:
            key, sub = prng.split(key)
            tok = prng.categorical(sub, logits / temperature)
        else:
            tok = torch.argmax(logits, dim=-1)
        tok = tok.to(torch.int32)
        out.append(tok)
        logits, state = lm.decode_step(params, cfg, state, tok, P + i)
    tokens = torch.stack(out, dim=1)
    if return_margins:
        return tokens, torch.stack(margins, dim=1)
    return tokens


def _prompt_len_spec(values):
    """One int = fixed length; two ints = uniform (lo, hi) mixed."""
    if len(values) == 1:
        return values[0]
    if len(values) == 2:
        return (values[0], values[1])
    raise SystemExit("--prompt-len takes one or two ints")


def _sampling_from_args(args):
    """Per-workload SamplingParams from the CLI flags; None (greedy,
    no stops, no logprobs) when every flag sits at its default."""
    stop = (tuple(args.stop),) if args.stop else ()
    if (args.temperature <= 0 and args.top_k == 0 and args.top_p >= 1.0
            and not stop and args.logprobs == 0):
        return None
    return SamplingParams(temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, seed=args.seed, stop=stop,
                          logprobs=args.logprobs)


def _make_workload(args, cfg):
    rate = float("inf") if args.rate <= 0 else args.rate
    plen = _prompt_len_spec(args.prompt_len)
    sampling = _sampling_from_args(args)
    if args.deadline_ms is not None:
        # stamp a per-request soft TTFT deadline: decoding is unchanged;
        # under --slo-shed the scheduler sheds requests that cannot make
        # it and admits tighter deadlines first within a priority class
        base = sampling if sampling is not None else SamplingParams()
        sampling = dataclasses.replace(base, deadline_ms=args.deadline_ms)
    common = dict(vocab_size=cfg.vocab_size, max_new=tuple(args.max_new),
                  sampling=sampling, seed=args.seed)
    if args.workload == "shared-prefix":
        return shared_prefix_requests(
            args.requests, prefix_len=args.prefix_len, suffix_len=plen,
            n_prefixes=args.n_prefixes, rate=rate, **common)
    if args.workload == "multi-tenant":
        return multi_tenant_requests(
            args.requests, n_tenants=args.tenants,
            prefix_len=args.prefix_len, suffix_len=plen, rate=rate,
            tenant_priorities=args.tenant_priorities, **common)
    if args.workload == "bursty":
        return bursty_requests(
            args.requests, base_rate=args.base_rate,
            burst_rate=args.burst_rate, burst_every=args.burst_every,
            burst_len=args.burst_len, prompt_len=plen,
            priorities=tuple(args.priorities), **common)
    if args.workload == "diurnal":
        return diurnal_requests(
            args.requests, rate_min=args.rate_min, rate_max=args.rate_max,
            period=args.diurnal_period, prompt_len=plen,
            priorities=tuple(args.priorities), **common)
    if args.workload == "repetitive":
        return repetitive_requests(
            args.requests, period=args.period, prompt_len=plen, rate=rate,
            **common)
    if args.workload == "long-document":
        return long_document_requests(args.requests, prompt_len=plen,
                                      rate=rate, **common)
    return synthetic_requests(args.requests, prompt_len=plen, rate=rate,
                              **common)


def _engine_kwargs(args, max_seq_len, device):
    return dict(num_slots=args.slots, block_size=args.block_size,
                max_seq_len=max_seq_len, prefix_cache=args.prefix_cache,
                prefill_buckets=args.prefill_buckets,
                prefill_max_batch=args.prefill_batch,
                prefill_chunk=args.prefill_chunk,
                speculate=args.speculate, draft=args.draft,
                ngram=args.ngram, kv_dtype=args.kv_dtype,
                host_cache_blocks=args.host_cache_blocks,
                priority_aging=args.priority_aging,
                # widen the top-k side output when the CLI asks for more
                # alternatives than the engine default carries
                max_logprobs=max(args.logprobs, 8), device=device)


def _slo_from_args(args):
    """(SLOPolicy, SLOTracker) when any SLO flag asks for the layer,
    else (None, None) — the default path carries zero SLO state."""
    slo_on = (args.slo_ttft_ms is not None
              or args.slo_latency_ms is not None
              or args.slo_shed or args.slo_autoscale)
    if not slo_on:
        return None, None
    policy = SLOPolicy(
        ttft_objective_ms=(args.slo_ttft_ms if args.slo_ttft_ms is not None
                           else 200.0),
        latency_objective_ms=args.slo_latency_ms,
        error_budget=args.slo_budget)
    return policy, SLOTracker(policy)


def _build_cluster(args, cfg, params, obs, slo_tracker, kwargs):
    """(router, replicas) for --autoscale or --replicas N, else None."""
    if args.autoscale:
        # elastic cluster: the router starts with min_replicas enabled
        # stacks; the rest are built up front and parked in the
        # autoscaler's standby pool, to be activated (warm) when
        # sustained queue pressure demands it and drained back when the
        # burst passes
        n_max = max(args.max_replicas, args.min_replicas)
        replicas = [Replica(params, cfg, replica_id=i, obs=obs, **kwargs)
                    for i in range(n_max)]
        router = Router(replicas[:args.min_replicas], policy=args.router,
                        obs=obs)
        policy = AutoscalePolicy(
            min_replicas=args.min_replicas, max_replicas=n_max,
            queue_high=args.queue_high, queue_low=args.queue_low,
            cooldown_s=args.scale_cooldown)
        controller = (SLOSignal(slo_tracker, policy, obs=obs)
                      if args.slo_autoscale else None)
        Autoscaler(router, policy=policy,
                   standby=replicas[args.min_replicas:], obs=obs,
                   controller=controller)
        return router, replicas
    if args.replicas > 1:
        replicas = [Replica(params, cfg, replica_id=i, obs=obs, **kwargs)
                    for i in range(args.replicas)]
        return Router(replicas, policy=args.router, obs=obs), replicas
    return None


def _run_engine(args, cfg, params, device):
    reqs = _make_workload(args, cfg)
    max_prompt = max(len(r.prompt) for r in reqs)
    kwargs = _engine_kwargs(args, max_prompt + max(args.max_new) + 1, device)
    _, slo_tracker = _slo_from_args(args)
    # the recorder is on only when an export was asked for — the default
    # NULL_OBS path records nothing and adds no work (and outputs are
    # bit-identical either way). --flight-recorder implies the recorder:
    # the ring is fed by the same instruments.
    recorder = (FlightRecorder(dump_path=args.flight_recorder)
                if args.flight_recorder else None)
    tracing = bool(args.trace_out or args.metrics_out
                   or args.flight_recorder)
    obs = Observability(recorder=recorder) if tracing else NULL_OBS
    if slo_tracker is not None:
        kwargs["slo_tracker"] = slo_tracker
        kwargs["slo_shed"] = args.slo_shed
        if obs.enabled:
            obs.slo = slo_tracker    # root view: metrics_dump sketches
    cluster = _build_cluster(args, cfg, params, obs, slo_tracker, kwargs)
    if cluster is not None:
        router, replicas = cluster
        done = router.run(reqs)
        stats = summarize_cluster(done, router.wall_time, router)
    else:
        engine = ServingEngine(params, cfg, obs=obs, **kwargs)
        replicas = []
        done = engine.run(reqs)
        stats = summarize(done, engine.wall_time, engine)
    if slo_tracker is not None and "slo" not in stats:
        # cluster paths: summarize_cluster has no engine handle, so the
        # shared tracker's snapshot is attached here
        stats["slo"] = slo_tracker.snapshot()
    stats["device"] = str(device)
    if replicas:
        # one device copy of the weights under every replica's runner
        stats["shared_weights"] = _shared_weights(replicas)
    if args.flight_recorder:
        doc = recorder.dump()
        errs = validate_trace_events(doc)
        if errs:
            raise SystemExit(f"invalid flight-recorder dump: {errs[:3]}")
        fr = doc["otherData"]["flight_recorder"]
        print(f"flight recorder: {fr['events']} events "
              f"({fr['dropped']} dropped, {len(fr['anomalies'])} "
              f"anomalies) to {args.flight_recorder}")
    if args.trace_out:
        doc = export_trace(obs, args.trace_out)
        errs = validate_trace_events(doc)
        if errs:
            raise SystemExit(f"invalid trace_event export: {errs[:3]}")
        print(f"wrote {len(doc['traceEvents'])} trace events "
              f"to {args.trace_out}")
    if args.metrics_out:
        doc = export_metrics(obs, args.metrics_out)
        errs = validate_metrics_dump(doc)
        if errs:
            raise SystemExit(f"invalid metrics dump: {errs[:3]}")
        print(f"wrote metrics ({len(doc['counters'])} counters, "
              f"{len(doc['series'])} series samples) to {args.metrics_out}")
    print(json.dumps(stats, indent=1))
    if done:
        sample = min(done, key=lambda c: c.rid)
        print(f"sample (req {sample.rid}): {sample.tokens[:16]}")


def _shared_weights(replicas) -> bool:
    """Whether every replica's runner holds the same tensor (one
    data_ptr) for every weight leaf."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    ptrs = [[t.data_ptr() for t in leaves(r.engine.runner.params)]
            for r in replicas]
    return all(p == ptrs[0] for p in ptrs)


def _naive_prompts(args, cfg):
    """The naive path's fixed batch of prompts: JAX's
    jax.random.randint(PRNGKey(seed + 1), (batch, prompt_len), 0, vocab)
    ((batch, prompt_len, n_codebooks) for audio), the same tokens (int64
    on the CPU)."""
    shape = (args.batch, args.prompt_len[0])
    if cfg.frontend == "audio":
        shape += (cfg.n_codebooks,)
    return prng.randint(prng.PRNGKey(args.seed + 1), shape, 0,
                        cfg.vocab_size)


def _run_naive(args, cfg, params, device):
    prompts = _naive_prompts(args, cfg)
    t0 = time.perf_counter()
    tokens = generate(params, cfg, prompts, max(args.max_new),
                      temperature=args.temperature, device=device)
    tokens = tokens.cpu()
    dt = time.perf_counter() - t0
    n_tok = tokens.shape[0] * tokens.shape[1]
    print(f"generated {tuple(tokens.shape)} in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s batched) on {device}")
    print(tokens[0][:16].numpy())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published config instead of .reduced()")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run "
                         "without a GPU)")
    ap.add_argument("--mode", default="engine", choices=["engine", "naive"])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed batch for --mode naive")
    ap.add_argument("--prompt-len", type=int, nargs="+", default=[64])
    ap.add_argument("--max-new", type=int, nargs=2, default=(8, 32),
                    metavar=("LO", "HI"))
    ap.add_argument("--workload", default="synthetic",
                    choices=["synthetic", "shared-prefix", "multi-tenant",
                             "repetitive", "long-document", "bursty",
                             "diurnal"])
    ap.add_argument("--prefix-len", type=int, default=48)
    ap.add_argument("--n-prefixes", type=int, default=1)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--tenant-priorities", type=int, nargs="+", default=None,
                    help="per-tenant scheduler priority classes (one int "
                         "per tenant; higher preempts lower — an SLO mix "
                         "for --workload multi-tenant)")
    ap.add_argument("--base-rate", type=float, default=4.0)
    ap.add_argument("--burst-rate", type=float, default=64.0)
    ap.add_argument("--burst-every", type=float, default=2.0)
    ap.add_argument("--burst-len", type=float, default=0.25)
    ap.add_argument("--priorities", type=int, nargs="+", default=[0],
                    help="priority classes drawn uniformly per request "
                         "(bursty / diurnal)")
    ap.add_argument("--rate-min", type=float, default=1.0)
    ap.add_argument("--rate-max", type=float, default=32.0)
    ap.add_argument("--diurnal-period", type=float, default=8.0)
    ap.add_argument("--priority-aging", type=float, default=2.0,
                    help="seconds of queue wait worth one priority class "
                         "at admission (starvation bound; <=0 disables)")
    ap.add_argument("--period", type=int, default=6)
    ap.add_argument("--speculate", type=int, default=0)
    ap.add_argument("--draft", default="ngram", choices=["ngram"])
    ap.add_argument("--ngram", type=int, default=3)
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=None)
    ap.add_argument("--prefill-buckets", type=int, nargs="+", default=None)
    ap.add_argument("--prefill-batch", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--rate", type=float, default=0.0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy; "
                         "each request gets its own PRNG stream)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--stop", type=int, nargs="+", default=None,
                    help="stop token sequence: generation ends when the "
                         "output ends with these ids")
    ap.add_argument("--logprobs", type=int, default=0,
                    help="record the chosen token's logprob plus the "
                         "top-k alternatives per position (0 = off)")
    ap.add_argument("--kv-dtype", default="fp16",
                    choices=["fp16", "int8", "fp8"],
                    help="paged KV pool dtype: fp16 keeps the activation "
                         "dtype, int8 / fp8 quantize on landing with "
                         "per-slot, per-head scale tables")
    ap.add_argument("--host-cache-blocks", type=int, default=0,
                    help="host-RAM spill tier capacity in KV blocks "
                         "(0 = off)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="model replicas behind the cluster router "
                         "(each a full engine stack; 1 = no router)")
    ap.add_argument("--autoscale", action="store_true",
                    help="elastic cluster: start --min-replicas, scale "
                         "out to --max-replicas under sustained queue "
                         "pressure and drain back when idle (overrides "
                         "--replicas)")
    ap.add_argument("--min-replicas", type=int, default=1,
                    help="enabled replicas at run start (--autoscale)")
    ap.add_argument("--max-replicas", type=int, default=3,
                    help="replica ceiling; the surplus stacks are built "
                         "up front as the warm standby pool "
                         "(--autoscale)")
    ap.add_argument("--queue-high", type=float, default=2.0,
                    help="per-replica queue depth that accumulates "
                         "toward a scale-out (--autoscale)")
    ap.add_argument("--queue-low", type=float, default=1.0,
                    help="per-replica load at or below which idleness "
                         "accumulates toward a scale-in (--autoscale)")
    ap.add_argument("--scale-cooldown", type=float, default=0.25,
                    help="minimum seconds between scaling decisions "
                         "(--autoscale)")
    ap.add_argument("--router", default="least-loaded",
                    choices=["rr", "least-loaded", "prefix"],
                    help="replica placement policy: round-robin, "
                         "least-loaded (slot+queue occupancy), or "
                         "prefix-affinity (BlockAllocator match_prefix "
                         "probe)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT objective in ms: turns on the SLO layer "
                         "(streaming latency sketches + burn-rate "
                         "windows; see repro_torch.serving.slo)")
    ap.add_argument("--slo-latency-ms", type=float, default=None,
                    help="end-to-end latency objective in ms (optional "
                         "second SLO besides TTFT)")
    ap.add_argument("--slo-budget", type=float, default=0.1,
                    help="error budget: tolerated fraction of requests "
                         "over objective (burn rate 1.0 = spending "
                         "exactly this budget)")
    ap.add_argument("--slo-shed", action="store_true",
                    help="SLO-aware admission: order by deadline slack "
                         "within a priority class and shed requests "
                         "whose --deadline-ms cannot be met (OFF by "
                         "default — without it admission order and "
                         "outputs are untouched)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request soft TTFT deadline in ms after "
                         "arrival (stamped on every request; acted on "
                         "only under --slo-shed)")
    ap.add_argument("--slo-autoscale", action="store_true",
                    help="drive --autoscale decisions from the TTFT "
                         "burn rate (SLOSignal) instead of queue depth")
    ap.add_argument("--flight-recorder", default=None, metavar="PATH",
                    help="always-on bounded ring of recent trace events; "
                         "dumps a Perfetto trace to PATH on anomalies "
                         "(TTFT breach, preemption storm, eviction "
                         "thrash) and at end of run. Enables the "
                         "observability recorder.")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON of "
                         "the run (request lifecycle spans per slot, "
                         "dispatch timeline; open in ui.perfetto.dev). "
                         "Enables the observability recorder.")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry dump JSON (counters/"
                         "gauges/histograms + SchedulerStats time series). "
                         "Enables the observability recorder.")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.slo_autoscale and not args.autoscale:
        raise SystemExit("--slo-autoscale requires --autoscale")

    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    # the compute dtype once, up front: every engine's runner (and every
    # replica of a cluster) then holds these very tensors
    params = lm.cast_params(lm.init_params(0, cfg, device=device), cfg)
    if args.mode == "engine":
        _run_engine(args, cfg, params, device)
    else:
        _run_naive(args, cfg, params, device)


if __name__ == "__main__":
    main()
