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

    # sampled decoding (per-request threefry streams, JAX's draws) with
    # stop tokens and top-k logprobs; int8 / fp8 KV pools with the host
    # spill tier:
    PYTHONPATH=src python -m repro_torch.launch.serve --temperature 0.8 \
        --top-k 50 --top-p 0.95 --speculate 4 --logprobs 2 --stop 7
    PYTHONPATH=src python -m repro_torch.launch.serve --workload \
        shared-prefix --n-prefixes 4 --kv-dtype int8 --host-cache-blocks 32

The CLI serves the `.reduced()` config (like the JAX CLI) through the
single-replica engine (`--mode engine`, the default) or generate()'s
fixed batch (`--mode naive`); `--full-width` serves the published config.
The engine serves smollm-135m, recurrentgemma-2b and rwkv6-3b (and the
other attention-only archs), greedy or sampled, on activation-dtype or
int8 / fp8 pools, with or without the host spill tier. The router,
autoscaler, SLO and flight-recorder flags belong to later slices and stop
the CLI with an error naming them.

`generate()` is the reference path: it primes a dense KV cache one token
at a time and decodes a fixed batch in lockstep; the engine's greedy
output must equal it token for token. Sampled, it draws as the JAX
`generate()` does: one `split` of the key a step, then
`categorical(sub, logits / temperature)`.
"""
from __future__ import annotations

import argparse
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
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.observability import (NULL_OBS, Observability,
                                               export_metrics, export_trace,
                                               validate_metrics_dump,
                                               validate_trace_events)


@torch.inference_mode()
def generate(params, cfg, prompts, gen_len: int, *, temperature: float = 0.0,
             seed: int = 0, device=None, return_margins: bool = False):
    """prompts: (B, P) int (an array, list or tensor). Decode with a dense
    KV cache primed token by token from the prompt: greedy, or with
    temperature > 0 sampled as the JAX `generate()` samples (the first
    token is the prompt's argmax; each later one splits the key of
    PRNGKey(seed) and draws categorical(sub, logits / temperature)).
    Returns (B, gen_len) int32 tokens on the device; with return_margins
    also the (B, gen_len) float32 top-1 minus top-2 logit gap of the
    step that chose each token. Runs on `device` (default CUDA; raises
    without a GPU unless device="cpu" is given)."""
    dev = resolve_device(device)
    params = lm.cast_params(to_device(params, dev), cfg)
    prompts = torch.as_tensor(prompts, device=dev)
    B, P = prompts.shape
    state = lm.init_decode_state(cfg, B, P + gen_len + 1, device=dev)
    logits = None
    for pos in range(P):
        logits, state = lm.decode_step(params, cfg, state, prompts[:, pos],
                                       pos)
    out, margins = [], []
    key = prng.PRNGKey(seed, device=dev)
    for i in range(gen_len):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
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
    common = dict(vocab_size=cfg.vocab_size, max_new=tuple(args.max_new),
                  sampling=_sampling_from_args(args), seed=args.seed)
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


# flags of the JAX CLI whose layers are ported in later slices: each stops
# the CLI with the layer's name when set away from its default
_LATER = {
    "replicas": ("replica router", lambda v: v != 1),
    "autoscale": ("autoscaler", bool),
    "slo_ttft_ms": ("SLO layer", lambda v: v is not None),
    "slo_latency_ms": ("SLO layer", lambda v: v is not None),
    "slo_shed": ("SLO layer", bool),
    "slo_autoscale": ("SLO layer", bool),
    "deadline_ms": ("SLO layer", lambda v: v is not None),
    "flight_recorder": ("flight recorder", lambda v: v is not None),
}


def _run_engine(args, cfg, params, device):
    reqs = _make_workload(args, cfg)
    max_prompt = max(len(r.prompt) for r in reqs)
    tracing = bool(args.trace_out or args.metrics_out)
    obs = Observability() if tracing else NULL_OBS
    engine = ServingEngine(
        params, cfg, num_slots=args.slots, block_size=args.block_size,
        max_seq_len=max_prompt + max(args.max_new) + 1,
        prefix_cache=args.prefix_cache,
        prefill_buckets=args.prefill_buckets,
        prefill_max_batch=args.prefill_batch,
        prefill_chunk=args.prefill_chunk, speculate=args.speculate,
        draft=args.draft, ngram=args.ngram, kv_dtype=args.kv_dtype,
        host_cache_blocks=args.host_cache_blocks,
        priority_aging=args.priority_aging,
        # widen the top-k side output when the CLI asks for more
        # alternatives than the engine default carries
        max_logprobs=max(args.logprobs, 8), obs=obs, device=device)
    done = engine.run(reqs)
    stats = summarize(done, engine.wall_time, engine)
    stats["device"] = str(device)
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
        print(f"wrote metrics to {args.metrics_out}")
    print(json.dumps(stats, indent=1))
    if done:
        sample = min(done, key=lambda c: c.rid)
        print(f"sample (req {sample.rid}): {sample.tokens[:16]}")


def _naive_prompts(args, cfg):
    """The naive path's fixed batch of prompts: JAX's
    jax.random.randint(PRNGKey(seed + 1), (batch, prompt_len), 0, vocab),
    the same tokens (int64 on the CPU)."""
    return prng.randint(prng.PRNGKey(args.seed + 1),
                        (args.batch, args.prompt_len[0]), 0, cfg.vocab_size)


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
    ap.add_argument("--trace-out", default=None, metavar="PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PATH")
    ap.add_argument("--seed", type=int, default=0)
    # JAX CLI flags whose layers come in later slices (see _LATER)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--slo-ttft-ms", type=float, default=None)
    ap.add_argument("--slo-latency-ms", type=float, default=None)
    ap.add_argument("--slo-shed", action="store_true")
    ap.add_argument("--slo-autoscale", action="store_true")
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--flight-recorder", default=None)
    args = ap.parse_args(argv)
    for flag, (layer, is_set) in _LATER.items():
        if is_set(getattr(args, flag)):
            raise SystemExit(f"--{flag.replace('_', '-')}: the {layer} is "
                             f"not ported to PyTorch yet (a later slice)")

    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    params = lm.init_params(0, cfg, device=device)
    if args.mode == "engine":
        _run_engine(args, cfg, params, device)
    else:
        _run_naive(args, cfg, params, device)


if __name__ == "__main__":
    main()
