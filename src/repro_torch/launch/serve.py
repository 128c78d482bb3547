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

The CLI serves the `.reduced()` config (like the JAX CLI) through the
single-replica engine (`--mode engine`, the default) or generate()'s
fixed batch (`--mode naive`); `--full-width` serves the published config.
The engine serves smollm-135m, recurrentgemma-2b and rwkv6-3b (and the
other attention-only archs). The router, autoscaler and SLO flags,
sampled decoding and the quantized / host-tier KV options belong to later
slices and stop the CLI with an error naming them.

`generate()` is the reference path: it primes a dense KV cache one token
at a time and decodes a fixed batch in lockstep; the engine's greedy
output must equal it token for token.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

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
from repro_torch.serving.observability import (NULL_OBS, Observability,
                                               export_metrics, export_trace,
                                               validate_metrics_dump,
                                               validate_trace_events)


@torch.inference_mode()
def generate(params, cfg, prompts, gen_len: int, *, temperature: float = 0.0,
             seed: int = 0, device=None, return_margins: bool = False):
    """prompts: (B, P) int (an array, list or tensor). Greedy decode with a dense KV cache primed
    token by token from the prompt. Returns (B, gen_len) int32 tokens on
    the device; with return_margins also the (B, gen_len) float32
    top-1 minus top-2 logit gap of the step that chose each token.
    Runs on `device` (default CUDA; raises without a GPU unless
    device="cpu" is given)."""
    if temperature > 0:
        raise NotImplementedError(
            "sampled generate() (temperature > 0) draws with jax.random; "
            "the PyTorch port decodes greedily until the sampling slice")
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
    for i in range(gen_len):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
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


def _make_workload(args, cfg):
    rate = float("inf") if args.rate <= 0 else args.rate
    plen = _prompt_len_spec(args.prompt_len)
    common = dict(vocab_size=cfg.vocab_size, max_new=tuple(args.max_new),
                  seed=args.seed)
    if args.workload == "shared-prefix":
        return shared_prefix_requests(
            args.requests, prefix_len=args.prefix_len, suffix_len=plen,
            n_prefixes=args.n_prefixes, rate=rate, **common)
    if args.workload == "multi-tenant":
        return multi_tenant_requests(
            args.requests, n_tenants=args.tenants,
            prefix_len=args.prefix_len, suffix_len=plen, rate=rate,
            **common)
    if args.workload == "bursty":
        return bursty_requests(
            args.requests, base_rate=args.base_rate,
            burst_rate=args.burst_rate, burst_every=args.burst_every,
            burst_len=args.burst_len, prompt_len=plen, **common)
    if args.workload == "diurnal":
        return diurnal_requests(
            args.requests, rate_min=args.rate_min, rate_max=args.rate_max,
            period=args.diurnal_period, prompt_len=plen, **common)
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
    "temperature": ("sampled decoding", lambda v: v > 0),
    "kv_dtype": ("quantized KV pools", lambda v: v != "fp16"),
    "host_cache_blocks": ("host KV spill tier", lambda v: v > 0),
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
        draft=args.draft, ngram=args.ngram, obs=obs, device=device)
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


def _run_naive(args, cfg, params, device):
    plen = args.prompt_len[0]
    rng = np.random.default_rng(args.seed + 1)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, plen))
    t0 = time.perf_counter()
    tokens = generate(params, cfg, prompts, max(args.max_new), device=device)
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
    ap.add_argument("--base-rate", type=float, default=4.0)
    ap.add_argument("--burst-rate", type=float, default=64.0)
    ap.add_argument("--burst-every", type=float, default=2.0)
    ap.add_argument("--burst-len", type=float, default=0.25)
    ap.add_argument("--rate-min", type=float, default=1.0)
    ap.add_argument("--rate-max", type=float, default=32.0)
    ap.add_argument("--diurnal-period", type=float, default=8.0)
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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-dtype", default="fp16",
                    choices=["fp16", "int8", "fp8"])
    ap.add_argument("--host-cache-blocks", type=int, default=0)
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
