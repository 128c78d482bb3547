#!/usr/bin/env python3
"""Where the port's bf16 gap between prefill and stepwise decode comes
from, on one CUDA card (the PyTorch port only; no JAX).

    PYTHONPATH=src python benchmarks/torch_rwkv6_bf16_gap.py \\
        [--seeds 0 1 2] [--out PATH]

Two parts:

1. GEMM row invariance. For each matmul shape of an rwkv6-3b layer (and the
   LM head), the first M rows of x @ w computed at M = 128 (a 2 x 64
   prefill) against the same rows computed alone at M = 2 and 4 (a decode
   step): the share of bf16 outputs that differ, the largest difference in
   bf16 ulps, and the cuBLAS kernels each M runs. Under three settings: the
   port's (bf16 inputs, float32 accumulation, no reduced-precision
   reduction), cuBLAS's default (reduced-precision reduction allowed), and
   float32 matmuls of the same bf16 values.
2. The 4-layer gate. rwkv6-3b at full width cut to 4 layers (seeded random
   weights, lm.init_params(seed)), prompts 2 x 64 drawn with
   numpy.random.default_rng(seed), the first token's logits after lm.prefill
   and after stepwise lm.decode_step, in bf16 and float32: bf16 prefill vs
   stepwise and bf16 vs float32, for each seed, under the same settings plus
   two more (only the channel mix's k @ w_v in float32; every matmul row by
   row, M = 1, so no result depends on the batch), with the ms of a 4-layer
   bf16 decode step (2 lanes) under each.

benchmarks/torch_rwkv6_bf16_reference.py measures the JAX package's own
gaps (CPU) on the same prompts and seeds.
"""
import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import lm  # noqa: E402

_MATMUL = torch.Tensor.__matmul__


@contextlib.contextmanager
def variant(name, d_ff):
    """One matmul setting for the duration of the block."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction

    def f32(a, b):
        if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
            return torch.matmul(a.float(), b.float()).to(torch.bfloat16)
        return torch.matmul(a, b)

    def f32_wv(a, b):
        if b.dim() == 2 and b.shape[0] == d_ff:
            return f32(a, b)
        return torch.matmul(a, b)

    def rows(a, b):
        flat = a.reshape(-1, a.shape[-1])
        out = torch.cat([torch.matmul(flat[i:i + 1], b)
                         for i in range(flat.shape[0])])
        return out.reshape(*a.shape[:-1], b.shape[-1])

    patch = {"fp32_linears": f32, "fp32_cmix_wv": f32_wv,
             "row_by_row": rows}.get(name)
    if name == "reduced_precision_reduction":
        flags.allow_bf16_reduced_precision_reduction = True
    if patch is not None:
        torch.Tensor.__matmul__ = patch
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = _MATMUL
        flags.allow_bf16_reduced_precision_reduction = saved


def _ulps(diff, ref):
    _, e = torch.frexp(ref.abs().clamp_min(2.0 ** -8))
    return (diff / torch.ldexp(torch.ones_like(diff), e - 8)).max().item()


def _kernels(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:60] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def gemm_invariance(cfg, dev):
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    dh = cfg.n_heads * cfg.head_dim
    shapes = {"tmix r/k/v/g, cmix w_r": (D, dh), "tmix w_o": (dh, D),
              "decay_A": (D, 32), "decay_B": (32, dh), "cmix w_k": (D, F),
              "cmix w_v": (F, D), "head": (D, V)}
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (K, N) in shapes.items():
        x = torch.randn(128, K, generator=g, device=dev)
        if name == "cmix w_v":
            x = torch.relu(x).square()          # the relu^2 activations
        x = x.to(torch.bfloat16)
        w = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).to(
            torch.bfloat16)
        rec = {}
        for setting in ("as_run", "reduced_precision_reduction",
                        "fp32_linears"):
            with variant(setting, F):
                full = x @ w
                row = {"kernels_M128": _kernels(lambda: x @ w)}
                for M in (2, 4):
                    part = x[:M] @ w
                    diff = (part.float() - full[:M].float()).abs()
                    row[f"M{M}"] = {
                        "share_differing": (diff > 0).float().mean().item(),
                        "max_ulps": _ulps(diff, full[:M].float()),
                        "kernels": _kernels(lambda: x[:M] @ w)}
                rec[setting] = row
        out[name] = rec
        print(f"[gemm] {name} K={K} N={N}: " + "; ".join(
            f"{s} M=2 {r['M2']['share_differing']:.4%} differ (max "
            f"{r['M2']['max_ulps']:.3g} ulps) {r['M2']['kernels']}"
            for s, r in rec.items()), flush=True)
    return out


def first_token_logits(params, cfg, prompts):
    """(after lm.prefill, after stepwise lm.decode_step) first-token
    logits, float32 (B, V)."""
    B, P = prompts.shape
    with torch.inference_mode():
        logits, _ = lm.prefill(params, cfg, {"tokens": prompts})
        pf = logits[:, -1].float()
        state = lm.init_decode_state(cfg, B, P + 1, device=prompts.device)
        for pos in range(P):
            st, state = lm.decode_step(params, cfg, state, prompts[:, pos],
                                       pos)
    return pf, st.float()


def gate(cfg4, seeds, dev, variants):
    cfg32 = dataclasses.replace(cfg4, dtype="float32")
    out = {}
    for seed in seeds:
        master = lm.init_params(seed, cfg4, device=dev)
        prompts = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg4.vocab_size, (2, 64)), device=dev)
        f_pf, f_st = first_token_logits(master, cfg32, prompts)
        bf = lm.cast_params(master, cfg4)
        del master
        for name in variants:
            with variant(name, cfg4.d_ff):
                b_pf, b_st = first_token_logits(bf, cfg4, prompts)
                state = lm.init_decode_state(cfg4, 2, 80, device=dev)
                tok = prompts[:, 0]
                with torch.inference_mode():
                    for _ in range(3):
                        lm.decode_step(bf, cfg4, state, tok, 0)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for pos in range(20):
                        lm.decode_step(bf, cfg4, state, tok, pos)
                    torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3 / 20
            rec = {"bf16_prefill_vs_stepwise":
                   (b_pf - b_st).abs().max().item(),
                   "bf16_vs_float32_prefill": (b_pf - f_pf).abs().max().item(),
                   "bf16_vs_float32_stepwise":
                   (b_st - f_st).abs().max().item(),
                   "float32_prefill_vs_stepwise":
                   (f_pf - f_st).abs().max().item(),
                   "decode_step_ms_4_layers": step_ms}
            out.setdefault(name, {})[seed] = rec
            print(f"[gate] seed {seed} {name}: " + ", ".join(
                f"{k} {v:.4g}" for k, v in rec.items()), flush=True)
        del bf
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = get_config("rwkv6-3b")
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    rec = {"card": card, "torch": torch.__version__,
           "gemm": gemm_invariance(cfg, dev),
           "gate_4_layers": gate(cfg4, args.seeds, dev, (
               "as_run", "reduced_precision_reduction", "fp32_linears",
               "fp32_cmix_wv", "row_by_row"))}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
