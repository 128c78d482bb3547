#!/usr/bin/env python3
"""Device time of the port's flash-attention backward at the shapes the
training and recurrentgemma paths give it, for comparing two checkouts on
one card.

    python benchmarks/torch_flash_bwd_times.py [--src DIR] [--tag NAME]
        [--yardsticks]

Times `repro_torch.kernels.flash_attention_bwd` from `--src` (default:
this checkout's src/; give another checkout's src/ to time its kernels,
which are then built into that checkout's build/) in bf16 at smollm-135m's
2 x 9/3 x 512 x 64, causal (the train phase's attention), and at
recurrentgemma-2b's 1 x 10/1 x 2304 x 256 with window 2048. o is the
forward twin's output; the result is checked against the backward twin
first (2 bf16 ulps, chip_smoke.py's gate). Where the wrapper takes the
forward's saved log-sum-exps (`lse=`), that route (the one training
runs) is timed too as `lse_ms`; this checkout's wrapper called without
them runs the forward kernel first to write them, so its `ms` holds one
forward launch more than a parent's that recomputed them inside. Device
time per call is torch.profiler's (chip_smoke.py's `_times`), with each
kernel's share; wall is CUDA-event time per back-to-back call. With
--yardsticks also the twin's and SDPA's forward + backward (k / v
expanded to every query head) device times. Prints the card's name and
power limit, then one JSON line: {"tag", "src", "card", "shapes":
[{"shape", "ms", "how", "wall_ms", "kernels", "lse_ms", "bound_ms",
"bound_by", "plain_ms", "sdpa_ms"}]}. Needs a CUDA device."""
import argparse
import importlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)

# (B, H, KV, S, hd, window): smollm-135m's training attention, causal;
# recurrentgemma-2b's local attention
SHAPES = ((2, 9, 3, 512, 64, 0), (1, 10, 1, 2304, 256, 2048))


def _kernel_ms(fn, reps=20):
    """Each CUDA kernel's device ms per call, by name (torch.profiler)."""
    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 0.0

    kern, _ = chip_smoke._profiled(window)
    return {e.key[:60]: e.self_device_time_total / reps / 1e3 for e in kern}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--yardsticks", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_bwd_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention_bwd, ref
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    saves_lse = "lse" in inspect.signature(flash_attention_bwd).parameters
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for B, H, KV, S, hd, window in SHAPES:
        q, do = (torch.randn(B, H, S, hd, generator=g, device=dev)
                 .bfloat16() for _ in "qd")
        k, v = (torch.randn(B, KV, S, hd, generator=g, device=dev)
                .bfloat16() for _ in "kv")
        o = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        a = (q, k, v, o, do)
        got = flash_attention_bwd(*a, causal=True, window=window)
        want = ref.flash_attention_bwd_ref(*a, causal=True, window=window)
        for name, gt, w in zip(("dq", "dk", "dv"), got, want):
            _, ulps = chip_smoke._check(f"flash_attention_bwd {name}", gt, w)
            if ulps > chip_smoke.TOL_ULPS:
                raise AssertionError(f"{name}: {ulps} bf16 ulps off the "
                                     f"twin")
        fn = (lambda a=a, w=window: flash_attention_bwd(
            *a, causal=True, window=w))
        ms, wall, how = chip_smoke._times(fn)
        row = dict(shape=f"{B} x {H}/{KV} x {S} x {hd}, window {window}, "
                         f"bf16", ms=ms, how=how, wall_ms=wall,
                   kernels=_kernel_ms(fn), lse_ms=None)
        if saves_lse:
            lse = torch.empty(B, H, S, dtype=torch.float32, device=dev)
            fa._forward(q, k, v, True, window, lse)
            row["lse_ms"] = chip_smoke._times(
                lambda a=a, w=window, lse=lse: flash_attention_bwd(
                    *a, causal=True, window=w, lse=lse))[0]
        pairs = sum(min(i + 1, window) if window else i + 1
                    for i in range(S))
        row["bound_ms"], row["bound_by"] = chip_smoke._bound_ms(
            4 * chip_smoke._nbytes(q) + 4 * chip_smoke._nbytes(k),
            10 * hd * B * H * pairs)
        if args.yardsticks:
            ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
            idx = torch.arange(S, device=dev)
            mask = None if not window else (
                (idx[None, :] <= idx[:, None])
                & (idx[None, :] > idx[:, None] - window))

            def sdpa(q=q, ke=ke, ve=ve, do=do, mask=mask):
                qq, kk, vv = (t.detach().requires_grad_()
                              for t in (q, ke, ve))
                F.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask,
                    is_causal=mask is None).backward(do)

            row["plain_ms"] = chip_smoke._times_spaced_first(
                lambda a=a, w=window: ref.flash_attention_bwd_ref(
                    *a, causal=True, window=w), reps=5)[0]
            row["sdpa_ms"] = chip_smoke._times_spaced_first(sdpa)[0]
        rows.append(row)
        print(f"[{args.tag}] {row}")
    print(card)
    print(json.dumps({"tag": args.tag, "src": args.src, "card": card,
                      "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
