#!/usr/bin/env python3
"""Device time of the port's rwkv6_scan kernel at rwkv6-3b's shapes, for
comparing two checkouts on one card.

    python benchmarks/torch_rwkv6_scan_times.py [--src DIR] [--tag NAME]

Times `repro_torch.kernels.rwkv6_scan` from `--src` (default: this
checkout's src/; give another checkout's src/ to time its kernel, which is
then built into that checkout's build/) at 40 heads of 64, bf16 r / k / v
with float32 w, u and a carried state: a decode step of 4 lanes (4 x 1),
a speculative verify chain of 4 x 5 (also with return_states where the
checkout's wrapper has it), a prefill of 2 x 512 and lm.forward's 1 x
2048. Device time per call is chip_smoke.py's `_times` (torch.profiler,
or CUDA events behind a spin kernel where no profiler window held every
call, labelled "spaced"); wall is CUDA-event time per back-to-back call.
Each shape's state is checked bit for bit against the twin first. Prints
the card's name and power limit, then one JSON line: {"tag", "src",
"card", "shapes": [{"shape", "ms", "wall_ms", "how", "bound_ms"}]}.
Needs a CUDA device."""
import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)

H, N = 40, 64
SHAPES = ((4, 1), (4, 5), (2, 512), (1, 2048))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_rwkv6_scan_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import ref, rwkv6_scan
    has_states = "return_states" in inspect.signature(rwkv6_scan).parameters
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for B, T in SHAPES:
        shape = (B, H, T, N)
        r, k, v = (torch.randn(*shape, generator=g, device=dev).mul(0.5)
                   .to(torch.bfloat16) for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(*shape, generator=g,
                                             device=dev) - 1))
        u = torch.randn(H, N, generator=g, device=dev) * 0.1
        s0 = torch.randn(B, H, N, N, generator=g, device=dev)
        a = (r, k, v, w, u, s0)
        _, got_s = rwkv6_scan(*a)
        _, want_s = ref.rwkv6_scan_ref(*a)
        if not torch.equal(got_s, want_s):
            raise AssertionError(f"rwkv6_scan {shape}: state not bit-equal "
                                 f"to the twin")
        arms = [("", {})]
        if has_states and T <= 8:
            arms.append((" return_states", {"return_states": True}))
        for label, kw in arms:
            fn = (lambda a=a, kw=kw: rwkv6_scan(*a, **kw))
            ms, wall, how = chip_smoke._times(fn, 20 if T < 64 else 5)
            steps = 4 * B * H * T * N * N if kw else 0
            bound, by = chip_smoke._bound_ms(
                chip_smoke._nbytes(r, k, v, w, u, s0, r, s0) + steps,
                7 * B * H * T * N * N, "f32")
            rows.append(dict(shape=f"{B} x {H} x {T} x {N} bf16{label}",
                             ms=ms, wall_ms=wall, how=how, bound_ms=bound,
                             bound_by=by))
            print(f"[{args.tag}] {rows[-1]}")
    print(card)
    print(json.dumps({"tag": args.tag, "src": args.src, "card": card,
                      "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
