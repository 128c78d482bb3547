#!/usr/bin/env python3
"""Device time of the port's rglru_scan kernel at recurrentgemma-2b's
shapes, for comparing two checkouts on one card.

    python benchmarks/torch_rglru_scan_times.py [--src DIR] [--tag NAME]

Times `repro_torch.kernels.rglru_scan` from `--src` (default: this
checkout's src/; give another checkout's src/ to time its kernel, which is
then built into that checkout's build/) at rnn_width 2560 in float32: a
decode step of 4 lanes (4 x 1), generate()'s prefill (4 x 64), a prefill
of 2 x 512 and lm.forward's 1 x 2304, each with a float32 h0. Device time
per call is torch.profiler's (chip_smoke.py's `_device_ms`, which falls
back to None when no window held every call); wall is CUDA-event time
per back-to-back call. Each shape's output is checked bit for bit against
the twin first. Prints the card's name and power limit, then one JSON
line: {"tag", "src", "card", "shapes": [{"shape", "ms", "wall_ms",
"bound_ms", "kernel", "blocks"}]} (kernel and blocks null where the
wrapper has no route). Needs a CUDA device."""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)

SHAPES = ((4, 1), (4, 64), (2, 512), (1, 2304))
C = 2560


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_rglru_scan_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import ref, rglru_scan
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for B, T in SHAPES:
        a = torch.sigmoid(torch.randn(B, T, C, generator=g, device=dev) * 2)
        x = torch.randn(B, T, C, generator=g, device=dev) * 0.3
        h0 = torch.randn(B, C, generator=g, device=dev)
        got, got_h = rglru_scan(a, x, h0)
        want, want_h = ref.rglru_scan_ref(a, x, h0)
        if not (torch.equal(got, want) and torch.equal(got_h, want_h)):
            raise AssertionError(f"rglru_scan {B} x {T} x {C}: not "
                                 f"bit-equal to the twin")
        fn = (lambda a=a, x=x, h0=h0: rglru_scan(a, x, h0))
        ms = chip_smoke._device_ms(fn)
        wall = chip_smoke._time_ms(fn, reps=50)
        bound, _ = chip_smoke._bound_ms(3 * a.numel() * 4 + 2 * B * C * 4,
                                        2 * a.numel(), "f32")
        plan = getattr(rglru_scan, "plan", None)
        kernel, nb = plan(a, x) if plan else (None, None)
        rows.append(dict(shape=f"{B} x {T} x {C} float32", ms=ms,
                         wall_ms=wall, bound_ms=bound, kernel=kernel,
                         blocks=nb))
        print(f"[{args.tag}] {rows[-1]}")
    print(card)
    print(json.dumps({"tag": args.tag, "src": args.src, "card": card,
                      "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
