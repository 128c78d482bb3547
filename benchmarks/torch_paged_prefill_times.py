#!/usr/bin/env python3
"""Device time of the port's paged_prefill over int8 / fp8 pools (and
over a bf16 pool beside them) at the shapes the smollm-135m engine gives
it, and the seconds its kernels take to build, for comparing two
checkouts on one card.

    python benchmarks/torch_paged_prefill_times.py [--src DIR] [--tag NAME]

Times `repro_torch.kernels.paged_prefill_attention` from `--src` (default:
this checkout's src/; give another checkout's src/ to time its kernels,
which are then built into that checkout's build/) with bf16 q and suffix
over pools quantized as the engine lands K/V (attention.quantize_kv) and
over the bf16 pool itself, at chip_smoke.py's 4 x 128 admission (cached
0 / 48 / 200, a padding row) and its verify of 8 x 5 (contexts <= 500),
9 / 3 heads of 64, block size 16. Each result is first held to the twin
(chip_smoke.py's 2 bf16 ulps). Device time per call is chip_smoke.py's
`_times` (torch.profiler, or CUDA events behind a spin kernel); wall is
CUDA-event time per back-to-back call; the bound counts each cached
token's 1-byte K and V and their f32 scales once. `build_s` is the
seconds of `build.build_all()` at start: every kernel of the checkout, one
nvcc each, all started together, as chip_smoke.py's build phase (0 where
the libraries were built before). Prints the card's name and power limit,
then one JSON line: {"tag", "src", "card", "build_s", "rows": [{"shape",
"pool", "ms", "how", "wall_ms", "bound_ms", "bound_by", "max_ulps"}]}.
Needs a CUDA device."""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)

H, KV, HD, BS, M = 9, 3, 64, 16, 32
# (name, starts, new tokens a row, Ls): chip_smoke.py's admission and
# speculate=4's verify chains
CASES = (("4 x 128, cached 0/48/200", [0, 48, 200, 0], [128, 128, 100, 0],
          128),
         ("verify 8 x 5, contexts <= 500", [0, 3, 17, 100, 250, 400, 500,
                                             311], [0, 1, 2, 5, 5, 3, 5, 0],
          5))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_paged_prefill_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build, paged_prefill_attention, ref
    from repro_torch.models.attention import quantize_kv
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, starts, counts, Ls in CASES:
        n = len(starts)
        q, ks, vs = (torch.randn(n, Ls, h, HD, generator=g, device=dev)
                     .bfloat16() for h in (H, KV, KV))
        kp, vp = (torch.randn(n * M + 1, BS, KV, HD, generator=g,
                              device=dev).bfloat16() for _ in range(2))
        tables = (1 + torch.randperm(n * M, generator=g, device=dev)
                  ).reshape(n, M).int()
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        ln = st + torch.tensor(counts, dtype=torch.int32, device=dev)
        cached = int(st.sum())
        pairs = sum(c * s + c * (c + 1) // 2 for c, s in zip(counts, starts))
        for pool, qdt in (("bf16", None), ("int8", torch.int8),
                          ("fp8", torch.float8_e4m3fn)):
            if qdt is None:
                a, kw, elem = (q, ks, vs, kp, vp, tables, st, ln), {}, 2 * HD
            else:
                (kq, ksc), (vq, vsc) = (quantize_kv(p, qdt) for p in (kp, vp))
                a = (q, ks, vs, kq, vq, tables, st, ln)
                kw, elem = dict(k_scale=ksc, v_scale=vsc), HD + 4
            got = paged_prefill_attention(*a, **kw)
            want = ref.paged_prefill_ref(*a, kw.get("k_scale"),
                                         kw.get("v_scale"))
            _, ulps = chip_smoke._check(f"paged_prefill {name} {pool}", got,
                                        want)
            ms, wall, how = chip_smoke._times(
                lambda a=a, kw=kw: paged_prefill_attention(*a, **kw))
            nbytes = (2 * chip_smoke._nbytes(q)
                      + chip_smoke._nbytes(ks, vs, tables, st, ln)
                      + 2 * cached * KV * elem)
            bound, by = chip_smoke._bound_ms(nbytes, 4 * H * HD * pairs)
            row = dict(shape=f"{name}, bf16 q", pool=pool, ms=ms, how=how,
                       wall_ms=wall, bound_ms=bound, bound_by=by,
                       max_ulps=ulps)
            rows.append(row)
            print(f"[{args.tag}] {row}")
    print(card)
    print(json.dumps({"tag": args.tag, "src": args.src, "card": card,
                      "build_s": build_s, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
