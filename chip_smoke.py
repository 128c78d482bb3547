#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. build   the three CUDA kernels from src/repro_torch/kernels/csrc/
             (one nvcc per source, all started together);
  2. kernels each kernel against its plain PyTorch twin at the shapes
             smollm-135m serving gives it (error vs a stated tolerance,
             the bytes-or-flops bound);
  3. small   a reduced float32 smollm on the card against the same model
             on the CPU (forward logits, engine tokens vs generate());
  4. forward full-width smollm-135m lm.forward on 2 x 256 tokens: finite
             logits, the flash kernel launched;
  5. engine  full-width smollm-135m (30 layers, d_model 576, seeded random
             weights) through ServingEngine: synthetic, shared-prefix
             (prefix cache hits) and repetitive (speculate=4) streams;
             every completion checked against generate() under the margin
             rule; the paged kernels launched;
  6. timings kernel / twin / library device time (torch.profiler) and
             wall time on phase 2's inputs, then one profiled window of
             engine decode steps (device busy vs wall, top kernels).
Launch counters are zeroed just before phases 4 and 5 and read just after,
so the launches reported are the main path's own. The last lines are the
card's name and power limit, the kernels JSON line and
{"ok": true, "device": {...}}. `--record PATH` also writes the full
record (per-stream telemetry, every divergence, the decode profile) as
JSON. It needs a CUDA device and the repo's src/.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks the bounds are stated against (NVIDIA data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12,
                "fp8": 1979e12}
# Each kernel against its twin, element by element: both compute in float32
# and round the result once to bf16, so they may differ by a rounding step;
# |kernel - twin| must be at most TOL_ULPS bf16 ulps of max(|twin|, 2^-8)
# (the floor covers float32 summation-order noise on values near 0). A
# dropped or extra key moves an output by ~|v| / ctx, many ulps.
TOL_ULPS = 2
ULP_FLOOR = 2.0 ** -8
# greedy identity on the card: where the engine and generate() first
# disagree, generate()'s top-1 minus top-2 logit gap must be at most this
# (3 bf16 ulps at the top logits' magnitude, 2-4, where they fall); the
# engine prefills a prompt in one paged_prefill call, generate() primes it
# token by token, so their bf16 roundings differ. The run also fails if
# generate()'s median gap is not above the bound (the rule would then
# excuse a typical token).
MARGIN_BOUND = 0.05
MARGIN_BOUND_F32 = 1e-3


def _time_ms(fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _device_ms(fn, reps=20):
    """Device time per call: the summed duration of every GPU kernel the
    calls ran, from torch.profiler (CUPTI), so host launch overhead is
    excluded. None when the profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def _times(fn, reps=20):
    """(device ms per call, wall ms per call): the kernels' own time and
    the host-visible time of back-to-back calls (CUDA events)."""
    return _device_ms(fn, reps), _time_ms(fn, reps)


def _bound_ms(nbytes, flops, kind="bf16"):
    tb = nbytes / PEAK_BYTES_S * 1e3
    tf = flops / PEAK_FLOPS_S[kind] * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(paths)} kernels from "
          f"{build.CSRC.relative_to(ROOT)} in {secs:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        regs = [ln.split("info    :")[1].strip()
                for ln in log.read_text().splitlines() if "Used" in ln]
        spills = [ln.strip() for ln in log.read_text().splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        print(f"[build] {name}: {len(regs)} instantiations; "
              f"e.g. {regs[0] if regs else '?'}; "
              f"{len(spills)} with spills")
    return {"seconds": secs, "libraries": {n: str(p.relative_to(ROOT))
                                           for n, p in paths.items()}}


def _check(name, got, want):
    """Kernel output against its twin's; returns (max abs error, max
    error in bf16 ulps of max(|twin|, ULP_FLOOR))."""
    diff = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float().abs().clamp_min(ULP_FLOOR))
    ulps = (diff / torch.ldexp(torch.ones_like(diff), e - 8)).max().item()
    err = diff.max().item()
    ok = ulps <= TOL_ULPS and bool(torch.isfinite(got).all())
    print(f"[kernels] {name}: max_abs_err {err:.3g}, max {ulps:.3g} bf16 "
          f"ulps (tolerance {TOL_ULPS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its twin "
                             f"({ulps} bf16 ulps > {TOL_ULPS}; max abs err "
                             f"{err})")
    return err, ulps


def phase_kernels(dev):
    """Each kernel against its twin at the shapes smollm-135m serving
    gives it: every arm must be within TOL_ULPS; a kernel's max_abs_err
    and max_ulps are the largest over its arms."""
    import torch.nn.functional as F
    from repro_torch.kernels import (flash_attention, paged_attention,
                                     paged_prefill_attention, ref)
    g = torch.Generator(device=dev).manual_seed(0)
    H, KV, hd, bs, M = 9, 3, 64, 16, 32
    bf = torch.bfloat16

    def rn(*s, dt=bf):
        return torch.randn(*s, generator=g, device=dev).to(dt)

    def i32(xs):
        return torch.tensor(xs, device=dev, dtype=torch.int32)

    def tables_for(rows, m=M):
        return (1 + torch.randperm(rows * m, generator=g, device=dev)
                ).reshape(rows, m).int()

    def arm(arms, name, got, want):
        err, ulps = _check(name, got, want)
        arms.append({"arm": name, "max_abs_err": err, "max_ulps": ulps})

    def worst(arms):
        return dict(max_abs_err=max(a["max_abs_err"] for a in arms),
                    max_ulps=max(a["max_ulps"] for a in arms),
                    tolerance=f"{TOL_ULPS} bf16 ulps per element", arms=arms)

    out = []
    # -- paged_attention: 8 slots, ragged ctx incl. 0, bf16 / int8 / fp8
    # pools; then generate()'s dense decode (one row, identity table, one
    # block of S_max = 256 + 32 + 1 tokens)
    arms = []
    B = 8
    N = B * M + 1
    q = rn(B, H, hd)
    kp, vp = rn(N, bs, KV, hd), rn(N, bs, KV, hd)
    tables = tables_for(B)
    ctx = i32([0, 1, 17, 64, 128, 200, 333, 512])
    args = (q, kp, vp, tables, ctx)
    arm(arms, "paged_attention bf16", paged_attention(*args),
        ref.paged_attention_ref(*args))
    ks = torch.rand(N, bs, KV, generator=g, device=dev) / 64
    vs = torch.rand(N, bs, KV, generator=g, device=dev) / 64
    for name, (kq, vq) in (
            ("int8", (torch.randint(-127, 128, (N, bs, KV, hd), generator=g,
                                    device=dev, dtype=torch.int8),
                      torch.randint(-127, 128, (N, bs, KV, hd), generator=g,
                                    device=dev, dtype=torch.int8))),
            ("fp8", (rn(N, bs, KV, hd, dt=torch.float32).mul(64)
                     .to(torch.float8_e4m3fn),
                     rn(N, bs, KV, hd, dt=torch.float32).mul(64)
                     .to(torch.float8_e4m3fn)))):
        arm(arms, f"paged_attention {name}",
            paged_attention(q, kq, vq, tables, ctx, k_scale=ks, v_scale=vs),
            ref.paged_attention_ref(q, kq, vq, tables, ctx, ks, vs))
    s_max = 256 + 32 + 1
    dense = (rn(1, H, hd), rn(1, s_max, KV, hd), rn(1, s_max, KV, hd),
             i32([[0]]), i32([270]))
    arm(arms, f"paged_attention generate() dense bs={s_max}",
        paged_attention(*dense), ref.paged_attention_ref(*dense))
    n_tok = int(ctx.sum())
    # q in, out back, the tables, and each context token's K and V once
    nbytes = (2 * _nbytes(q) + _nbytes(tables, ctx)
              + 2 * n_tok * KV * hd * kp.element_size())
    bound, by = _bound_ms(nbytes, 4 * H * hd * n_tok)
    out.append(dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:84",
        _fns=(lambda a=args: paged_attention(*a),
              lambda a=args: ref.paged_attention_ref(*a), None),
        bound_ms=bound, bound_by=by,
        shape=dict(B=B, H=H, KV=KV, hd=hd, bs=bs, M=M, ctx=ctx.tolist()),
        **worst(arms)))

    # -- paged_prefill, at each shape the engine gives it: an admission of
    # 4 x 128 (a fresh prompt, a cached prefix, a long cached prefix and a
    # batch-padding row; window 0 and 64), the smallest suffix bucket
    # (Ls = 16, a partial query tile), and speculate=4's verify chains
    # (N = 8 slots, Ls = chain buckets 2, 4, 5; starts = positions up to
    # 500, lengths = starts + counts, counts 0 for idle and sitting-out
    # lanes)
    def prefill_case(starts, counts, Ls):
        n = len(starts)
        st = i32(starts)
        return (rn(n, Ls, H, hd), rn(n, Ls, KV, hd), rn(n, Ls, KV, hd),
                rn(n * M + 1, bs, KV, hd), rn(n * M + 1, bs, KV, hd),
                tables_for(n), st, st + i32(counts))

    arms = []
    args = prefill_case([0, 48, 200, 0], [128, 128, 100, 0], 128)
    for w in (0, 64):
        arm(arms, f"paged_prefill 4x128 window={w}",
            paged_prefill_attention(*args, window=w),
            ref.paged_prefill_ref(*args, window=w))
    cases = [("4x16 bucket", prefill_case([160, 0, 33, 0], [10, 16, 12, 0],
                                          16))]
    for T in (2, 4, 5):
        cases.append((f"verify 8x{T}", prefill_case(
            [0, 3, 17, 100, 250, 400, 500, 311],
            [0, 1, 2, T, T, min(3, T), T, 0], T)))
    for name, c in cases:
        arm(arms, f"paged_prefill {name}", paged_prefill_attention(*c),
            ref.paged_prefill_ref(*c))
    q, ksuf, vsuf, kp, vp, tables, starts, lengths = args
    # pairs the data needs: each real query sees starts pool keys plus
    # i + 1 suffix keys (window 0)
    suf = (lengths - starts).clamp_min(0).tolist()
    pairs = sum(s * st + s * (s + 1) // 2
                for s, st in zip(suf, starts.tolist()))
    pool_tok = int(starts.sum())
    nbytes = (2 * _nbytes(q) + _nbytes(ksuf, vsuf, tables, starts, lengths)
              + 2 * pool_tok * KV * hd * kp.element_size())
    bound, by = _bound_ms(nbytes, 4 * H * hd * pairs)
    out.append(dict(
        name="paged_prefill", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_prefill.cu",
        replaces="src/repro/kernels/paged_prefill.py:99",
        _fns=(lambda a=args: paged_prefill_attention(*a),
              lambda a=args: ref.paged_prefill_ref(*a), None),
        bound_ms=bound, bound_by=by,
        shape=dict(N=4, Ls=128, H=H, KV=KV, hd=hd, bs=bs, M=M,
                   starts=starts.tolist(), lengths=lengths.tolist()),
        **worst(arms)))

    # -- flash_attention: 2 x 512 causal and not, and lm.forward's 2 x 256;
    # SDPA as the yardstick
    arms = []
    q, k, v = rn(2, H, 256, hd), rn(2, KV, 256, hd), rn(2, KV, 256, hd)
    arm(arms, "flash_attention 2x256 causal=True",
        flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))
    S = 512
    q, k, v = rn(2, H, S, hd), rn(2, KV, S, hd), rn(2, KV, S, hd)
    for causal in (True, False):
        arm(arms, f"flash_attention 2x{S} causal={causal}",
            flash_attention(q, k, v, causal=causal),
            ref.flash_attention_ref(q, k, v, causal=causal))
    bound, by = _bound_ms(2 * _nbytes(q) + _nbytes(k, v),
                          4 * 2 * H * hd * S * (S + 1) // 2)
    out.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:71",
        _fns=(lambda: flash_attention(q, k, v, causal=True),
              lambda: ref.flash_attention_ref(q, k, v, causal=True),
              lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=True, enable_gqa=True)),
        bound_ms=bound, bound_by=by,
        shape=dict(B=2, H=H, KV=KV, S=S, hd=hd), **worst(arms)))
    return out


def phase_timings(kern):
    """Time each kernel, its twin and the library call on phase 2's
    inputs: ms / plain_ms / library_ms are device time per call, with the
    wall-clock (CUDA event) time per call of each beside it. Runs after
    the main path, so the profiler's hooks cannot slow it."""
    for r in kern:
        for key, fn in zip(("ms", "plain_ms", "library_ms"), r.pop("_fns")):
            wall_key = key.replace("ms", "wall_ms")
            if fn is None:
                r[key], r[wall_key] = None, None
                continue
            dev_ms, r[wall_key] = _times(fn)
            if dev_ms is None:
                raise AssertionError("torch.profiler reported no device "
                                     "time")
            r[key] = dev_ms
        print(f"[timings] {r['name']}: device {r['ms']:.4f} ms per call "
              f"(wall {r['wall_ms']:.4f}); twin {r['plain_ms']:.4f} (wall "
              f"{r['plain_wall_ms']:.4f}); library {r['library_ms']}; "
              f"bound {r['bound_ms']:.5f} by {r['bound_by']}")


def _first_divergence(a, b):
    n = min(len(a), len(b))
    for i in range(n):
        if int(a[i]) != int(b[i]):
            return i
    return None if len(a) == len(b) else n


def check_against_generate(params, cfg, reqs, done, dev, bound):
    """The margin rule: engine tokens equal generate()'s up to the first
    divergence, and there generate()'s top-1/top-2 gap is <= bound. Also
    returns generate()'s gaps at every generated position."""
    from repro_torch.launch.serve import generate
    by_rid = {r.rid: r for r in reqs}
    exact, within, gaps = 0, [], []
    for c in sorted(done, key=lambda c: c.rid):
        r = by_rid[c.rid]
        toks, margins = generate(params, cfg, r.prompt[None],
                                 r.max_new_tokens, device=dev,
                                 return_margins=True)
        toks, margins = toks[0].cpu().numpy(), margins[0].cpu().numpy()
        gaps.extend(float(x) for x in margins)
        i = _first_divergence(c.tokens, toks)
        if i is None:
            exact += 1
            continue
        gap = float(margins[i]) if i < len(margins) else float("inf")
        within.append({"rid": c.rid, "at": i, "margin": gap})
        if gap > bound:
            raise AssertionError(
                f"request {c.rid}: engine and generate() diverge at token "
                f"{i} where generate()'s top-1/top-2 margin is {gap:.4f} "
                f"> {bound}")
    return {"requests": len(done), "exact": exact,
            "diverged_within_bound": within, "bound": bound, "gaps": gaps}


def phase_small(dev):
    """A reduced float32 smollm (head_dim 64, which the kernels take) on
    the card against the same model on the CPU (the kernels' twins)."""
    from repro_torch.configs import get_config
    from repro_torch.device import to_device
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServingEngine, synthetic_requests
    cfg = get_config("smollm-135m").reduced(head_dim=64)
    params = lm.init_params(0, cfg, device="cpu")
    cuda_params = to_device(params, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    want, _ = lm.forward(params, cfg, {"tokens": toks})
    got, _ = lm.forward(cuda_params, cfg, {"tokens": toks.to(dev)})
    err = (got.cpu() - want).abs().max().item()
    print(f"[small] forward logits cuda vs cpu: max_abs_err {err:.3g} "
          f"(tolerance 1e-4)")
    if err > 1e-4:
        raise AssertionError(f"small forward differs: {err}")
    reqs = synthetic_requests(6, vocab_size=cfg.vocab_size,
                              prompt_len=(5, 40), max_new=(8, 16), seed=3)
    eng = ServingEngine(cuda_params, cfg, num_slots=4, block_size=16,
                        max_seq_len=64, device=dev)
    done = eng.run(reqs)
    rec = check_against_generate(params, cfg, reqs, done, "cpu",
                                 MARGIN_BOUND_F32)
    rec.pop("gaps")
    print(f"[small] engine (cuda) vs generate (cpu): {rec['exact']}/"
          f"{rec['requests']} exact, "
          f"{len(rec['diverged_within_bound'])} within the margin bound")
    return {"forward_max_abs_err": err, "engine_vs_generate": rec}


def phase_forward(params, cfg, dev):
    from repro_torch import kernels
    from repro_torch.models import lm
    toks = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(2))
    with torch.inference_mode():
        lm.forward(params, cfg, {"tokens": toks})        # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = lm.forward(params, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    print(f"[forward] logits {shape} {logits.dtype} finite={finite} in "
          f"{secs * 1e3:.1f} ms; launches {counts}")
    if not finite or shape != (2, 256, cfg.vocab_size):
        raise AssertionError("forward logits are not finite or misshapen")
    if counts["flash_attention"] == 0:
        raise AssertionError("lm.forward did not launch flash_attention")
    return {"ms": secs * 1e3, "launches": counts}


def phase_engine(params, cfg, dev):
    """Three streams through ServingEngine. Launch counters are zeroed
    before each stream and read after it: each stream must launch
    paged_prefill once per layer per prefill or verify dispatch and
    paged_attention once per layer per plain decode step, and both must
    be > 0 in every stream (the speculate=4 stream included)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.serving.engine import (ServingEngine,
                                            repetitive_requests,
                                            shared_prefix_requests,
                                            summarize, synthetic_requests)
    V = cfg.vocab_size
    kw = dict(num_slots=8, block_size=16, max_seq_len=512,
              prefix_cache=True, device=dev)
    streams = [
        ("synthetic", {}, synthetic_requests(
            16, vocab_size=V, prompt_len=(32, 256), max_new=(32, 32),
            seed=0)),
        ("shared_prefix", {}, shared_prefix_requests(
            8, vocab_size=V, prefix_len=160, suffix_len=(8, 64),
            max_new=(32, 32), seed=1)),
        ("repetitive_speculate4", {"speculate": 4}, repetitive_requests(
            4, vocab_size=V, period=6, prompt_len=(48, 96),
            max_new=(32, 32), seed=2)),
    ]
    engines = {0: ServingEngine(params, cfg, **kw),
               4: ServingEngine(params, cfg, speculate=4, **kw)}
    for eng in engines.values():       # warm-up: cuBLAS handles, allocator
        eng.run(synthetic_requests(2, vocab_size=V, prompt_len=(20, 40),
                                   max_new=(4, 4), seed=9))
        eng.reset_prefix_cache()
    torch.cuda.synchronize()
    results = []
    for name, extra, reqs in streams:
        eng = engines[extra.get("speculate", 0)]
        kernels.reset_launch_counts()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        stats = summarize(done, eng.wall_time, eng)
        stats["decode_or_verify_steps"] = eng.steps
        stats["launches"] = counts
        verifies = (stats.get("speculation") or {}).get("verify_dispatches",
                                                        0)
        prefills = stats["prefill"]["dispatches"]
        want = {"paged_prefill": cfg.n_layers * (prefills + verifies),
                "paged_attention": cfg.n_layers * (eng.steps - verifies),
                "flash_attention": 0}
        results.append((name, reqs, done, stats))
        print(f"[engine] {name}: {stats['requests']} requests, "
              f"{stats['generated_tokens']} tokens, "
              f"{stats['tokens_per_s']} tokens/s, ttft p50 "
              f"{stats['ttft_p50_ms']} ms p99 {stats['ttft_p99_ms']} ms; "
              f"prefix hits {stats['prefix_cache']['hit_requests']}, "
              f"cached tokens {stats['prefill']['cached_tokens']}; "
              f"{prefills} prefill, {verifies} verify, "
              f"{eng.steps - verifies} decode dispatches; launches {counts}")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{want} from the dispatch counts")
        if counts["paged_attention"] == 0 or counts["paged_prefill"] == 0:
            raise AssertionError(f"{name}: the engine did not launch both "
                                 f"paged kernels")
        if extra.get("speculate") and verifies == 0:
            raise AssertionError(f"{name}: no verify dispatch")
    launches = {k: sum(st["launches"][k] for _, _, _, st in results)
                for k in results[0][3]["launches"]}
    steps = sum(st["decode_or_verify_steps"] for _, _, _, st in results)
    prefills = sum(st["prefill"]["dispatches"] for _, _, _, st in results)
    print(f"[engine] all streams: launches {launches}; {steps} decode/verify "
          f"steps, {prefills} prefill dispatches")
    record = {"launches": launches, "steps": steps,
              "prefill_dispatches": prefills, "streams": {}}
    gaps = []
    for name, reqs, done, stats in results:
        if len(done) != len(reqs):
            raise AssertionError(f"{name}: {len(done)} of {len(reqs)} "
                                 f"requests completed")
        rec = check_against_generate(params, cfg, reqs, done, dev,
                                     MARGIN_BOUND)
        gaps.extend(rec.pop("gaps"))
        where = [(d["rid"], d["at"], round(d["margin"], 4))
                 for d in rec["diverged_within_bound"]]
        print(f"[engine] {name} vs generate(): {rec['exact']}/"
              f"{rec['requests']} exact; (request, token, margin) of each "
              f"divergence within the bound: {where}")
        record["streams"][name] = {"stats": stats, "vs_generate": rec}
    gaps = np.asarray(gaps)
    record["generate_margins"] = {
        "positions": int(gaps.size),
        "median": float(np.median(gaps)),
        "p10": float(np.percentile(gaps, 10)),
        "share_at_or_below_bound": float((gaps <= MARGIN_BOUND).mean())}
    m = record["generate_margins"]
    print(f"[engine] generate() top-1/top-2 gaps over {m['positions']} "
          f"positions: median {m['median']:.4f}, p10 {m['p10']:.4f}, "
          f"{m['share_at_or_below_bound']:.1%} at or below the bound "
          f"{MARGIN_BOUND}")
    if m["median"] <= MARGIN_BOUND:
        raise AssertionError(f"generate()'s median gap {m['median']} is not "
                             f"above the margin bound {MARGIN_BOUND}")
    return record, engines[0]


def profile_decode(eng, vocab, n_steps=10):
    """Where one decode step's time goes: 8 lanes decoding (prompts of
    128, all admitted first), n_steps engine steps under torch.profiler.
    Returns wall ms per step, device-busy ms per step (summed kernel
    time), the idle share and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import synthetic_requests
    for r in synthetic_requests(8, vocab_size=vocab, prompt_len=128,
                                max_new=(n_steps + 8, n_steps + 8), seed=5):
        eng.submit(r)
    eng.begin_run()
    while eng.stats().queue_depth:     # admit all 8
        eng.step()
    for _ in range(2):                 # then a couple of plain decodes
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_steps
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / n_steps
    launches = sum(e.count for e in kern) / n_steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    while eng.has_work:
        eng.step()
    eng.scheduler.completions = []
    rec = {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
           "idle_share": 1.0 - busy / wall,
           "kernel_launches_per_step": launches,
           "top_kernels": [{"name": e.key[:80], "ms_per_step":
                            e.self_device_time_total / 1e3 / n_steps,
                            "calls_per_step": e.count / n_steps}
                           for e in top]}
    print(f"[profile] decode step: wall {wall:.2f} ms, device busy "
          f"{busy:.3f} ms (idle {rec['idle_share']:.1%}), "
          f"{launches:.0f} kernel launches per step")
    for t in rec["top_kernels"]:
        print(f"[profile]   {t['ms_per_step']:.4f} ms x "
              f"{t['calls_per_step']:.0f}  {t['name']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="write the full run record as JSON to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    dev = resolve_device("cuda")       # also sets the float flags
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    record["build"] = phase_build()
    kern = phase_kernels(dev)
    record["small"] = phase_small(dev)
    cfg = get_config("smollm-135m")
    params = lm.cast_params(lm.init_params(0, cfg, device=dev), cfg)
    record["forward"] = phase_forward(params, cfg, dev)
    record["engine"], engine = phase_engine(params, cfg, dev)
    # profiled last: torch.profiler's hooks stay behind in the process
    phase_timings(kern)
    record["decode_profile"] = profile_decode(engine, cfg.vocab_size)
    launches = {"flash_attention":
                record["forward"]["launches"]["flash_attention"],
                "paged_attention":
                record["engine"]["launches"]["paged_attention"],
                "paged_prefill": record["engine"]["launches"]["paged_prefill"]}
    for k in kern:
        k["launches"] = launches[k["name"]]
    record["kernels"] = kern
    record["seconds"] = time.perf_counter() - t_start
    if args.record:
        path = Path(args.record)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))
    print(f"[done] {record['seconds']:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
