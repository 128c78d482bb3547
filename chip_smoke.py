#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. build   the four CUDA kernels from src/repro_torch/kernels/csrc/
             (one nvcc per source, all started together);
  2. kernels each kernel against its plain PyTorch twin at the shapes its
             main path gives it (error vs a stated tolerance, the
             bytes-or-flops bound): the attention kernels at smollm-135m
             serving shapes, svrg_update at 2^20, an odd tail and an
             unaligned view, float32 and bf16;
  3. small   a reduced float32 smollm on the card against the same model
             on the CPU (forward logits, engine tokens vs generate());
  4. forward full-width smollm-135m lm.forward on 2 x 256 tokens: finite
             logits, the flash kernel launched;
  5. engine  full-width smollm-135m (30 layers, d_model 576, seeded random
             weights) through ServingEngine: synthetic, shared-prefix
             (prefix cache hits) and repetitive (speculate=4) streams;
             every completion checked against generate() under the margin
             rule; the paged kernels launched;
  6. core    the paper core on paper-lsq (d = 64, m = 8 machines, b = 128,
             T = 8): MP-DSVRG, MP-DANE (exact) and minibatch-prox (exact)
             on the card against the same runs on the CPU over the same
             replayed data, each within its rate bound; MP-DSVRG launches
             svrg_update T * K * batch times. Then MP-DSVRG at d = 2^20
             (X is 4 GiB a step on the card): wall time, launches, each
             step's prox subproblem solved to a stated share of its gap,
             w_avg near the exact minibatch-prox path's, the closed-form
             suboptimality reported;
  7. timings kernel / twin / library device time (torch.profiler) and
             wall time on phase 2's inputs, then one profiled window of
             engine decode steps and one profiled MP-DSVRG outer step at
             d = 2^20 (device busy vs wall, top kernels).
Launch counters are zeroed just before phases 4, 5 (per stream) and 6 and
read just after, so the launches reported are the main paths' own. The
last lines are the card's name and power limit, the kernels JSON line and
{"ok": true, "device": {...}}. `--record PATH` also writes the full
record (per-stream telemetry, every divergence, the profiles) as JSON. It
needs a CUDA device and the repo's src/.
"""
import argparse
import dataclasses
import itertools
import json
import math
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
# svrg_update against its twin: float32 within 1e-6 (1 + |twin|) (the JAX
# kernel test's 1e-6); bf16 within 1 ulp of max(|twin|, 2^-8), since both
# compute in float32 and round once
SVRG_TOL_F32 = 1e-6
SVRG_TOL_ULPS = 1
# the core phase's CUDA runs against the same runs on the CPU: float32
# iterates within 1e-5 absolute, the tolerance tests/test_torch_core.py
# states for the port against the JAX package
CORE_ATOL = 1e-5
# the d = 2^20 arm. MP-DSVRG's K = 10 inner iterations close each outer
# step's prox-subproblem gap f_t(w) - f_t(w_t*) to <= PROX_GAP_RATIO of its
# value at w_{t-1} (about 2^-K is expected), and its w_avg lies within
# EXACT_PATH_DIST (relative) of the exact minibatch-prox path's average on
# the same data; tests/test_torch_core.py::
# test_mp_dsvrg_tracks_exact_prox_path holds the same bounds on the CPU at
# d = 16 and 1024, and test_exact_path_bounds_catch_a_faulty_update shows
# both fail at d = 1024 when a term of the update is dropped or wrong. At this width the population suboptimality cannot show
# learning: each sample's signal variance is ~1/d against a noise variance
# of 0.01, and the exact path itself ends next to, or above, the value at
# w = 0; the run reports the three values without a bound between them.
PROX_GAP_RATIO = 1e-2
EXACT_PATH_DIST = 0.1


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


def _check(name, got, want, tol_ulps=TOL_ULPS, f32_tol=None):
    """Kernel output against its twin's; returns (max abs error, max
    error in bf16 ulps of max(|twin|, ULP_FLOOR)). With f32_tol, every
    element must also be within f32_tol * (1 + |twin|)."""
    diff = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float().abs().clamp_min(ULP_FLOOR))
    ulps = (diff / torch.ldexp(torch.ones_like(diff), e - 8)).max().item()
    err = diff.max().item()
    ok = ulps <= tol_ulps and bool(torch.isfinite(got).all())
    if f32_tol is not None:
        ok = ok and bool((diff <= f32_tol * (1 + want.float().abs())).all())
    tol = f"{tol_ulps} bf16 ulps" + (f", {f32_tol} (1 + |twin|)"
                                     if f32_tol is not None else "")
    print(f"[kernels] {name}: max_abs_err {err:.3g}, max {ulps:.3g} bf16 "
          f"ulps (tolerance {tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its twin "
                             f"(max {ulps} bf16 ulps, max abs err {err}; "
                             f"tolerance {tol})")
    return err, ulps


def phase_kernels(dev):
    """Each kernel against its twin at the shapes its main path gives it:
    every arm must be within its tolerance; a kernel's max_abs_err and
    max_ulps are the largest over its arms."""
    import torch.nn.functional as F
    from repro_torch.kernels import (flash_attention, paged_attention,
                                     paged_prefill_attention, ref,
                                     svrg_update)
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

    def arm(arms, name, got, want, **tol):
        err, ulps = _check(name, got, want, **tol)
        arms.append({"arm": name, "max_abs_err": err, "max_ulps": ulps})

    def worst(arms, tolerance=f"{TOL_ULPS} bf16 ulps per element"):
        return dict(max_abs_err=max(a["max_abs_err"] for a in arms),
                    max_ulps=max(a["max_ulps"] for a in arms),
                    tolerance=tolerance, arms=arms)

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

    # -- svrg_update: n = 64 (the core phase's paper-lsq width), n = 2^20
    # (parameter-sized vectors), an odd tail, and views one element into
    # their buffers (not 16-byte aligned: the scalar path), float32 and bf16
    arms = []
    for n, offset in ((64, 0), (1 << 20, 0), (100003, 0), (100003, 1)):
        for dt in (torch.float32, bf):
            xs = [rn(n + offset, dt=dt)[offset:] for _ in range(5)]
            tol = (dict(f32_tol=SVRG_TOL_F32) if dt == torch.float32
                   else dict(tol_ulps=SVRG_TOL_ULPS))
            arm(arms, f"svrg_update n={n} offset={offset} {dt}",
                svrg_update(*xs, 0.1, 0.5),
                ref.svrg_update_ref(*xs, 0.1, 0.5), **tol)
    n = 1 << 20
    # timed cold, as the bound assumes (every byte from device memory): the
    # calls rotate over four input sets, 4 x 20 MB against the 50 MB L2, so
    # a set has left the L2 by its next turn
    sets = itertools.cycle([[rn(n, dt=torch.float32) for _ in range(5)]
                            for _ in range(4)])
    # five vectors read and one written; 7 float32 operations per element
    bound, by = _bound_ms(6 * 4 * n, 7 * n, "f32")
    out.append(dict(
        name="svrg_update", route="cuda",
        source="src/repro_torch/kernels/csrc/svrg_update.cu",
        replaces="src/repro/kernels/svrg_update.py:35",
        _fns=(lambda: svrg_update(*next(sets), 0.1, 0.5),
              lambda: ref.svrg_update_ref(*next(sets), 0.1, 0.5), None),
        bound_ms=bound, bound_by=by, shape=dict(n=n, dtype="float32"),
        **worst(arms, f"float32 {SVRG_TOL_F32} (1 + |twin|); bf16 "
                      f"{SVRG_TOL_ULPS} ulp")))
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
                "flash_attention": 0, "svrg_update": 0}
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


class Replay:
    """A stream that ignores its generator and hands out pre-drawn data in
    order: the same batches through the CUDA and the CPU runs."""

    def __init__(self, dim, items):
        self.dim = dim
        self._items = iter(items)

    def sample(self, generator, n):
        return next(self._items)

    def sample_distributed(self, generator, m, b):
        return next(self._items)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _prox_point_wide(w_prev, Xm, ym, gamma):
    """The exact union minibatch-prox point (eq. 12), in float64, for d far
    above the n = m * b rows: through the n x n system (Woodbury),
    (X^T X / n + gamma I)^-1 v = (v - X^T (X X^T + n gamma I)^-1 X v) / gamma
    with v = X^T y / n + gamma w_prev."""
    X = Xm.reshape(-1, Xm.shape[-1]).double()
    y = ym.reshape(-1).double()
    n = X.shape[0]
    v = X.T @ y / n + gamma * w_prev.double()
    G = X @ X.T + n * gamma * torch.eye(n, dtype=X.dtype, device=X.device)
    return (v - X.T @ torch.linalg.solve(G, X @ v)) / gamma


def _prox_gap(w, w_star, Xm, gamma):
    """f_t(w) - f_t(w_star) of the least-squares prox subproblem at its
    exact minimizer w_star, with no cancellation: 0.5 (|X e|^2 / n +
    gamma |e|^2), e = w - w_star, in float64."""
    X = Xm.reshape(-1, Xm.shape[-1]).double()
    e = w.double() - w_star
    return 0.5 * ((X @ e).square().sum() / X.shape[0]
                  + gamma * e.square().sum()).item()


def phase_core(dev):
    """The paper core on the card. paper-lsq at its own widths (d = 64,
    noise 0.1, decay 0.5; spec from 8192 rows) with the quickstart's
    m = 8, b = 128, T = 8: MP-DSVRG, MP-DANE (exact) and minibatch-prox
    (exact, b * m rows a step) run on the card and on the CPU over the same
    data, drawn once on the card; iterates must agree within CORE_ATOL,
    plans and ledgers must be equal, and each w_avg's population
    suboptimality must be within its theorem's bound. Then MP-DSVRG at
    d = 2^20. svrg_update's counter is zeroed before each CUDA run and
    read after it. Returns the record and a function that profiles one
    outer step at d = 2^20 (called after the other profiles)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import losses, theory
    from repro_torch.core.minibatch_prox import run_minibatch_prox
    from repro_torch.core.mp_dane import run_mp_dane
    from repro_torch.core.mp_dsvrg import _dsvrg_inner, run_mp_dsvrg
    from repro_torch.data.synthetic import LeastSquaresStream
    cfg = get_config("paper-lsq")
    m, b, T = 8, 128, 8
    stream = LeastSquaresStream(dim=cfg.dim, noise=cfg.noise,
                                decay=cfg.decay, seed=0)
    X, y = stream.sample(torch.Generator(device=dev).manual_seed(1), 8192)
    L, beta = losses.loss_constants(X, y, radius=cfg.radius)
    spec = theory.ProblemSpec(L=L, beta=beta, B=1.0, dim=cfg.dim)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = [stream.sample_distributed(gen, m, b) for _ in range(T)]
    flat = [(Xm.reshape(m * b, -1), ym.reshape(-1)) for Xm, ym in draws]
    print(f"[core] paper-lsq d={cfg.dim}, m={m}, b={b}, T={T}: L {L:.4f}, "
          f"beta {beta:.4f}")
    record = {"paper_lsq": {"dim": cfg.dim, "m": m, "b": b, "T": T,
                            "L": L, "beta": beta}}
    launches = 0
    runs = (
        ("mp_dsvrg", run_mp_dsvrg, (m, b, T), draws, {}, False),
        ("mp_dane", run_mp_dane, (m, b, T), draws,
         {"local_solver": "exact"}, False),
        ("minibatch_prox", run_minibatch_prox, (m * b, T), flat,
         {"solver": "exact"}, True))
    for name, run, shape, data, kw, exact in runs:
        kernels.reset_launch_counts()
        got, secs = _timed(lambda: run(Replay(cfg.dim, data), spec, *shape,
                                       device=dev, **kw))
        counts = kernels.launch_counts()
        want = run(Replay(cfg.dim, [(a.cpu(), c.cpu()) for a, c in data]),
                   spec, *shape, device="cpu", **kw)
        err = (got.iterates.cpu() - want.iterates).abs().max().item()
        sub = stream.population_suboptimality(got.w_avg).item()
        closed = stream.expected_suboptimality(got.w_avg).item()
        bound = theory.rate_bound_weakly_convex(spec, m * b, T, exact=exact)
        plan = (dataclasses.asdict(got.plan) if hasattr(got, "plan")
                else None)
        rec = {"seconds": secs, "launches": counts, "cpu_max_abs_err": err,
               "population_suboptimality": sub,
               "closed_form_suboptimality": closed, "rate_bound": bound,
               "ledger": got.ledger.as_dict(), "plan": plan}
        record[name] = rec
        print(f"[core] {name}: {secs * 1e3:.1f} ms on the card; iterates vs "
              f"CPU max_abs_err {err:.3g} (tolerance {CORE_ATOL}); "
              f"suboptimality {sub:.5f} (closed form {closed:.5f}) <= bound "
              f"{bound:.5f}; ledger {rec['ledger']}; launches {counts}")
        if not err <= CORE_ATOL:
            raise AssertionError(f"{name}: CUDA and CPU iterates differ by "
                                 f"{err}")
        if got.ledger.as_dict() != want.ledger.as_dict() or (
                plan is not None and plan != dataclasses.asdict(want.plan)):
            raise AssertionError(f"{name}: ledger or plan differs from the "
                                 f"CPU run's")
        if not sub <= bound:
            raise AssertionError(f"{name}: suboptimality {sub} above the "
                                 f"rate bound {bound}")
        want_svrg = (T * got.plan.K * got.plan.batch if name == "mp_dsvrg"
                     else 0)
        if counts["svrg_update"] != want_svrg:
            raise AssertionError(f"{name}: svrg_update launched "
                                 f"{counts['svrg_update']} times, expected "
                                 f"T * K * batch = {want_svrg}")
        launches += counts["svrg_update"]

    # -- scale arm: MP-DSVRG at d = 2^20, X (8, 128, 2^20) float32 = 4 GiB
    # a step. The T steps' data is drawn first (32 GiB on the card) and
    # replayed, so the exact minibatch-prox path can be run on the same
    # data beside it.
    d = 1 << 20
    big = LeastSquaresStream(dim=d, noise=cfg.noise, decay=cfg.decay, seed=0)
    g = torch.Generator(device=dev).manual_seed(1)
    consts = [losses.loss_constants(*big.sample(g, 1024), radius=cfg.radius)
              for _ in range(8)]                        # 8192 rows
    spec_big = theory.ProblemSpec(L=max(c[0] for c in consts),
                                  beta=max(c[1] for c in consts), B=1.0,
                                  dim=d)
    g = torch.Generator(device=dev).manual_seed(0)
    draws, draw_secs = _timed(lambda: [big.sample_distributed(g, m, b)
                                       for _ in range(T)])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res, secs = _timed(lambda: run_mp_dsvrg(Replay(d, draws), spec_big, m,
                                            b, T, device=dev))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    plan = res.plan
    # each outer step's prox subproblem: how much of the gap between the
    # previous iterate and the exact prox point the K inner iterations
    # closed; and the exact minibatch-prox path (Theorem 4's algorithm,
    # the same gamma) on the same data
    ratios, exact = [], []
    w_prev = w_exact = torch.zeros(d, device=dev)
    for t, (Xm, ym) in enumerate(draws):
        star = _prox_point_wide(w_prev, Xm, ym, plan.gamma)
        ratios.append(_prox_gap(res.iterates[t], star, Xm, plan.gamma)
                      / _prox_gap(w_prev, star, Xm, plan.gamma))
        w_prev = res.iterates[t]
        w_exact = _prox_point_wide(w_exact, Xm, ym, plan.gamma)
        exact.append(w_exact)
    last = draws[-1]
    del draws, star
    w_exact_avg = torch.stack(exact).mean(0)
    dist = (torch.linalg.vector_norm(res.w_avg.double() - w_exact_avg)
            / torch.linalg.vector_norm(w_exact_avg)).item()
    sub = big.expected_suboptimality(res.w_avg).item()
    sub_exact = big.expected_suboptimality(w_exact_avg).item()
    sub0 = big.expected_suboptimality(torch.zeros(d, device=dev)).item()
    rec = {"dim": d, "m": m, "b": b, "T": T, "L": spec_big.L,
           "beta": spec_big.beta, "plan": dataclasses.asdict(plan),
           "seconds": secs, "draw_seconds": draw_secs, "launches": counts,
           "peak_memory_gib": peak, "prox_gap_ratios": ratios,
           "distance_to_exact_path": dist,
           "closed_form_suboptimality": sub,
           "closed_form_suboptimality_exact_path": sub_exact,
           "closed_form_suboptimality_at_0": sub0}
    record["scale"] = rec
    print(f"[core] MP-DSVRG d=2^20, m={m}, b={b}, T={T} (plan K={plan.K}, "
          f"p={plan.p}, batch={plan.batch}, gamma={plan.gamma:.4f}): "
          f"{secs:.3f} s wall (data drawn before, in {draw_secs:.3f} s), "
          f"launches {counts}, peak {peak:.2f} GiB; prox gap closed to "
          f"<= {max(ratios):.3e} of its start in every step (tolerance "
          f"{PROX_GAP_RATIO}); w_avg within {dist:.3e} of the exact "
          f"minibatch-prox path's (tolerance {EXACT_PATH_DIST}); "
          f"closed-form suboptimality {sub:.6e} (exact path {sub_exact:.6e}, "
          f"w = 0 {sub0:.6e})")
    if counts["svrg_update"] != T * plan.K * plan.batch:
        raise AssertionError(f"scale arm: svrg_update launched "
                             f"{counts['svrg_update']} times, expected "
                             f"{T * plan.K * plan.batch}")
    if not (math.isfinite(sub) and max(ratios) <= PROX_GAP_RATIO
            and dist <= EXACT_PATH_DIST):
        raise AssertionError(f"scale arm: suboptimality {sub}, prox gap "
                             f"ratios {ratios}, distance to the exact path "
                             f"{dist}")
    launches += counts["svrg_update"]
    record["svrg_update_launches"] = launches

    def profile_outer_step():
        """One MP-DSVRG outer step at d = 2^20 (K inner iterations on the
        last step's data) under torch.profiler: wall, device busy, the
        idle share and svrg_update's device time per call."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        Xm, ym = last
        eta = 0.3 / (spec_big.beta + plan.gamma)
        w = res.w_last
        step = lambda: _dsvrg_inner(losses.least_squares(), w, w, Xm, ym,
                                    plan.gamma, eta, plan.p, plan.K, 0.0)
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = _timed(step)
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        svrg = [e for e in kern if "svrg_update" in e.key]
        if busy <= 0 or not svrg:
            raise AssertionError("torch.profiler reported no device time "
                                 "for the outer step")
        out = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
               "idle_share": 1.0 - busy / (wall * 1e3),
               "svrg_update_calls": sum(e.count for e in svrg),
               "svrg_update_device_ms_per_call":
               sum(e.self_device_time_total for e in svrg) / 1e3
               / sum(e.count for e in svrg),
               "top_kernels": [
                   {"name": e.key[:80],
                    "ms": e.self_device_time_total / 1e3, "calls": e.count}
                   for e in sorted(kern,
                                   key=lambda e: -e.self_device_time_total)[
                                       :6]]}
        print(f"[profile] MP-DSVRG outer step d=2^20: wall "
              f"{out['wall_ms']:.2f} ms, device busy "
              f"{out['device_busy_ms']:.3f} ms (idle "
              f"{out['idle_share']:.1%}); svrg_update "
              f"{out['svrg_update_device_ms_per_call'] * 1e3:.2f} us per "
              f"call x {out['svrg_update_calls']}")
        for t in out["top_kernels"]:
            print(f"[profile]   {t['ms']:.4f} ms x {t['calls']}  "
                  f"{t['name']}")
        return out

    return record, profile_outer_step


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
    record["core"], profile_outer_step = phase_core(dev)
    # profiled last: torch.profiler's hooks stay behind in the process
    phase_timings(kern)
    record["decode_profile"] = profile_decode(engine, cfg.vocab_size)
    record["core_profile"] = profile_outer_step()
    launches = {"flash_attention":
                record["forward"]["launches"]["flash_attention"],
                "paged_attention":
                record["engine"]["launches"]["paged_attention"],
                "paged_prefill": record["engine"]["launches"]["paged_prefill"],
                "svrg_update": record["core"]["svrg_update_launches"]}
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
