#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. build   the seven CUDA kernels from src/repro_torch/kernels/csrc/
             (one nvcc per source, all started together); cuobjdump -sass
             must find HGMMA (wgmma) in every bf16 / f16 instantiation of
             the tensor-core flash and paged_prefill kernels (paged_prefill
             over pools of q's dtype and over int8 / fp8 pools);
  2. kernels each kernel against its plain PyTorch twin at the shapes its
             main path gives it (error vs a stated tolerance, the
             bytes-or-flops bound): the attention kernels at smollm-135m
             serving shapes, at recurrentgemma-2b's (10 heads over 1 KV
             head, hd 256: flash at 2304 tokens with window 2048 and
             without, paged decode over one 2048-slot block per row) and at
             the other head dims the configs have (16, 80; paged_prefill
             also 256; flash also 128), at grok-1-314b's (48 heads over 8
             KV heads, hd 128: paged decode over 8 lanes up to 256 tokens,
             paged_prefill's 4 x 128 admission and 8 x 16-token suffixes
             after 64 cached tokens on the tensor cores, flash at 4 x 128
             and 8 x 80 tokens and its backward at 2 x 128, each timed
             beside its twin), paged decode's batch invariance
             (each row alone bit-equal to its batch row), paged_prefill in
             bf16 and f16 (the tensor-core kernel; block sizes 16, 4 and
             2048; NaN / inf in the masked pool slots), bf16 and f16 over
             int8 / fp8 pools (the tensor-core kernel; the admission at
             windows 0 / 64, the 16 bucket, verify 8 x 2 / 4 / 5, block
             sizes 4 and 2048, hd 16 / 80 / 256, NaN codes and scales in
             the masked slots; each arm also bit-equal across two
             launches) and in float32 over float32 and int8 pools (the
             CUDA-core kernel), svrg_update at
             2^20, an odd tail and an unaligned view, rglru_scan through
             both its kernels (the bulk kernel at 2 x 512, 1 x 2304, 4 x
             64 and the chunk edges T = 64 / 65; the direct kernel at
             decode's 4 and 8 x 1, T = 63 and 0, C = 2561 and 13 and an
             unaligned view; C = 2560 unless named; float32, bf16 and f16
             bit-equal to the twin, the kernel and blocks named per arm),
             rwkv6_scan at 4 x 40 x 1 x 64 (a decode step), 2 x 40 x 512 x
             64, 1 x 40 x 2048 x 64 and 2 x 4 x 40 x 16, and padded to a
             multiple of 8 at 2 x 4 x 40 x 12 / 60 and an unaligned 64
             view, with and without a carried state (its state bit-equal
             to the twin, its y to the split emulation of its order),
             float32 and bf16, and with return_states over the engine's
             verify chains (4 x 40 x 2 / 4 / 5 x 64, 2 x 4 x 5 x 16 / 12:
             y and S_T unchanged by the flag, every step's state bit-equal
             to the twin and to the call cut to that step); paged decode
             with window 2048 at hd 256, group 10, over engine pools (ctx
             past, at and inside the window; bf16 and float32; rows
             inside the window bit-equal to the unwindowed call, each row
             alone to its batch row); and flash, paged_prefill and paged
             decode on bf16 views one element off a 16-byte boundary
             (copied before their TMA reads), bit-equal to the aligned
             call; paged decode with window 2048 at hd 256, group 10 over
             int8 and fp8 engine pools (quantized as the engine lands
             K/V; each row alone bit-equal to its batch row), and
             paged_prefill over engine-quantized int8 / fp8 pools at the
             4 x 128 admission and a verify of 8 x 5 (the tensor-core
             kernel), timed against the bytes of 1-byte pools plus their
             f32 scales; the flash
             backward (dq, dk, dv) at smollm's 2 x 9/3 x 512 x 64 in bf16
             and float32, its train micro-batch 8 x 9/3 x 512 in bf16, at
             1 x 10/1 x 2304, hd 256, window 2048 and at hd 16 / 80 / 128
             (causal, not, window 48), bf16 on the forward kernel's o and
             saved log-sum-exps as training runs it, two launches
             bit-equal, timed beside SDPA's forward + backward; the
             flash kernels' bidirectional prefix arm, forward and
             backward, at paligemma-3b's 2 x 8 / 1 heads x 320, hd 256,
             prefix 256 (bf16 on the forward's saved log-sum-exps, and
             float32 on the CUDA cores) and with a prefix of 100
             straddling a 64-row tile (2 x 4 / 2 x 200, hd 64, windows 0
             and 48), each timed beside SDPA with the same boolean mask;
             paged decode at generate()'s dense-cache shapes of
             paligemma-3b (hd 256, group 8) and musicgen-medium (hd 64,
             group 1);
  3. small   the reduced float32 smollm (head_dim 16) on the card against
             the same model on the CPU (forward logits, engine tokens vs
             generate());
     small_hybrid  the same for a reduced float32 recurrentgemma-2b with
             the full model's attention shapes (forward on 2 x 40 tokens
             past its window of 16, generate() token for token), and its
             engine on the card against its engine on the CPU token for
             token: a 30-token prompt admitted in chunks of 8 beside a
             decoding lane (also equal to generate()), and four prompts at
             speculate=4 with partial scripted drafts (equal accepted
             counts);
     small_rwkv  the same for the reduced float32 rwkv6-3b (4 heads of 16);
     small_sampled  sampled decoding on the reduced float32 smollm: the
             engine on the card against the engine on the CPU over the
             mixed greedy / top-k / top-p batch at speculate 0 and 4
             (tokens equal up to a divergence where the CPU's draw margin
             is <= 1e-3; the share of draws under it printed), each
             sampled request alone equal to its batched tokens, the
             tiny-vocab marginal of verify_tokens (total variation < 0.03,
             accept rate within 0.02 of q(d)), position keys and accept
             uniforms on the card bit-equal to the CPU's;
     small_moe  the reduced float32 grok-1-314b (4 experts, top-2) and
             llama4 (16 experts, top-1) through the engine on the card
             against the engine on the CPU (a mixed stream with a shared
             prefix, chunked prompts and capacity drops; grok also at
             speculate=4): tokens equal up to a divergence where the CPU's
             routing margin for that request so far (k-th minus (k+1)-th
             router probability) or its top-1/top-2 logit gap is <= 1e-3;
     small_frontends  the reduced float32 paligemma-3b (a vision prefix of
             8 patches, 4 heads over 1 KV head) and musicgen-medium (4
             codebooks) on the card against the same models on the CPU:
             forward logits (1e-4), train_loss and every gradient (the
             flash backward's prefix arm), greedy generate() under the
             float32 margin rule;
     train_small  the reduced float32 smollm's training: three MBProx and
             three AdamW steps on the card against the same steps on the
             CPU, then tests/test_system.py's loss-drop run (60 MBProx
             steps through the train CLI's train()) on the card;
     serve_cli_default  `python -m repro_torch.launch.serve` with its
             defaults (the engine on the reduced smollm) exits 0 on the card;
  4. forward full-width smollm-135m lm.forward on 2 x 256 tokens: finite
             logits, the flash kernel launched;
  5. engine  full-width smollm-135m (30 layers, d_model 576, seeded random
             weights) through ServingEngine: synthetic (16 prompts, 4
             each of 16, 40, 64 and 96 tokens), shared-prefix (8 of a
             64-token prefix and 20-token suffixes, prefix cache hits) and
             repetitive (speculate=4; 24 and 48 tokens) streams, 16 new
             tokens; every completion checked against generate() (one
             batch a prompt length) under the margin rule; the paged
             kernels launched; then a sampled stream
             (temperature 0.8, top-k 50, top-p 0.95, speculate 4;
             tokens/s, launches per dispatch);
     engine_quant  the same model with float32 weights on activation-dtype,
             int8 and fp8 pools, 4 requests (prompts 64-160, 16 new) on
             the card against the same engine on the CPU (worker
             processes), tokens under the float32 margin rule; then bf16
             on bf16 / int8 / fp8 pools over the synthetic stream:
             tokens/s, TTFT, TPOT, every block returned, cache_bytes ==
             paged_bytes, per-token agreement with the bf16 pools
             (printed); every paged launch of a quantized run on the
             kernels' int8 / fp8 arm;
     engine_tiered  bf16 and int8 pools with the host spill tier on and
             off over 16 rotating tenants' shared-prefix stream (8 slots,
             a slots-only pool): revivals >= 1, every revived block
             bit-equal to its host copy, promotion widths on the bucket
             grid, tokens equal to the device-only run's up to a
             divergence inside the bf16 margin rule;
     engine_cluster  the serving cluster on the same bf16 weights, cast
             once: replicas built one at a time, each adding its pools and
             nothing else to torch.cuda.memory_allocated() (within 16
             MiB); multi_tenant_requests (16 over 4 tenants, 16 new tokens,
             all at t=0) through one engine, a Router of 2 replicas under
             round-robin / least-loaded / prefix-affinity and of 4 under
             prefix-affinity: every arm's tokens under the margin rule
             against generate(), every block back, placements summing to
             16, launches by dispatch; a drain arm (replica 1 disabled
             after its first step: its queue requeues, all 16 complete);
             an autoscaled cluster (1 to 3 replicas) on a burst of 32 at
             t=0: a scale-out, all complete under the rule;
     serve_cli_cluster  the serve CLI at full width, twice: --replicas 2
             --router prefix (multi-tenant; trace and metrics exports) and
             --autoscale --slo-autoscale --slo-shed with a tight objective
             and deadline and the flight recorder (diurnal): exit 0,
             exports and dump valid, metrics at schema v2 with the SLO
             sketches, completions plus shed requests equal the requests;
     train   full-width smollm-135m training: float32 card vs CPU (one
             MBProx and one AdamW step at 2 x 64), the config's bf16
             activations over float32 masters at 16 x 512 (6 MBProx and
             4 AdamW outer steps, 10 and 6 before the MoE slice's cut:
             tokens/s, ms a step, peak memory, one
             profiled outer step; the first 5 losses against a float32
             card run), and the train CLI's checkpoint / resume on the card
             (the resumed losses against an uninterrupted run, the card's
             checkpoint restored on the CPU bit for bit);
  6. core    the paper core on paper-lsq (d = 64, m = 8 machines, b = 128,
             T = 8): MP-DSVRG, MP-DANE (exact) and minibatch-prox (exact)
             on the card against the same runs on the CPU over the same
             replayed data, each within its rate bound; MP-DSVRG launches
             svrg_update T * K * batch times. Then MP-DSVRG at d = 2^20
             (X is 4 GiB a step on the card): wall time, launches, each
             step's prox subproblem solved to a stated share of its gap,
             w_avg near the exact minibatch-prox path's, the closed-form
             suboptimality reported. Between them, the stochastic local
             solvers and the baselines, each on the card and (in worker
             processes) on the CPU over the same data: MP-DANE with SAGA
             and prox-SVRG at the quickstart's widths (the plan's K, R,
             kappa; the first 2 of its 8 outer steps), Figure 3's arm (d = 32, m = 4, b = 64 / 256 / 1024,
             SAGA, K = 1 / 4) and App. E's (logistic, b = 512, prox-SVRG,
             K = 4) beside minibatch SGD, and the five baselines at the
             JAX tests' sizes; iterates within 1e-5, equal ledgers and
             plans, threefry index draws bit-equal on card and CPU, each
             within its test's limit, MP-DANE below minibatch SGD at
             b = 1024 / 512, DSVRG-ERM launching svrg_update K x n / m
             times;
  7. recurrentgemma  full-width recurrentgemma-2b (26 layers, 2.9 B seeded
             random params, bf16): lm.forward on 1 x 2304 tokens (18
             rglru_scan + 8 flash_attention launches), generate() on 4 x
             64-token prompts with 32 new tokens (96 steps x 18 rglru_scan
             and x 8 paged_attention launches), the margin rule in float32
             (prefill + decode from its cache vs generate()); then
     engine_recurrentgemma  the same weights through ServingEngine (4
             slots, block 16, max_seq_len 2560) on six prompts of 32-160
             tokens and one of 2300 (admitted in 2048-token chunks while
             the others decode; decoding past the 2048 window), 16 new
             tokens each: float32 (every completion under the float32
             margin rule against float32 greedy decode from lm.prefill's
             cache, which phase 7 holds to generate()), float32 at
             speculate=4 with partial scripted drafts, and bf16 (tokens/s,
             TTFT, TPOT, finite logprobs, every block returned), launches
             counted per dispatch;
     paligemma  full-width paligemma-3b (18 layers, 8 / 1 heads of 256,
             vocab 257216; 2.51 B seeded params, bf16; the earlier models'
             weights freed first): 2 x (256 seeded patch embeddings + 64
             text tokens) through lm.prefill (the flash prefix arm), 32
             greedy decode_steps from its cache, the tokens held by the
             bf16 margin rule against one lm.forward over the prefix,
             prompt and generated text; prefill ms, ms a decode step, peak
             memory; one bf16 train_loss forward + backward at B = 2 (the
             backward's prefix arm at full width), its ms and peak;
     musicgen  full-width musicgen-medium (48 layers, 24 heads of 64, 4
             codebooks of 2048; 1.38 B seeded params, bf16): generate() on
             2 x 32 x 4 seeded prompts + 32 new, held per codebook by the
             bf16 margin rule against one lm.forward; tokens/s, ms a step;
             the naive serve CLI once at full width;
  8. rwkv6   full-width rwkv6-3b (32 layers, 3.07 B seeded random params,
             bf16; the other models' weights freed first): lm.forward on 1 x
             2048 tokens (32 rwkv6_scan launches), generate() on 4 x 64 + 32
             (96 steps x 32 launches), the margin rule in float32, and a
             record of the bf16 gaps at 32 layers beside JAX's;
     engine_rwkv6  the same weights through the engine as in
             engine_recurrentgemma (verify launches rwkv6_scan with
             return_states, 32 a dispatch);
     rwkv6_4_layers  the bf16 gate at 4 layers on three seeds: bf16 prefill
             vs stepwise decode <= 0.125 and bf16 vs float32 <= 0.86 on the
             first token's logits, as the port runs (the bounds are twice
             the JAX package's own gaps, measured by
             benchmarks/torch_rwkv6_bf16_reference.py) (the naive serve
             CLI at full width runs once, for musicgen-medium; its runs
             for rwkv6-3b and recurrentgemma-2b were cut for the MoE and
             frontends phases' time: both models' generate() runs in
             their phases);
     engine_moe  full-width grok-1-314b (d_model 6144, 48 / 8 heads of
             128, 8 experts of d_ff 32768, top-2, vocab 131072, bf16) with
             its depth cut to 2 layers (11.45 B params; JAX's seed-0
             weights drawn by lm.init_params on the card, timed; beside
             rwkv6-3b's bf16 weights, which its profiles keep) through
             ServingEngine (8 slots,
             block 16, max_seq_len 256): (a) 16 requests, 4 each of 16 /
             32 / 64 / 128 tokens, 16 new, under the bf16 margin rule
             against lm.prefill at each prompt's length + lm.decode_step,
             (b) 8 requests on a 64-token shared prefix with 16-token
             suffixes (prefix hits route only the suffix: tokens exact /
             diverged, not gated); the token-expert assignments each arm
             drops past capacity (moe.tally), tokens/s, TTFT, TPOT, peak
             memory, both paged kernels launched per dispatch, every block
             back;
  9. timings kernel device time (torch.profiler; where no profiler
             window holds every call's kernels, CUDA events around calls
             queued behind a spin kernel), twin and library device time
             (those events first, one profiler window where they cannot
             be taken) and
             wall time on phase 2's inputs, then one profiled window of
             engine decode steps, one profiled MP-DSVRG outer step at
             d = 2^20, one profiled MP-DANE SAGA round at the quickstart's
             widths and profiled rwkv6-3b and recurrentgemma decode steps,
             through generate()'s lm.decode_step and through the engine
             (4 lanes; device busy vs wall, top kernels); the smollm
             engine's decode step is profiled greedy and sampled, and a
             sweep of engine_cluster's 2 replicas (8 lanes each, stepped
             in turn as the router steps them), and engine_moe's decode
             step (8 lanes) beside the bytes of weights it reads.
Launch counters are zeroed just before phases 4, 5 (per stream), 6, 7, 8,
train_small, train, small_frontends, paligemma (prefill, decode, the
train step), musicgen (generate(), its reference forward) and the engine
phases (their forwards, generate() and
engine runs; engine_cluster's per arm) and
read just after, so the launches reported are the main paths' own; the
paged kernels also count their launches over int8 / fp8 pools. The last lines are the card's name and
power limit, the kernels JSON line and {"ok": true, "device": {...}}.
`--record PATH` also writes the full record (per-stream telemetry, every
divergence, the profiles) as JSON. It needs a CUDA device and the repo's
src/.
"""
import argparse
import dataclasses
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# what a run writes besides its checkpoints: the engine_quant workers' weights
BUILD = ROOT / "build" / "chip_smoke"

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
# flash_attention_bwd against its twin: float32 dq / dk / dv within 2e-5
# of the twin's max |grad| (both sum in float32, in other orders); bf16 by
# the TOL_ULPS rule (both accumulate in float32 and round once); two
# launches bit-equal (no atomics)
BWD_TOL_F32 = 2e-5
# the training phases, card against CPU. Reduced and full-width float32:
# losses within TRAIN_LOSS_RTOL (relative) and MBProx params within
# TRAIN_ATOL (its updates are linear in the gradients, whose card / CPU
# difference is float32 summation noise). AdamW's first update is
# g / (|g| + 1e-8), so an element whose gradient is near eps turns that
# noise into a visible share of lr: its params are held to a relative L2
# difference of TRAIN_ADAM_RL2 of the update and to at most 2 lr a step
# (a sign flip), with the max printed. The bf16 run's first 5 MBProx
# losses within TRAIN_BF16_ATOL of a float32 run on the same batches; a
# resumed run's losses within RESUME_ATOL of an uninterrupted one's.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_ATOL = 1e-5
TRAIN_ADAM_RL2 = 1e-3
TRAIN_BF16_ATOL = 0.05
RESUME_ATOL = 1e-6
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
# rwkv6_scan against its twin in float32: within 1e-5 (1 + |twin|), the
# tolerance tests/test_torch_recurrent.py holds the twin to JAX's oracle at
RWKV_TOL_F32 = 1e-5
# The JAX package's own bf16 gaps on rwkv6-3b at full width, first-token
# logits of 2 x 64-token prompts (numpy.random.default_rng(seed)) with
# weights repro.models.lm.init_params(PRNGKey(seed)): the output of
# benchmarks/torch_rwkv6_bf16_reference.py (JAX 0.9.0 on the CPU; PERF.md).
# At 4 layers, per seed:
JAX_BF16_4_LAYERS = {
    0: {"bf16_prefill_vs_stepwise": 0.0,
        "bf16_vs_float32_prefill": 0.293362,
        "bf16_vs_float32_stepwise": 0.293356},
    1: {"bf16_prefill_vs_stepwise": 0.0625,
        "bf16_vs_float32_prefill": 0.351309,
        "bf16_vs_float32_stepwise": 0.335692},
    2: {"bf16_prefill_vs_stepwise": 0.0,
        "bf16_vs_float32_prefill": 0.447123,
        "bf16_vs_float32_stepwise": 0.447128}}
# The port's 4-layer gate, on each of the same seeds. Prefill vs stepwise:
# twice JAX's largest, 2 x 0.0625. bf16 vs float32: 0.86, twice JAX's
# largest (0.428) as first measured; the script's seeds reach 0.447, so
# the bound is a little under twice that.
RWKV_BF16_GAP_BOUND = 0.125
RWKV_BF16_DRIFT_BOUND = 0.86
# At 32 layers, seed 0 (a record beside the port's, no bound):
JAX_BF16_32_LAYERS = {"bf16_prefill_vs_stepwise": 0.783203,
                      "bf16_vs_float32_prefill": 3.26453,
                      "bf16_vs_float32_stepwise": 3.26653,
                      "float32_max_abs_logit": 5.20014}


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


def _device_ms(fn, reps=20, tries=2):
    """Device time per call: the summed duration of every GPU kernel the
    calls ran, from torch.profiler (CUPTI), so host launch overhead is
    excluded. Every call launches the same kernels, so a whole window sees
    each kernel a multiple of `reps` times. The profiler now and then drops
    some or all of a window's kernels on the H100 machine, which would read
    too fast; such a window (no device time, or a kernel seen a number of
    times that is not a multiple of `reps`) is profiled again, up to
    `tries` windows. None when no window was whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in kern)
        if us > 0 and all(e.count % reps == 0 for e in kern):
            return us / reps / 1e3
    return None


def _profiled(window, tries=3):
    """Run `window()`, which returns its wall ms, under torch.profiler until
    a window shows device time, up to `tries` windows (the profiler drops
    kernels now and then; see _device_ms).
    Returns (the profiled CUDA kernels, by name, and the window's wall
    ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = window()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if sum(e.self_device_time_total for e in kern) > 0:
            return kern, wall
    raise AssertionError(f"torch.profiler reported no device time in "
                         f"{tries} windows")


def _spaced_ms(fn, reps, wall_ms):
    """Device time per call from CUDA events around `reps` calls queued
    behind a spin kernel (torch.cuda._sleep) that outlasts their host-side
    launch, so the card runs them back to back and the events time its
    own work only. None where the launches outran the spin (host gaps
    would then count) or would take over 200 ms to queue."""
    if reps * wall_ms > 200:
        return None
    fn()
    torch.cuda.synchronize()
    s0, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s0.record()
    torch.cuda._sleep(int((2 * reps * wall_ms + 1) * 2e6))  # <= 2 GHz
    t0 = time.perf_counter()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    e1.synchronize()
    if s0.elapsed_time(e0) <= queued_ms:
        return None
    return e0.elapsed_time(e1) / reps


def _times(fn, reps=20, tries=2):
    """(device ms per call, wall ms per call, how the device time was
    taken): the kernels' own time from torch.profiler (up to `tries`
    windows), or where no profiler window held every call's kernels from
    CUDA events behind a spin kernel ("spaced"), else None; and the
    host-visible time of back-to-back calls (CUDA events)."""
    dev = _device_ms(fn, reps, tries)
    wall = _time_ms(fn, reps)
    if dev is not None:
        return dev, wall, "profiler"
    dev = _spaced_ms(fn, reps, wall)
    return dev, wall, None if dev is None else "spaced"


# a twin slower than this a call is timed over SLOW_REPS calls: the
# recurrent scans' twins at prompt lengths take 20-260 ms a call
SLOW_MS = 10.0
SLOW_REPS = 3


def _times_spaced_first(fn, reps=20):
    """_times for a twin or a library call: their many small launches
    rarely all land in one profiler window, and each window costs about a
    second of host time, so CUDA events behind a spin kernel come first
    and one profiler window only where those cannot be taken. A call
    slower than SLOW_MS is timed over SLOW_REPS calls."""
    warmup = 5
    if _time_ms(fn, 1, warmup=1) > SLOW_MS:
        reps, warmup = SLOW_REPS, 0
    wall = _time_ms(fn, reps, warmup)
    dev = _spaced_ms(fn, reps, wall)
    if dev is not None:
        return dev, wall, "spaced"
    dev = _device_ms(fn, reps, 1)
    return dev, wall, None if dev is None else "profiler"


def _bound_ms(nbytes, flops, kind="bf16"):
    tb = nbytes / PEAK_BYTES_S * 1e3
    tf = flops / PEAK_FLOPS_S[kind] * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _flash_mask(S, causal=True, window=0, prefix=0, device="cpu"):
    """The flash kernels' (S, S) mask on S tokens (kernels/ref.py:
    flash_visible): what SDPA takes as attn_mask for the same work."""
    from repro_torch.kernels.ref import flash_visible
    pos = torch.arange(S, device=device)
    return flash_visible(pos[:, None], pos[None, :], causal, window, prefix)


def _visible_pairs(S, causal=True, window=0, prefix=0):
    """The (query, key) pairs the flash masks let through on S tokens: the
    work a bound counts."""
    return int(_flash_mask(S, causal, window, prefix).sum())


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(paths)} kernels from "
          f"{build.CSRC.relative_to(ROOT)} in {secs:.1f} s")
    spilled = {}
    for name, path in paths.items():
        lines = path.with_suffix(".log").read_text().splitlines()
        regs = [ln.split("info    :")[1].strip() for ln in lines
                if "Used" in ln]
        # ptxas: "Function properties for <mangled name>", then "N bytes
        # stack frame, S bytes spill stores, L bytes spill loads"; the
        # template's int arguments (the head dim) are mangled as Li<n>E
        fn, spills = "", []
        for ln in lines:
            if "Function properties for" in ln:
                fn = ln.split("for", 1)[1].strip()
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m and int(m.group(1)) > 0:
                spills.append((re.findall(r"Li(\d+)E", fn), ln.strip()))
        spilled[name] = [f"{'/'.join(d)}: {ln}" for d, ln in spills]
        print(f"[build] {name}: {len(regs)} instantiations; "
              f"e.g. {regs[0] if regs else '?'}; {len(spills)} spill"
              + "".join(f"; template ints {'/'.join(d)}: {ln}"
                        for d, ln in spills[:3]))
    return {"seconds": secs, "spills": spilled,
            "flash_hgmma": _hgmma(build, paths["flash_attention"],
                                  "flash_wgmma_kernel"),
            "paged_prefill_hgmma": _hgmma(build, paths["paged_prefill"],
                                          "paged_prefill_wgmma_kernel",
                                          pools=PREFILL_POOLS),
            "flash_bwd_hgmma": _hgmma(build, paths["flash_attention_bwd"],
                                      "bwd_dq_wgmma_kernel",
                                      "bwd_dkdv_wgmma_kernel"),
            "libraries": {n: str(p.relative_to(ROOT))
                          for n, p in paths.items()}}


# paged_prefill_wgmma_kernel's pool template argument (csrc/paged_prefill.cu:
# 0 for a pool of q's dtype, else the int8 / fp8 dtype code) and its name
# in _hgmma's keys
PREFILL_POOLS = {"0": "", "3": "/int8", "4": "/fp8"}


def _hgmma(build, lib, *kernels, pools=None):
    """HGMMA (wgmma) instructions in each bf16 / f16 instantiation of each
    tensor-core kernel of `kernels` in library `lib`, from one cuobjdump
    -sass (beside nvcc); fails if cuobjdump is missing or an instantiation
    at some head dim of build.HEAD_DIMS (and, with `pools`, for each pool
    template argument: {its value: its name}) is missing or has none."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        raise AssertionError(f"cuobjdump not found beside nvcc ({cuobjdump})")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    names = {"13__nv_bfloat16": "bf16", "6__half": "f16"}
    counts = {k: {} for k in kernels}
    key = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            key = None
            kernel = next((k for k in kernels if k in fn), None)
            if kernel is not None:
                dt = next((v for k, v in names.items() if k in fn), "?")
                ints = re.findall(r"Li(\d+)E", fn)
                pool = "" if pools is None else pools.get(ints[1], "?")
                key = (kernel, f"{dt}/hd{ints[0]}{pool}")
                counts[kernel][key[1]] = 0
        elif key is not None and "HGMMA" in ln:
            counts[key[0]][key[1]] += 1
    want = {f"{dt}/hd{hd}{pool}" for dt in names.values()
            for hd in build.HEAD_DIMS
            for pool in (pools or {"": ""}).values()}
    for kernel, c in counts.items():
        print(f"[build] {kernel} SASS, HGMMA per instantiation: "
              + ", ".join(f"{k} {v}" for k, v in sorted(c.items())))
        if set(c) != want or not all(c.values()):
            raise AssertionError(f"{kernel}: a bf16 / f16 instantiation is "
                                 f"missing or has no HGMMA: {c}")
    return counts if len(kernels) > 1 else counts[kernels[0]]


def _check(name, got, want, tol_ulps=TOL_ULPS, f32_tol=None):
    """Kernel output against its twin's; returns (max abs error, max
    error in bf16 ulps of max(|twin|, ULP_FLOOR)). With f32_tol, every
    element must also be within f32_tol * (1 + |twin|)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, twin "
                             f"{tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float().abs().clamp_min(ULP_FLOOR))
    # an empty output (T = 0) has no element to differ
    ulps = (diff / torch.ldexp(torch.ones_like(diff), e - 8)).max().item() \
        if diff.numel() else 0.0
    err = diff.max().item() if diff.numel() else 0.0
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
    from repro_torch.kernels import (build, flash_attention, paged_attention,
                                     paged_prefill_attention, ref,
                                     rglru_scan, rwkv6_scan, svrg_update)
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

    def off16(t):
        """t copied into a view one element into a fresh buffer: contiguous
        and, in bf16, 2 bytes off a 16-byte boundary."""
        v = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:]
        return v.view(t.shape).copy_(t)

    def unaligned_arm(name, fn, twin, args, which, bound):
        """fn with the inputs at positions `which` moved off a 16-byte
        boundary: the wrapper copies them back (build.tma_copies), so the
        result must be the aligned call's bit for bit. Returns the arm for
        the timings phase; its time beside the aligned call's is what the
        copies cost."""
        moved = tuple(off16(a) if i in which else a
                      for i, a in enumerate(args))
        if not all(build.tma_copies(*(moved[i].data_ptr() for i in which))):
            raise AssertionError(f"{name}: the views are 16-byte aligned")
        if not torch.equal(fn(*moved), fn(*args)):
            raise AssertionError(f"{name}: an unaligned view changed the "
                                 f"result")
        print(f"[kernels] {name}: inputs {which} one element off a 16-byte "
              f"boundary give the aligned call's bits ok")
        return dict(label=f"inputs {which} one bf16 element off a 16-byte "
                          f"boundary (copied before the launch)",
                    _fns=(lambda: fn(*moved), lambda: twin(*moved), None),
                    bound_ms=bound[0], bound_by=bound[1])

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
    # recurrentgemma-2b's attn_local decode: 10 query heads over 1 KV head,
    # hd 256, each row's rolling buffer one block of window = 2048 slots
    rg_ctx = i32([2048, 1500, 700, 1])
    rg = (rn(4, 10, 256), rn(4, 2048, 1, 256), rn(4, 2048, 1, 256),
          i32([[0], [1], [2], [3]]), rg_ctx)
    arm(arms, "paged_attention hd256 group10 4x2048 bf16",
        paged_attention(*rg), ref.paged_attention_ref(*rg))
    rg_tok = int(rg_ctx.sum())
    rg_bound = _bound_ms(2 * _nbytes(rg[0]) + _nbytes(rg[3], rg[4])
                         + 2 * rg_tok * 256 * 2, 4 * 10 * 256 * rg_tok)
    rg_arm = dict(label="hd256 group10 B=4, one 2048-slot block, ctx "
                        "2048/1500/700/1, bf16",
                  _fns=(lambda a=rg: paged_attention(*a),
                        lambda a=rg: ref.paged_attention_ref(*a), None),
                  bound_ms=rg_bound[0], bound_by=rg_bound[1])
    n_tok = int(ctx.sum())
    # q in, out back, the tables, and each context token's K and V once
    nbytes = (2 * _nbytes(q) + _nbytes(tables, ctx)
              + 2 * n_tok * KV * hd * kp.element_size())
    bound, by = _bound_ms(nbytes, 4 * H * hd * n_tok)
    # batch invariance, which the engine's greedy identity with generate()
    # rests on: every row alone equals its row of the batch bit for bit
    # grok-1-314b's decode (engine_moe): 48 query heads over 8 KV heads
    # (group 6), hd 128, bf16 pools in 16-token blocks, 8 lanes up to the
    # engine's max_seq_len of 256
    gm = 256 // bs
    gctx = i32([0, 1, 17, 64, 100, 144, 200, 255])
    gk = (rn(8, 48, 128), rn(8 * gm + 1, bs, 8, 128),
          rn(8 * gm + 1, bs, 8, 128), tables_for(8, gm), gctx)
    arm(arms, "paged_attention grok-1 hd128 group6 B=8 bf16",
        paged_attention(*gk), ref.paged_attention_ref(*gk))
    g_tok = int(gctx.sum())
    gb = _bound_ms(2 * _nbytes(gk[0]) + _nbytes(gk[3], gk[4])
                   + 2 * g_tok * 8 * 128 * 2, 4 * 48 * 128 * g_tok)
    grok_pa_arm = dict(label="grok-1-314b's decode: 48 / 8 heads, hd 128, "
                             "B=8, ctx 0..255, bf16 pools",
                       _fns=(lambda a=gk: paged_attention(*a),
                             lambda a=gk: ref.paged_attention_ref(*a), None),
                       bound_ms=gb[0], bound_by=gb[1])
    # generate()'s dense-cache decode of the frontends' archs (identity
    # tables, one block of S_max a row): paligemma-3b's 8 query heads over
    # 1 KV head at hd 256 (the phase's 256 patches + 64 text tokens + 32
    # new), musicgen-medium's 24 heads of hd 64 over 24 KV heads (32 + 32)
    fe_arms = []
    for fname, fh, fkv, fhd, s_max, fctx in (
            ("paligemma hd256 group8", 8, 1, 256, 353, [352, 321]),
            ("musicgen hd64 group1", 24, 24, 64, 65, [64, 33])):
        fa_ = (rn(2, fh, fhd), rn(2, s_max, fkv, fhd), rn(2, s_max, fkv, fhd),
               i32([[0], [1]]), i32(fctx))
        arm(arms, f"paged_attention {fname} generate() dense B=2 bf16",
            paged_attention(*fa_), ref.paged_attention_ref(*fa_))
        f_tok = sum(fctx)
        fb_ = _bound_ms(2 * _nbytes(fa_[0]) + _nbytes(fa_[3], fa_[4])
                        + 2 * f_tok * fkv * fhd * 2, 4 * fh * fhd * f_tok)
        fe_arms.append(dict(
            label=f"{fname}'s generate() decode: {fh} / {fkv} heads, hd "
                  f"{fhd}, B=2, ctx {fctx[0]}/{fctx[1]}, bf16 (PR 30)",
            _fns=(lambda a=fa_: paged_attention(*a),
                  lambda a=fa_: ref.paged_attention_ref(*a), None),
            bound_ms=fb_[0], bound_by=fb_[1]))
    for name, a in (("engine B=8", args), ("hd256 group10 B=4", rg),
                    ("grok-1 hd128 group6 B=8", gk)):
        full = paged_attention(*a)
        for b_ in range(a[0].shape[0]):
            alone = paged_attention(a[0][b_:b_ + 1], a[1], a[2],
                                    a[3][b_:b_ + 1], a[4][b_:b_ + 1])
            if not torch.equal(alone[0], full[b_]):
                raise AssertionError(f"paged_attention {name}: row {b_} "
                                     f"alone differs from its batch row")
        print(f"[kernels] paged_attention {name}: each row alone equals its "
              f"batch row bit for bit ok")
    # the engine's decode of recurrentgemma-2b's attn_local layers: hd 256,
    # 10 query heads over 1 KV head, the whole history in 16-token blocks,
    # window 2048; contexts past the window (the chunked 2300-token prompt
    # of the engine phase decodes at 2300..2316), at it and inside it; bf16
    # and float32 (the engine phase's float32 run). Rows inside the window
    # give the unwindowed call's bits, and every row its bits alone
    win, wctx = 2048, [2316, 2049, 2048, 900, 1, 0]
    wm = -(-max(wctx) // bs)
    for dt_name, dt in (("bf16", bf), ("float32", torch.float32)):
        wa = (rn(len(wctx), 10, 256, dt=dt),
              rn(len(wctx) * wm + 1, bs, 1, 256, dt=dt),
              rn(len(wctx) * wm + 1, bs, 1, 256, dt=dt),
              tables_for(len(wctx), wm), i32(wctx))
        got = paged_attention(*wa, window=win)
        arm(arms, f"paged_attention window={win} hd256 group10 engine "
                  f"pools {dt_name}", got,
            ref.paged_attention_ref(*wa, window=win),
            **({} if dt is bf else dict(f32_tol=2e-5)))
        inside = wa[4] <= win
        if not torch.equal(got[inside], paged_attention(*wa)[inside]):
            raise AssertionError(f"paged_attention window={win}: rows "
                                 f"inside the window differ from the call "
                                 f"without one")
        for b_ in range(len(wctx)):
            alone = paged_attention(wa[0][b_:b_ + 1], wa[1], wa[2],
                                    wa[3][b_:b_ + 1], wa[4][b_:b_ + 1],
                                    window=win)
            if not torch.equal(alone[0], got[b_]):
                raise AssertionError(f"paged_attention window={win} "
                                     f"{dt_name}: row {b_} alone differs "
                                     f"from its batch row")
        if dt is bf:
            w_args = wa
    print(f"[kernels] paged_attention window={win} (ctx {wctx}): rows "
          f"inside the window equal the unwindowed call, each row alone "
          f"its batch row, bit for bit ok")
    w_tok = sum(min(c, win) for c in wctx)
    w_bound = _bound_ms(2 * _nbytes(w_args[0]) + _nbytes(w_args[3], w_args[4])
                        + 2 * w_tok * 256 * 2, 4 * 10 * 256 * w_tok)
    w_arm = dict(label=f"hd256 group10 B=6, window {win}, engine pools "
                       f"(block {bs}), ctx {'/'.join(map(str, wctx))}, bf16",
                 _fns=(lambda a=w_args: paged_attention(*a, window=win),
                       lambda a=w_args: ref.paged_attention_ref(
                           *a, window=win), None),
                 bound_ms=w_bound[0], bound_by=w_bound[1])
    # the same windowed decode over int8 / fp8 engine pools, quantized as
    # the engine lands K/V (attention.quantize_kv): window and scales
    # together, as the quantized recurrentgemma-2b engine runs them; the
    # bound reads each window token's 1-byte K and V and their f32 scales
    from repro_torch.models.attention import quantize_kv
    wq_arms = []
    for name, qdt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        (kq, ksc), (vq, vsc) = (quantize_kv(p_, qdt) for p_ in w_args[1:3])
        wqa = (w_args[0], kq, vq, w_args[3], w_args[4])
        qkw = dict(k_scale=ksc, v_scale=vsc, window=win)
        got = paged_attention(*wqa, **qkw)
        arm(arms, f"paged_attention window={win} hd256 group10 engine "
                  f"pools {name} bf16", got,
            ref.paged_attention_ref(*wqa, ksc, vsc, window=win))
        for b_ in range(len(wctx)):
            alone = paged_attention(wqa[0][b_:b_ + 1], kq, vq,
                                    wqa[3][b_:b_ + 1], wqa[4][b_:b_ + 1],
                                    **qkw)
            if not torch.equal(alone[0], got[b_]):
                raise AssertionError(f"paged_attention window={win} {name}: "
                                     f"row {b_} alone differs from its batch "
                                     f"row")
        qb = _bound_ms(2 * _nbytes(wqa[0]) + _nbytes(wqa[3], wqa[4])
                       + 2 * w_tok * (256 + 4), 4 * 10 * 256 * w_tok)
        wq_arms.append(dict(
            label=f"hd256 group10 B=6, window {win}, engine pools {name} "
                  f"with f32 scales, ctx {'/'.join(map(str, wctx))}",
            _fns=(lambda a=wqa, k=qkw: paged_attention(*a, **k),
                  lambda a=wqa, k=qkw: ref.paged_attention_ref(
                      *a, k["k_scale"], k["v_scale"], window=win), None),
            bound_ms=qb[0], bound_by=qb[1]))
    print(f"[kernels] paged_attention window={win} over int8 / fp8 engine "
          f"pools: each row alone equals its batch row bit for bit ok")
    # q and both pools as views off a 16-byte boundary (the pools are
    # copied whole before the TMA row gathers)
    pa_unaligned = unaligned_arm("paged_attention B=8 bf16", paged_attention,
                                 ref.paged_attention_ref, args, (0, 1, 2),
                                 (bound, by))
    out.append(dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:84",
        _fns=(lambda a=args: paged_attention(*a),
              lambda a=args: ref.paged_attention_ref(*a), None),
        bound_ms=bound, bound_by=by,
        shape=dict(B=B, H=H, KV=KV, hd=hd, bs=bs, M=M, ctx=ctx.tolist()),
        _extra=[rg_arm, w_arm, *wq_arms, pa_unaligned, grok_pa_arm,
                *fe_arms],
        **worst(arms)))

    # -- paged_prefill, at each shape the engine gives it: an admission of
    # 4 x 128 (a fresh prompt, a cached prefix, a long cached prefix and a
    # batch-padding row; window 0 and 64), the smallest suffix bucket
    # (Ls = 16, a partial query tile), and speculate=4's verify chains
    # (N = 8 slots, Ls = chain buckets 2, 4, 5; starts = positions up to
    # 500, lengths = starts + counts, counts 0 for idle and sitting-out
    # lanes); bf16 and f16 (the tensor-core kernel), at the engine's block
    # size 16 and at 4 and 2048 (one block a row), and with NaN / inf in
    # every pool slot a row may not see; the same shapes over int8 / fp8
    # pools quantized as the engine lands them (the tensor-core kernel, the
    # codes converted exactly to q's dtype); float32 over float32 and int8
    # pools (the CUDA-core kernel) at the admission
    def prefill_case(starts, counts, Ls, dt=bf, bs_=bs, m=M):
        n = len(starts)
        st = i32(starts)
        return (rn(n, Ls, H, hd, dt=dt), rn(n, Ls, KV, hd, dt=dt),
                rn(n, Ls, KV, hd, dt=dt), rn(n * m + 1, bs_, KV, hd, dt=dt),
                rn(n * m + 1, bs_, KV, hd, dt=dt), tables_for(n, m), st,
                st + i32(counts))

    def prefill_bound(c, scales=False):
        """Bytes: q in and out, the suffix K/V, the index tensors and each
        cached token's K and V once (with its two f32 scales per KV head
        for an int8 / fp8 pool); pairs: each real query sees starts pool
        keys plus i + 1 suffix keys (window 0)."""
        q_, ks_, vs_, kp_, _, tb_, st_, ln_ = c
        h_, hd_ = q_.shape[2:]
        suf = (ln_ - st_).clamp_min(0).tolist()
        pairs = sum(s_ * t_ + s_ * (s_ + 1) // 2
                    for s_, t_ in zip(suf, st_.tolist()))
        nbytes = (2 * _nbytes(q_) + _nbytes(ks_, vs_, tb_, st_, ln_)
                  + 2 * int(st_.sum()) * ks_.shape[2]
                  * (hd_ * kp_.element_size() + 4 * scales))
        return _bound_ms(nbytes, 4 * h_ * hd_ * pairs)

    def prefill_blocks(c):
        """Blocks the launch takes: the tensor-core kernel's (N, KV, Ls /
        (64 // group)) or the CUDA-core kernel's (N, KV, Ls / 32)."""
        q_, ks_ = c[0], c[1]
        n_, ls_, h_, hd_ = q_.shape
        kv_ = ks_.shape[2]
        rows = (64 // (h_ // kv_) if prefill_route(q_.dtype) == "wgmma"
                else 16 if hd_ >= 256 else 32)
        return n_ * kv_ * -(-ls_ // rows)

    def quantized(c, qdt):
        """c's pools quantized as the engine lands K/V
        (attention.quantize_kv): (args, dict(k_scale=, v_scale=))."""
        (kq, ksc), (vq, vsc) = (quantize_kv(p_, qdt) for p_ in c[3:5])
        return (*c[:3], kq, vq, *c[5:]), dict(k_scale=ksc, v_scale=vsc)

    def qarm(arms_, name, c, **kw):
        """An arm over an int8 / fp8 pool: within TOL_ULPS of the twin and
        bit-equal across two launches."""
        got = paged_prefill_attention(*c, **kw)
        if not torch.equal(got, paged_prefill_attention(*c, **kw)):
            raise AssertionError(f"paged_prefill {name}: two launches "
                                 f"differ")
        arm(arms_, f"paged_prefill {name}", got,
            ref.paged_prefill_ref(*c, kw["k_scale"], kw["v_scale"],
                                  window=kw.get("window", 0)))

    def prefill_timed(label, c, **kw):
        b_ = prefill_bound(c, scales="k_scale" in kw)
        return dict(label=label, blocks=prefill_blocks(c),
                    _fns=(lambda a=c: paged_prefill_attention(*a, **kw),
                          lambda a=c: ref.paged_prefill_ref(*a, **kw), None),
                    bound_ms=b_[0], bound_by=b_[1])

    from repro_torch.kernels.paged_prefill import route as prefill_route
    QPOOLS = (("int8", torch.int8), ("fp8", torch.float8_e4m3fn))
    arms, pp_extra, q_timed = [], [], {}
    adm = ([0, 48, 200, 0], [128, 128, 100, 0], 128)
    verify = [0, 3, 17, 100, 250, 400, 500, 311]
    args = prefill_case(*adm)
    for dt_name, dt in (("bf16", bf), ("f16", torch.float16)):
        cases = [("4x128", args if dt is bf else prefill_case(*adm, dt=dt)),
                 ("4x16 bucket", prefill_case([160, 0, 33, 0],
                                              [10, 16, 12, 0], 16, dt=dt))]
        for T in (2, 4, 5):
            cases.append((f"verify 8x{T}", prefill_case(
                verify, [0, 1, 2, T, T, min(3, T), T, 0], T, dt=dt)))
        for name, c in cases:
            for w in ((0, 64) if name == "4x128" else (0,)):
                arm(arms, f"paged_prefill {name} window={w} {dt_name}",
                    paged_prefill_attention(*c, window=w),
                    ref.paged_prefill_ref(*c, window=w))
                for qname, qdt in QPOOLS:
                    cq, qkw = quantized(c, qdt)
                    qarm(arms, f"{name} window={w} engine-quantized {qname} "
                               f"pool {dt_name}", cq, window=w, **qkw)
                    if dt is bf and w == 0:
                        q_timed[name, qname] = cq, qkw
        if dt is not bf:
            pp_extra.append(prefill_timed(
                "4 x 128, cached 0/48/200, f16", cases[0][1]))
        else:
            pp_extra.append(prefill_timed(
                "verify 8 x 5 over contexts <= 500, bf16", cases[-1][1]))
    for bs_, m in ((4, 128), (2048, 1)):
        c = prefill_case(*adm, bs_=bs_, m=m)
        arm(arms, f"paged_prefill 4x128 block_size={bs_} bf16",
            paged_prefill_attention(*c), ref.paged_prefill_ref(*c))
        for qname, qdt in QPOOLS:
            cq, qkw = quantized(c, qdt)
            qarm(arms, f"4x128 block_size={bs_} engine-quantized {qname} "
                       f"pool bf16", cq, **qkw)
        pp_extra.append(prefill_timed(
            f"4 x 128, cached 0/48/200, block size {bs_}, bf16", c))
    q, ksuf, vsuf, kp, vp, tables, starts, lengths = args
    used = torch.zeros(kp.shape[:2], dtype=torch.bool, device=dev)
    for n_, s_ in enumerate(starts.tolist()):
        t_ = torch.arange(s_, device=dev)
        used[tables[n_, t_ // bs].long(), t_ % bs] = True
    kd, vd = kp.clone(), vp.clone()
    kd[~used] = float("nan")
    vd[~used] = float("inf")
    dirty = (q, ksuf, vsuf, kd, vd, tables, starts, lengths)
    got = paged_prefill_attention(*dirty)
    arm(arms, "paged_prefill 4x128 NaN / inf in the masked pool slots bf16",
        got, ref.paged_prefill_ref(*dirty))
    if not torch.equal(got, paged_prefill_attention(*args)):
        raise AssertionError("paged_prefill: NaN / inf in masked pool slots "
                             "moved the result")
    print("[kernels] paged_prefill: NaN / inf in the masked pool slots leave "
          "the result bit for bit the same ok")
    # fp8 NaN codes (0x7F / 0xFF) and NaN scales, int8 NaN scales, in every
    # pool slot a row may not see: the kernel stages code 0 and scale 0
    # there (0 times NaN is NaN on the tensor cores), so the result is the
    # clean call's bit for bit
    for qname, qdt in QPOOLS:
        cq, qkw = quantized(args, qdt)
        kd, vd = cq[3].clone(), cq[4].clone()
        dkw = {k_: t_.clone() for k_, t_ in qkw.items()}
        for t_ in dkw.values():
            t_[~used] = float("nan")
        if qname == "fp8":
            kd.view(torch.uint8)[~used] = 0x7F
            vd.view(torch.uint8)[~used] = 0xFF
        dq = (*cq[:3], kd, vd, *cq[5:])
        what = "codes and scales" if qname == "fp8" else "scales"
        qarm(arms, f"4x128 NaN {what} in the masked {qname} pool slots bf16",
             dq, **dkw)
        if not torch.equal(paged_prefill_attention(*dq, **dkw),
                           paged_prefill_attention(*cq, **qkw)):
            raise AssertionError(f"paged_prefill: NaN {what} in the masked "
                                 f"{qname} pool slots moved the result")
        print(f"[kernels] paged_prefill: NaN {what} in the masked {qname} "
              f"pool slots leave the result bit for bit the same ok")
    c32 = prefill_case(*adm, dt=torch.float32)
    arm(arms, "paged_prefill 4x128 float32 (CUDA cores)",
        paged_prefill_attention(*c32), ref.paged_prefill_ref(*c32),
        f32_tol=2e-5)
    pp_extra.append(prefill_timed(
        "4 x 128, cached 0/48/200, float32 (the CUDA-core kernel)", c32))
    sc = [torch.rand(kp.shape[:3], generator=g, device=dev) / 64
          for _ in range(2)]
    for name, pools in (
            ("int8", [torch.randint(-127, 128, kp.shape, generator=g,
                                    device=dev, dtype=torch.int8)
                      for _ in range(2)]),
            ("fp8", [rn(*kp.shape, dt=torch.float32).mul(64)
                     .to(torch.float8_e4m3fn) for _ in range(2)])):
        c = (q, ksuf, vsuf, *pools, tables, starts, lengths)
        qarm(arms, f"4x128 random {name} codes, scales in [0, 1/64) bf16", c,
             k_scale=sc[0], v_scale=sc[1])
        if name == "int8":
            # float32 q over an int8 pool keeps the CUDA-core kernel
            c = (*c32[:3], *pools, *c32[5:])
            arm(arms, "paged_prefill 4x128 int8 pool float32 (CUDA cores)",
                paged_prefill_attention(*c, k_scale=sc[0], v_scale=sc[1]),
                ref.paged_prefill_ref(*c, *sc), f32_tol=2e-5)
    # the engine's int8 / fp8 admission and verify on pools quantized as
    # the engine lands them (bf16 q and suffix, the tensor-core kernel),
    # timed against the bytes of 1-byte pools plus their f32 scales
    for qname, _ in QPOOLS:
        for what, where in (("4x128", "4 x 128, cached 0/48/200"),
                            ("verify 8x5", "verify 8 x 5 over contexts <= "
                                           "500")):
            cq, qkw = q_timed[what, qname]
            pp_extra.append(prefill_timed(
                f"{where}, engine-quantized {qname} pool with f32 scales, "
                f"bf16 (the tensor-core kernel)", cq, **qkw))
    # grok-1-314b's admissions (engine_moe): 48 query heads over 8 KV
    # heads (group 6), hd 128, bf16, the tensor-core kernel; 4 x 128 (three
    # fresh prompts and a batch-padding row) and arm (b)'s prefix hits, 8
    # x 16-token suffixes after 64 cached tokens
    def grok_case(starts, counts, Ls, m=256 // bs):
        n = len(starts)
        st = i32(starts)
        return (rn(n, Ls, 48, 128), rn(n, Ls, 8, 128), rn(n, Ls, 8, 128),
                rn(n * m + 1, bs, 8, 128), rn(n * m + 1, bs, 8, 128),
                tables_for(n, m), st, st + i32(counts))

    for gname, gc in (("4x128", grok_case([0, 0, 0, 0], [128, 128, 100, 0],
                                          128)),
                      ("8x16 after 64 cached", grok_case([64] * 8, [16] * 8,
                                                         16))):
        arm(arms, f"paged_prefill grok-1 hd128 group6 {gname} bf16",
            paged_prefill_attention(*gc), ref.paged_prefill_ref(*gc))
        pp_extra.append(prefill_timed(
            f"grok-1-314b's {gname}: 48 / 8 heads, hd 128, bf16 (the "
            f"tensor-core kernel)", gc))
    bound, by = prefill_bound(args)
    # the admission with q, the suffix and both pools off a 16-byte
    # boundary: the wrapper copies all five before the TMA reads
    pp_extra.append(unaligned_arm(
        "paged_prefill 4x128 bf16", paged_prefill_attention,
        ref.paged_prefill_ref, args, (0, 1, 2, 3, 4), (bound, by)))
    out.append(dict(
        name="paged_prefill", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_prefill.cu",
        replaces="src/repro/kernels/paged_prefill.py:99",
        _fns=(lambda a=args: paged_prefill_attention(*a),
              lambda a=args: ref.paged_prefill_ref(*a), None),
        bound_ms=bound, bound_by=by, blocks=prefill_blocks(args),
        shape=dict(N=4, Ls=128, H=H, KV=KV, hd=hd, bs=bs, M=M,
                   starts=starts.tolist(), lengths=lengths.tolist()),
        _extra=pp_extra, **worst(arms)))

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
    # recurrentgemma-2b's lm.forward at 2304 tokens: 10 heads over 1 KV
    # head, hd 256, the attn_local window 2048 (and plain causal)
    Sr, Wr = 2304, 2048
    qr, kr, vr = rn(1, 10, Sr, 256), rn(1, 1, Sr, 256), rn(1, 1, Sr, 256)
    for w in (Wr, 0):
        arm(arms, f"flash_attention 1x10x{Sr} hd256 window={w}",
            flash_attention(qr, kr, vr, window=w),
            ref.flash_attention_ref(qr, kr, vr, window=w))
    pairs = sum(min(i + 1, Wr) for i in range(Sr))
    fb = _bound_ms(2 * _nbytes(qr) + _nbytes(kr, vr), 4 * 10 * 256 * pairs)
    kpos = torch.arange(Sr, device=dev)
    mask = ((kpos[None, :] <= kpos[:, None])
            & (kpos[None, :] > kpos[:, None] - Wr))
    fl_arm = dict(label=f"1 x 10 x {Sr}, hd 256, window {Wr}, bf16",
                  _fns=(lambda: flash_attention(qr, kr, vr, window=Wr),
                        lambda: ref.flash_attention_ref(qr, kr, vr,
                                                        window=Wr),
                        lambda: F.scaled_dot_product_attention(
                            qr, kr, vr, attn_mask=mask, enable_gqa=True)),
                  bound_ms=fb[0], bound_by=fb[1])
    # hd 128 (no config of the main path has it; timed beside SDPA)
    f128 = (rn(2, 16, 1024, 128), rn(2, 4, 1024, 128), rn(2, 4, 1024, 128))
    arm(arms, "flash_attention 2x16x1024 hd128 causal=True",
        flash_attention(*f128), ref.flash_attention_ref(*f128))
    fb128 = _bound_ms(2 * _nbytes(f128[0]) + _nbytes(*f128[1:]),
                      4 * 2 * 16 * 128 * 1024 * 1025 // 2)
    f128_arm = dict(label="hd128 16/4 heads 2 x 1024, causal, bf16",
                    _fns=(lambda: flash_attention(*f128),
                          lambda: ref.flash_attention_ref(*f128),
                          lambda: F.scaled_dot_product_attention(
                              *f128, is_causal=True, enable_gqa=True)),
                    bound_ms=fb128[0], bound_by=fb128[1])
    # grok-1-314b's lm.prefill (engine_moe's reference route): 48 query
    # heads over 8 KV heads, hd 128, 4 x 128 and 8 x 80 tokens
    g128 = (rn(4, 48, 128, 128), rn(4, 8, 128, 128), rn(4, 8, 128, 128))
    g80 = (rn(8, 48, 80, 128), rn(8, 8, 80, 128), rn(8, 8, 80, 128))
    for gname, ga in (("4x48/8x128", g128), ("8x48/8x80", g80)):
        arm(arms, f"flash_attention grok-1 {gname} hd128 causal=True",
            flash_attention(*ga), ref.flash_attention_ref(*ga))
    gfb = _bound_ms(2 * _nbytes(g128[0]) + _nbytes(*g128[1:]),
                    4 * 4 * 48 * 128 * 128 * 129 // 2)
    grok_fl_arm = dict(label="grok-1-314b's prefill: 4 x 48 / 8 heads x 128, "
                             "hd 128, causal, bf16",
                       _fns=(lambda: flash_attention(*g128),
                             lambda: ref.flash_attention_ref(*g128),
                             lambda: F.scaled_dot_product_attention(
                                 *g128, is_causal=True, enable_gqa=True)),
                       bound_ms=gfb[0], bound_by=gfb[1])
    # paligemma-3b's prefix-LM attention (lm.prefill / forward /
    # train_loss): 2 x 8 query heads over 1 KV head x 320 tokens, hd 256,
    # its 256 vision patches a bidirectional prefix; bf16 on the tensor
    # cores writing the lse (as under autograd) and float32 on the CUDA
    # cores; then a prefix straddling a 64-row tile (4 / 2 heads, hd 64,
    # 200 tokens, prefix 100), without and with window 48. Each timed
    # beside SDPA with the same boolean mask, k / v expanded to every head
    from repro_torch.kernels.flash_attention import _forward as flash_fwd

    def prefix_timed(label, qkv, prefix, window=0):
        q_, k_, v_ = qkv
        B_, H_, S_, hd_ = q_.shape
        ke, ve = (t.repeat_interleave(H_ // k_.shape[1], dim=1)
                  for t in (k_, v_))
        mask = _flash_mask(S_, True, window, prefix, dev)
        b_ = _bound_ms(2 * _nbytes(q_) + _nbytes(k_, v_),
                       4 * B_ * H_ * hd_ * _visible_pairs(S_, True, window,
                                                          prefix),
                       "f32" if q_.dtype == torch.float32 else "bf16")
        return dict(label=label + " (PR 30)",
                    _fns=(lambda: flash_attention(q_, k_, v_, window=window,
                                                  prefix_len=prefix),
                          lambda: ref.flash_attention_ref(
                              q_, k_, v_, window=window, prefix_len=prefix),
                          lambda: F.scaled_dot_product_attention(
                              q_, ke, ve, attn_mask=mask)),
                    bound_ms=b_[0], bound_by=b_[1])

    pg = (rn(2, 8, 320, 256), rn(2, 1, 320, 256), rn(2, 1, 320, 256))
    pg_lse = torch.empty(2, 8, 320, dtype=torch.float32, device=dev)
    arm(arms, "flash_attention paligemma 2x8/1x320 hd256 prefix=256 bf16 "
        "(lse written)", flash_fwd(*pg, True, 0, pg_lse, 256),
        ref.flash_attention_ref(*pg, prefix_len=256))
    pg32 = tuple(t.float() for t in pg)
    arm(arms, "flash_attention paligemma 2x8/1x320 hd256 prefix=256 float32 "
        "(CUDA cores)", flash_attention(*pg32, prefix_len=256),
        ref.flash_attention_ref(*pg32, prefix_len=256), f32_tol=2e-5)
    st = (rn(2, 4, 200, 64), rn(2, 2, 200, 64), rn(2, 2, 200, 64))
    for w in (0, 48):
        arm(arms, f"flash_attention 2x4/2x200 hd64 prefix=100 window={w} "
            f"bf16", flash_attention(*st, window=w, prefix_len=100),
            ref.flash_attention_ref(*st, window=w, prefix_len=100))
    prefix_arms = [
        prefix_timed("paligemma-3b's prefix-LM: 2 x 8 / 1 heads x 320, hd "
                     "256, prefix 256, bf16", pg, 256),
        prefix_timed("paligemma-3b's prefix-LM in float32 (CUDA cores)",
                     pg32, 256),
        *(prefix_timed(f"a prefix of 100 straddling a 64-row tile: 2 x 4 / "
                       f"2 heads x 200, hd 64, window {w}, bf16", st, 100,
                       w) for w in (0, 48))]
    fl_unaligned = unaligned_arm(
        f"flash_attention 2x{S} causal bf16", flash_attention,
        ref.flash_attention_ref, (q, k, v), (0, 1, 2), (bound, by))
    out.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:71",
        _fns=(lambda: flash_attention(q, k, v, causal=True),
              lambda: ref.flash_attention_ref(q, k, v, causal=True),
              lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=True, enable_gqa=True)),
        bound_ms=bound, bound_by=by,
        shape=dict(B=2, H=H, KV=KV, S=S, hd=hd),
        _extra=[fl_arm, f128_arm, fl_unaligned, grok_fl_arm, *prefix_arms],
        **worst(arms)))

    # -- flash_attention_bwd: the gradient of every attention layer of
    # lm.train_loss. smollm-135m's 2 x 9/3 x 512 x 64 in bf16 (the train
    # phase's dtype) and float32, its train-phase micro-batch 8 x 9/3 x 512
    # in bf16, recurrentgemma-2b's hd 256, 10 over 1 KV head, window 2048
    # at 1 x 2304, and hd 16 / 80 / 128. bf16 / f16 run as training calls
    # them: o and each row's lse from the forward kernel, the lse passed
    # on (what autograd saves). SDPA's forward + backward under autograd
    # is the library yardstick (k / v expanded to every query head first,
    # so it takes its fastest backend; it then does a little less work
    # than the kernel's per-group dK / dV sums)
    from repro_torch.kernels import flash_attention_bwd
    arms = []

    def bwd_inputs(B, H_, KV_, S_, hd_, dt):
        return (rn(B, H_, S_, hd_, dt=dt), rn(B, KV_, S_, hd_, dt=dt),
                rn(B, KV_, S_, hd_, dt=dt), rn(B, H_, S_, hd_, dt=dt))

    def bwd_arm(name, qkvd, causal=True, window=0, prefix=0):
        """(q, k, v, o, do) and the saved lse (None for float32)."""
        q_, k_, v_, do_ = qkvd
        lse = (None if q_.dtype == torch.float32 else
               torch.empty(q_.shape[:3], dtype=torch.float32, device=dev))
        o_ = flash_fwd(q_, k_, v_, causal, window, lse, prefix)
        a_ = (q_, k_, v_, o_, do_)
        mk = dict(causal=causal, window=window, prefix_len=prefix)
        got = flash_attention_bwd(*a_, lse=lse, **mk)
        again = flash_attention_bwd(*a_, lse=lse, **mk)
        want = ref.flash_attention_bwd_ref(*a_, **mk)
        for n_, g_, r_, w_ in zip(("dq", "dk", "dv"), got, again, want):
            if not torch.equal(g_, r_):
                raise AssertionError(f"flash_attention_bwd {name} {n_}: two "
                                     f"launches differ")
            arm(arms, f"flash_attention_bwd {name} {n_}", g_, w_)
            if q_.dtype == torch.float32:
                err = (g_ - w_).abs().max().item()
                lim = BWD_TOL_F32 * w_.abs().max().item()
                print(f"[kernels] flash_attention_bwd {name} {n_}: float32 "
                      f"max_abs_err {err:.3g} (tolerance {lim:.3g}, "
                      f"{BWD_TOL_F32} of max |twin|) "
                      f"{'ok' if err <= lim else 'FAIL'}")
                if err > lim:
                    raise AssertionError(f"flash_attention_bwd {name} {n_}:"
                                         f" float32 error {err} > {lim}")
        print(f"[kernels] flash_attention_bwd {name}: two launches bit-equal "
              f"ok")
        return a_, lse

    def bwd_timed(label, a_lse, causal=True, window=0, mask=None, prefix=0):
        a_, lse = a_lse
        q_, k_, v_, o_, do_ = a_
        B_, H_, S_, hd_ = q_.shape
        g_ = H_ // k_.shape[1]
        ke, ve = (t.repeat_interleave(g_, dim=1) for t in (k_, v_))
        pairs = _visible_pairs(S_, causal, window, prefix)
        b_ = _bound_ms(4 * _nbytes(q_) + 4 * _nbytes(k_),
                       10 * hd_ * B_ * H_ * pairs,
                       "bf16" if q_.dtype != torch.float32 else "f32")

        def sdpa():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q_, ke, ve))
            F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask,
                is_causal=mask is None and causal).backward(do_)

        return dict(label=label,
                    _fns=(lambda: flash_attention_bwd(*a_, causal=causal,
                                                      window=window,
                                                      prefix_len=prefix,
                                                      lse=lse),
                          lambda: ref.flash_attention_bwd_ref(
                              *a_, causal=causal, window=window,
                              prefix_len=prefix), sdpa),
                    bound_ms=b_[0], bound_by=b_[1])

    S = 512
    bwd_main = bwd_arm("2x9/3x512 hd64 causal bf16",
                       bwd_inputs(2, H, KV, S, hd, bf))
    bwd_f32 = bwd_arm("2x9/3x512 hd64 causal float32",
                      bwd_inputs(2, H, KV, S, hd, torch.float32))
    bwd_arm("8x9/3x512 hd64 causal bf16", bwd_inputs(8, H, KV, S, hd, bf))
    bwd_rg = bwd_arm(f"1x10/1x{Sr} hd256 window={Wr} bf16",
                     bwd_inputs(1, 10, 1, Sr, 256, bf), window=Wr)
    bwd_extra = [bwd_timed("2 x 9/3 x 512, hd 64, causal, float32", bwd_f32),
                 dict(bwd_timed(f"1 x 10/1 x {Sr}, hd 256, window {Wr}, bf16",
                                bwd_rg, window=Wr, mask=mask), _reps=5)]
    # grok-1-314b's attention at hd 128, group 6 (MoE training's shape)
    bwd_grok = bwd_arm("2x48/8x128 hd128 causal bf16",
                       bwd_inputs(2, 48, 8, 128, 128, bf))
    bwd_extra.append(bwd_timed("grok-1-314b's 2 x 48/8 x 128, hd 128, "
                               "causal, bf16", bwd_grok))
    # the other head dims: checked, not timed (the timings phase's length)
    for hd_, (h_, kv_) in ((16, (4, 2)), (80, (8, 8)), (128, (16, 4))):
        for causal, w in ((True, 0), (False, 0), (True, 48)):
            bwd_arm(f"2x{h_}/{kv_}x200 hd{hd_} causal={causal} window={w} "
                    f"bf16", bwd_inputs(2, h_, kv_, 200, hd_, bf), causal, w)
    # paligemma-3b's prefix-LM backward (train_loss): 2 x 8 / 1 heads x
    # 320, hd 256, prefix 256, bf16 on the forward's saved lse and float32
    # on the CUDA cores; a prefix of 100 straddling a 64-row tile at hd 64,
    # without and with window 48
    for dt_name, dt in (("bf16", bf), ("float32", torch.float32)):
        a_pg = bwd_arm(f"paligemma 2x8/1x320 hd256 prefix=256 {dt_name}",
                       bwd_inputs(2, 8, 1, 320, 256, dt), prefix=256)
        bwd_extra.append(bwd_timed(
            f"paligemma-3b's prefix-LM: 2 x 8 / 1 heads x 320, hd 256, "
            f"prefix 256, {dt_name} (PR 30)", a_pg,
            mask=_flash_mask(320, True, 0, 256, dev), prefix=256))
    for w in (0, 48):
        a_st = bwd_arm(f"2x4/2x200 hd64 prefix=100 window={w} bf16",
                       bwd_inputs(2, 4, 2, 200, 64, bf), window=w,
                       prefix=100)
        bwd_extra.append(bwd_timed(
            f"a prefix of 100 straddling a 64-row tile: 2 x 4 / 2 heads x "
            f"200, hd 64, window {w}, bf16 (PR 30)", a_st, window=w,
            mask=_flash_mask(200, True, w, 100, dev), prefix=100))
    main_t = bwd_timed("", bwd_main)
    out.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:71",
        _fns=main_t["_fns"], bound_ms=main_t["bound_ms"],
        bound_by=main_t["bound_by"],
        shape=dict(B=2, H=H, KV=KV, S=S, hd=hd, dtype="bfloat16",
                   causal=True),
        _extra=bwd_extra,
        **worst(arms, f"float32 {BWD_TOL_F32} of max |twin| (and "
                      f"{TOL_ULPS} bf16 ulps); bf16 {TOL_ULPS} bf16 ulps; "
                      f"two launches bit-equal")))

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

    # -- rglru_scan at recurrentgemma-2b's width (rnn_width 2560), through
    # both kernels of csrc/rglru_scan.cu, the one kernels/rglru_scan.py's
    # route picks from the shape and the pointers: the bulk kernel at a
    # prefill of 2 x 512, lm.forward's 1 x 2304, generate()'s prefill of 4
    # x 64 and the chunk edges T = 64 / 65; the direct kernel at a decode
    # step of 4 and 8 lanes (T = 1), under a chunk (T = 63), at T = 0 (h_T
    # = h0), at rows that are not 16-byte multiples (C = 2561, 13) and at a
    # view one element into its buffer. float32 (the model's own inputs:
    # its gates are float32), bf16 and f16; h_seq and h_T bit-equal to the
    # twin in every arm
    arms = []
    C = 2560

    def on_card(t, offset):
        """t `offset` elements into a larger buffer: a contiguous view,
        16-byte aligned only where offset * itemsize is a multiple of
        16."""
        buf = torch.empty(offset + t.numel(), dtype=t.dtype, device=dev)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view

    def rg_inputs(B_, T_, C_, dt=torch.float32, with_h0=True, offset=0):
        a_ = torch.sigmoid(rn(B_, T_, C_, dt=torch.float32) * 2).to(dt)
        x_ = (rn(B_, T_, C_, dt=torch.float32) * 0.3).to(dt)
        h0 = rn(B_, C_, dt=torch.float32) if with_h0 else None
        return on_card(a_, offset), on_card(x_, offset), h0

    def rg_launch(a_):
        """(the kernel the route picks, blocks it launches)."""
        return rglru_scan.plan(a_[0], a_[1])

    for B_, T_, C_, off in ((2, 512, C, 0), (1, 2304, C, 0), (4, 64, C, 0),
                            (1, 64, C, 0), (1, 65, C, 0), (4, 1, C, 0),
                            (8, 1, C, 0), (1, 63, C, 0), (2, 0, C, 0),
                            (2, 100, 2561, 0), (2, 100, 13, 0),
                            (1, 100, 2564, 0), (2, 512, C, 1)):
        for dt in (torch.float32, bf, torch.float16):
            for with_h0 in (False, True):
                a_ = rg_inputs(B_, T_, C_, dt, with_h0, off)
                got, got_h = rglru_scan(*a_)
                want, want_h = ref.rglru_scan_ref(*a_)
                k_, nb = rg_launch(a_)
                name = (f"rglru_scan {B_}x{T_}x{C_} {dt} "
                        f"h0={'yes' if with_h0 else 'no'}"
                        + (f" offset {off}" if off else "")
                        + f" ({k_} kernel, {nb} blocks)")
                arm(arms, name, got, want, f32_tol=0.0)
                arm(arms, name + " h_T", got_h, want_h, f32_tol=0.0)

    def rg_bound(a_):
        # two reads, one write per element, plus h0 read and h_T written;
        # a multiply and an add per element
        return _bound_ms(3 * _nbytes(a_[0]) + 2 * _nbytes(a_[2]),
                         2 * a_[0].numel(), "f32")

    def rg_timed(label, a_, reps=20):
        b_ = rg_bound(a_)
        k_, nb = rg_launch(a_)
        return dict(label=f"{label}, {k_} kernel", kernel=k_, blocks=nb,
                    _fns=(lambda: rglru_scan(*a_),
                          lambda: ref.rglru_scan_ref(*a_), None),
                    bound_ms=b_[0], bound_by=b_[1], _reps=reps)

    # the decode step's shape, where 1728 of a generate() run's launches
    # go; the prompt shapes beside it. The twin is a host loop of T steps:
    # 3 timed calls, not 20, at the long prompts
    dec = rg_inputs(4, 1, C)
    k_dec, nb_dec = rg_launch(dec)
    bound, by = rg_bound(dec)
    out.append(dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:44",
        _fns=(lambda: rglru_scan(*dec), lambda: ref.rglru_scan_ref(*dec),
              None),
        bound_ms=bound, bound_by=by, kernel=k_dec, blocks=nb_dec,
        shape=dict(B=4, T=1, C=C, dtype="float32"),
        _extra=[rg_timed(f"1 x 2304 x {C} float32 (lm.forward)",
                         rg_inputs(1, 2304, C), 3),
                rg_timed(f"2 x 512 x {C} float32", rg_inputs(2, 512, C), 3),
                rg_timed(f"4 x 64 x {C} float32 (generate()'s prefill)",
                         rg_inputs(4, 64, C))],
        **worst(arms, "h_seq and h_T bit-equal to the twin (float32, "
                      "bf16, f16)")))

    # -- the attention kernels at the other head dims the configs have: 16
    # (every .reduced(): the serve CLI's defaults), 80 (stablelm-3b) and,
    # for paged_prefill, 256 (recurrentgemma-2b's); bf16, small shapes
    by_name = {r["name"]: r for r in out}
    for hd, (h_, kv_) in ((16, (4, 2)), (80, (32, 32)), (256, (10, 1))):
        tag = f"hd{hd} {h_}/{kv_} heads"
        fa = (rn(2, h_, 200, hd), rn(2, kv_, 200, hd), rn(2, kv_, 200, hd))
        pa = (rn(4, h_, hd), rn(33, bs, kv_, hd), rn(33, bs, kv_, hd),
              tables_for(4, 8), i32([0, 1, 13, 64]))
        pp = (rn(3, 16, h_, hd), rn(3, 16, kv_, hd), rn(3, 16, kv_, hd),
              pa[1], pa[2], pa[3][:3], i32([0, 8, 0]), i32([16, 24, 9]))
        new = {"flash_attention": [], "paged_attention": [],
               "paged_prefill": []}
        if hd != 256:        # flash / paged decode at 256: the arms above
            for causal, w in ((True, 0), (False, 0), (True, 48)):
                arm(new["flash_attention"], f"flash_attention {tag} 2x200 "
                    f"causal={causal} window={w}",
                    flash_attention(*fa, causal=causal, window=w),
                    ref.flash_attention_ref(*fa, causal=causal, window=w))
            arm(new["paged_attention"], f"paged_attention {tag} B=4, ctx "
                f"0/1/13/64", paged_attention(*pa),
                ref.paged_attention_ref(*pa))
        for w in (0, 6):
            arm(new["paged_prefill"], f"paged_prefill {tag} 3 x 16, cached "
                f"0/8/0 window={w}", paged_prefill_attention(*pp, window=w),
                ref.paged_prefill_ref(*pp, window=w))
            for qname, qdt in QPOOLS:
                cq, qkw = quantized(pp, qdt)
                qarm(new["paged_prefill"], f"{tag} 3 x 16, cached 0/8/0 "
                     f"window={w} engine-quantized {qname} pool bf16", cq,
                     window=w, **qkw)
        for name, arms_ in new.items():
            r = by_name[name]
            r["arms"] += arms_
            r["max_abs_err"] = max(a_["max_abs_err"] for a_ in r["arms"])
            r["max_ulps"] = max(a_["max_ulps"] for a_ in r["arms"])
        if hd != 256:
            pairs = 2 * 200 * 201 // 2          # causal, 2 rows of 200
            fb = _bound_ms(2 * _nbytes(fa[0]) + _nbytes(fa[1], fa[2]),
                           4 * h_ * hd * pairs)
            by_name["flash_attention"]["_extra"].append(dict(
                label=f"{tag} 2 x 200, causal, bf16",
                _fns=(lambda a=fa: flash_attention(*a),
                      lambda a=fa: ref.flash_attention_ref(*a),
                      lambda a=fa: F.scaled_dot_product_attention(
                          *a, is_causal=True, enable_gqa=True)),
                bound_ms=fb[0], bound_by=fb[1]))
            n_tok = 1 + 13 + 64
            pb = _bound_ms(2 * _nbytes(pa[0]) + _nbytes(pa[3], pa[4])
                           + 2 * n_tok * kv_ * hd * 2, 4 * h_ * hd * n_tok)
            by_name["paged_attention"]["_extra"].append(dict(
                label=f"{tag} B=4, ctx 0/1/13/64, bf16",
                _fns=(lambda a=pa: paged_attention(*a),
                      lambda a=pa: ref.paged_attention_ref(*a), None),
                bound_ms=pb[0], bound_by=pb[1]))
        by_name["paged_prefill"]["_extra"].append(prefill_timed(
            f"{tag} 3 x 16, cached 0/8/0, bf16", pp))

    # -- rwkv6_scan at rwkv6-3b's width (40 heads of 64): a decode step of
    # 4 lanes (T = 1 from the carried state), a prefill of 2 x 512 and
    # lm.forward's 1 x 2048; and the reduced model's 2 x 4 x 40 x 16; then
    # the padded path (kernels/rwkv6_scan.py:pad_head_dim) at 2 x 4 x 40 x
    # N for head dims that are not a multiple of 8 (N = 12, 60) and for a
    # view one element into its buffer (N = 64); r / k / v float32 and
    # bf16, w and u float32, with and without s0. y within float32
    # RWKV_TOL_F32 (1 + |twin|) or TOL_ULPS bf16 ulps (only the order of
    # the sum over the key channel differs) and bit-equal to
    # ref.rwkv6_scan_split_ref, which sums in the kernel's order;
    # S_T bit-equal
    arms = []

    def rwkv_inputs(shape, dt, with_s0, offset=0):
        B_, H_, _, N_ = shape
        r_, k_, v_ = (on_card(rn(*shape, dt=torch.float32).mul(0.5).to(dt),
                              offset) for _ in range(3))
        w_ = on_card(torch.exp(-torch.exp(rn(*shape, dt=torch.float32)
                                          - 1)), offset)
        u_ = rn(H_, N_, dt=torch.float32) * 0.1
        s0_ = rn(B_, H_, N_, N_, dt=torch.float32) if with_s0 else None
        return r_, k_, v_, w_, u_, s0_

    for shape, off in (((4, 40, 1, 64), 0), ((2, 40, 512, 64), 0),
                       ((1, 40, 2048, 64), 0), ((2, 4, 40, 16), 0),
                       ((2, 4, 40, 12), 0), ((2, 4, 40, 60), 0),
                       ((2, 4, 40, 64), 1)):
        for dt in (torch.float32, bf):
            for with_s0 in (False, True):
                a_ = rwkv_inputs(shape, dt, with_s0, off)
                got, got_s = rwkv6_scan(*a_)
                want, want_s = ref.rwkv6_scan_ref(*a_)
                name = (f"rwkv6_scan {'x'.join(map(str, shape))} {dt} "
                        f"s0={'yes' if with_s0 else 'no'}"
                        + (f" offset {off} (padded copy)" if off else "")
                        + (" (padded to a multiple of 8)"
                           if shape[-1] % 8 else ""))
                tol = (dict(f32_tol=RWKV_TOL_F32) if dt == torch.float32
                       else dict(tol_ulps=TOL_ULPS))
                arm(arms, name, got, want, **tol)
                arm(arms, name + " S_T", got_s, want_s, f32_tol=0.0)
                split, _ = ref.rwkv6_scan_split_ref(*a_)
                arm(arms, name + " y vs the split emulation", got, split,
                    f32_tol=0.0)

    # the speculative verify's arm: return_states=True over the engine's
    # chain buckets (speculate=4: T = 2, 4, 5) at 4 lanes, bf16 from a
    # carried state, and the reduced model's 2 x 4 x 5 x 16 and a padded
    # N = 12: y and S_T bit-equal to the call without the flag, S_steps
    # bit-equal to the twin's and each S_steps[:, :, t] to S_T of the call
    # cut to t + 1 steps
    for shape in ((4, 40, 2, 64), (4, 40, 4, 64), (4, 40, 5, 64),
                  (2, 4, 5, 16), (2, 4, 5, 12)):
        for dt in (torch.float32, bf):
            a_ = rwkv_inputs(shape, dt, True)
            y_, s_, steps_ = rwkv6_scan(*a_, return_states=True)
            y0, s0_ = rwkv6_scan(*a_)
            name = (f"rwkv6_scan {'x'.join(map(str, shape))} {dt} "
                    f"return_states")
            if not (torch.equal(y_, y0) and torch.equal(s_, s0_)):
                raise AssertionError(f"{name}: y or S_T moved with the flag")
            _, _, want_steps = ref.rwkv6_scan_ref(*a_, return_states=True)
            arm(arms, name + " S_steps", steps_, want_steps, f32_tol=0.0)
            for t_ in range(shape[2]):
                _, s_cut = rwkv6_scan(*(x[:, :, :t_ + 1].contiguous()
                                        for x in a_[:4]), *a_[4:])
                if not torch.equal(steps_[:, :, t_], s_cut):
                    raise AssertionError(f"{name}: step {t_} differs from "
                                         f"the cut call's S_T")
    print("[kernels] rwkv6_scan return_states: y and S_T unchanged by the "
          "flag, every step's state bit-equal to the twin and to the cut "
          "call ok")

    def rwkv_bound(a_, states=False):
        r_, k_, v_, w_, u_, s0_ = a_
        B_, H_, T_, N_ = r_.shape
        # r, k, v, w, u and s0 read once, y and S_T (and with states every
        # step's state) written once; 7 float32 operations per state
        # element per step
        return _bound_ms(_nbytes(r_, k_, v_, w_, u_, s0_, r_, s0_)
                         + (4 * B_ * H_ * T_ * N_ * N_ if states else 0),
                         7 * B_ * H_ * T_ * N_ * N_, "f32")

    def rwkv_blocks(a_):
        """Blocks the launch takes: 16 value columns of one head each, of
        the head dim padded to a multiple of 8."""
        B_, H_, _, N_ = a_[0].shape
        return B_ * H_ * -(-(-(-N_ // 8) * 8) // 16)

    step = rwkv_inputs((4, 40, 1, 64), bf, True)
    extra = []
    for shape, off, what in (
            ((1, 40, 2048, 64), 0, " (lm.forward)"),
            ((2, 40, 512, 64), 0, ""),
            ((2, 4, 40, 16), 0, " (the reduced model's, aligned)"),
            ((2, 4, 40, 12), 0, " (padded to 16)"),
            ((2, 4, 40, 64), 1, " offset 1 (a padded copy)")):
        a_ = rwkv_inputs(shape, bf, True, off)
        b_ = rwkv_bound(a_)
        # the twin is a host loop of T steps: 3 timed calls, not 20
        extra.append(dict(label=f"{' x '.join(map(str, shape))} bf16, w "
                                f"float32{what}",
                          blocks=rwkv_blocks(a_),
                          _fns=(lambda a=a_: rwkv6_scan(*a),
                                lambda a=a_: ref.rwkv6_scan_ref(*a), None),
                          bound_ms=b_[0], bound_by=b_[1],
                          _reps=3 if shape[2] > 40 else 20))
    vfy = rwkv_inputs((4, 40, 5, 64), bf, True)
    for states in (True, False):
        b_ = rwkv_bound(vfy, states)
        extra.append(dict(
            label=f"verify 4 x 40 x 5 x 64 bf16 from s0, "
                  f"{'with' if states else 'without'} return_states",
            blocks=rwkv_blocks(vfy),
            _fns=(lambda a=vfy, st=states: rwkv6_scan(*a, return_states=st),
                  lambda a=vfy, st=states: ref.rwkv6_scan_ref(
                      *a, return_states=st), None),
            bound_ms=b_[0], bound_by=b_[1]))
    bound, by = rwkv_bound(step)
    out.append(dict(
        name="rwkv6_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:55",
        _fns=(lambda: rwkv6_scan(*step), lambda: ref.rwkv6_scan_ref(*step),
              None),
        bound_ms=bound, bound_by=by, blocks=rwkv_blocks(step),
        shape=dict(B=4, H=40, T=1, N=64, dtype="bfloat16", s0=True),
        _extra=extra,
        **worst(arms, f"float32 {RWKV_TOL_F32} (1 + |twin|); bf16 "
                      f"{TOL_ULPS} bf16 ulps; S_T bit-equal to the twin, y "
                      f"to the split emulation")))
    return out


def phase_timings(kern):
    """Time each kernel, its twin and the library call on phase 2's
    inputs: ms / plain_ms / library_ms are device time per call, with the
    wall-clock (CUDA event) time per call of each beside it. Runs after
    the main path, so the profiler's hooks cannot slow it."""
    def timed(r):
        reps = r.pop("_reps", 20)
        for key, fn in zip(("ms", "plain_ms", "library_ms"), r.pop("_fns")):
            wall_key = key.replace("ms", "wall_ms")
            if fn is None:
                r[key], r[wall_key] = None, None
                continue
            dev_ms, r[wall_key], how = (_times(fn, reps) if key == "ms"
                                        else _times_spaced_first(fn, reps))
            if how == "spaced":
                r.setdefault("spaced_timed", []).append(key)
            if dev_ms is None:
                # no device time could be taken: CUDA-event time of
                # back-to-back calls stands in, and the record says so
                r.setdefault("event_timed", []).append(key)
                dev_ms = r[wall_key]
            r[key] = dev_ms
        return (f"device {r['ms']:.4f} ms per call (wall {r['wall_ms']:.4f}"
                f"); twin {r['plain_ms']:.4f} (wall {r['plain_wall_ms']:.4f})"
                f"; library {r['library_ms']}; bound {r['bound_ms']:.5f} by "
                f"{r['bound_by']}"
                + (f"; {r['blocks']} blocks" if "blocks" in r else "")
                + (f", {r['kernel']} kernel" if "kernel" in r else "")
                + (f"; device time from CUDA events behind a spin kernel "
                   f"for {r['spaced_timed']}" if r.get("spaced_timed")
                   else "")
                + (f"; CUDA-event time of back-to-back calls for "
                   f"{r['event_timed']} (no device time could be taken)"
                   if r.get("event_timed") else ""))

    for r in kern:
        print(f"[timings] {r['name']}: {timed(r)}")
        r["timed_arms"] = r.pop("_extra", [])
        for e in r["timed_arms"]:
            print(f"[timings]   {r['name']} at {e['label']}: {timed(e)}")


def _first_divergence(a, b):
    n = min(len(a), len(b))
    for i in range(n):
        if int(a[i]) != int(b[i]):
            return i
    return None if len(a) == len(b) else n


def _batched_refs(params, cfg, reqs, dev):
    """generate() over the whole stream in one batch (its prompts are of
    one length): {rid: (tokens, top-1/top-2 gaps)}, the margin rule's
    reference."""
    import numpy as np
    from repro_torch.launch.serve import generate
    prompts = np.stack([r.prompt for r in reqs])
    gen = max(r.max_new_tokens for r in reqs)
    toks, margins = generate(params, cfg, prompts, gen, device=dev,
                             return_margins=True)
    toks, margins = toks.cpu().numpy(), margins.cpu().numpy()
    return {r.rid: (toks[i, :r.max_new_tokens], margins[i, :r.max_new_tokens])
            for i, r in enumerate(reqs)}


def check_against_generate(params, cfg, reqs, done, dev, bound):
    """The margin rule (_margin_rule) against generate(), run once for
    each prompt length on the requests of that length as one batch. Also
    returns generate()'s gaps at every generated position."""
    groups = {}
    for r in reqs:
        groups.setdefault(len(r.prompt), []).append(r)
    refs = {}
    for group in groups.values():
        refs.update(_batched_refs(params, cfg, group, dev))
    rec = _margin_rule(done, refs, bound, "engine vs generate()")
    rec["gaps"] = [float(x) for c in sorted(done, key=lambda c: c.rid)
                   for x in refs[c.rid][1]]
    return rec


def _margin_rule(done, refs, bound, what):
    """The margin rule: each completion equals generate()'s tokens up to
    the first divergence, and there generate()'s top-1/top-2 gap is <=
    bound. refs: {rid: (generate()'s tokens, its gaps)}."""
    exact, within = 0, []
    for c in sorted(done, key=lambda c: c.rid):
        toks, margins = refs[c.rid]
        i = _first_divergence(c.tokens, toks)
        if i is None:
            exact += 1
            continue
        gap = float(margins[i]) if i < len(margins) else float("inf")
        within.append({"rid": c.rid, "at": i, "margin": gap})
        if gap > bound:
            raise AssertionError(
                f"{what}: request {c.rid} leaves generate() at token {i} "
                f"where generate()'s top-1/top-2 margin is {gap:.5f} > "
                f"{bound}")
    return {"requests": len(done), "exact": exact,
            "diverged_within_bound": within, "bound": bound}


def phase_small(dev):
    """The reduced float32 smollm (head_dim 16, as .reduced() has it) on
    the card against the same model on the CPU (the kernels' twins)."""
    from repro_torch.configs import get_config
    from repro_torch.device import to_device
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServingEngine, synthetic_requests
    cfg = get_config("smollm-135m").reduced()
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


def phase_small_recurrent(dev, cfg, tag):
    """A reduced float32 recurrent model on the card against the same
    model on the CPU (the kernels' twins): forward logits on 2 x 40 tokens
    within 1e-4; greedy generate() token for token."""
    from repro_torch.device import to_device
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    params = lm.init_params(0, cfg, device="cpu")
    cuda_params = to_device(params, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    want, _ = lm.forward(params, cfg, {"tokens": toks})
    got, _ = lm.forward(cuda_params, cfg, {"tokens": toks.to(dev)})
    err = (got.cpu() - want).abs().max().item()
    print(f"[{tag}] forward logits cuda vs cpu (2 x 40 tokens, head_dim "
          f"{cfg.head_dim}, window {cfg.window}): max_abs_err {err:.3g} "
          f"(tolerance 1e-4)")
    if err > 1e-4:
        raise AssertionError(f"{tag}: forward differs: {err}")
    prompts = torch.randint(0, cfg.vocab_size, (2, 24),
                            generator=torch.Generator().manual_seed(2))
    want_t = generate(params, cfg, prompts, 32, device="cpu")
    got_t = generate(cuda_params, cfg, prompts, 32, device=dev)
    same = bool(torch.equal(got_t.cpu(), want_t))
    print(f"[{tag}] generate() 2 x 24 + 32 tokens cuda vs cpu: "
          f"{'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"{tag}: generate() differs between the card "
                             f"and the CPU")
    return {"forward_max_abs_err": err, "generate_equal": same,
            "engine": _small_engine_card_vs_cpu(params, cuda_params, cfg,
                                                dev, tag)}


class ScriptedProposer:
    """A draft proposer that knows each request's greedy continuation
    (`scripts`: [(prompt list, continuation list)]) and proposes it with
    its second token off by one: the first draft token is accepted and
    the rest rejected, so every verify of a longer draft rolls the
    recurrent state back to a mid-chain snapshot."""

    def __init__(self, scripts, vocab_size):
        self.scripts = scripts
        self.vocab_size = vocab_size

    def propose(self, history, k):
        hist = list(history)
        for prompt, out in self.scripts:
            full = prompt + out
            if (len(prompt) < len(hist) <= len(full)
                    and hist == full[:len(hist)]):
                nxt = full[len(hist):len(hist) + k]
                if len(nxt) > 1:
                    nxt[1] = (nxt[1] + 1) % self.vocab_size
                return nxt
        return []


def _scripts(reqs, outs):
    """ScriptedProposer scripts from requests and {rid: continuation}."""
    return [([int(t) for t in r.prompt], [int(t) for t in outs[r.rid]])
            for r in reqs]


def _small_engine_card_vs_cpu(params, cuda_params, cfg, dev, tag):
    """The reduced recurrent model's engine on the card against the same
    engine on the CPU, token for token: (a) a 30-token prompt admitted in
    chunks of 8 beside a decoding 5-token request (2 slots, block 4), the
    stream on which the JAX engine leaves generate() (ROADMAP, reference
    faults), also equal to generate() on the CPU; (b) four 9-token prompts
    at speculate=4 with partial scripted drafts (scripts from generate()
    on the CPU), equal accepted counts on both."""
    import numpy as np
    from repro_torch.launch.serve import generate
    from repro_torch.serving.engine import Request, ServingEngine
    V = cfg.vocab_size

    def chunked():
        rng = np.random.default_rng(0)
        return [Request(rid=0, prompt=rng.integers(0, V, 5).astype(np.int32),
                        max_new_tokens=20),
                Request(rid=1, prompt=rng.integers(0, V, 30).astype(np.int32),
                        max_new_tokens=6)]

    def drafted():
        rng = np.random.default_rng(2)
        return [Request(rid=i, prompt=rng.integers(0, V, 9).astype(np.int32),
                        max_new_tokens=n)
                for i, n in enumerate((12, 7, 10, 5))]

    want = {name: {r.rid: generate(params, cfg, r.prompt[None],
                                   r.max_new_tokens, device="cpu")[0].numpy()
                   for r in make()}
            for name, make in (("chunked", chunked), ("drafted", drafted))}
    runs = {"chunked": (chunked, dict(num_slots=2, block_size=4,
                                      max_seq_len=64, prefill_buckets=[4, 8],
                                      prefill_chunk=8)),
            "drafted": (drafted, dict(num_slots=2, block_size=4,
                                      max_seq_len=32, speculate=4))}
    rec = {}
    for name, (make, kw) in runs.items():
        got = {}
        for where, p_ in (("cpu", params), ("cuda", cuda_params)):
            eng = ServingEngine(p_, cfg, device="cpu" if where == "cpu"
                                else dev, **kw)
            if kw.get("speculate"):
                eng.scheduler._proposers = [ScriptedProposer(
                    _scripts(make(), want[name]), V)] * eng.num_slots
            done = sorted(eng.run(make()), key=lambda c: c.rid)
            got[where] = ([c.tokens.tolist() for c in done],
                          eng.scheduler.proposed_tokens,
                          eng.scheduler.accepted_tokens,
                          eng.runner.prefill_dispatches)
        same = got["cpu"] == got["cuda"]
        exact = got["cpu"][0] == [want[name][i].tolist()
                                  for i in sorted(want[name])]
        rec[name] = {"equal": same, "equals_generate": exact,
                     "proposed": got["cuda"][1], "accepted": got["cuda"][2],
                     "prefill_dispatches": got["cuda"][3]}
        print(f"[{tag}] engine {name} cuda vs cpu: "
              f"{'equal' if same else 'DIFFER'} (tokens, proposed / "
              f"accepted {got['cuda'][1]} / {got['cuda'][2]}, "
              f"{got['cuda'][3]} prefill dispatches); equal to generate(): "
              f"{exact}")
        if not same:
            raise AssertionError(f"{tag}: engine {name} differs between the "
                                 f"card and the CPU: {got}")
        if name == "chunked" and not exact:
            raise AssertionError(f"{tag}: the chunked stream leaves "
                                 f"generate() on the CPU")
        if name == "drafted" and not 0 < got["cuda"][2] < got["cuda"][1]:
            raise AssertionError(f"{tag}: partial drafts were not partly "
                                 f"accepted: {got['cuda'][1:3]}")
    return rec


# ----------------------------------------------------------------------------
# training: lm.train_loss through the flash kernels and their backward,
# MBProx and the AdamW baseline, checkpoint and resume
# ----------------------------------------------------------------------------

def _train_batches(cfg, n, batch, seq, n_micro, seed=0):
    """n batches of the train CLI's stream (TokenStream under
    fold_in(PRNGKey(seed + 1), step)), on the CPU."""
    from repro_torch import prng
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.train import make_batch
    stream = TokenStream(cfg.vocab_size, seq, seed=seed)
    return [make_batch(cfg, stream, prng.fold_in(prng.PRNGKey(seed + 1), i),
                       batch, n_micro) for i in range(n)]


def _train_run(cfg, params, dev, optimizer, batches, lrs, timed=False):
    """Steps of the MBProx (default config) or AdamW baseline step from
    `params` on `batches`: (losses, final params, wall seconds per step
    when timed)."""
    from repro_torch.device import to_device
    from repro_torch.launch import steps as steps_lib
    p = to_device(params, dev)
    if optimizer == "mbprox":
        step, opt, _ = steps_lib.make_mbprox_train_step(cfg)
    else:
        step, opt = steps_lib.make_baseline_train_step(cfg)
    s, losses, secs = opt.init(p), [], []
    for b, lr in zip(batches, lrs):
        t0 = time.perf_counter()
        p, s, m = step(p, s, to_device(b, dev), lr)
        losses.append(float(m["loss"]))          # waits for the step
        secs.append(time.perf_counter() - t0)
    return (losses, p, secs) if timed else (losses, p)


def _tree_diff(a, b, start):
    """(max |a - b|, ||a - b|| / ||a - start||) over the leaves, on the
    CPU."""
    from repro_torch.tree import tree_leaves
    mx, d2, u2 = 0.0, 0.0, 0.0
    for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(start)):
        x, y, z = x.float().cpu(), y.float().cpu(), z.float().cpu()
        mx = max(mx, (x - y).abs().max().item())
        d2 += float(((x - y) ** 2).sum())
        u2 += float(((x - z) ** 2).sum())
    return mx, math.sqrt(d2) / max(math.sqrt(u2), 1e-30)


def _card_vs_cpu(tag, cfg, params, dev, batches, runs):
    """Each (optimizer, lr) run on the card and on the CPU from the same
    params and batches, held to the TRAIN_* gates; returns the record."""
    rec = {}
    for optimizer, lr in runs:
        lrs = [lr] * len(batches)
        gl, gp = _train_run(cfg, params, dev, optimizer, batches, lrs)
        cl, cp = _train_run(cfg, params, "cpu", optimizer, batches, lrs)
        lerr = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
        mx, rl2 = _tree_diff(gp, cp, params)
        if optimizer == "mbprox":
            ok = mx <= TRAIN_ATOL
            gate = f"max |dp| <= {TRAIN_ATOL}"
        else:
            ok = rl2 <= TRAIN_ADAM_RL2 and mx <= 2 * lr * len(batches)
            gate = (f"relative L2 <= {TRAIN_ADAM_RL2}, max <= "
                    f"{2 * lr * len(batches):.3g}")
        ok = ok and lerr <= TRAIN_LOSS_RTOL
        print(f"[{tag}] {optimizer} lr {lr} x {len(batches)} steps, card vs "
              f"CPU: losses {gl} vs {cl} (max rel {lerr:.3g}, tolerance "
              f"{TRAIN_LOSS_RTOL}); params max |dp| {mx:.3g}, relative L2 "
              f"{rl2:.3g} ({gate}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: {optimizer} on the card differs "
                                 f"from the CPU")
        rec[optimizer] = {"lr": lr, "card_losses": gl, "cpu_losses": cl,
                          "loss_max_rel": lerr, "param_max_abs": mx,
                          "param_rel_l2": rl2}
    return rec


def phase_train_small(dev):
    """Reduced float32 smollm (hd 16): three MBProx and three AdamW steps on
    the card against the same steps on the CPU (the kernels' twins), then
    tests/test_system.py's loss-drop run through the train CLI's train()
    on the card (60 MBProx steps, lr 5e-2, batch 8 x 32)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    cfg = get_config("smollm-135m").reduced()
    params = lm.init_params(0, cfg, device="cpu")
    kernels.reset_launch_counts()
    rec = _card_vs_cpu("train_small", cfg, params, dev,
                       _train_batches(cfg, 3, 8, 32, 2),
                       (("mbprox", 5e-2), ("baseline", 3e-3)))
    t0 = time.perf_counter()
    _, losses = train("smollm-135m", 60, optimizer="mbprox", lr=5e-2,
                      batch_size=8, seq_len=32, log_every=1000, device=dev)
    secs = time.perf_counter() - t0
    ok = min(losses) < losses[0] - 0.2
    print(f"[train_small] train() 60 MBProx steps on the card in {secs:.1f}"
          f" s: loss {losses[0]:.4f} -> min {min(losses):.4f} (must drop "
          f"by > 0.2) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train_small: the loss did not drop")
    rec["loss_drop"] = {"first": losses[0], "min": min(losses),
                        "last": losses[-1], "seconds": secs}
    rec["launches"] = kernels.launch_counts()
    if not all(rec["launches"][k] for k in ("flash_attention",
                                            "flash_attention_bwd")):
        raise AssertionError(f"train_small: flash forward / backward not "
                             f"launched: {rec['launches']}")
    return rec


def _profile_step(step_fn, tag):
    """One profiled outer step: wall, device-busy ms, idle share, kernel
    launches, the flash forward / backward wrappers' launches, and the
    device ms of the flash kernels (flash_*_ms: the forward's, and the
    backward's passes and group sum)."""
    from repro_torch import kernels

    def window():
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    before = kernels.launch_counts()
    kern, wall = _profiled(window)
    after = kernels.launch_counts()
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall,
           "launches": sum(e.count for e in kern),
           "flash_fwd": after["flash_attention"] - before["flash_attention"],
           "flash_bwd": (after["flash_attention_bwd"]
                         - before["flash_attention_bwd"]),
           "flash_fwd_ms": sum(e.self_device_time_total for e in kern
                               if "flash_wgmma_kernel" in e.key
                               or "flash_attention_kernel" in e.key) / 1e3,
           "flash_bwd_ms": sum(e.self_device_time_total for e in kern
                               if "bwd_" in e.key) / 1e3,
           "top": [(e.key, e.count, e.self_device_time_total / 1e3)
                   for e in top]}
    print(f"[{tag}] profiled outer step: wall {wall:.2f} ms, device-busy "
          f"{busy:.3f} ms, idle {100 * out['idle_share']:.1f}%, "
          f"{out['launches']} kernel launches, flash forward "
          f"{out['flash_fwd']} / backward {out['flash_bwd']} calls, "
          f"{out['flash_fwd_ms']:.3f} / {out['flash_bwd_ms']:.3f} ms")
    for k, n, ms in out["top"]:
        print(f"[{tag}]   {ms:9.3f} ms  x{n:5d}  {k[:90]}")
    return out


def phase_train(dev):
    """Full-width smollm-135m: (a) float32, card against CPU (2 x 64,
    n_micro 2, one MBProx and one AdamW step); (b) the config's bf16
    activations over float32 masters at 16 x 512, n_micro 2: 6 MBProx and
    4 AdamW outer steps (tokens/s, ms per step, peak memory, one profiled
    step), the first 5 MBProx losses against a float32 card run on the
    same batches; (c) the train CLI's checkpoint and resume: 4 steps with
    a checkpoint, resumed to 6, against 6 uninterrupted; the card's
    checkpoint restored on the CPU bit for bit."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.device import to_device
    from repro_torch.models import lm
    cfg = get_config("smollm-135m")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    kernels.reset_launch_counts()
    rec = {}
    # (a) the weights drawn on the card, a copy on the CPU
    params = to_device(lm.init_params(0, cfg32, device=dev), "cpu")
    rec["float32_card_vs_cpu"] = _card_vs_cpu(
        "train", cfg32, params, dev, _train_batches(cfg32, 1, 2, 64, 2),
        (("mbprox", 3e-3), ("baseline", 3e-3)))
    del params
    _train_bf16_and_resume(cfg, cfg32, dev, rec)
    rec["launches"] = kernels.launch_counts()
    if not all(rec["launches"][k] for k in ("flash_attention",
                                            "flash_attention_bwd")):
        raise AssertionError(f"train: flash forward / backward not "
                             f"launched: {rec['launches']}")
    return rec


def _train_bf16_and_resume(cfg, cfg32, dev, rec):
    """Phase train's (b) and (c), into `rec`."""
    import shutil
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.device import to_device
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import Schedule
    from repro_torch.tree import tree_leaves
    # (b)
    master = lm.init_params(0, cfg, device=dev)
    batches = _train_batches(cfg, 7, 16, 512, 2)
    sched = Schedule(peak=3e-3, warmup=5, total=20)
    lrs = [sched(i) for i in range(7)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, p, secs = _train_run(cfg, master, dev, "mbprox", batches[:6],
                                 lrs[:6], timed=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = 16 * 512
    step_ms = 1e3 * sorted(secs[1:])[len(secs[1:]) // 2]
    l32, _ = _train_run(cfg32, master, dev, "mbprox", batches[:5], lrs[:5])
    gap = max(abs(a - b) for a, b in zip(losses[:5], l32))
    adam, _, asecs = _train_run(cfg, master, dev, "baseline", batches[:4],
                                lrs[:4], timed=True)
    finite = all(math.isfinite(x) for x in losses + adam + l32)
    ok = finite and gap <= TRAIN_BF16_ATOL
    adam_ms = 1e3 * sorted(asecs[1:])[len(asecs[1:]) // 2]
    print(f"[train] bf16 MBProx 16 x 512, n_micro 2: losses "
          f"{[round(x, 4) for x in losses]}; median {step_ms:.1f} ms an "
          f"outer step (first {1e3 * secs[0]:.1f}), "
          f"{tokens / step_ms * 1e3:.0f} tokens/s; peak {peak:.2f} GiB "
          f"allocated")
    print(f"[train] first 5 losses bf16 vs float32 on the card: {l32} "
          f"(max gap {gap:.4g}, tolerance {TRAIN_BF16_ATOL}); AdamW 4 steps"
          f" {[round(x, 4) for x in adam]} median {adam_ms:.1f} ms "
          f"({tokens / adam_ms * 1e3:.0f} tokens/s); all finite {finite} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train: bf16 losses not finite or too far "
                             "from float32")
    step, opt, _ = steps_lib.make_mbprox_train_step(cfg)
    state = {"p": p, "s": opt.init(p)}

    def one_step():
        state["p"], state["s"], _ = step(state["p"], state["s"],
                                         to_device(batches[6], dev), lrs[6])

    prof = _profile_step(one_step, "train")
    rec["bf16"] = {"batch": [16, 512], "n_micro": 2, "mbprox_losses": losses,
                   "mbprox_step_ms": step_ms, "first_step_ms": 1e3 * secs[0],
                   "tokens_per_s": tokens / step_ms * 1e3,
                   "peak_allocated_gib": peak, "float32_losses": l32,
                   "bf16_vs_float32_gap": gap, "adamw_losses": adam,
                   "adamw_step_ms": adam_ms, "profile": prof}
    del master, p, state
    torch.cuda.empty_cache()
    # (c)
    d = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(reduced=False, log_every=1000, device=dev)
    t0 = time.perf_counter()
    _, first = train("smollm-135m", 4, ckpt_dir=str(d), **kw)
    resumed_p, resumed = train("smollm-135m", 6, ckpt_dir=str(d),
                               resume=True, **kw)
    ckpt_s = time.perf_counter() - t0
    _, whole = train("smollm-135m", 6, **kw)
    rerr = max(abs(a - b) for a, b in zip(resumed, whole[4:]))
    bit = resumed == whole[4:]
    cpu_params = to_device(resumed_p, "cpu")
    like = {"params": cpu_params,
            "opt": steps_lib.make_mbprox_train_step(cfg)[1].init(cpu_params)}
    restored, at = ckpt_lib.restore(str(d), like)
    same = at == 5 and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(restored["params"]),
                                          tree_leaves(cpu_params)))
    ok = len(resumed) == 2 and rerr <= RESUME_ATOL and same
    print(f"[train] train() 4 steps + checkpoint, resumed to 6 ({ckpt_s:.1f}"
          f" s with two saves and a restore): losses {resumed} vs "
          f"uninterrupted {whole[4:]} (max {rerr:.3g}, tolerance "
          f"{RESUME_ATOL}; bit-equal {bit}); the card's checkpoint of step "
          f"{at} restored on the CPU equals the card's params bit for bit "
          f"{same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train: resume or the CPU restore failed")
    shutil.rmtree(d, ignore_errors=True)
    rec["resume"] = {"losses": resumed, "uninterrupted": whole[4:],
                     "max_abs": rerr, "bit_equal": bit, "seconds": ckpt_s,
                     "cpu_restore_bit_equal": same}


def phase_serve_cli_default():
    """`python -m repro_torch.launch.serve` with its defaults (the engine
    on the reduced smollm, head_dim 16) in a process of its own, on the
    card: it must exit 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                          cwd=ROOT, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    stats = {}
    if proc.returncode == 0:
        text = proc.stdout[proc.stdout.index("{"):proc.stdout.rindex("}") + 1]
        stats = json.loads(text)
    print(f"[serve_cli_default] python -m repro_torch.launch.serve: exit "
          f"{proc.returncode} in {secs:.1f} s (process start included); "
          f"{stats.get('requests')} requests, "
          f"{stats.get('generated_tokens')} tokens, "
          f"{stats.get('tokens_per_s')} tokens/s on {stats.get('device')}")
    if proc.returncode != 0 or stats.get("device") != "cuda":
        raise AssertionError(f"the default serve CLI failed (exit "
                             f"{proc.returncode}):\n{proc.stderr[-3000:]}")
    return {"seconds": secs, "stats": stats}


def _greedy_from_prefill(params, cfg, prompts, gen_len,
                         return_margins=False):
    """Greedy decode from lm.prefill's cache (the whole prompt in one
    pass, then decode_step from the state it leaves). With return_margins
    also the top-1 minus top-2 logit gap of the step that chose each
    token, as generate() gives them."""
    from repro_torch.models import lm
    P = prompts.shape[1]
    logits, cache = lm.prefill(params, cfg, {"tokens": prompts})
    state = lm.decode_state_from_prefill(cfg, cache, P + gen_len + 1)
    logits = logits[:, -1]
    out, margins = [], []
    for i in range(gen_len):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        logits, state = lm.decode_step(params, cfg, state, tok, P + i)
    if return_margins:
        return torch.stack(out, dim=1), torch.stack(margins, dim=1)
    return torch.stack(out, dim=1)


def _full_width(cfg, dev, S, per_call, per_step, tag):
    """A full-width model on the card (seeded random weights, the float32
    master and its bf16 cast): lm.forward on 1 x S tokens, generate() on 4
    x 64-token prompts with 32 new tokens, and the margin rule in float32
    (prefill + decode from its cache against generate()) on two of them.
    Launch counters are zeroed before, and read after, the forward and the
    generate() run: the forward must launch exactly `per_call` and each
    decode step `per_step` ({kernel: launches}). Returns (record, the
    float32 master, the bf16 params)."""
    import numpy as np
    from repro_torch import convert, kernels
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    t0 = time.perf_counter()
    master = lm.init_params(0, cfg, device=dev)
    params = lm.cast_params(master, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = convert.param_count(master)
    gib = torch.cuda.memory_allocated() / 2**30
    kinds = lm.layer_kinds(cfg)
    print(f"[{tag}] {cfg.n_layers} layers "
          f"({', '.join(f'{kinds.count(k)} {k}' for k in sorted(set(kinds)))}"
          f"), {n_params} params, init + bf16 cast {init_s:.2f} s, "
          f"{gib:.1f} GiB allocated")
    rec = {"params": n_params, "init_s": init_s, "allocated_gib": gib}
    zero = {k: 0 for k in kernels.launch_counts()}

    g = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, S), device=dev, generator=g)
    with torch.inference_mode():
        lm.forward(params, cfg, {"tokens": toks[:, :64]})     # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = lm.forward(params, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    want = dict(zero, **per_call)
    print(f"[{tag}] forward 1 x {S}: logits {shape} finite={finite} in "
          f"{fwd_s * 1e3:.1f} ms; launches {counts}")
    if not finite or shape != (1, S, cfg.vocab_size):
        raise AssertionError(f"{tag}: full-width forward logits are not "
                             f"finite or misshapen")
    if counts != want:
        raise AssertionError(f"{tag}: forward launches {counts}, expected "
                             f"{want}")
    rec["forward"] = {"tokens": S, "ms": fwd_s * 1e3, "launches": counts}

    B, P, N = 4, 64, 32
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                            generator=g)
    generate(params, cfg, prompts[:, :2], 2, device=dev)     # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, margins = generate(params, cfg, prompts, N, device=dev,
                               return_margins=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    steps = P + N
    want = dict(zero, **{k: steps * v for k, v in per_step.items()})
    gen = {"batch": B, "prompt": P, "new": N, "decode_steps": steps,
           "seconds": gen_s, "tokens_per_s": B * N / gen_s,
           "ms_per_step": gen_s * 1e3 / steps, "launches": counts,
           "margin_median": float(margins.float().median())}
    print(f"[{tag}] generate() {B} x {P} + {N}: {gen_s:.2f} s, "
          f"{gen['tokens_per_s']:.1f} tokens/s, {gen['ms_per_step']:.2f} ms "
          f"per decode step ({steps} steps); launches {counts}")
    if counts != want:
        raise AssertionError(f"{tag}: generate() launches {counts}, expected "
                             f"{want} ({steps} steps x {per_step})")
    if tokens.shape != (B, N) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{tag}: generate() tokens misshapen or out of "
                             f"range")
    rec["generate"] = gen

    # the margin rule in float32: prefill + decode from its cache against
    # generate() on the same two prompts
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p2 = prompts[:2]
    ref_t, ref_m = generate(master, cfg32, p2, N, device=dev,
                            return_margins=True)
    with torch.inference_mode():
        got_t = _greedy_from_prefill(master, cfg32, p2, N)
    rows = []
    for r in range(2):
        a, b = got_t[r].cpu().numpy(), ref_t[r].cpu().numpy()
        i = _first_divergence(a, b)
        gap = None if i is None else float(ref_m[r, i])
        rows.append({"row": r, "first_divergence": i, "margin": gap})
        if i is not None and gap > MARGIN_BOUND_F32:
            raise AssertionError(
                f"{tag} row {r}: prefill + decode and generate() diverge at "
                f"token {i} where generate()'s top-1/top-2 margin is "
                f"{gap:.5f} > {MARGIN_BOUND_F32}")
    m32 = ref_m.float().cpu().numpy().ravel()
    rec["margin_rule_f32"] = {"rows": rows, "bound": MARGIN_BOUND_F32,
                              "generate_margin_median": float(np.median(m32)),
                              "generate_margin_min": float(m32.min())}
    print(f"[{tag}] float32 prefill + decode vs generate() (2 x {P} + {N}): "
          f"first divergences {[x['first_divergence'] for x in rows]} "
          f"(margin bound {MARGIN_BOUND_F32}); generate() gaps median "
          f"{np.median(m32):.4f}, min {m32.min():.2e}")
    return rec, master, params


def phase_recurrentgemma(dev):
    """Full-width recurrentgemma-2b (26 layers: 18 RG-LRU, 8 attn_local
    with window 2048; d_model 2560, 10 heads over 1 KV head, head_dim 256,
    vocab 256000) through _full_width: lm.forward on 1 x 2304 tokens (past
    the window), generate() and the margin rule. Returns (record, the
    float32 master, the bf16 params) for the engine phase."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("recurrentgemma-2b")
    kinds = lm.layer_kinds(cfg)
    n_rec, n_attn = kinds.count("rec"), kinds.count("attn_local")
    return _full_width(
        cfg, dev, 2304, {"rglru_scan": n_rec, "flash_attention": n_attn},
        {"rglru_scan": n_rec, "paged_attention": n_attn}, "recurrentgemma")


def _first_token_logits(params, cfg, prompts):
    """The first token's logits (the last prompt position's) after
    lm.prefill and after priming lm.decode_step token by token, float32
    (B, V) each."""
    from repro_torch.models import lm
    B, P = prompts.shape
    with torch.inference_mode():
        logits, _ = lm.prefill(params, cfg, {"tokens": prompts})
        pf = logits[:, -1].float()
        state = lm.init_decode_state(cfg, B, P + 1, device=prompts.device)
        for pos in range(P):
            st, state = lm.decode_step(params, cfg, state, prompts[:, pos],
                                       pos)
    return pf, st.float()


def _bf16_gaps(master, cfg, prompts):
    """bf16 against float32 and bf16 prefill against bf16 stepwise decode
    on the first token's logits, as the port runs (the float32 master in
    float32, its bf16 cast in bf16)."""
    f_pf, f_st = _first_token_logits(
        master, dataclasses.replace(cfg, dtype="float32"), prompts)
    from repro_torch.models import lm
    b_pf, b_st = _first_token_logits(lm.cast_params(master, cfg), cfg,
                                     prompts)
    return {"bf16_prefill_vs_stepwise": (b_pf - b_st).abs().max().item(),
            "bf16_vs_float32_prefill": (b_pf - f_pf).abs().max().item(),
            "bf16_vs_float32_stepwise": (b_st - f_st).abs().max().item(),
            "float32_prefill_vs_stepwise": (f_pf - f_st).abs().max().item(),
            "float32_max_abs_logit": f_pf.abs().max().item(),
            "bf16_argmax_equals_float32":
            (b_pf.argmax(-1) == f_pf.argmax(-1)).tolist()}


def _np_prompts(seed, vocab, dev, shape=(2, 64)):
    """Prompts drawn as benchmarks/torch_rwkv6_bf16_reference.py draws the
    JAX package's: numpy.random.default_rng(seed)."""
    import numpy as np
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, vocab, shape), device=dev)


def phase_rwkv6(dev):
    """Full-width rwkv6-3b (32 RWKV6 layers: d_model 2560, 40 heads of 64,
    d_ff 8960, vocab 65536; 3.07 B params) through _full_width: lm.forward
    on 1 x 2048 tokens, generate() and the margin rule; then, as a record
    with no bound, the bf16 gaps of the first token's logits at 32 layers
    beside JAX's. Returns (record, the float32 master, the bf16 params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("rwkv6-3b")
    n = lm.layer_kinds(cfg).count("rwkv")
    rec, master, params = _full_width(cfg, dev, 2048, {"rwkv6_scan": n},
                                      {"rwkv6_scan": n}, "rwkv6")
    # bf16 at 32 layers: a record, not a check (the reference's own gap is
    # a large share of its logits at this depth)
    b32 = _bf16_gaps(master, cfg, _np_prompts(0, cfg.vocab_size, dev))
    torch.cuda.empty_cache()
    b32["jax"] = JAX_BF16_32_LAYERS
    rec["bf16_record_32_layers"] = b32
    print(f"[rwkv6] record, not a check: at 32 layers (seed 0, 2 x 64) the "
          f"first-token logits move in bf16 by "
          f"{b32['bf16_vs_float32_prefill']:.3f} after prefill and "
          f"{b32['bf16_vs_float32_stepwise']:.3f} after stepwise decode "
          f"against float32 (JAX: "
          f"{JAX_BF16_32_LAYERS['bf16_vs_float32_prefill']:.3f} and "
          f"{JAX_BF16_32_LAYERS['bf16_vs_float32_stepwise']:.3f}), bf16 "
          f"prefill vs stepwise {b32['bf16_prefill_vs_stepwise']:.4f} (JAX: "
          f"{JAX_BF16_32_LAYERS['bf16_prefill_vs_stepwise']:.4f}), float32 "
          f"prefill vs stepwise {b32['float32_prefill_vs_stepwise']:.2e}; "
          f"float32 max |logit| {b32['float32_max_abs_logit']:.3f} (JAX: "
          f"{JAX_BF16_32_LAYERS['float32_max_abs_logit']:.3f})")
    return rec, master, params


def phase_rwkv6_4_layers(dev):
    """The bf16 gate, fixed before the port's numbers were seen: rwkv6-3b at
    full width cut to 4 layers, seeds 0, 1, 2 (weights lm.init_params(seed),
    which are JAX's init_params(PRNGKey(seed)) weights, the ones
    JAX_BF16_4_LAYERS was measured on; prompts 2 x 64 from
    numpy.random.default_rng(seed)), the first token's
    logits as the port runs. For every seed, bf16 prefill vs bf16 stepwise
    decode <= RWKV_BF16_GAP_BOUND and bf16 vs float32 (after prefill and
    after stepwise decode) <= RWKV_BF16_DRIFT_BOUND."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=4)
    rec = {"bounds": {"bf16_prefill_vs_stepwise": RWKV_BF16_GAP_BOUND,
                      "bf16_vs_float32": RWKV_BF16_DRIFT_BOUND},
           "jax": JAX_BF16_4_LAYERS, "seeds": {}}
    for seed in (0, 1, 2):
        master = lm.init_params(seed, cfg, device=dev)
        r = _bf16_gaps(master, cfg, _np_prompts(seed, cfg.vocab_size, dev))
        del master
        torch.cuda.empty_cache()
        rec["seeds"][seed] = r
        j = JAX_BF16_4_LAYERS[seed]
        drift = max(r["bf16_vs_float32_prefill"],
                    r["bf16_vs_float32_stepwise"])
        ok = (r["bf16_prefill_vs_stepwise"] <= RWKV_BF16_GAP_BOUND
              and drift <= RWKV_BF16_DRIFT_BOUND)
        print(f"[rwkv6_4_layers] seed {seed}, first-token logits (2 x 64): "
              f"bf16 prefill vs stepwise {r['bf16_prefill_vs_stepwise']:.4f} "
              f"(bound {RWKV_BF16_GAP_BOUND}; JAX "
              f"{j['bf16_prefill_vs_stepwise']}); bf16 vs float32 "
              f"{r['bf16_vs_float32_prefill']:.4f} after prefill, "
              f"{r['bf16_vs_float32_stepwise']:.4f} after stepwise decode "
              f"(bound {RWKV_BF16_DRIFT_BOUND}; JAX "
              f"{j['bf16_vs_float32_prefill']:.4f} / "
              f"{j['bf16_vs_float32_stepwise']:.4f}); float32 prefill vs "
              f"stepwise {r['float32_prefill_vs_stepwise']:.2e}; bf16 greedy "
              f"token equals float32's on rows "
              f"{r['bf16_argmax_equals_float32']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"seed {seed}: bf16 gaps {r} past the "
                                 f"bounds {rec['bounds']}")
    return rec


def _full_width_stream(vocab, logprobs=0):
    """The recurrent engine phases' stream: six prompts of 32-160 tokens
    and one of 2300 (past the 2048-token default prefill chunk, so it is
    admitted in two chunks while the others decode, and it decodes past
    recurrentgemma-2b's 2048-token window), 16 new tokens each, all at t =
    0, prompts from numpy.random.default_rng(5)."""
    import numpy as np
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams
    rng = np.random.default_rng(5)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=16,
                    sampling=SamplingParams(logprobs=logprobs))
            for i, n in enumerate((32, 96, 160, 2300, 32, 96, 160))]


def _prefill_refs(params, cfg, reqs, dev):
    """{rid: (the reference's tokens, its top-1/top-2 gaps)}: greedy
    decode from lm.prefill's dense cache (_greedy_from_prefill, held to
    generate() under the float32 margin rule in _full_width), the prompts
    of one length in one batch. generate() primes its cache a token at a
    time, which for the 2300-token prompt took over a minute a model."""
    import numpy as np
    groups = {}
    for r in reqs:
        groups.setdefault((len(r.prompt), r.max_new_tokens), []).append(r)
    out = {}
    for (_, n), rs in groups.items():
        prompts = torch.as_tensor(np.stack([r.prompt for r in rs]),
                                  device=dev)
        toks, margins = _greedy_from_prefill(params, cfg, prompts, n,
                                             return_margins=True)
        for i, r in enumerate(rs):
            out[r.rid] = (toks[i].cpu().numpy(),
                          margins[i].float().cpu().numpy())
    return out


def phase_engine_recurrent(master, params, cfg, dev, tag):
    """A full-width recurrent model (phase 7's or 8's weights) through
    ServingEngine with 4 slots, block 16, max_seq_len 2560, on
    _full_width_stream: in float32 (every completion under the float32
    margin rule against float32 greedy decode from lm.prefill's cache,
    _prefill_refs), in float32 at speculate=4 with partial scripted drafts
    (scripts from the reference's tokens), and
    in bf16 (tokens/s, TTFT, TPOT; every request completes with finite
    logprobs and every block returns). Launch counters are zeroed before
    each run and read after it: per dispatch, each attention layer
    launches paged_prefill (prefill, verify) or paged_attention (decode),
    each recurrent layer its scan; rwkv6 verifies launch rwkv6_scan with
    return_states. Returns (record, launches summed over the runs)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.kernels import rwkv6_scan
    from repro_torch.models import lm
    from repro_torch.serving.engine import (ServingEngine, summarize,
                                            synthetic_requests)
    V = cfg.vocab_size
    kinds = lm.layer_kinds(cfg)
    n_attn = kinds.count("attn") + kinds.count("attn_local")
    n_rec, n_rwkv = kinds.count("rec"), kinds.count("rwkv")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    kw = dict(num_slots=4, block_size=16, max_seq_len=2560, device=dev)
    totals = {k: 0 for k in kernels.launch_counts()}

    def run(eng, name, logprobs=0):
        eng.run(synthetic_requests(2, vocab_size=V, prompt_len=(20, 40),
                                   max_new=(3, 3), seed=9))   # warm-up
        torch.cuda.synchronize()
        free0 = eng.allocator.num_free
        reqs = _full_width_stream(V, logprobs)
        kernels.reset_launch_counts()
        done = sorted(eng.run(reqs), key=lambda c: c.rid)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        stats = summarize(done, eng.wall_time, eng)
        prefills = stats["prefill"]["dispatches"]
        verifies = (stats.get("speculation") or {}).get(
            "verify_dispatches", 0)
        want = {"paged_prefill": n_attn * (prefills + verifies),
                "paged_attention": n_attn * (eng.steps - verifies),
                "flash_attention": 0, "flash_attention_bwd": 0,
                "svrg_update": 0,
                "rglru_scan": n_rec * (prefills + eng.steps),
                "rwkv6_scan": n_rwkv * (prefills + eng.steps)}
        stats.update(launches=counts, decode_or_verify_steps=eng.steps,
                     rwkv6_scan_with_states=rwkv6_scan.state_launches)
        print(f"[{tag}] {name}: {stats['requests']} requests, "
              f"{stats['generated_tokens']} tokens in {stats['wall_s']} s, "
              f"{stats['tokens_per_s']} tokens/s, ttft p50 "
              f"{stats['ttft_p50_ms']} ms p99 {stats['ttft_p99_ms']} ms, "
              f"tpot p50 {stats['tpot_p50_ms']} ms; {prefills} prefill, "
              f"{verifies} verify, {eng.steps - verifies} decode dispatches; "
              f"prefill shapes {sorted(eng.runner.prefill_shapes)}; "
              f"launches {counts}"
              + (f", {rwkv6_scan.state_launches} rwkv6_scan with states"
                 if n_rwkv else ""))
        if counts != want:
            raise AssertionError(f"{tag} {name}: launches {counts}, expected "
                                 f"{want} from the dispatch counts")
        if n_rwkv and rwkv6_scan.state_launches != n_rwkv * verifies:
            raise AssertionError(f"{tag} {name}: {rwkv6_scan.state_launches} "
                                 f"rwkv6_scan launches with states, expected "
                                 f"{n_rwkv * verifies}")
        if len(done) != len(reqs) or eng.allocator.num_free != free0:
            raise AssertionError(f"{tag} {name}: {len(done)} of {len(reqs)} "
                                 f"requests completed, "
                                 f"{free0 - eng.allocator.num_free} blocks "
                                 f"not returned")
        if (1, 2048) not in eng.runner.prefill_shapes:
            raise AssertionError(f"{tag} {name}: the 2300-token prompt was "
                                 f"not admitted in 2048-token chunks")
        for c in done:
            if len(c.tokens) != 16 or not bool(((c.tokens >= 0)
                                                & (c.tokens < V)).all()):
                raise AssertionError(f"{tag} {name}: request {c.rid}'s "
                                     f"tokens misshapen or out of range")
        for k in totals:
            totals[k] += counts[k]
        return reqs, done, stats

    rec = {"stream": {"prompts": [32, 96, 160, 2300, 32, 96, 160],
                      "new_tokens": 16, "slots": 4, "block_size": 16,
                      "max_seq_len": 2560, "prefill_chunk": 2048}}
    eng = ServingEngine(master, cfg32, **kw)
    reqs, done, stats = run(eng, "float32")
    del eng
    t0 = time.perf_counter()
    with torch.inference_mode():
        refs = _prefill_refs(master, cfg32, reqs, dev)
    gen_s = time.perf_counter() - t0
    rule = _margin_rule(done, refs, MARGIN_BOUND_F32, f"{tag} float32")
    print(f"[{tag}] float32 engine vs float32 prefill + decode "
          f"({gen_s:.1f} s): "
          f"{rule['exact']}/{rule['requests']} exact; divergences within "
          f"the bound {MARGIN_BOUND_F32}: "
          f"{[(d['rid'], d['at'], d['margin']) for d in rule['diverged_within_bound']]}")
    rec["float32"] = {"stats": stats, "vs_prefill_decode": rule,
                      "reference_seconds": gen_s}

    eng = ServingEngine(master, cfg32, speculate=4, **kw)
    eng.scheduler._proposers = [ScriptedProposer(
        _scripts(reqs, {r: t for r, (t, _) in refs.items()}),
        V)] * eng.num_slots
    _, done, stats = run(eng, "float32 speculate=4 partial drafts")
    sched = eng.scheduler
    del eng
    rule = _margin_rule(done, refs, MARGIN_BOUND_F32,
                        f"{tag} float32 speculate=4")
    spec = stats.get("speculation") or {}
    print(f"[{tag}] float32 speculate=4 vs float32 prefill + decode: "
          f"{rule['exact']}/{rule['requests']} exact; proposed "
          f"{sched.proposed_tokens}, accepted {sched.accepted_tokens}")
    if not spec.get("verify_dispatches") or not (
            0 < sched.accepted_tokens < sched.proposed_tokens):
        raise AssertionError(f"{tag}: the partial drafts were not verified "
                             f"and partly accepted ({spec})")
    rec["float32_speculate4"] = {"stats": stats, "vs_prefill_decode": rule,
                                 "proposed": sched.proposed_tokens,
                                 "accepted": sched.accepted_tokens}
    torch.cuda.empty_cache()

    eng = ServingEngine(params, cfg, **kw)
    _, done, stats = run(eng, "bf16", logprobs=1)
    del eng
    torch.cuda.empty_cache()
    lps = np.concatenate([c.logprobs for c in done])
    if not (np.isfinite(lps).all() and (lps <= 0).all()):
        raise AssertionError(f"{tag} bf16: logprobs not finite or positive")
    rec["bf16"] = {"stats": stats}
    return rec, totals


# ----------------------------------------------------------------------------
# MoE: reduced grok-1-314b / llama4 card vs CPU, and full-width grok-1-314b
# (2 layers) through the engine
# ----------------------------------------------------------------------------

def _margin_run(eng, reqs):
    """eng.run(reqs), with every emitted token's routing margin: the
    smallest k-th minus (k+1)-th router probability of any MoE decision
    made for its request up to the step that emitted it (moe.tally with
    margins around each dispatch; a row or lane is known by the
    scheduler's slot, an admission's row by its prompt). Returns (completions
    by rid, {rid: [margin per emitted token]})."""
    import numpy as np
    from repro_torch.models import moe
    rid_of = {r.prompt.tobytes(): r.rid for r in reqs}
    runner, sched = eng.runner, eng.scheduler
    orig = {n: getattr(runner, n) for n in ("prefill", "decode", "verify")}
    step_min = {}

    def wrap(name, rids_of):
        def call(*a, **kw):
            rids = rids_of(*a)
            with moe.tally(margins=True) as t:
                out = orig[name](*a, **kw)
            if t.row_margins:
                m = torch.stack(t.row_margins).amin(0).tolist()
                for rid, v in zip(rids, m):
                    if rid is not None:
                        step_min[rid] = min(step_min.get(rid, math.inf), v)
            return out
        return call

    def lanes(*_):
        return [None if s is None else s.req.rid for s in sched._slots]

    def rows(rows):
        # a chunk's row holds its prompt up to the chunk's end, in a slot
        # the scheduler has already given it; a whole prompt's slot is
        # taken once the dispatch returns
        return [rid_of[np.asarray(r.tokens, np.int32).tobytes()]
                if sched._slots[r.slot] is None
                else sched._slots[r.slot].req.rid for r in rows]

    runner.prefill = wrap("prefill", rows)
    runner.decode = wrap("decode", lanes)
    runner.verify = wrap("verify", lanes)
    margins, run_min = {r.rid: [] for r in reqs}, {}
    try:
        for r in reqs:
            eng.submit(r)
        eng.begin_run()
        while eng.has_work:
            step_min.clear()
            eng.step()
            now = {s.req.rid: len(s.out) for s in sched._slots
                   if s is not None}
            now.update({c.rid: len(c.tokens) for c in sched.completions})
            for rid, n in now.items():
                run_min[rid] = min(run_min.get(rid, math.inf),
                                   step_min.get(rid, math.inf))
                margins[rid] += [run_min[rid]] * (n - len(margins[rid]))
    finally:
        for n, fn in orig.items():
            setattr(runner, n, fn)
    done = {c.rid: c for c in sched.completions}
    sched.completions = []
    return done, margins


def phase_small_moe(dev):
    """The reduced float32 grok-1-314b (4 experts, top-2) and llama4 (16
    experts, top-1) through ServingEngine (4 slots, block 4, prefix cache,
    chunks of 16) on the card against the same engine on the CPU: a mixed
    stream (a shared prefix, chunked 18- and 30-token prompts; prefills
    drop assignments past capacity), and for grok also speculate=4 on a
    repetitive stream. Tokens equal up to a divergence where the CPU's
    routing margin for that request so far, or its top-1/top-2 logit gap
    at the token, is <= MARGIN_BOUND_F32; every block back."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.device import to_device
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampling import SamplingParams
    kw = dict(num_slots=4, block_size=4, max_seq_len=64, prefill_chunk=16,
              prefix_cache=True)
    rec = {}
    for tag, cfg in (("grok", get_config("grok-1-314b").reduced()),
                     ("llama4", get_config("llama4-maverick-400b-a17b")
                      .reduced(n_experts=16))):
        params = lm.init_params(0, cfg, device="cpu")
        cuda_params = to_device(params, dev)
        V = cfg.vocab_size
        rng = np.random.default_rng(11)
        prefix = rng.integers(0, V, 12).astype(np.int32)
        mixed = [rng.integers(0, V, n).astype(np.int32)
                 for n in (9, 15, 30, 3)]
        mixed[1:1] = [np.concatenate([prefix, rng.integers(0, V, n)
                                      .astype(np.int32)]) for n in (4, 6)]
        pattern = rng.integers(0, V, 4).astype(np.int32)
        streams = [("mixed", 0, mixed)]
        if tag == "grok":
            streams.append(("repetitive", 4, [np.tile(pattern, 5)[:n]
                                              for n in (14, 18, 11)]))
        for name, spec, prompts in streams:
            runs = {}
            for where, p_ in (("cpu", params), ("cuda", cuda_params)):
                eng = ServingEngine(p_, cfg, speculate=spec,
                                    device="cpu" if where == "cpu" else dev,
                                    **kw)
                free0 = eng.allocator.num_free
                runs[where] = _margin_run(eng, [
                    Request(rid=i, prompt=p, max_new_tokens=12,
                            sampling=SamplingParams(logprobs=2))
                    for i, p in enumerate(prompts)])
                if eng.allocator.num_free != free0:
                    raise AssertionError(f"small_moe {tag} {name} "
                                         f"({where}): blocks not returned")
            (cpu, margins), (card, _) = runs["cpu"], runs["cuda"]
            exact, excused = 0, []
            for rid, c in sorted(cpu.items()):
                i = _first_divergence(card[rid].tokens, c.tokens)
                if i is None:
                    exact += 1
                    continue
                top = c.top_logprobs[i]
                gap = float(top[0] - top[1])
                excused.append({"rid": rid, "at": i, "logit_gap": gap,
                                "routing_margin": margins[rid][i]})
                if min(gap, margins[rid][i]) > MARGIN_BOUND_F32:
                    raise AssertionError(
                        f"small_moe {tag} {name}: request {rid} leaves the "
                        f"CPU's tokens at {i}, where the CPU's logit gap is "
                        f"{gap:.3g} and its routing margin so far "
                        f"{margins[rid][i]:.3g} (bound {MARGIN_BOUND_F32})")
            low = sum(m <= MARGIN_BOUND_F32 for ms in margins.values()
                      for m in ms)
            total = sum(len(ms) for ms in margins.values())
            rec[f"{tag}_{name}"] = {
                "requests": len(cpu), "speculate": spec, "exact": exact,
                "diverged_within_bound": excused,
                "tokens_after_a_small_routing_margin": [low, total]}
            print(f"[small_moe] {tag} {name} (speculate {spec}): engine "
                  f"cuda vs cpu {exact}/{len(cpu)} exact, divergences "
                  f"within the bound {excused}; {low} of {total} tokens "
                  f"follow a routing margin <= {MARGIN_BOUND_F32}")
    return rec


# full-width grok-1-314b, the depth cut to 2 layers, through the engine
MOE_ARCH = "grok-1-314b"
MOE_LAYERS = 2
MOE_KW = dict(num_slots=8, block_size=16, max_seq_len=256,
              prefix_cache=True)


def _moe_requests(V):
    """Arm (a)'s stream: 16 requests at t = 0, 4 each of 16 / 32 / 64 / 128
    tokens (each length a bucket of its own; lengths interleaved), 16 new
    tokens, prompts from numpy.random.default_rng(0)."""
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, V, n).astype(np.int32),
                    max_new_tokens=16)
            for i, n in enumerate((16, 32, 64, 128) * 4)]


def _weight_read_bytes(params):
    """Bytes of weights one decode step reads: every tensor but the
    embedding table (of which it reads a row a lane). Each expert stack is
    read whole, since every expert computes its capacity slots."""
    from repro_torch.tree import tree_leaves
    e = params["embed"]
    return (sum(t.numel() * t.element_size() for t in tree_leaves(params))
            - e.numel() * e.element_size())


def phase_engine_moe(dev):
    """Full-width grok-1-314b (d_model 6144, 48 / 8 heads of 128, 8
    experts of d_ff 32768, top-2, vocab 131072, bf16) with its depth cut
    to 2 layers, JAX's seed-0 weights drawn by lm.init_params on the card
    (timed), through ServingEngine (8 slots, block 16, max_seq_len 256,
    speculate 0, prefix cache on). (a) The identity arm (_moe_requests)
    under the bf16 margin rule against lm.prefill at each prompt's own
    length (one batch a length) and lm.decode_step (_prefill_refs); the
    token-expert assignments each dropped; tokens/s, TTFT, TPOT; both
    paged kernels launched once per layer per dispatch. (b) The
    shared-prefix arm: 8 requests on one 64-token prefix with 16-token
    suffixes, whose prefix hits route only the suffix: tokens exact /
    diverged against the same reference route, drops; every block back.
    Returns (record, the engine, the params) for the decode profile."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import lm, moe
    from repro_torch.serving.engine import (ServingEngine,
                                            shared_prefix_requests,
                                            summarize, synthetic_requests)
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    weight_bytes = _weight_read_bytes(params)
    print(f"[engine_moe] {cfg.name} at {cfg.n_layers} layers: {n_params:,} "
          f"params, {n_bytes / 2**30:.2f} GiB, drawn by lm.init_params on "
          f"the card in {init_s:.1f} s")
    V = cfg.vocab_size
    eng = ServingEngine(params, cfg, device=dev, **MOE_KW)
    eng.run(synthetic_requests(2, vocab_size=V, prompt_len=(20, 40),
                               max_new=(4, 4), seed=9))      # warm-up
    eng.reset_prefix_cache()
    torch.cuda.synchronize()
    free0 = eng.allocator.num_free
    rec = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                      "params": n_params, "param_bytes": n_bytes,
                      "init_s": init_s,
                      "weight_read_bytes_per_step": weight_bytes}}
    launches = {}
    arms = (("identity", _moe_requests(V)),
            ("shared_prefix", shared_prefix_requests(
                8, vocab_size=V, prefix_len=64, suffix_len=16,
                max_new=(16, 16), seed=1)))
    for name, reqs in arms:
        kernels.reset_launch_counts()
        with moe.tally() as t:
            done = eng.run(reqs)
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assigned, dropped = t.read()
        stats = summarize(done, eng.wall_time, eng)
        prefills = stats["prefill"]["dispatches"]
        want = {"paged_prefill": cfg.n_layers * prefills,
                "paged_attention": cfg.n_layers * eng.steps,
                "flash_attention": 0, "flash_attention_bwd": 0,
                "svrg_update": 0, "rglru_scan": 0, "rwkv6_scan": 0}
        if counts != want:
            raise AssertionError(f"engine_moe {name}: launches {counts}, "
                                 f"expected {want} from the dispatches")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if len(done) != len(reqs) or eng.allocator.num_free != free0:
            raise AssertionError(f"engine_moe {name}: {len(done)} of "
                                 f"{len(reqs)} completed, "
                                 f"{eng.allocator.num_free} of {free0} "
                                 f"blocks free")
        # the reference route: its lm.prefill launches flash_attention,
        # its decode_step paged_attention over the dense cache
        kernels.reset_launch_counts()
        with moe.tally() as rt:
            refs = _prefill_refs(params, cfg, reqs, dev)
        ref_counts = kernels.launch_counts()
        r_assigned, r_dropped = rt.read()
        if name == "identity":
            vs = _margin_rule(done, refs, MARGIN_BOUND,
                              "engine_moe vs lm.prefill + decode_step")
            for k in ("flash_attention", "paged_attention"):
                launches[k] += ref_counts[k]
        else:
            vs = {"requests": len(done), "exact": sum(
                _first_divergence(c.tokens, refs[c.rid][0]) is None
                for c in done)}
        gaps = np.concatenate([refs[c.rid][1] for c in done])
        stats.update(launches=counts, reference_launches=ref_counts,
                     decode_steps=eng.steps,
                     drops={"assigned": assigned, "dropped": dropped,
                            "share": dropped / assigned},
                     reference_drops={"assigned": r_assigned,
                                      "dropped": r_dropped,
                                      "share": r_dropped / r_assigned},
                     vs_reference=vs,
                     reference_gap_median=float(np.median(gaps)))
        rec[name] = stats
        within = [(d["rid"], d["at"], round(d["margin"], 4))
                  for d in vs.get("diverged_within_bound", [])]
        print(f"[engine_moe] {name}: {stats['requests']} requests, "
              f"{stats['generated_tokens']} tokens, {stats['tokens_per_s']} "
              f"tokens/s, ttft p50 {stats['ttft_p50_ms']} ms p99 "
              f"{stats['ttft_p99_ms']} ms, tpot p50 {stats['tpot_p50_ms']} "
              f"ms; prefix hits {stats['prefix_cache']['hit_requests']}; "
              f"{prefills} prefill, {eng.steps} decode dispatches; launches "
              f"{counts}; dropped {dropped} of {assigned} token-expert "
              f"assignments ({dropped / assigned:.2%}; the reference route "
              f"{r_dropped} of {r_assigned}); vs lm.prefill + decode_step "
              f"{vs['exact']}/{vs['requests']} exact"
              + (f", divergences within the bound (request, token, gap) "
                 f"{within}" if name == "identity" else "")
              + f"; the reference's median top-1/top-2 gap "
                f"{np.median(gaps):.4f}")
    if rec["identity"]["reference_gap_median"] <= MARGIN_BOUND:
        raise AssertionError(f"engine_moe: the reference's median gap "
                             f"{rec['identity']['reference_gap_median']} "
                             f"is not above the margin bound {MARGIN_BOUND}")
    rec["launches"] = launches
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print(f"[engine_moe] peak torch.cuda.max_memory_allocated "
          f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB; weights a decode "
          f"step reads {weight_bytes / 1e9:.3f} GB, "
          f"{weight_bytes / PEAK_BYTES_S * 1e3:.3f} ms at "
          f"{PEAK_BYTES_S / 1e12} TB/s")
    return rec, eng, params


def profile_moe_decode(eng, params):
    """profile_decode of engine_moe's engine (8 lanes decoding 128-token
    prompts) beside the step's weight-read bound."""
    rec = profile_decode(eng, eng.cfg.vocab_size)
    nbytes = _weight_read_bytes(params)
    rec["weight_read_bound_ms"] = nbytes / PEAK_BYTES_S * 1e3
    rec["weight_read_bytes"] = nbytes
    print(f"[profile] {eng.cfg.name} ({eng.cfg.n_layers} layers) decode "
          f"step's weight-read bound: {nbytes / 1e9:.3f} GB in "
          f"{rec['weight_read_bound_ms']:.3f} ms, "
          f"{rec['weight_read_bound_ms'] / rec['device_busy_ms_per_step']:.1%}"
          f" of the device-busy {rec['device_busy_ms_per_step']:.3f} ms; "
          f"wall {rec['wall_ms_per_step']:.2f} ms")
    return rec


def profile_lm_decode(params, cfg, dev, n_steps=4):
    """Where one full-width decode step's time goes (recurrentgemma-2b,
    rwkv6-3b): 4 lanes at position 100 (8 warm-up steps first), n_steps
    lm.decode_step calls under torch.profiler. Wall and device-busy ms per
    step, the idle share, kernel launches per step and the top kernels by
    device time."""
    from repro_torch.models import lm
    B, start = 4, 100
    # room for three profiled windows (_profiled)
    state = lm.init_decode_state(cfg, B, start + 8 + 3 * n_steps + 1,
                                 device=dev)
    tok = torch.zeros(B, dtype=torch.int32, device=dev)
    pos = start

    def steps(n):
        nonlocal state, tok, pos
        t0 = time.perf_counter()
        for _ in range(n):
            logits, state = lm.decode_step(params, cfg, state, tok, pos)
            tok = torch.argmax(logits, -1).to(torch.int32)
            pos += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / max(n, 1)

    with torch.inference_mode():
        steps(8)
        kern, wall = _profiled(lambda: steps(n_steps))
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / n_steps
    launches = sum(e.count for e in kern) / n_steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    out = {"batch": B, "position": start + 8, "wall_ms_per_step": wall,
           "device_busy_ms_per_step": busy, "idle_share": 1.0 - busy / wall,
           "kernel_launches_per_step": launches,
           "top_kernels": [{"name": e.key[:80], "ms_per_step":
                            e.self_device_time_total / 1e3 / n_steps,
                            "calls_per_step": e.count / n_steps}
                           for e in top]}
    print(f"[profile] {cfg.name} decode step (4 lanes): wall {wall:.2f} "
          f"ms, device busy {busy:.3f} ms (idle {out['idle_share']:.1%}), "
          f"{launches:.0f} kernel launches per step")
    for t in out["top_kernels"]:
        print(f"[profile]   {t['ms_per_step']:.4f} ms x "
              f"{t['calls_per_step']:.0f}  {t['name']}")
    return out


def phase_serve_cli(dev, arch):
    """The naive serve CLI once at full width (its own seeded params)."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    serve.main(["--arch", arch, "--full-width", "--mode", "naive", "--batch",
                "2", "--prompt-len", "16", "--max-new", "8", "8", "--device",
                str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"[serve_cli] {arch} --full-width --mode naive: {secs:.1f} s")
    return {"seconds": secs}


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


def _interleaved(make, lengths, per, seed, **kw):
    """`per` requests of `make` (a workload generator) at each prompt
    length, interleaved (one of each length in turn), rids 0 .. n-1."""
    groups = [make(per, prompt_len=n, seed=seed + i, **kw)
              for i, n in enumerate(lengths)]
    out = [g[j] for j in range(per) for g in groups]
    for i, r in enumerate(out):
        r.rid = i
    return out


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
    # generate(), the streams' reference, primes its cache a token at a
    # time, so the prompts and new tokens are cut to a third of the
    # tokens they had (32-256 / 160 + 8-64 / 48-96 prompts, 32 new) to
    # keep the script inside its clock; and the prompts take a few
    # lengths, interleaved, so that generate() checks each length's
    # requests as one batch (check_against_generate)
    streams = [
        ("synthetic", {}, _interleaved(
            synthetic_requests, (16, 40, 64, 96), 4, vocab_size=V,
            max_new=(16, 16), seed=0)),
        ("shared_prefix", {}, shared_prefix_requests(
            8, vocab_size=V, prefix_len=64, suffix_len=20,
            max_new=(16, 16), seed=1)),
        ("repetitive_speculate4", {"speculate": 4}, _interleaved(
            repetitive_requests, (24, 48), 2, vocab_size=V, period=6,
            max_new=(16, 16), seed=2)),
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
                "flash_attention": 0, "flash_attention_bwd": 0,
                "svrg_update": 0, "rglru_scan": 0, "rwkv6_scan": 0}
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
    # the sampled stream (temperature 0.8, top-k 50, top-p 0.95) on the
    # speculate=4 engine: every request completes, the paged kernels launch
    # per dispatch as in the greedy streams, and the sampler ran
    from repro_torch.serving.sampling import SamplingParams
    eng = engines[4]
    free0 = eng.allocator.num_free
    sreqs = repetitive_requests(8, vocab_size=V, period=6,
                                prompt_len=(48, 96), max_new=(32, 32), seed=3,
                                sampling=SamplingParams(temperature=0.8,
                                                        top_k=50, top_p=0.95,
                                                        seed=5))
    kernels.reset_launch_counts()
    sdone = eng.run(sreqs)
    torch.cuda.synchronize()
    scounts = kernels.launch_counts()
    sstats = summarize(sdone, eng.wall_time, eng)
    sverifies = sstats["speculation"]["verify_dispatches"]
    swant = {"paged_prefill": cfg.n_layers * (sstats["prefill"]["dispatches"]
                                              + sverifies),
             "paged_attention": cfg.n_layers * (eng.steps - sverifies),
             "flash_attention": 0, "flash_attention_bwd": 0,
             "svrg_update": 0, "rglru_scan": 0, "rwkv6_scan": 0}
    sstats.update(launches=scounts, decode_or_verify_steps=eng.steps,
                  sampled_dispatches=eng.runner.sampled_dispatches)
    print(f"[engine] sampled_speculate4 (temperature 0.8, top-k 50, top-p "
          f"0.95): {sstats['requests']} requests, "
          f"{sstats['generated_tokens']} tokens, {sstats['tokens_per_s']} "
          f"tokens/s, ttft p50 {sstats['ttft_p50_ms']} ms, tpot p50 "
          f"{sstats['tpot_p50_ms']} ms; {sverifies} verify, "
          f"{eng.steps - sverifies} decode dispatches, "
          f"{eng.runner.sampled_dispatches} of them sampled; proposed "
          f"{sstats['speculation']['proposed_tokens']}, accepted "
          f"{sstats['speculation']['accepted_tokens']}; launches {scounts}")
    if (scounts != swant or len(sdone) != len(sreqs)
            or eng.allocator.num_free != free0
            or eng.runner.sampled_dispatches == 0
            or any(len(c.tokens) != 32 for c in sdone)):
        raise AssertionError(f"sampled stream: launches {scounts} (expected "
                             f"{swant}), {len(sdone)} of {len(sreqs)} "
                             f"completed, {eng.runner.sampled_dispatches} "
                             f"sampled dispatches")
    launches = {k: sum(st["launches"][k] for _, _, _, st in results)
                + scounts[k] for k in results[0][3]["launches"]}
    steps = sum(st["decode_or_verify_steps"] for _, _, _, st in results)
    prefills = sum(st["prefill"]["dispatches"] for _, _, _, st in results)
    print(f"[engine] all streams: launches {launches}; {steps} decode/verify "
          f"steps, {prefills} prefill dispatches")
    record = {"launches": launches, "steps": steps,
              "prefill_dispatches": prefills, "streams": {},
              "sampled_speculate4": sstats}
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


class LogisticStream:
    """The App. E task (benchmarks/appendix_e_logistic.py) on the port's
    stream: paper-lsq's features, labels the signs of the teacher's margin
    with 5% of them flipped, all drawn from the caller's torch.Generator."""

    def __init__(self, dim, seed=0):
        from repro_torch.data.synthetic import LeastSquaresStream
        self.dim = dim
        self._base = LeastSquaresStream(dim=dim, noise=0.0, seed=seed)

    def sample(self, generator, n):
        X, _ = self._base.sample(generator, n)
        sign = torch.where(X @ self._base.w_star(X.device) >= 0, 1.0, -1.0)
        flip = torch.rand(n, generator=generator, device=X.device) < 0.05
        return X, torch.where(flip, -sign, sign)

    def sample_distributed(self, generator, m, b):
        X, y = self.sample(generator, m * b)
        return X.reshape(m, b, self.dim), y.reshape(m, b)

    def population_logloss(self, w, n_eval=32768):
        X, y = self.sample(torch.Generator(device=w.device).manual_seed(
            10**6), n_eval)
        return torch.logaddexp(torch.zeros((), device=w.device),
                               -y * (X @ w)).mean().item()


def _core_run(job, device):
    """One run of a core arm on `device` over the arm's replayed data:
    {seconds, iterates (MP-DANE's), w_avg, w_last, ledger, plan}."""
    import importlib
    from repro_torch.core import losses
    mod, name = job["fn"].split(":")
    kw = dict(job["kw"])
    if "loss" in kw:
        kw["loss"] = getattr(losses, kw["loss"])()
    data = [(X.to(device), y.to(device)) for X, y in job["data"]]
    stream = Replay(job["dim"], data)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = getattr(importlib.import_module(mod), name)(
        stream, job["spec"], *job["args"], device=device, **kw)
    if device != "cpu":
        torch.cuda.synchronize()
    plan = getattr(res, "plan", None)
    return {"seconds": time.perf_counter() - t0,
            "iterates": getattr(res, "iterates", None), "w_avg": res.w_avg,
            "w_last": res.w_last, "ledger": res.ledger.as_dict(),
            "plan": None if plan is None else dataclasses.asdict(plan)}


def _cpu_replica(job):
    """A core arm's run on the CPU, in a worker process (spawned: it
    imports this file anew), so the CPU replicas run beside the card's."""
    torch.set_num_threads(1)
    out = _core_run(job, "cpu")
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def _index_draws(seed, T, R, K, steps, n, device):
    """The example indices of the first DANE round of every outer step of
    run_mp_dane(seed=...), keys and draws on `device`: the reference's
    chain split(key, 3) -> ks, split(ks, R)[0], split(., K)[0], then
    randint(., (steps,), 0, n). (T, steps) int64."""
    from repro_torch import prng
    key, out = prng.PRNGKey(seed, device=device), []
    for _ in range(T):
        key, _, ks = prng.split(key, 3)
        kk = prng.split(prng.split(ks, R)[0], K)[0]
        out.append(prng.randint(kk, (steps,), 0, n))
    return torch.stack(out)


def _core_arms(dev, stream, spec, draws):
    """The inexact MP-DANE runs and the baselines, at the widths the
    paper's own drivers use, each with its data drawn on the card first
    (the same batches then replay to its CPU run):
      - quickstart (examples/quickstart.py: paper-lsq, m = 8, b = 128,
        the first 2 of its T = 8 `draws`, a cut of depth that keeps the
        script inside its clock): MP-DANE saga (the quickstart's eta_scale
        0.1) and prox_svrg (0.05, tests/test_core_distributed.py's), the
        plan's K, R and kappa; each within Thm 7's inexact rate bound at
        T = 2;
      - Figure 3 (benchmarks/fig3_convergence.py: d = 32, m = 4,
        n_local = 1024, b = 64 / 256 / 1024, T = 1024 / b): MP-DANE saga,
        K = 1 and 4, R = 1, kappa = 0, eta_scale 0.1 (each within Thm 7's
        bound), beside minibatch SGD on the same data;
      - Appendix E (benchmarks/appendix_e_logistic.py, the test's b = 512,
        T = 1): MP-DANE prox_svrg on logistic loss, K = 4, eta_scale 0.3,
        beside minibatch SGD with the logistic loss;
      - the baselines at tests/test_core_distributed.py's sizes and
        limits (d = 16): minibatch SGD (< 0.1), accelerated (< 0.15),
        single-machine SGD (< 0.05), DSVRG-ERM (< 0.05; svrg_update
        launched K x n / m times), EMSO (one round a step).
    Each arm: {name, fn, args, kw, spec, dim, data, check}, where check
    reads the card's result."""
    from repro_torch.core import losses, theory
    from repro_torch.data.synthetic import LeastSquaresStream
    arms = []
    dane = "repro_torch.core.mp_dane:run_mp_dane"
    base = "repro_torch.core.baselines:"

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def suboptimality(stream, limit):
        def check(res):
            sub = stream.population_suboptimality(res["w_avg"]).item()
            return {"population_suboptimality": sub, "limit": limit,
                    "ok": limit is None or sub <= limit}
        return check

    def spec_of(stream):
        L, beta = losses.loss_constants(*stream.sample(gen(1), 4096),
                                        radius=1.0)
        return theory.ProblemSpec(L=L, beta=beta, B=1.0, dim=stream.dim)

    draws = draws[:2]
    m, b, T = draws[0][0].shape[0], draws[0][0].shape[1], len(draws)
    thm7 = theory.rate_bound_weakly_convex(spec, m * b, T, exact=False)
    for solver, eta in (("saga", 0.1), ("prox_svrg", 0.05)):
        arms.append(dict(
            name=f"quickstart mp_dane {solver}", fn=dane, args=(m, b, T),
            kw=dict(local_solver=solver, eta_scale=eta), spec=spec,
            dim=spec.dim, data=draws, check=suboptimality(stream, thm7)))

    fig3 = LeastSquaresStream(dim=32, noise=0.1, seed=0)
    fspec = spec_of(fig3)
    for b in (64, 256, 1024):
        T = 1024 // b
        g = gen(0)
        data = [fig3.sample_distributed(g, 4, b) for _ in range(T)]
        bound = theory.rate_bound_weakly_convex(fspec, 4 * b, T, exact=False)
        for K in (1, 4):
            arms.append(dict(
                name=f"fig3 b={b} mp_dane saga K={K}", fn=dane,
                args=(4, b, T), kw=dict(K=K, R=1, kappa=0.0,
                                        local_solver="saga", eta_scale=0.1),
                spec=fspec, dim=32, data=data,
                check=suboptimality(fig3, bound)))
        arms.append(dict(name=f"fig3 b={b} minibatch_sgd",
                         fn=base + "run_minibatch_sgd", args=(4, b, T),
                         kw={}, spec=fspec, dim=32, data=data,
                         check=suboptimality(fig3, None)))

    logi = LogisticStream(32)
    lspec = theory.ProblemSpec(L=2.0, beta=0.5, B=2.0, dim=32)
    data = [logi.sample_distributed(gen(0), 4, 512)]

    def logloss(res):
        return {"population_logloss": logi.population_logloss(res["w_avg"]),
                "ok": True}
    arms.append(dict(name="appE b=512 mp_dane prox_svrg K=4", fn=dane,
                     args=(4, 512, 1),
                     kw=dict(K=4, R=1, kappa=0.0, local_solver="prox_svrg",
                             eta_scale=0.3, loss="logistic"),
                     spec=lspec, dim=32, data=data, check=logloss))
    arms.append(dict(name="appE b=512 minibatch_sgd",
                     fn=base + "run_minibatch_sgd", args=(4, 512, 1),
                     kw=dict(loss="logistic"), spec=lspec, dim=32, data=data,
                     check=logloss))

    test = LeastSquaresStream(dim=16, noise=0.1, seed=0)
    tspec = spec_of(test)
    for name, args, kw, limit in (
            ("run_minibatch_sgd", (4, 16, 64), {}, 0.1),
            ("run_acc_minibatch_sgd", (4, 32, 32), {}, 0.15),
            ("run_single_sgd", (4096,), {}, 0.05),
            ("run_dsvrg_erm", (4, 4096), dict(K=20), 0.05),
            ("run_emso", (4, 64, 4), {}, None)):
        g = gen(0)
        if name == "run_single_sgd":
            data = [test.sample(g, 4096)]
        elif name == "run_dsvrg_erm":
            data = [test.sample_distributed(g, 4, 1024)]
        else:
            data = [test.sample_distributed(g, *args[:2])
                    for _ in range(args[2])]
        arms.append(dict(name=f"baseline {name[4:]}", fn=base + name,
                         args=args, kw=kw, spec=tspec, dim=16, data=data,
                         check=suboptimality(test, limit)))
    return arms


def _run_core_arms(dev, arms):
    """Each arm on the card, its CPU run beside it in worker processes:
    iterates (or w_avg and w_last) within CORE_ATOL, equal ledgers and
    plans, the MP-DANE runs' threefry index draws with keys on the card
    bit-equal to the CPU's, each result within its limit; then the claims
    of Figure 3 (MP-DANE below minibatch SGD at b = 1024) and App. E (at
    b = 512, in log loss), EMSO's one round a step and DSVRG-ERM's
    svrg_update launches. Returns (record, svrg_update launches)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch import kernels
    record, launches = {}, 0
    jobs = [{k: a[k] for k in ("fn", "args", "kw", "spec", "dim")}
            | {"data": [(X.cpu(), y.cpu()) for X, y in a["data"]]}
            for a in arms]
    with ProcessPoolExecutor(
            4, mp_context=multiprocessing.get_context("spawn")) as pool:
        replicas = [pool.submit(_cpu_replica, j) for j in jobs]
        results = []
        for a, j in zip(arms, jobs):
            kernels.reset_launch_counts()
            got = _core_run(dict(j, data=a["data"]), dev)
            results.append((got, kernels.launch_counts()))
        wants = [f.result() for f in replicas]
    for a, (got, counts), want in zip(arms, results, wants):
        name = a["name"]
        if got["iterates"] is not None:
            err = (got["iterates"].cpu() - want["iterates"]).abs().max()
        else:
            err = max((got[k].cpu() - want[k]).abs().max()
                      for k in ("w_avg", "w_last"))
        err = err.item()
        rec = {"seconds": got["seconds"], "cpu_seconds": want["seconds"],
               "cpu_max_abs_err": err, "launches": counts,
               "ledger": got["ledger"], "plan": got["plan"],
               **a["check"](got)}
        kw = a["kw"]
        if "local_solver" in kw:
            plan = got["plan"]
            steps = a["args"][1]
            draws = [_index_draws(0, a["args"][2], plan["R"], plan["K"],
                                  steps, steps, d) for d in (dev, "cpu")]
            rec["index_draws_bit_equal"] = torch.equal(draws[0].cpu(),
                                                       draws[1])
            if not rec["index_draws_bit_equal"]:
                raise AssertionError(f"{name}: threefry draws on the card "
                                     f"differ from the CPU's")
        record[name] = rec
        metric = {k: rec[k] for k in ("population_suboptimality",
                                      "population_logloss", "limit")
                  if k in rec}
        print(f"[core] {name}: {got['seconds'] * 1e3:.1f} ms on the card "
              f"(CPU run {want['seconds'] * 1e3:.1f} ms); vs CPU "
              f"max_abs_err {err:.3g} (tolerance {CORE_ATOL}); {metric}; "
              f"ledger {rec['ledger']}; svrg_update launches "
              f"{counts['svrg_update']}"
              + ("; index draws bit-equal on the card and the CPU"
                 if "index_draws_bit_equal" in rec else ""))
        if not err <= CORE_ATOL:
            raise AssertionError(f"{name}: CUDA and CPU runs differ by {err}")
        if got["ledger"] != want["ledger"] or got["plan"] != want["plan"]:
            raise AssertionError(f"{name}: ledger or plan differs from the "
                                 f"CPU run's")
        if not rec["ok"]:
            raise AssertionError(f"{name}: {metric} outside its limit")
        want_svrg = (kw["K"] * a["args"][1] // a["args"][0]
                     if a["fn"].endswith("run_dsvrg_erm") else 0)
        if counts["svrg_update"] != want_svrg:
            raise AssertionError(f"{name}: svrg_update launched "
                                 f"{counts['svrg_update']} times, expected "
                                 f"{want_svrg}")
        launches += counts["svrg_update"]
    for mp, sgd, key in (
            ("fig3 b=1024 mp_dane saga K=1", "fig3 b=1024 minibatch_sgd",
             "population_suboptimality"),
            ("fig3 b=1024 mp_dane saga K=4", "fig3 b=1024 minibatch_sgd",
             "population_suboptimality"),
            ("appE b=512 mp_dane prox_svrg K=4", "appE b=512 minibatch_sgd",
             "population_logloss")):
        if not record[mp][key] < record[sgd][key]:
            raise AssertionError(f"{mp}: {key} {record[mp][key]} not below "
                                 f"{sgd}'s {record[sgd][key]}")
        print(f"[core] {mp}: {key} {record[mp][key]:.5f} below {sgd}'s "
              f"{record[sgd][key]:.5f} ok")
    emso = record["baseline emso"]["ledger"]
    if emso["comm_rounds"] != 4:
        raise AssertionError(f"EMSO: {emso['comm_rounds']} rounds in 4 steps")
    return record, launches


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

    record["inexact_and_baselines"], n = _run_core_arms(
        dev, _core_arms(dev, stream, spec, draws))
    launches += n
    first = draws[0]                # the SAGA round's profile reruns it

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
        Xm, ym = last
        eta = 0.3 / (spec_big.beta + plan.gamma)
        w = res.w_last
        step = lambda: _dsvrg_inner(losses.least_squares(), w, w, Xm, ym,
                                    plan.gamma, eta, plan.p, plan.K, 0.0)
        step()
        torch.cuda.synchronize()
        kern, wall_ms = _profiled(lambda: _timed(step)[1] * 1e3)
        wall = wall_ms / 1e3
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

    saga = record["inexact_and_baselines"]["quickstart mp_dane saga"]["plan"]

    def profile_saga_round():
        """One DANE iteration of the quickstart's MP-DANE with the SAGA
        local solver (b = 128 solver steps over the 8 machines at once, the
        first step's data) under torch.profiler: wall, device busy, the
        idle share, and wall and launches per solver step."""
        from repro_torch import prng
        from repro_torch.core.mp_dane import _dane_round
        Xm, ym = first
        gamma, kappa = saga["gamma"], saga["kappa"]
        eta = 0.1 / (spec.beta + gamma + kappa)
        w = torch.zeros(cfg.dim, device=dev)
        step = lambda: _dane_round(losses.least_squares(), w, Xm, ym, w, w,
                                   gamma, kappa, 0.0, True, "saga",
                                   prng.PRNGKey(0), eta)
        step()
        torch.cuda.synchronize()
        kern, wall = _profiled(lambda: _timed(step)[1] * 1e3)
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        launches = sum(e.count for e in kern)
        out = {"wall_ms": wall, "device_busy_ms": busy,
               "idle_share": 1.0 - busy / wall, "launches": launches,
               "wall_us_per_solver_step": wall * 1e3 / b,
               "launches_per_solver_step": launches / b,
               "top_kernels": [
                   {"name": e.key[:80],
                    "ms": e.self_device_time_total / 1e3, "calls": e.count}
                   for e in sorted(kern,
                                   key=lambda e: -e.self_device_time_total)[
                                       :6]]}
        print(f"[profile] MP-DANE SAGA round (quickstart, {b} solver steps "
              f"x {m} machines): wall {wall:.2f} ms, device busy "
              f"{busy:.3f} ms (idle {out['idle_share']:.1%}), {launches} "
              f"launches ({launches / b:.1f} and "
              f"{out['wall_us_per_solver_step']:.1f} us a solver step)")
        for t in out["top_kernels"]:
            print(f"[profile]   {t['ms']:.4f} ms x {t['calls']}  "
                  f"{t['name']}")
        return out

    def profile_core():
        return {"mp_dsvrg_outer_step_d2e20": profile_outer_step(),
                "mp_dane_saga_round": profile_saga_round()}

    return record, profile_core


# ----------------------------------------------------------------------------
# sampled decoding and the quantized / tiered KV pools
# ----------------------------------------------------------------------------

def _sampled_mix(vocab, repetitive=False):
    """tests/test_sampling.py:_mixed_requests: greedy, top-k 32, top-p 0.9
    and explicit temperature-0 lanes in one batch (repetitive prompts so
    that n-gram drafts verify under speculation)."""
    import numpy as np
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams
    rng = np.random.default_rng(5)
    if repetitive:
        pat = rng.integers(0, vocab, 5).astype(np.int32)
        prompts = [np.tile(pat, 4)[:16] for _ in range(4)]
    else:
        prompts = [rng.integers(0, vocab, 9).astype(np.int32)
                   for _ in range(4)]
    return [Request(rid=0, prompt=prompts[0], max_new_tokens=8),
            Request(rid=1, prompt=prompts[1], sampling=SamplingParams(
                temperature=0.8, top_k=32, seed=11, max_new_tokens=9)),
            Request(rid=2, prompt=prompts[2], sampling=SamplingParams(
                temperature=1.2, top_p=0.9, seed=7, max_new_tokens=6)),
            Request(rid=3, prompt=prompts[3], sampling=SamplingParams(
                temperature=0.0, max_new_tokens=7))]


def _draw_margins(params, cfg, req, tokens):
    """Per emitted token of a completion on the CPU, how near its draw came
    to another outcome: the top-2 gap of warped logits plus the draw's
    Gumbel noise (the raw logits' gap for a greedy lane), and the distance
    of the accept uniform from q(token) (a speculative accept turns on
    u < q). Logits are the model's on prompt + tokens, teacher-forced."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.models import lm
    from repro_torch.serving import sampling
    sp = req.sampling or sampling.GREEDY
    P, n = len(req.prompt), len(tokens)
    seq = torch.from_numpy(np.concatenate([req.prompt, tokens[:-1]])
                           .astype(np.int64))[None]
    logits, _ = lm.forward(params, cfg, {"tokens": seq})
    logits = logits[0, P - 1:P - 1 + n].float()
    if sp.greedy:
        top = torch.topk(logits, 2, dim=-1).values
        return (top[:, 0] - top[:, 1]).numpy()
    pos = torch.arange(P - 1, P - 1 + n, dtype=torch.int32)
    f = lambda v, dt: torch.full((n,), v, dtype=dt)   # noqa: E731
    warped = sampling.warp_logits(logits, f(sp.temperature, torch.float32),
                                  f(sp.top_k, torch.int32),
                                  f(sp.top_p, torch.float32))
    seeds = f(sampling.seed32(sp.seed), torch.int32)
    noisy = warped + prng.gumbel(sampling._keys(seeds, pos,
                                                sampling.TAG_SAMPLE),
                                 (logits.shape[-1],))
    top = torch.topk(noisy, 2, dim=-1).values
    gap = (top[:, 0] - top[:, 1]).numpy()
    u = prng.uniform(sampling._keys(seeds, pos, sampling.TAG_ACCEPT))
    q = torch.softmax(warped, -1).gather(
        -1, torch.from_numpy(tokens.astype(np.int64))[:, None])[:, 0]
    return np.minimum(gap, (u - q).abs().numpy())


def phase_small_sampled(dev):
    """Sampled decoding on the card: (a) the reduced float32 smollm's
    engine on the card against the same engine on the CPU over the mixed
    greedy / top-k / top-p batch at speculate 0 and 4: tokens equal up to
    a divergence, which may come only where the CPU's draw margin
    (_draw_margins) is <= MARGIN_BOUND_F32, with the share of draws under
    it printed; (b) each sampled request alone on the card gives its
    batched tokens; (c) the tiny-vocab marginal of verify_tokens on the
    card (total variation < 0.03, accept rate within 0.02 of q(d), over
    16384 seeds); (d) position keys and accept uniforms drawn on the card
    bit-equal to the CPU's."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.device import to_device
    from repro_torch.models import lm
    from repro_torch.serving import sampling
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("smollm-135m").reduced()
    params = lm.init_params(0, cfg, device="cpu")
    cuda_params = to_device(params, dev)
    V = cfg.vocab_size
    rec = {}
    for spec in (0, 4):
        got = {}
        for where, p_ in (("cpu", params), ("cuda", cuda_params)):
            eng = ServingEngine(p_, cfg, num_slots=4, block_size=4,
                                max_seq_len=32, speculate=spec,
                                device="cpu" if where == "cpu" else dev)
            done = sorted(eng.run(_sampled_mix(V, bool(spec))),
                          key=lambda c: c.rid)
            got[where] = (done, eng.runner.sampled_dispatches,
                          eng.scheduler.proposed_tokens, eng)
        reqs = _sampled_mix(V, bool(spec))
        exact, within, margins = 0, [], []
        for r, c_cpu, c_gpu in zip(reqs, got["cpu"][0], got["cuda"][0]):
            m = _draw_margins(params, cfg, r, c_cpu.tokens)
            margins.extend(m.tolist())
            i = _first_divergence(c_gpu.tokens, c_cpu.tokens)
            if i is None:
                exact += 1
                continue
            gap = float(m[i]) if i < len(m) else float("inf")
            within.append({"rid": r.rid, "at": i, "margin": gap})
            if gap > MARGIN_BOUND_F32:
                raise AssertionError(
                    f"small_sampled speculate={spec}: request {r.rid} "
                    f"leaves the CPU engine at token {i} where the draw "
                    f"margin is {gap:.5f} > {MARGIN_BOUND_F32}")
        margins = np.asarray(margins)
        under = float((margins <= MARGIN_BOUND_F32).mean())
        if got["cuda"][1] == 0 or (spec and got["cuda"][2] == 0):
            raise AssertionError(f"small_sampled speculate={spec}: no "
                                 f"sampled dispatch or no draft proposed")
        eng = got["cuda"][3]
        solo_ok = True
        for rid in (1, 2):
            solo = eng.run([dataclasses.replace(reqs[rid])])[0]
            solo_ok &= bool(np.array_equal(solo.tokens,
                                           got["cuda"][0][rid].tokens))
        if not solo_ok:
            raise AssertionError(f"small_sampled speculate={spec}: a "
                                 f"sampled request alone differs from its "
                                 f"batched tokens on the card")
        rec[f"speculate{spec}"] = {
            "exact": exact, "requests": len(reqs), "diverged_within_bound":
            within, "draws": int(margins.size),
            "share_of_draws_under_bound": under,
            "sampled_dispatches": got["cuda"][1],
            "proposed": got["cuda"][2], "alone_equals_batched": solo_ok}
        print(f"[small_sampled] speculate={spec}: card vs CPU {exact}/"
              f"{len(reqs)} exact, divergences within the draw margin "
              f"{MARGIN_BOUND_F32}: {[(d['rid'], d['at']) for d in within]}; "
              f"{under:.4f} of {margins.size} draws under the bound; "
              f"{got['cuda'][1]} sampled dispatches, {got['cuda'][2]} "
              f"drafts proposed; each sampled request alone equals its "
              f"batched tokens ok")
    # the tiny-vocab marginal (tests/test_sampling.py's limits)
    Vt, temp, n = 8, 0.9, 16384
    row = torch.randn(Vt, generator=torch.Generator().manual_seed(3))
    q = torch.softmax(row / temp, -1).numpy()
    marg = {}
    for label, d, topk in (("inside", int(np.argsort(q)[Vt // 2]), 0),
                           ("outside top-3", int(np.argsort(q)[0]), 3)):
        logits = row.to(dev)[None, None].expand(n, 2, Vt)
        chain = torch.tensor([[1, d]], dtype=torch.int32,
                             device=dev).expand(n, 2)
        full = lambda v, dt: torch.full((n,), v, dtype=dt,  # noqa: E731
                                        device=dev)
        emit, acc, _ = sampling.verify_tokens(
            logits, chain, full(2, torch.int32), full(13, torch.int32),
            full(temp, torch.float32), full(topk, torch.int32),
            full(1.0, torch.float32),
            torch.arange(n, dtype=torch.int32, device=dev))
        wq = torch.softmax(sampling.warp_logits(
            row[None], torch.tensor([temp]), torch.tensor([topk]),
            torch.tensor([1.0]))[0], -1).numpy()
        freq = np.bincount(emit[:, 0].cpu().numpy(), minlength=Vt) / n
        tv = 0.5 * float(np.abs(freq - wq).sum())
        rate = float(acc.cpu().numpy().astype(bool).mean())
        marg[label] = {"total_variation": tv, "accept_rate": rate,
                       "q_draft": float(wq[d])}
        print(f"[small_sampled] tiny-vocab marginal, draft {label}: total "
              f"variation {tv:.4f} (< 0.03), accept rate {rate:.4f} vs "
              f"q(d) {wq[d]:.4f} (within 0.02)")
        if not (tv < 0.03 and abs(rate - wq[d]) < 0.02):
            raise AssertionError(f"small_sampled: tiny-vocab marginal "
                                 f"{label} off: {marg[label]}")
    rec["tiny_vocab_marginal"] = marg
    # keys and uniforms on the card bit-equal to the CPU's
    seeds = torch.tensor([0, 1, -1, -2**31, 2**31 - 1, 77], dtype=torch.int32)
    pos = torch.arange(0, 6000, 7, dtype=torch.int32)
    sg, pg = torch.broadcast_tensors(seeds[:, None], pos[None])
    for tag in (sampling.TAG_SAMPLE, sampling.TAG_ACCEPT):
        kc = sampling._keys(sg, pg, tag)
        kg = sampling._keys(sg.to(dev), pg.to(dev), tag)
        if not torch.equal(kg.cpu(), kc) or not torch.equal(
                prng.uniform(kg).cpu(), prng.uniform(kc)):
            raise AssertionError(f"small_sampled: keys or uniforms on the "
                                 f"card differ from the CPU's (tag {tag})")
    k8 = sampling._keys(sg, pg, sampling.TAG_SAMPLE).reshape(-1, 2)[:8]
    gc, gg = (prng.gumbel(k8.to(d_), (4096,)) for d_ in ("cpu", dev))
    rec["gumbel_card_vs_cpu_max_abs"] = float((gg.cpu() - gc).abs().max())
    print(f"[small_sampled] {kc.shape[0] * kc.shape[1]} position keys and "
          f"accept uniforms on the card bit-equal to the CPU's ok; Gumbel "
          f"noise card vs CPU max abs {rec['gumbel_card_vs_cpu_max_abs']:.3g}")
    return rec


def _quant_requests(vocab):
    """engine_quant's float32 stream: 4 prompts of 64-160 tokens, 16 new
    tokens each, logprobs 2 (the top-2 gap of every emitted position)."""
    from repro_torch.serving.engine import synthetic_requests
    from repro_torch.serving.sampling import SamplingParams
    return synthetic_requests(4, vocab_size=vocab, prompt_len=(64, 160),
                              max_new=(16, 16), seed=4,
                              sampling=SamplingParams(logprobs=2))


QUANT_KW = dict(num_slots=4, block_size=16, max_seq_len=192)


def _quant_cpu_engine(kv_dtype, cfg, params_path):
    """engine_quant's float32 engine on the CPU, in a worker process, on
    the card's params (drawn there once, saved at `params_path`).
    {rid: (tokens, top-2 logprob gaps)}."""
    from repro_torch.serving.engine import ServingEngine
    torch.set_num_threads(2)
    params = torch.load(params_path)
    eng = ServingEngine(params, cfg, kv_dtype=kv_dtype, device="cpu",
                        **QUANT_KW)
    done = eng.run(_quant_requests(cfg.vocab_size))
    return {c.rid: (c.tokens, c.top_logprobs[:, 0] - c.top_logprobs[:, 1])
            for c in done}


def _check_quant_launches(tag, eng, stats, counts, arms, kv_dtype, n_attn):
    """The per-dispatch launch formula of an attention-only engine run,
    and every paged launch on the quantized arm for an int8 / fp8 pool
    (none for an activation-dtype pool)."""
    prefills = stats["prefill"]["dispatches"]
    verifies = (stats.get("speculation") or {}).get("verify_dispatches", 0)
    want = {"paged_prefill": n_attn * (prefills + verifies),
            "paged_attention": n_attn * (eng.steps - verifies)}
    quant = kv_dtype != "fp16"
    want_arms = {"paged_prefill_quant": want["paged_prefill"] * quant,
                 "paged_attention_quant": want["paged_attention"] * quant}
    got = {k: counts[k] for k in want}
    got_arms = {k: arms[k] for k in want_arms}
    if got != want or got_arms != want_arms or 0 in got.values():
        raise AssertionError(f"{tag}: launches {got} / quantized arms "
                             f"{got_arms}, expected {want} / {want_arms}")
    return {**got, **got_arms}


def phase_engine_quant(params, cfg, dev):
    """int8 / fp8 KV pools through the engine on full-width smollm-135m.
    float32: activation-dtype, int8 and fp8 pools on the card against the
    same engine on the CPU (worker processes) over _quant_requests, tokens
    under the float32 margin rule (the CPU run's top-2 gap at a
    divergence <= MARGIN_BOUND_F32): the quantized kernel arms held to
    their twins end to end. bf16: the engine phase's synthetic stream on
    bf16, int8 and fp8 pools: tokens/s, TTFT, TPOT, every block returned,
    cache_bytes == paged_bytes, per-token agreement with the bf16 pools
    (printed, not gated). Every run's launches follow the per-dispatch
    formula, the quantized runs' all on the quantized arms."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    from repro_torch import kernels
    from repro_torch.device import to_device
    from repro_torch.models import lm
    from repro_torch.serving import kv_cache
    from repro_torch.serving.engine import (ServingEngine, summarize,
                                            synthetic_requests)
    V = cfg.vocab_size
    n_attn = cfg.n_layers
    kvs = ("fp16", "int8", "fp8")
    rec = {"float32": {}, "bf16": {}}
    totals = {"paged_prefill": 0, "paged_attention": 0}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    # the weights are drawn once, on the card; the CPU workers load a copy
    master = lm.init_params(0, cfg32, device=dev)
    path = BUILD / "engine_quant_params.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(to_device(master, "cpu"), path)
    with ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_runs = {kv: pool.submit(_quant_cpu_engine, kv, cfg32, str(path))
                    for kv in kvs}
        card = {}
        for kv in kvs:
            eng = ServingEngine(master, cfg32, kv_dtype=kv, device=dev,
                                **QUANT_KW)
            kernels.reset_launch_counts()
            done = eng.run(_quant_requests(V))
            torch.cuda.synchronize()
            stats = summarize(done, eng.wall_time, eng)
            card[kv] = ({c.rid: c.tokens for c in done}, _check_quant_launches(
                f"engine_quant float32 {kv}", eng, stats,
                kernels.launch_counts(), kernels.arm_launch_counts(), kv,
                n_attn))
            del eng
        del master
        torch.cuda.empty_cache()
        cpu = {kv: f.result() for kv, f in cpu_runs.items()}
    path.unlink()
    for kv in kvs:
        toks, launches = card[kv]
        refs = {rid: (t, g) for rid, (t, g) in cpu[kv].items()}
        rule = _margin_rule([SimpleNamespace(rid=rid, tokens=t)
                             for rid, t in toks.items()], refs,
                            MARGIN_BOUND_F32, f"engine_quant float32 {kv}")
        for k in totals:
            totals[k] += launches[k]
        rec["float32"][kv] = {"vs_cpu": rule, "launches": launches}
        print(f"[engine_quant] float32 {kv} pools, card vs CPU: "
              f"{rule['exact']}/{rule['requests']} exact; divergences within "
              f"the bound {MARGIN_BOUND_F32}: "
              f"{[(d['rid'], d['at'], d['margin']) for d in rule['diverged_within_bound']]}; "
              f"launches {launches}")
    kw = dict(num_slots=8, block_size=16, max_seq_len=512, prefix_cache=True,
              device=dev)
    base = None
    for kv in kvs:
        eng = ServingEngine(params, cfg, kv_dtype=kv, **kw)
        eng.run(synthetic_requests(2, vocab_size=V, prompt_len=(20, 40),
                                   max_new=(4, 4), seed=9))   # warm-up
        eng.reset_prefix_cache()
        torch.cuda.synchronize()
        free0 = eng.allocator.num_free
        reqs = synthetic_requests(16, vocab_size=V, prompt_len=(32, 256),
                                  max_new=(32, 32), seed=0)
        kernels.reset_launch_counts()
        done = sorted(eng.run(reqs), key=lambda c: c.rid)
        torch.cuda.synchronize()
        stats = summarize(done, eng.wall_time, eng)
        launches = _check_quant_launches(
            f"engine_quant bf16 {kv}", eng, stats, kernels.launch_counts(),
            kernels.arm_launch_counts(), kv, n_attn)
        for k in totals:
            totals[k] += launches[k]
        want_bytes = kv_cache.paged_bytes(cfg, eng.allocator.num_blocks,
                                          eng.block_size, kv)
        if (len(done) != len(reqs) or eng.allocator.num_free != free0
                or eng.cache_bytes != want_bytes
                or stats["kv"]["device_pool_bytes"] != want_bytes):
            raise AssertionError(f"engine_quant bf16 {kv}: {len(done)} of "
                                 f"{len(reqs)} completed, "
                                 f"{free0 - eng.allocator.num_free} blocks "
                                 f"not returned, cache_bytes "
                                 f"{eng.cache_bytes} vs {want_bytes}")
        toks = [c.tokens for c in done]
        if base is None:
            base = toks
        agree = float(np.mean(np.concatenate([a == b for a, b in
                                              zip(toks, base)])))
        rec["bf16"][kv] = {"stats": stats, "launches": launches,
                           "token_agreement_with_bf16_pools": agree,
                           "cache_bytes": eng.cache_bytes}
        print(f"[engine_quant] bf16 {kv} pools: {stats['tokens_per_s']} "
              f"tokens/s, ttft p50 {stats['ttft_p50_ms']} ms p99 "
              f"{stats['ttft_p99_ms']} ms, tpot p50 {stats['tpot_p50_ms']} "
              f"ms; pool {eng.cache_bytes} bytes; per-token agreement with "
              f"the bf16 pools {agree:.4f}; launches {launches}; every block "
              f"returned ok")
        del eng
        torch.cuda.empty_cache()
    return rec, totals


def _tiered_requests(vocab):
    """tests/test_kv_quant.py:_tiered_reqs scaled from 2 slots to the engine
    phase's 8: 16 rotating tenants (4 per 2 slots) with 48-token system
    prompts, 32 requests, suffixes of 8-16 and 4-8 new tokens, against a
    slots-only pool (1 + 8 x 6 blocks of 16), so an admission evicts other
    tenants' chains and only revival finds a tenant's prefix again."""
    from repro_torch.serving.engine import shared_prefix_requests
    from repro_torch.serving.sampling import SamplingParams
    return shared_prefix_requests(32, vocab_size=vocab, prefix_len=48,
                                  suffix_len=(8, 16), max_new=(4, 8),
                                  n_prefixes=16, seed=0,
                                  sampling=SamplingParams(logprobs=2))


def phase_engine_tiered(params, cfg, dev):
    """The host spill tier on full-width smollm-135m, bf16 and int8 pools:
    _tiered_requests with host_cache_blocks 64 and 0. Revivals >= 1;
    every revived block's payload read back from the pools bit-equal to
    the host copy uploaded (the round trip exact); promotion widths on
    promote_buckets; every block returned. Tokens: equal to the
    device-only run's up to a divergence, which may come only where that
    run's top-2 gap is <= MARGIN_BOUND (a revived prefix is attended as
    pool tiles, a recomputed one as suffix tiles: another bf16 rounding
    order); the exact count is printed."""
    from repro_torch import kernels
    from repro_torch.serving import kv_cache
    from repro_torch.serving.bucketing import pick_bucket
    from repro_torch.serving.engine import ServingEngine, summarize
    V = cfg.vocab_size
    kw = dict(num_slots=8, block_size=16, max_seq_len=96, prefix_cache=True,
              num_blocks=1 + 8 * 6, device=dev)
    rec, totals = {}, {"paged_prefill": 0, "paged_attention": 0}
    for kv in ("fp16", "int8"):
        runs = {}
        for tier in (64, 0):
            eng = ServingEngine(params, cfg, kv_dtype=kv,
                                host_cache_blocks=tier, **kw)
            checked = [0]
            if tier:
                store = eng.allocator._store

                def verified(ids, payloads, store=store, eng=eng,
                             checked=checked):
                    store(ids, payloads)
                    for b, pl in zip(ids, payloads):
                        back = kv_cache.gather_blocks(
                            cfg, eng.runner.state,
                            torch.tensor([b], device=dev), device="cpu")
                        for (_, x), (_, y) in zip(
                                kv_cache.lm._layers(back, cfg),
                                kv_cache.lm._layers(pl, cfg)):
                            for n_ in x:
                                if not torch.equal(
                                        x[n_].view(torch.uint8),
                                        y[n_].view(torch.uint8)):
                                    raise AssertionError(
                                        f"engine_tiered {kv}: block {b}'s "
                                        f"{n_} differs from its host copy "
                                        f"after revival")
                        checked[0] += 1

                eng.allocator._store = verified
            free0 = eng.allocator.num_free
            kernels.reset_launch_counts()
            done = sorted(eng.run(_tiered_requests(V)), key=lambda c: c.rid)
            torch.cuda.synchronize()
            stats = summarize(done, eng.wall_time, eng)
            launches = _check_quant_launches(
                f"engine_tiered {kv} host {tier}", eng, stats,
                kernels.launch_counts(), kernels.arm_launch_counts(), kv,
                cfg.n_layers)
            for k in totals:
                totals[k] += launches[k]
            if len(done) != 32 or eng.allocator.num_free != free0:
                raise AssertionError(f"engine_tiered {kv} host {tier}: "
                                     f"{len(done)} of 32 completed or blocks "
                                     f"not returned")
            runs[tier] = (done, eng, stats, checked[0], launches)
        done, eng, stats, checked, launches = runs[64]
        alloc, runner = eng.allocator, eng.runner
        shapes, buckets = runner.promote_shapes, runner.promote_buckets
        if (alloc.host_revivals < 1 or checked != alloc.host_revivals
                or not shapes or not shapes <= set(buckets)
                or any(w != pick_bucket(w, buckets) for w in shapes)):
            raise AssertionError(f"engine_tiered {kv}: revivals "
                                 f"{alloc.host_revivals} ({checked} checked),"
                                 f" promotion widths {sorted(shapes)} on "
                                 f"{buckets}")
        off = runs[0][0]
        refs = {c.rid: (c.tokens, c.top_logprobs[:, 0] - c.top_logprobs[:, 1])
                for c in off}
        rule = _margin_rule(done, refs, MARGIN_BOUND,
                            f"engine_tiered {kv} host tier on vs off")
        rec[kv] = {"vs_device_only": rule, "stats": stats,
                   "device_only_stats": runs[0][2],
                   "revivals": alloc.host_revivals,
                   "demotions": alloc.host_demotions,
                   "revived_blocks_checked": checked,
                   "promote_shapes": sorted(shapes), "launches": launches}
        print(f"[engine_tiered] {kv}: host tier on vs off {rule['exact']}/"
              f"{rule['requests']} exact, divergences within the bound "
              f"{MARGIN_BOUND}: "
              f"{[(d['rid'], d['at'], round(d['margin'], 4)) for d in rule['diverged_within_bound']]}; "
              f"{alloc.host_demotions} demotions, {alloc.host_revivals} "
              f"revivals ({checked} revived blocks bit-equal to their host "
              f"copies), cached tokens {stats['prefill']['cached_tokens']} "
              f"vs {runs[0][2]['prefill']['cached_tokens']} device-only; "
              f"promotion widths {sorted(shapes)} on {buckets}; "
              f"{stats['tokens_per_s']} vs {runs[0][2]['tokens_per_s']} "
              f"tokens/s")
    return rec, totals


# the cluster phase's engine settings (engine phase's, with room for the
# profile's 128-token prompts)
CLUSTER_KW = dict(num_slots=8, block_size=16, max_seq_len=160,
                  prefix_cache=True)
# a replica built beside others must add its pools and nothing else: the
# growth of torch.cuda.memory_allocated() across its construction within
# this of its cache_bytes (a second copy of smollm-135m's bf16 weights
# would add 257 MiB)
REPLICA_MEM_SLACK = 16 * 2 ** 20


def _cluster_launches(tag, engines, counts, n_attn):
    """The per-dispatch launch formula summed over a cluster's engines
    (no speculation): paged_prefill once a layer a prefill dispatch,
    paged_attention once a layer a decode step, both launched."""
    want = {k: 0 for k in counts}
    want["paged_prefill"] = n_attn * sum(e.runner.prefill_dispatches
                                         for e in engines)
    want["paged_attention"] = n_attn * sum(e.steps for e in engines)
    if counts != want or not counts["paged_prefill"] \
            or not counts["paged_attention"]:
        raise AssertionError(f"{tag}: launches {counts}, expected {want} "
                             f"from the dispatch counts")
    return counts


def _blocks_back(tag, engines):
    for e in engines:
        held = e.allocator.num_blocks - 1 - e.allocator.num_free
        if held:
            raise AssertionError(f"{tag}: an engine holds {held} blocks "
                                 f"after its run")


def phase_engine_cluster(params, cfg, dev):
    """The serving cluster on full-width smollm-135m (bf16 weights cast
    once; every replica's runner holds them as they are). Replicas are
    built one at a time and torch.cuda.memory_allocated() read around
    each: its growth must be its cache_bytes within REPLICA_MEM_SLACK.
    The stream: multi_tenant_requests, 16 requests over 4 tenants (48-token
    system prompts, 16-token suffixes), 16 new tokens, all at t=0, through
    one ServingEngine, a Router of 2 replicas under each policy and of 4
    under prefix-affinity (prefix caches cold before each arm): every arm's
    tokens under the margin rule against generate() (MARGIN_BOUND), every
    block back, placements summing to 16, launches by the per-dispatch
    formula; tokens/s and the cached prompt tokens printed. A drain arm
    disables replica 1 after its first step: its queued requests requeue
    and all 16 complete under the same rule. Then an autoscaled cluster
    (AutoscalePolicy(min_replicas=1, max_replicas=3), standby replicas
    1-2) on bursty_requests(32), all at t=0: at least one scale-out, all
    32 complete under the rule. Which replica, how many scale-outs: timing
    decides them, so they are printed, not held. Returns (record, paged
    launches, the two replicas for the cluster decode profile)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.serving.autoscaler import Autoscaler, AutoscalePolicy
    from repro_torch.serving.engine import (ServingEngine, bursty_requests,
                                            multi_tenant_requests, summarize,
                                            synthetic_requests)
    from repro_torch.serving.replica import Replica
    from repro_torch.serving.router import POLICIES, Router, summarize_cluster
    V, L = cfg.vocab_size, cfg.n_layers
    kw = dict(CLUSTER_KW, device=dev)

    def stream():
        return multi_tenant_requests(16, vocab_size=V, n_tenants=4,
                                     prefix_len=48, suffix_len=16,
                                     max_new=(16, 16), seed=21)

    def burst():
        reqs = bursty_requests(32, vocab_size=V, prompt_len=64,
                               max_new=(16, 16), seed=22)
        for r in reqs:
            r.arrival = 0.0
        return reqs

    def warm(eng):                     # cuBLAS handles, the allocator
        eng.run(synthetic_requests(2, vocab_size=V, prompt_len=(20, 40),
                                   max_new=(4, 4), seed=9))
        eng.reset_prefix_cache()

    torch.cuda.synchronize()
    single = ServingEngine(params, cfg, **kw)
    warm(single)
    replicas, memory = [], []
    for i in range(4):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        rep = Replica(params, cfg, replica_id=i, **kw)
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated() - m0
        memory.append({"replica": i, "allocated_growth": grew,
                       "cache_bytes": rep.engine.cache_bytes})
        if abs(grew - rep.engine.cache_bytes) > REPLICA_MEM_SLACK:
            raise AssertionError(
                f"replica {i}: memory_allocated grew by {grew} bytes, its "
                f"pools are {rep.engine.cache_bytes}: something beside the "
                f"pools (a copy of the weights?) was allocated")
        if rep.engine.runner.params["embed"].data_ptr() != \
                params["embed"].data_ptr():
            raise AssertionError(f"replica {i} holds its own weights")
        warm(rep.engine)
        replicas.append(rep)
    grown = [(m["allocated_growth"], m["cache_bytes"]) for m in memory]
    print(f"[engine_cluster] memory_allocated growth per replica vs its "
          f"cache_bytes: {grown}")

    refs = _batched_refs(params, cfg, stream(), dev)
    gaps = np.concatenate([g for _, g in refs.values()])
    if np.median(gaps) <= MARGIN_BOUND:
        raise AssertionError(f"generate()'s median gap {np.median(gaps)} is "
                             f"not above the margin bound {MARGIN_BOUND}")
    launches = {"paged_attention": 0, "paged_prefill": 0}
    rec = {"memory": memory, "arms": {},
           "generate_median_gap": float(np.median(gaps))}

    def arm(tag, runner, engines, reqs, refs, router=None):
        for e in engines:
            e.reset_prefix_cache()
        kernels.reset_launch_counts()
        done = runner.run(reqs)
        torch.cuda.synchronize()
        counts = _cluster_launches(tag, engines, kernels.launch_counts(), L)
        for k in launches:
            launches[k] += counts[k]
        _blocks_back(tag, engines)
        if len(done) != len(reqs):
            raise AssertionError(f"{tag}: {len(done)} of {len(reqs)} "
                                 f"completed")
        rule = _margin_rule(done, refs, MARGIN_BOUND, f"{tag} vs generate()")
        stats = (summarize_cluster(done, runner.wall_time, runner)
                 if router else summarize(done, runner.wall_time, runner))
        cl = stats.get("cluster", {})
        placed = cl.get("placed", [len(done)])
        if sum(placed) != len(reqs):
            raise AssertionError(f"{tag}: placements {placed}")
        cached = cl.get("cached_prompt_tokens",
                        stats["prefill"]["cached_tokens"]
                        if "prefill" in stats else None)
        where = [(d["rid"], d["at"], round(d["margin"], 4))
                 for d in rule["diverged_within_bound"]]
        print(f"[engine_cluster] {tag}: {stats['tokens_per_s']} tokens/s, "
              f"ttft p50 {stats['ttft_p50_ms']} ms p99 "
              f"{stats['ttft_p99_ms']} ms; placed {placed}; cached prompt "
              f"tokens {cached}; vs generate() {rule['exact']}/"
              f"{rule['requests']} exact, divergences within the bound: "
              f"{where}; launches paged_prefill {counts['paged_prefill']}, "
              f"paged_attention {counts['paged_attention']}")
        rec["arms"][tag] = {"stats": stats, "vs_generate": rule,
                            "launches": counts, "placed": placed,
                            "cached_prompt_tokens": cached}
        return done, stats

    arm("single_engine", single, [single], stream(), refs)
    for policy in POLICIES:
        router = Router(replicas[:2], policy=policy)
        arm(f"2_replicas_{policy}", router,
            [r.engine for r in replicas[:2]], stream(), refs, router)
    router = Router(replicas, policy="prefix-affinity")
    arm("4_replicas_prefix-affinity", router, [r.engine for r in replicas],
        stream(), refs, router)

    # drain: replica 1 is disabled after its first step; its queue moves
    reqs = stream()
    router = Router(replicas[:2], policy="round-robin")
    engines = [r.engine for r in replicas[:2]]
    for rep in replicas[:2]:
        rep.reset_prefix_cache()
        rep.begin_run()
    kernels.reset_launch_counts()
    for r in reqs:
        router.submit(r)
    router.place()
    replicas[1].step()
    router.place()
    orphans = router.disable(1)
    while router.has_work:
        router.place()
        for rep in replicas[:2]:
            if rep.has_work:
                rep.step()
    torch.cuda.synchronize()
    router.enable(1)
    done = [c for rep in replicas[:2] for c in rep.take_completions()]
    counts = _cluster_launches("drain", engines, kernels.launch_counts(), L)
    for k in launches:
        launches[k] += counts[k]
    _blocks_back("drain", engines)
    if not orphans or len(done) != len(reqs) \
            or {c.rid for c in done} != {r.rid for r in reqs}:
        raise AssertionError(f"drain: {len(orphans)} requeued, {len(done)} "
                             f"of {len(reqs)} completed")
    rule = _margin_rule(done, refs, MARGIN_BOUND, "drain vs generate()")
    print(f"[engine_cluster] drain: replica 1 disabled after one step, "
          f"{len(orphans)} queued requests requeued, replica 1 finished "
          f"{replicas[1].placed} it had admitted; {len(done)}/16 complete, "
          f"{rule['exact']} exact vs generate()")
    rec["drain"] = {"requeued": len(orphans), "kept": replicas[1].placed,
                    "vs_generate": rule, "launches": counts}

    # the autoscaled cluster: one replica, two in standby
    reqs = burst()
    brefs = _batched_refs(params, cfg, reqs, dev)
    router = Router(replicas[:1], policy="least-loaded")
    asc = Autoscaler(router, policy=AutoscalePolicy(min_replicas=1,
                                                    max_replicas=3),
                     standby=replicas[1:3])
    engines = [r.engine for r in replicas[:3]]
    for e in engines:
        e.reset_prefix_cache()
    kernels.reset_launch_counts()
    done = router.run(reqs)
    torch.cuda.synchronize()
    counts = _cluster_launches("autoscale", engines, kernels.launch_counts(),
                               L)
    for k in launches:
        launches[k] += counts[k]
    _blocks_back("autoscale", engines)
    summary = asc.summary()
    stats = summarize_cluster(done, router.wall_time, router)
    rule = _margin_rule(done, brefs, MARGIN_BOUND, "autoscale vs generate()")
    print(f"[engine_cluster] autoscale (bursty, 32 at t=0): "
          f"{stats['tokens_per_s']} tokens/s, ttft p50 "
          f"{stats['ttft_p50_ms']} ms p99 {stats['ttft_p99_ms']} ms; "
          f"{rule['exact']}/{rule['requests']} exact vs generate(); "
          f"summary {json.dumps(summary)}")
    if summary["scale_out_events"] < 1 or len(done) != len(reqs):
        raise AssertionError(f"autoscale: {summary['scale_out_events']} "
                             f"scale-outs, {len(done)} of {len(reqs)} "
                             f"completed")
    rec["autoscale"] = {"summary": summary, "stats": stats,
                        "vs_generate": rule, "launches": counts}
    rec["launches"] = launches
    print(f"[engine_cluster] paged launches over the phase: {launches}")
    return rec, launches, replicas[:2]


def _cli_stats(proc):
    text = proc.stdout[proc.stdout.index("{"):proc.stdout.rindex("}") + 1]
    return json.loads(text)


def phase_serve_cli_cluster():
    """The port's serve CLI at full width in processes of its own, on the
    card: (1) --replicas 2 --router prefix on multi-tenant traffic with
    --trace-out / --metrics-out; (2) --autoscale (1 to 3 replicas) with
    --slo-autoscale, a tight --slo-ttft-ms, --slo-shed, a tight
    --deadline-ms and --flight-recorder on diurnal traffic, with
    --metrics-out. Both exit 0; their exports and the recorder's dump are
    valid under the port's validators, the metrics of (2) at schema v2
    with the SLO sketches; completions plus shed requests equal the
    requests; the replicas shared one copy of the weights."""
    from repro_torch.serving.observability import (METRICS_SCHEMA,
                                                   validate_metrics_dump,
                                                   validate_trace_events)
    out = BUILD / "serve_cli_cluster"
    out.mkdir(parents=True, exist_ok=True)
    runs = {
        "replicas_prefix": (16, [
            "--replicas", "2", "--router", "prefix",
            "--workload", "multi-tenant", "--tenants", "4",
            "--prompt-len", "16", "--max-new", "8", "16",
            "--trace-out", str(out / "trace.json"),
            "--metrics-out", str(out / "metrics.json")]),
        "autoscale_slo": (24, [
            "--autoscale", "--min-replicas", "1", "--max-replicas", "3",
            "--slo-autoscale", "--slo-ttft-ms", "250", "--slo-shed",
            "--deadline-ms", "1000", "--workload", "diurnal",
            "--rate-min", "8", "--rate-max", "64", "--diurnal-period", "1",
            "--prompt-len", "32", "--max-new", "8", "16",
            "--flight-recorder", str(out / "flight.json"),
            "--metrics-out", str(out / "metrics_slo.json")]),
    }
    rec = {}
    for name, (n, flags) in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--full-width",
             "--requests", str(n), *flags], cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"serve CLI {name} failed (exit "
                                 f"{proc.returncode}):\n{proc.stderr[-3000:]}")
        stats = _cli_stats(proc)
        cl = stats["cluster"]
        shed = stats.get("shed_requests", 0)
        scaler = {k: v for k, v in cl.get("autoscaler", {}).items()
                  if k != "policy"}
        slo = {k: stats["slo"][k] for k in ("breaches", "peak_burn",
                                            "ttft_p50_ms")
               } if "slo" in stats else None
        print(f"[serve_cli_cluster] {name}: exit 0 in {secs:.1f} s (process "
              f"start included); {stats['requests']} completed + {shed} shed "
              f"of {n}; {stats['tokens_per_s']} tokens/s; placed "
              f"{cl['placed']}, cached prompt tokens "
              f"{cl['cached_prompt_tokens']}; autoscaler "
              f"{json.dumps(scaler)}; slo {json.dumps(slo)}")
        if stats["requests"] + shed != n or stats["device"] != "cuda" \
                or stats["shared_weights"] is not True:
            raise AssertionError(f"serve CLI {name}: {stats['requests']} "
                                 f"completed + {shed} shed of {n} on "
                                 f"{stats['device']}, shared weights "
                                 f"{stats['shared_weights']}")
        rec[name] = {"seconds": secs, "stats": stats}
    checks = [("trace", validate_trace_events, out / "trace.json"),
              ("flight recorder dump", validate_trace_events,
               out / "flight.json"),
              ("metrics", validate_metrics_dump, out / "metrics.json"),
              ("SLO metrics", validate_metrics_dump,
               out / "metrics_slo.json")]
    for what, validate, path in checks:
        doc = json.loads(path.read_text())
        errs = validate(doc)
        if errs:
            raise AssertionError(f"serve CLI {what} ({path.name}) invalid: "
                                 f"{errs[:3]}")
    slo = json.loads((out / "metrics_slo.json").read_text())
    if slo["schema"] != METRICS_SCHEMA or not slo.get("sketches"):
        raise AssertionError(f"the SLO run's metrics dump is at "
                             f"{slo['schema']} with "
                             f"{len(slo.get('sketches', []))} sketches")
    fr = json.loads((out / "flight.json").read_text())
    print(f"[serve_cli_cluster] exports valid: trace, metrics, metrics "
          f"{slo['schema']} with {len(slo['sketches'])} sketches, flight "
          f"recorder {fr['otherData']['flight_recorder']['events']} events, "
          f"{len(fr['otherData']['flight_recorder']['anomalies'])} anomalies")
    rec["sketches"] = len(slo["sketches"])
    return rec


def profile_cluster(replicas, vocab, n_sweeps=4):
    """Where one cluster sweep's time goes: the replicas each with every
    lane decoding (prompts of 128, all admitted first), n_sweeps sweeps
    (each replica steps once, in turn, as Router.run does) under
    torch.profiler. Returns wall ms per sweep, device-busy ms per sweep,
    the idle share and launches per sweep."""
    from repro_torch.serving.engine import synthetic_requests
    new = 3 * n_sweeps + 8
    for rep in replicas:
        rep.reset_prefix_cache()
        for r in synthetic_requests(rep.num_slots, vocab_size=vocab,
                                    prompt_len=128, max_new=(new, new),
                                    seed=5 + rep.replica_id):
            rep.submit(r)
        rep.begin_run()
    while any(rep.snapshot().queue_depth for rep in replicas):
        for rep in replicas:
            rep.step()
    for _ in range(2):
        for rep in replicas:
            rep.step()
    torch.cuda.synchronize()

    def window():
        t0 = time.perf_counter()
        for _ in range(n_sweeps):
            for rep in replicas:
                rep.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_sweeps

    kern, wall = _profiled(window)
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / n_sweeps
    launches = sum(e.count for e in kern) / n_sweeps
    while any(rep.has_work for rep in replicas):
        for rep in replicas:
            if rep.has_work:
                rep.step()
    for rep in replicas:
        rep.take_completions()
    rec = {"replicas": len(replicas),
           "lanes": sum(r.num_slots for r in replicas),
           "wall_ms_per_sweep": wall, "device_busy_ms_per_sweep": busy,
           "idle_share": 1.0 - busy / wall,
           "kernel_launches_per_sweep": launches}
    print(f"[profile] smollm-135m cluster sweep ({len(replicas)} replicas x "
          f"{replicas[0].num_slots} lanes, each replica one step in turn): "
          f"wall {wall:.2f} ms, device busy {busy:.3f} ms (idle "
          f"{rec['idle_share']:.1%}), {launches:.0f} kernel launches per "
          f"sweep")
    return rec



def profile_decode(eng, vocab, n_steps=4, sampling=None):
    """Where one decode step's time goes: every lane decoding (prompts of
    128, all admitted first), n_steps engine steps under torch.profiler;
    with `sampling`, every lane sampled with it. Returns wall ms per step,
    device-busy ms per step (summed kernel time), the idle share and the
    top kernels by device time."""
    from repro_torch.serving.engine import synthetic_requests
    # room for three profiled windows (_profiled)
    new = 3 * n_steps + 8
    for r in synthetic_requests(eng.num_slots, vocab_size=vocab,
                                prompt_len=128, max_new=(new, new), seed=5,
                                sampling=sampling):
        eng.submit(r)
    eng.begin_run()
    while eng.stats().queue_depth:     # admit them all
        eng.step()
    for _ in range(2):                 # then a couple of plain decodes
        eng.step()
    torch.cuda.synchronize()

    def window():
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_steps

    kern, wall = _profiled(window)
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
    rec["lanes"] = eng.num_slots
    rec["sampled"] = sampling is not None
    print(f"[profile] {eng.cfg.name} engine "
          f"{'sampled ' if sampling is not None else ''}decode step "
          f"({eng.num_slots} lanes): wall {wall:.2f} ms, device busy "
          f"{busy:.3f} ms (idle {rec['idle_share']:.1%}), "
          f"{launches:.0f} kernel launches per step")
    for t in rec["top_kernels"]:
        print(f"[profile]   {t['ms_per_step']:.4f} ms x "
              f"{t['calls_per_step']:.0f}  {t['name']}")
    return rec


# ----------------------------------------------------------------------------
# the frontends (PR 30): paligemma-3b's vision prefix, musicgen-medium's
# codebooks
# ----------------------------------------------------------------------------

def _frontend_batch(cfg, B, S, seed, device):
    """Seeded inputs (numpy) on `device`: S text tokens and their targets
    ((B, S, n_codebooks) for audio) and, for vision, B x vision_tokens
    patch embeddings (vision_dim wide, float32)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.frontend == "audio" else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape),
             "targets": rng.integers(0, cfg.vocab_size, shape)}
    if cfg.frontend == "vision":
        batch["vision_emb"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _rows_margin_rule(got, ref, ref_m, bound, what):
    """The margin rule row by row: each row of `got` equals `ref` up to its
    first divergence (time-major over the codebooks of an audio token),
    and there the reference's top-1/top-2 gap is <= bound. Returns the
    first divergences (None: equal)."""
    firsts = []
    for r in range(got.shape[0]):
        a, b = got[r].reshape(-1).cpu(), ref[r].reshape(-1).cpu()
        i = _first_divergence(a, b)
        firsts.append(i)
        if i is not None and float(ref_m[r].reshape(-1)[i]) > bound:
            raise AssertionError(
                f"{what} row {r}: leaves the reference at {i} where its "
                f"top-1/top-2 margin is {float(ref_m[r].reshape(-1)[i]):.5f}"
                f" > {bound}")
    return firsts


def _teacher_forced_rule(tokens, logits, bound, what):
    """Greedy tokens against one teacher-forced lm.forward over prompt +
    generated: tokens[:, j] must be the argmax of logits[:, j] wherever the
    forward's top-1/top-2 gap there is above `bound` (one margin a codebook
    for audio); the run also fails unless the forward's median gap is
    above the bound, which would otherwise excuse a typical token."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = tokens.to(logits.device) != logits.argmax(-1)
    bad = differ & (gap > bound)
    median = float(gap.median())
    rec = {"tokens": int(differ.numel()), "differ": int(differ.sum()),
           "max_gap_where_differ": float(gap[differ].max())
           if bool(differ.any()) else None,
           "gap_median": median, "bound": bound}
    print(f"[{what}] greedy tokens vs one lm.forward: {rec['differ']} of "
          f"{rec['tokens']} differ, each where the forward's top-1/top-2 "
          f"gap is <= {bound} (largest {rec['max_gap_where_differ']}); gap "
          f"median {median:.4f}")
    if bool(bad.any()) or median <= bound:
        raise AssertionError(f"{what}: the bf16 margin rule fails ({rec})")
    return rec


def phase_small_frontends(dev):
    """Reduced float32 paligemma-3b (8 patches of 32 as a bidirectional
    prefix, 4 query heads over 1 KV head, hd 16) and musicgen-medium (4
    codebooks, 4 heads of 16) on the card against the same models on the
    CPU (the kernels' twins): forward logits within 1e-4; train_loss
    within TRAIN_LOSS_RTOL and every gradient leaf within 1e-4 of max(1,
    max |g|) (the flash backward's prefix arm on paligemma); greedy
    generate() under the float32 margin rule (MARGIN_BOUND_F32)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.device import to_device
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.optim.mbprox import value_and_grad
    from repro_torch.tree import tree_leaves
    kernels.reset_launch_counts()
    rec = {}
    for arch in ("paligemma-3b", "musicgen-medium"):
        cfg = get_config(arch).reduced()
        params = lm.init_params(0, cfg, device="cpu")
        cuda_params = to_device(params, dev)
        batch = _frontend_batch(cfg, 2, 24, 1, "cpu")
        cbatch = {k: v.to(dev) for k, v in batch.items()}
        want, _ = lm.forward(params, cfg, batch)
        got, _ = lm.forward(cuda_params, cfg, cbatch)
        ferr = (got.cpu() - want).abs().max().item()

        def loss_fn(p, m):
            return lm.train_loss(p, cfg, m)

        (cl, _), cg = value_and_grad(loss_fn, params, batch)
        (gl, _), gg = value_and_grad(loss_fn, cuda_params, cbatch)
        lerr = abs(float(gl) - float(cl)) / abs(float(cl))
        gerr = max((a.cpu() - b).abs().max().item()
                   / max(1.0, b.abs().max().item())
                   for a, b in zip(tree_leaves(gg), tree_leaves(cg)))
        prompts = batch["tokens"][:, :8]
        toks, _ = generate(cuda_params, cfg, prompts, 16, device=dev,
                           return_margins=True)
        ref_t, ref_m = generate(params, cfg, prompts, 16, device="cpu",
                                return_margins=True)
        firsts = _rows_margin_rule(toks, ref_t, ref_m, MARGIN_BOUND_F32,
                                   f"small_frontends {arch} generate()")
        ok = ferr <= 1e-4 and lerr <= TRAIN_LOSS_RTOL and gerr <= 1e-4
        print(f"[small_frontends] {arch}: forward {tuple(got.shape)} cuda "
              f"vs cpu max_abs_err {ferr:.3g} (1e-4); train_loss rel "
              f"{lerr:.3g} ({TRAIN_LOSS_RTOL}), gradients max {gerr:.3g} "
              f"of max(1, max |g|) (1e-4); generate() {tuple(toks.shape)} "
              f"first divergences {firsts} (margin bound "
              f"{MARGIN_BOUND_F32}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"small_frontends {arch}: the card differs "
                                 f"from the CPU")
        rec[arch] = {"forward_max_abs_err": ferr, "loss_rel_err": lerr,
                     "grad_max_rel_err": gerr,
                     "generate_first_divergences": firsts}
    rec["launches"] = kernels.launch_counts()
    if not all(rec["launches"][k] for k in ("flash_attention",
                                            "flash_attention_bwd",
                                            "paged_attention")):
        raise AssertionError(f"small_frontends: a kernel of the path was not "
                             f"launched: {rec['launches']}")
    return rec


def phase_paligemma(dev):
    """Full-width paligemma-3b (18 layers, d_model 2048, 8 query heads over
    1 KV head of 256, d_ff 16384, vocab 257216; JAX's seed-0 weights drawn
    on the card, bf16): 2 rows of 256 seeded patch embeddings (1152 wide)
    + 64 text tokens through lm.prefill (18 flash launches on the prefix
    arm), 32 greedy decode_steps from its cache (18 paged_attention
    launches each), the tokens held by the bf16 margin rule against one
    lm.forward over the prefix + prompt + generated text; then one bf16
    train_loss forward + backward at B = 2 (the backward's prefix arm at
    full width). Prefill ms, ms per decode step, train ms and peak memory
    are recorded; the phase frees its tensors."""
    from repro_torch import convert, kernels
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim.mbprox import value_and_grad
    from repro_torch.tree import tree_leaves
    cfg = get_config("paligemma-3b")
    n_layers, P, N = cfg.n_layers, 64, 32
    t0 = time.perf_counter()
    params = lm.cast_params(lm.init_params(0, cfg, device=dev), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = convert.param_count(params)
    batch = _frontend_batch(cfg, 2, P, 7, dev)
    prompt = {k: batch[k] for k in ("tokens", "vision_emb")}
    S_all = cfg.vision_tokens + P
    print(f"[paligemma] {n_params} params, init + bf16 cast {init_s:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    with torch.inference_mode():
        lm.prefill(params, cfg, prompt)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, cfg, prompt)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pf_counts = kernels.launch_counts()
        state = lm.decode_state_from_prefill(cfg, cache, S_all + N + 1)
        del cache
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        out = [tok]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(N):
            lg, state = lm.decode_step(params, cfg, state, tok, S_all + i)
            tok = lg.argmax(-1).to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / N
        dec_counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        del state
        gen = torch.stack(out, dim=1)                         # (2, N + 1)
        ref, _ = lm.forward(params, cfg, {
            "tokens": torch.cat([prompt["tokens"], gen[:, :N]], dim=1),
            "vision_emb": prompt["vision_emb"]})
    if logits.shape != (2, P, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"paligemma: prefill logits {logits.shape} "
                             f"misshapen or not finite")
    if (pf_counts["flash_attention"] != n_layers
            or dec_counts["paged_attention"] != n_layers * N):
        raise AssertionError(f"paligemma: launches prefill {pf_counts}, "
                             f"decode {dec_counts}")
    rule = _teacher_forced_rule(gen, ref[:, P - 1:], MARGIN_BOUND,
                                "paligemma")
    print(f"[paligemma] prefill 2 x ({cfg.vision_tokens} patches + {P} "
          f"tokens): {prefill_ms:.2f} ms; {N} decode steps: {step_ms:.2f} ms "
          f"a step; peak {peak:.2f} GiB; launches prefill {pf_counts}, "
          f"decode {dec_counts}")
    del logits, ref, lg
    # one bf16 train_loss forward + backward (remat per layer) at B = 2
    train_ms = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):                        # the first warms up
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        (loss, _), grads = value_and_grad(
            lambda p, m: lm.train_loss(p, cfg, m), params, batch)
        torch.cuda.synchronize()
        train_ms.append((time.perf_counter() - t0) * 1e3)
        tr_counts = kernels.launch_counts()
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
        del grads
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[paligemma] bf16 train_loss forward + backward, B = 2: loss "
          f"{float(loss):.4f}, {train_ms[1]:.1f} ms (first {train_ms[0]:.1f})"
          f", peak {train_peak:.2f} GiB, launches {tr_counts}")
    if not finite or tr_counts["flash_attention_bwd"] != n_layers:
        raise AssertionError(f"paligemma: train_loss not finite ({finite}) "
                             f"or backward launches {tr_counts}")
    del params
    torch.cuda.empty_cache()
    return {"params": n_params, "init_s": init_s, "prefill_ms": prefill_ms,
            "decode_ms_per_step": step_ms, "peak_gib": peak,
            "margin_rule": rule, "train_ms": train_ms[1],
            "train_first_ms": train_ms[0], "train_peak_gib": train_peak,
            "launches": {k: pf_counts[k] + dec_counts[k] + tr_counts[k]
                         for k in pf_counts}}


def phase_musicgen(dev):
    """Full-width musicgen-medium (48 layers, d_model 1536, 24 heads of 64,
    4 codebooks of 2048; JAX's seed-0 weights drawn on the card, bf16):
    generate() on 2 x 32 seeded 4-codebook prompts + 32 new (64 steps x 48
    paged_attention launches), its tokens held per codebook by the bf16
    margin rule against one lm.forward over prompt + generated (48 flash
    launches); tokens/s and ms a step recorded; then the naive serve CLI
    at full width. The phase frees its tensors."""
    from repro_torch import convert, kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    cfg = get_config("musicgen-medium")
    B, P, N = 2, 32, 32
    t0 = time.perf_counter()
    params = lm.cast_params(lm.init_params(0, cfg, device=dev), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = convert.param_count(params)
    prompts = _frontend_batch(cfg, B, P, 9, dev)["tokens"]
    generate(params, cfg, prompts[:, :2], 2, device=dev)      # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = generate(params, cfg, prompts, N, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    gen_counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        ref, _ = lm.forward(params, cfg, {
            "tokens": torch.cat([prompts, tokens[:, :N - 1]], dim=1)})
    fwd_counts = kernels.launch_counts()
    if tokens.shape != (B, N, cfg.n_codebooks) or ref.shape != (
            B, P + N - 1, cfg.n_codebooks, cfg.vocab_size):
        raise AssertionError(f"musicgen: tokens {tuple(tokens.shape)}, "
                             f"logits {tuple(ref.shape)}")
    steps = P + N
    if (gen_counts["paged_attention"] != cfg.n_layers * steps
            or fwd_counts["flash_attention"] != cfg.n_layers):
        raise AssertionError(f"musicgen: launches generate() {gen_counts}, "
                             f"forward {fwd_counts}")
    rule = _teacher_forced_rule(tokens, ref[:, P - 1:], MARGIN_BOUND,
                                "musicgen")
    rec = {"params": n_params, "init_s": init_s, "seconds": secs,
           "tokens_per_s": B * N / secs, "ms_per_step": secs * 1e3 / steps,
           "decode_steps": steps, "margin_rule": rule,
           "launches": {k: gen_counts[k] + fwd_counts[k]
                        for k in gen_counts}}
    print(f"[musicgen] {n_params} params, init + bf16 cast {init_s:.2f} s; "
          f"generate() {B} x {P} x {cfg.n_codebooks} + {N}: {secs:.2f} s, "
          f"{rec['tokens_per_s']:.1f} tokens/s (of {cfg.n_codebooks} "
          f"codes), {rec['ms_per_step']:.2f} ms a step; launches "
          f"{rec['launches']}")
    del params, ref
    torch.cuda.empty_cache()
    rec["serve_cli"] = phase_serve_cli(dev, "musicgen-medium")
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
    from repro_torch.serving.engine import ServingEngine
    dev = resolve_device("cuda")       # also sets the float flags
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "phase_seconds": {}}

    def phase(name, fn, *a):
        """Run one phase; its wall seconds go to record["phase_seconds"]."""
        t0 = time.perf_counter()
        out = fn(*a)
        record["phase_seconds"][name] = time.perf_counter() - t0
        return out

    record["build"] = phase("build", phase_build)
    kern = phase("kernels", phase_kernels, dev)
    record["small"] = phase("small", phase_small, dev)
    # recurrentgemma-2b reduced at the full model's attention shapes (10
    # heads over 1 KV head, hd 256) with its window of 16 passed in the 40
    # tokens; rwkv6-3b reduced (4 heads of 16)
    record["small_hybrid"] = phase(
        "small_hybrid", phase_small_recurrent, dev,
        get_config("recurrentgemma-2b").reduced(head_dim=256, n_heads=10,
                                                n_kv_heads=1),
        "small_hybrid")
    record["small_rwkv"] = phase("small_rwkv", phase_small_recurrent, dev,
                                 get_config("rwkv6-3b").reduced(),
                                 "small_rwkv")
    record["small_sampled"] = phase("small_sampled", phase_small_sampled,
                                    dev)
    record["small_moe"] = phase("small_moe", phase_small_moe, dev)
    record["small_frontends"] = phase("small_frontends",
                                      phase_small_frontends, dev)
    record["train_small"] = phase("train_small", phase_train_small, dev)
    record["serve_cli_default"] = phase("serve_cli_default",
                                        phase_serve_cli_default)
    cfg = get_config("smollm-135m")
    params = lm.cast_params(lm.init_params(0, cfg, device=dev), cfg)
    record["forward"] = phase("forward", phase_forward, params, cfg, dev)
    record["engine"], engine = phase("engine", phase_engine, params, cfg,
                                     dev)
    record["engine_quant"], quant_launches = phase(
        "engine_quant", phase_engine_quant, params, cfg, dev)
    record["engine_tiered"], tiered_launches = phase(
        "engine_tiered", phase_engine_tiered, params, cfg, dev)
    record["engine_cluster"], cluster_launches, cluster_replicas = phase(
        "engine_cluster", phase_engine_cluster, params, cfg, dev)
    record["serve_cli_cluster"] = phase("serve_cli_cluster",
                                        phase_serve_cli_cluster)
    record["train"] = phase("train", phase_train, dev)
    record["core"], profile_core = phase("core", phase_core, dev)
    record["recurrentgemma"], rg_master, rg_params = phase(
        "recurrentgemma", phase_recurrentgemma, dev)
    record["engine_recurrentgemma"], rg_engine = phase(
        "engine_recurrentgemma", phase_engine_recurrent, rg_master,
        rg_params, get_config("recurrentgemma-2b"), dev,
        "engine_recurrentgemma")
    # the other models' weights leave the card before paligemma-3b's and
    # rwkv6-3b's
    del rg_master, rg_params, params
    torch.cuda.empty_cache()
    record["paligemma"] = phase("paligemma", phase_paligemma, dev)
    record["musicgen"] = phase("musicgen", phase_musicgen, dev)
    record["rwkv6"], rw_master, rwkv_params = phase("rwkv6", phase_rwkv6, dev)
    record["engine_rwkv6"], rw_engine = phase(
        "engine_rwkv6", phase_engine_recurrent, rw_master, rwkv_params,
        get_config("rwkv6-3b"), dev, "engine_rwkv6")
    del rw_master
    torch.cuda.empty_cache()
    record["rwkv6_4_layers"] = phase("rwkv6_4_layers", phase_rwkv6_4_layers,
                                     dev)
    record["engine_moe"], moe_engine, moe_params = phase(
        "engine_moe", phase_engine_moe, dev)
    # profiled last: torch.profiler's hooks stay behind in the process
    phase("timings", phase_timings, kern)
    record["decode_profile"] = phase("decode_profile", profile_decode,
                                     engine, cfg.vocab_size)
    from repro_torch.serving.sampling import SamplingParams
    record["sampled_decode_profile"] = phase(
        "sampled_decode_profile", profile_decode, engine, cfg.vocab_size, 4,
        SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=5))
    record["cluster_decode_profile"] = phase(
        "cluster_decode_profile", profile_cluster, cluster_replicas,
        cfg.vocab_size)
    del cluster_replicas
    record["moe_decode_profile"] = phase(
        "moe_decode_profile", profile_moe_decode, moe_engine, moe_params)
    del moe_engine, moe_params
    torch.cuda.empty_cache()
    record["core_profile"] = phase("core_profile", profile_core)
    rw_cfg = get_config("rwkv6-3b")
    record["rwkv6_decode_profile"] = phase(
        "rwkv6_decode_profile", profile_lm_decode, rwkv_params, rw_cfg, dev)
    # the engine of the bf16 runs of phase engine_rwkv6, every lane decoding
    record["rwkv6_engine_decode_profile"] = phase(
        "rwkv6_engine_decode_profile", profile_decode,
        ServingEngine(rwkv_params, rw_cfg, num_slots=4, block_size=16,
                      max_seq_len=2560, device=dev), rw_cfg.vocab_size)
    del rwkv_params
    torch.cuda.empty_cache()
    rg_cfg = get_config("recurrentgemma-2b")
    rg_params = lm.cast_params(lm.init_params(0, rg_cfg, device=dev), rg_cfg)
    record["recurrentgemma_decode_profile"] = phase(
        "recurrentgemma_decode_profile", profile_lm_decode, rg_params,
        rg_cfg, dev)
    record["recurrentgemma_engine_decode_profile"] = phase(
        "recurrentgemma_engine_decode_profile", profile_decode,
        ServingEngine(rg_params, rg_cfg, num_slots=4, block_size=16,
                      max_seq_len=2560, device=dev), rg_cfg.vocab_size)
    del rg_params
    rg, rw = record["recurrentgemma"], record["rwkv6"]
    mo = record["engine_moe"]["launches"]
    tr = (record["train_small"]["launches"], record["train"]["launches"])
    # the frontends' phases: the reduced models on the card, full-width
    # paligemma-3b and musicgen-medium
    fe = (record["small_frontends"]["launches"],
          record["paligemma"]["launches"], record["musicgen"]["launches"])
    launches = {"flash_attention":
                record["forward"]["launches"]["flash_attention"]
                + rg["forward"]["launches"]["flash_attention"]
                + sum(t["flash_attention"] for t in tr + fe)
                + mo["flash_attention"],
                "flash_attention_bwd":
                sum(t["flash_attention_bwd"] for t in tr + fe),
                "paged_attention":
                record["engine"]["launches"]["paged_attention"]
                + quant_launches["paged_attention"]
                + tiered_launches["paged_attention"]
                + cluster_launches["paged_attention"]
                + rg["generate"]["launches"]["paged_attention"]
                + rg_engine["paged_attention"] + mo["paged_attention"]
                + sum(t["paged_attention"] for t in fe),
                "paged_prefill": record["engine"]["launches"]["paged_prefill"]
                + quant_launches["paged_prefill"]
                + tiered_launches["paged_prefill"]
                + cluster_launches["paged_prefill"]
                + rg_engine["paged_prefill"] + mo["paged_prefill"],
                "svrg_update": record["core"]["svrg_update_launches"],
                "rglru_scan": rg["forward"]["launches"]["rglru_scan"]
                + rg["generate"]["launches"]["rglru_scan"]
                + rg_engine["rglru_scan"],
                "rwkv6_scan": rw["forward"]["launches"]["rwkv6_scan"]
                + rw["generate"]["launches"]["rwkv6_scan"]
                + rw_engine["rwkv6_scan"]}
    for k in kern:
        k["launches"] = launches[k["name"]]
    record["kernels"] = kern
    record["seconds"] = time.perf_counter() - t_start
    if args.record:
        path = Path(args.record)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))
    print(f"[done] {record['seconds']:.1f} s; by phase "
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      record["phase_seconds"].items()))
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
