#!/usr/bin/env python3
"""The JAX package's own bf16 gaps on rwkv6-3b at full width (CPU), the
reference that chip_smoke.py's bf16 gate for the PyTorch port is stated
against.

    JAX_PLATFORMS=cpu PYTHONPATH=src python \\
        benchmarks/torch_rwkv6_bf16_reference.py [--layers 4 32] \\
        [--seeds 0 1 2] [--seeds-32 0] [--out PATH]

For rwkv6-3b (d_model 2560, 40 heads x 64, d_ff 8960, vocab 65536) cut to
L layers, with seeded random weights (repro.models.lm.init_params at
PRNGKey(seed)) and prompts 2 x 64 drawn with numpy.random.default_rng(seed)
(chip_smoke.py draws the port's prompts the same way and its weights with
lm.init_params(seed)), the first token's logits (the last prompt
position's) are taken after lm.prefill and after priming lm.decode_step
token by token, once with the float32 master weights in float32 and once
with the bf16 weights in bf16 (the config's own dtypes). It prints, per
(layers, seed):

  bf16_prefill_vs_stepwise   max |bf16 prefill - bf16 stepwise|
  bf16_vs_float32_prefill    max |bf16 - float32| after prefill
  bf16_vs_float32_stepwise   max |bf16 - float32| after stepwise decode
  float32_prefill_vs_stepwise, float32_max_abs_logit

and, per layer count, the largest of each over the seeds. The bf16
weights are drawn with param_dtype bfloat16, which rounds the same float32
draws the master holds, so they equal the master cast to bf16 (checked on
the embedding) without both being held at once: at 32 layers the float32
master is 12.3 GB. Imports JAX and the JAX package, never the port.
"""
import argparse
import dataclasses
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import lm

_prefill = jax.jit(lm.prefill, static_argnums=(1,))
_step = jax.jit(lm.decode_step, static_argnums=(1,))


def first_token_logits(params, cfg, prompts):
    """(after lm.prefill, after stepwise lm.decode_step), float32 (B, V)."""
    B, P = prompts.shape
    logits, _ = _prefill(params, cfg, {"tokens": prompts})
    pf = np.asarray(logits[:, -1], np.float32)
    state = lm.init_decode_state(cfg, B, max_len=P + 1)
    for pos in range(P):
        st, state = _step(params, cfg, state, prompts[:, pos],
                          jnp.int32(pos))
    return pf, np.asarray(st, np.float32)


def measure(n_layers, seed):
    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cfg_bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    prompts = jnp.asarray(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 64)), jnp.int32)
    key = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    master = lm.init_params(key, cfg)
    embed_bf = np.asarray(master["embed"].astype(jnp.bfloat16), np.float32)
    f_pf, f_st = first_token_logits(master, cfg32, prompts)
    del master
    bf = lm.init_params(key, cfg_bf)
    assert np.array_equal(np.asarray(bf["embed"], np.float32), embed_bf)
    b_pf, b_st = first_token_logits(bf, cfg, prompts)
    del bf
    rec = {"bf16_prefill_vs_stepwise": float(np.abs(b_pf - b_st).max()),
           "bf16_vs_float32_prefill": float(np.abs(b_pf - f_pf).max()),
           "bf16_vs_float32_stepwise": float(np.abs(b_st - f_st).max()),
           "float32_prefill_vs_stepwise": float(np.abs(f_pf - f_st).max()),
           "float32_max_abs_logit": float(np.abs(f_pf).max()),
           "bf16_argmax_equals_float32":
           (b_pf.argmax(-1) == f_pf.argmax(-1)).tolist(),
           "seconds": time.perf_counter() - t0}
    print(f"[jax] {n_layers} layers, seed {seed}: " + ", ".join(
        f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
        for k, v in rec.items()), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 32])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2],
                    help="seeds at every layer count but 32")
    ap.add_argument("--seeds-32", type=int, nargs="+", default=[0],
                    help="seeds at 32 layers (12.3 GB of float32 weights "
                         "each)")
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = {"jax": jax.__version__, "backend": jax.default_backend(),
           "prompts": "2 x 64, numpy.random.default_rng(seed)", "runs": {}}
    for L in args.layers:
        seeds = args.seeds_32 if L == 32 else args.seeds
        runs = {s: measure(L, s) for s in seeds}
        largest = {k: max(r[k] for r in runs.values())
                   for k in ("bf16_prefill_vs_stepwise",
                             "bf16_vs_float32_prefill",
                             "bf16_vs_float32_stepwise")}
        out["runs"][L] = {"seeds": runs, "largest": largest}
        print(f"[jax] {L} layers, largest over seeds {seeds}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in largest.items()), flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"[jax] {out['seconds']:.1f} s in all")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
