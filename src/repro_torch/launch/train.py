"""End-to-end training driver (the port of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 200 --optimizer mbprox --ckpt-dir /tmp/run1 [--resume]

    # on a machine without a GPU:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu

Trains the `.reduced()` config (like the JAX driver; `--full-config` for
the published one) on the synthetic token stream with MBProx (the paper's
technique, `optim/mbprox.py`) or the AdamW baseline, on CUDA unless
`--device` names another device. Batches are drawn on the CPU from
threefry keys fold_in(PRNGKey(seed + 1), step) (JAX's batches) and moved
to the device. Checkpoints (every 50 steps and at the end) use the JAX
package's file format, so either package resumes the other's run.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import prng
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.optim.optimizers import Schedule


def make_batch(cfg, stream, key, batch_size, n_micro, device=None):
    toks, targets = stream.batch(key, batch_size)
    Bm = batch_size // n_micro
    return {"tokens": toks.reshape(n_micro, Bm, -1).to(device),
            "targets": targets.reshape(n_micro, Bm, -1).to(device)}


def train(arch: str, steps: int, *, optimizer: str = "mbprox",
          batch_size: int = 8, n_micro: int = 2, seq_len: int = 64,
          lr: float = 3e-3, ckpt_dir: str | None = None,
          resume: bool = False, reduced: bool = True, log_every: int = 10,
          seed: int = 0, device=None):
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq_len,
                         seed=seed)

    params = lm.init_params(seed, cfg, device=dev)
    if optimizer == "mbprox":
        step_fn, inner_opt, mp_cfg = steps_lib.make_mbprox_train_step(cfg)
        opt_state = inner_opt.init(params)
    else:
        step_fn, opt = steps_lib.make_baseline_train_step(cfg)
        opt_state = opt.init(params)
    sched = Schedule(peak=lr, warmup=max(5, steps // 20), total=steps)

    start = 0
    if ckpt_dir and resume:
        restored, s = ckpt_lib.restore(ckpt_dir, {"params": params,
                                                  "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = s + 1
            print(f"resumed from step {s}")

    losses = []
    t0 = time.time()
    for step in range(start, steps):
        key = prng.fold_in(prng.PRNGKey(seed + 1), step)
        batch = make_batch(cfg, stream, key, batch_size, n_micro, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch,
                                             sched(step))
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({dt:.1f}s)", flush=True)
        if ckpt_dir and (step + 1) % 50 == 0:
            ckpt_lib.save(ckpt_dir, step, {"params": params,
                                           "opt": opt_state})
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, steps - 1, {"params": params,
                                            "opt": opt_state})
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--optimizer", default="mbprox",
                    choices=["mbprox", "baseline"])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' to run "
                         "without a GPU)")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, args.steps, optimizer=args.optimizer,
                      batch_size=args.batch_size, seq_len=args.seq_len,
                      lr=args.lr, ckpt_dir=args.ckpt_dir,
                      resume=args.resume, reduced=not args.full_config,
                      device=args.device)
    print(f"final loss: {losses[-1]:.4f} "
          f"(start {losses[0]:.4f}, min {min(losses):.4f})")


if __name__ == "__main__":
    main()
