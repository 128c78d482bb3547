#!/usr/bin/env python3
"""Host cost of the port's checkpoints at full-width smollm-135m.

    PYTHONPATH=src python benchmarks/torch_checkpoint_io.py [--out DIR]

Draws smollm-135m's float32 params (seed 0, on the CPU) and times, on
this host's CPU: zlib at levels 0, 1 and 6 over the first 64 MiB of the
params' bytes (the ratio and MB/s of each; the format takes any zlib
stream, the port writes level 0), then `checkpoint.save` and `restore`
of {"params", "opt"} with an SGD-momentum state (1.08 GB), into --out
(default: build/checkpoint_io under this checkout), removed afterwards.
Prints one JSON line. Needs no GPU; the numbers are the host's.
"""
import argparse
import json
import shutil
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "checkpoint_io"))
    args = ap.parse_args(argv)
    params = lm.init_params(0, get_config("smollm-135m"), device="cpu")
    raw = b"".join(t.numpy().tobytes() for t in tree_leaves(params))
    sample = raw[:64 << 20]
    levels = {}
    for level in (0, 1, 6):
        t0 = time.perf_counter()
        n = len(zlib.compress(sample, level))
        secs = time.perf_counter() - t0
        levels[level] = {"ratio": n / len(sample),
                         "mb_per_s": len(sample) / secs / 1e6}
    tree = {"params": params, "opt": sgd(momentum=0.9).init(params)}
    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    path = ckpt.save(str(out), 0, tree)
    save_s = time.perf_counter() - t0
    size = Path(path).stat().st_size
    t0 = time.perf_counter()
    back, _ = ckpt.restore(str(out), tree)
    restore_s = time.perf_counter() - t0
    same = all(a.equal(b) for a, b in zip(tree_leaves(back),
                                          tree_leaves(tree)))
    shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"param_bytes": len(raw), "zlib_64mib": levels,
                      "checkpoint_bytes": size, "save_s": save_s,
                      "restore_s": restore_s, "restored_equal": same}))


if __name__ == "__main__":
    main()
