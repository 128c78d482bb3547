"""Set-up shared by the port's CPU tests (tests/test_torch_*.py).

The tier-1 run starts several pytest-xdist workers on one machine. At its
default size torch's intra-op pool takes one thread per core in every
worker, so together the workers run several threads a core, and each of
torch's parallel regions waits for threads that are not scheduled: a
train loop that takes 6 s alone took 351 s so. `share_cores()` gives each
worker its share of the cores this process may run on (at least one
thread); a run without xdist keeps torch's default. The thread count
changes no result a test checks: the tests hold the port to JAX within
tolerances and to itself bit for bit on one process, whose thread count is
the same for both sides."""
import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // workers))
