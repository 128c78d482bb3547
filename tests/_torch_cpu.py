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
the same for both sides.

`time_limit` is an autouse fixture: a port test file imports it, and each
of its tests then fails by itself once it has run TEST_LIMIT_S seconds,
instead of holding the whole run until the run's own clock cuts it (a cut
run reports nothing past the cut). The longest port test takes ~40 s
alone on 8 cores; the limit leaves six times that for a host shared with
other runs.

`StepClock` is the clock engine, SLO and cluster tests inject (`now_fn=`)
so that no test loop is driven by the wall clock."""
import os
import signal
import threading

import pytest
import torch

TEST_LIMIT_S = 240


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // workers))


@pytest.fixture(autouse=True)
def time_limit(request):
    """SIGALRM after TEST_LIMIT_S seconds raises TimeoutError in the
    running test (set-up and tear-down included). Off where signals cannot
    be taken: outside the main thread, or without SIGALRM."""
    if (threading.current_thread() is not threading.main_thread()
            or not hasattr(signal, "SIGALRM")):
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f"{request.node.nodeid}: still running after its "
                           f"time limit of {TEST_LIMIT_S} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


class StepClock:
    """A deterministic clock for engine and cluster tests (their `now_fn`):
    every reading moves it `dt` seconds, so a run's timeline follows its
    code path and not the host's speed, and the engine's and router's
    idle waits never sleep on it. Give one instance to every engine of a
    cluster and to its router."""

    def __init__(self, dt: float = 1e-3):
        self.dt = dt
        self.t = 0.0

    def __call__(self) -> float:
        self.t += self.dt
        return self.t
