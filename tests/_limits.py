"""A wall-clock limit on one test, without torch or JAX (tests/conftest.py
puts one on every test of the suite; tests/_torch_cpu.py a tighter one on
the port's tests).

`alarm_after(seconds, nodeid)` arms SIGALRM for the block it guards: a
test still running when it fires gets a TimeoutError raised where it
stands and fails by itself, instead of holding its pytest-xdist worker
until the run's own clock cuts the whole run (a cut run reports nothing
past the cut). Off where signals cannot be taken: outside the main
thread, or without SIGALRM. The previous handler is put back and the
alarm cancelled on the way out."""
import contextlib
import signal
import threading


@contextlib.contextmanager
def alarm_after(seconds: int, nodeid: str):
    if (threading.current_thread() is not threading.main_thread()
            or not hasattr(signal, "SIGALRM")):
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f"{nodeid}: still running after its time limit "
                           f"of {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
