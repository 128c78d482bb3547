"""The port's CPU test set-up (tests/_torch_cpu.py): share_cores() gives a
pytest-xdist worker its share of the cores, and the autouse time_limit
fixture fails a test that runs past its limit instead of letting it hold
the run (checked in a child pytest with a 1 s limit); so does the suite's
own limit on every other test (tests/conftest.py, checked the same
way)."""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("workers", ["1", "3", "6", "64"])
def test_share_cores_gives_each_worker_its_share(monkeypatch, workers):
    threads = torch.get_num_threads()
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
    try:
        _torch_cpu.share_cores()
        cores = len(os.sched_getaffinity(0))
        want = threads if workers == "1" else max(1, cores // int(workers))
        assert torch.get_num_threads() == want
    finally:
        torch.set_num_threads(threads)


def test_time_limit_fails_a_test_past_its_limit(tmp_path):
    (tmp_path / "test_child.py").write_text(textwrap.dedent("""
        import time

        import _torch_cpu
        from _torch_cpu import time_limit  # noqa: F401

        _torch_cpu.TEST_LIMIT_S = 1


        def test_sleeps():
            time.sleep(30)


        def test_spins():
            t = time.time()
            while time.time() - t < 30:
                pass


        def test_short():
            pass
        """))
    env = dict(os.environ, PYTHONPATH=TESTS)
    env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p",
                        "no:cacheprovider", "-p", "no:xdist", "-p",
                        "no:randomly", str(tmp_path)], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stdout
    assert "2 failed, 1 passed" in r.stdout, r.stdout
    assert r.stdout.count("TimeoutError") >= 2, r.stdout


def test_suite_time_limit_fails_a_test_past_its_limit(tmp_path):
    """tests/conftest.py's limit on a test file that imports nothing of the
    port (a JAX test file's case): the suite's conftest, its limit cut to
    1 s, fails the hanging tests by themselves and passes the short one."""
    text = open(os.path.join(TESTS, "conftest.py")).read()
    assert "SUITE_LIMIT_S = 300\n" in text
    (tmp_path / "conftest.py").write_text(
        text.replace("SUITE_LIMIT_S = 300\n", "SUITE_LIMIT_S = 1\n"))
    (tmp_path / "test_child.py").write_text(textwrap.dedent("""
        import time


        def test_sleeps():
            time.sleep(30)


        def test_waits_on_a_lock():
            import threading
            lock = threading.Lock()
            lock.acquire()
            lock.acquire(timeout=30)


        def test_short():
            pass
        """))
    env = dict(os.environ, PYTHONPATH=TESTS)
    env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p",
                        "no:cacheprovider", "-p", "no:xdist", "-p",
                        "no:randomly", str(tmp_path)], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stdout
    assert "2 failed, 1 passed" in r.stdout, r.stdout
    assert r.stdout.count("TimeoutError") >= 2, r.stdout
