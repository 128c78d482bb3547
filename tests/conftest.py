"""Settings shared by every test of the suite.

`time_limit` puts a wall-clock limit on each test (set-up and tear-down
included, by SIGALRM: tests/_limits.py): a test that hangs or waits past
SUITE_LIMIT_S seconds fails by itself with a TimeoutError, instead of
holding its pytest-xdist worker until the tier-1 run's own clock cuts the
whole run, which then reports nothing past the cut (the reference's
priority-aging livelock in
tests/test_preemption.py::test_starvation_freedom_under_high_priority_stream
did so on loaded hosts). The limit is 1.8 times the slowest passing
test of four tier-1 runs made as two copies at once on one 8-core host
(tests/test_long_context.py::test_chunked_identity_property, 170 s), so
no slow pass becomes a failure. The port's test files import a tighter
limit of the same name (tests/_torch_cpu.py), which overrides this one
there. Nothing is skipped, deselected or marked."""
import pytest
from _limits import alarm_after

SUITE_LIMIT_S = 300


@pytest.fixture(autouse=True)
def time_limit(request):
    with alarm_after(SUITE_LIMIT_S, request.node.nodeid):
        yield
