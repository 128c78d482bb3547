"""repro_torch.serving.slo.QuantileSketch: the pinned relative-error
bound against the exact nearest-rank order statistic, on every bucket
edge, on adversarial distributions and under hypothesis streams. The
port reports each bucket's point U * 2 / (1 + gamma), whose relative
error is (gamma-1)/(gamma+1) = rel_err at both edges; the JAX package's
arithmetic midpoint is off by (gamma-1)/2 just above a lower edge."""
import math

import numpy as np
import pytest

from _torch_cpu import time_limit  # noqa: F401
from repro_torch.serving.slo import QuantileSketch


def _exact_nearest_rank(vals, q):
    s = sorted(vals)
    return s[min(max(1, math.ceil(q * len(s))) - 1, len(s) - 1)]


def _assert_within_bound(vals, rel_err=0.01):
    sk = QuantileSketch(rel_err)
    for v in vals:
        sk.observe(float(v))
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        exact = _exact_nearest_rank(vals, q)
        est = sk.quantile(q)
        assert abs(est - exact) <= rel_err * exact + 1e-12, \
            (q, est, exact)


@pytest.mark.parametrize("rel_err", [0.01, 0.05])
def test_sketch_bound_at_every_bucket_edge(rel_err):
    """A value just above each bucket's lower edge and one at its upper
    edge, alone in the sketch: the arithmetic midpoint breaks the bound
    on the first, the port's point holds it on both."""
    sk = QuantileSketch(rel_err, min_value=1e-4, max_value=3.5e3)
    for i in range(1, len(sk.counts) - 1):
        lo = sk.min_value * sk.gamma ** (i - 1)
        for v in (lo * (1 + 1e-9), lo * sk.gamma):
            one = QuantileSketch(rel_err, min_value=1e-4, max_value=3.5e3)
            one.observe(v)
            assert abs(one.quantile(0.5) - v) <= rel_err * v + 1e-12, (i, v)


def test_sketch_midpoint_would_break_the_bound():
    """The fault this port repairs: (L + U) / 2 against a value just
    above L is off by (gamma - 1) / 2 > rel_err."""
    sk = QuantileSketch(0.01)
    lo = sk.min_value * sk.gamma ** 9
    midpoint = (lo + lo * sk.gamma) / 2
    assert (midpoint - lo) / lo > 0.01
    sk.observe(lo * (1 + 1e-9))
    assert abs(sk.quantile(1.0) - lo) <= 0.01 * lo + 1e-12


def test_sketch_bound_on_adversarial_distributions():
    rng = np.random.default_rng(0)
    _assert_within_bound(rng.lognormal(0.0, 2.0, 4000))     # heavy tail
    _assert_within_bound(rng.pareto(1.1, 4000) + 1e-3)      # heavier
    _assert_within_bound(np.full(100, 0.123))               # constant
    _assert_within_bound(np.concatenate([                   # bimodal,
        rng.normal(0.001, 1e-5, 2000).clip(1e-4),           # 5 decades
        rng.normal(100.0, 1.0, 2000).clip(1.0)]))           # apart
    _assert_within_bound(np.geomspace(1e-4, 3.5e3, 999))    # every decade
    _assert_within_bound([5.0])                             # single value
    _assert_within_bound(np.arange(1, 100, dtype=float), rel_err=0.05)


def test_sketch_bound_on_random_streams():
    """3000 seeded streams of 1 to 300 log-uniform values over the
    sketch's range, each at a random q."""
    rng = np.random.default_rng(7)
    for _ in range(3000):
        vals = list(np.exp(rng.uniform(math.log(1e-4), math.log(3.5e3),
                                       rng.integers(1, 301))))
        q = float(rng.uniform())
        sk = QuantileSketch(0.01)
        for v in vals:
            sk.observe(v)
        exact = _exact_nearest_rank(vals, q)
        assert abs(sk.quantile(q) - exact) <= 0.01 * exact + 1e-12


def test_sketch_bound_property_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(st.lists(st.floats(min_value=1e-4, max_value=3.5e3),
                        min_size=1, max_size=300),
               st.floats(min_value=0.0, max_value=1.0))
    @hyp.settings(max_examples=200, deadline=None, database=None)
    def prop(vals, q):
        sk = QuantileSketch(0.01)
        for v in vals:
            sk.observe(v)
        exact = _exact_nearest_rank(vals, q)
        assert abs(sk.quantile(q) - exact) <= 0.01 * exact + 1e-12

    prop()


def test_sketch_merge_equals_concatenated_stream():
    rng = np.random.default_rng(1)
    a, b, both = (QuantileSketch(0.01) for _ in range(3))
    for v in rng.lognormal(0, 1, 500):
        a.observe(v)
        both.observe(v)
    for v in rng.lognormal(2, 1, 700):
        b.observe(v)
        both.observe(v)
    a.merge(b)
    assert a.counts == both.counts and a.count == both.count
    assert a.quantile(0.9) == both.quantile(0.9)
