"""The port's paper core (repro_torch.core, repro_torch.data) held to the
JAX package (repro.core, repro.data) on the CPU, at the sizes of
tests/test_core_distributed.py: DIM=16, m=4 machines, b=64.

Function inputs come from numpy seeds; the data of whole runs is drawn by
the JAX stream and replayed, as numpy arrays, to both packages (`Replay`:
a stream that hands out the next pre-drawn batch and ignores its key).
Plans and ledgers must be equal; float32 results agree within ATOL: the
two packages sum in other orders (matmuls, reductions) and solve with
other LU codes, and the differences stay near float32 rounding of O(1)
values even through MP-DSVRG's hundreds of sequential steps.

The statistical checks of tests/test_core_prox.py and
tests/test_core_distributed.py that this slice's functions can run are
ported below on the port's own stream (a torch.Generator draw)."""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from benchmarks.appendix_e_logistic import \
    LogisticStream as JLogisticStream  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import prox as jprox  # noqa: E402
from repro.core import solvers as jsolvers  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.core.minibatch_prox import run_minibatch_prox as jrun_mbp  # noqa: E402
from repro.core.mp_dane import run_mp_dane as jrun_dane  # noqa: E402
from repro.core.mp_dsvrg import _dsvrg_inner_spmd  # noqa: E402
from repro.core.mp_dsvrg import run_mp_dsvrg as jrun_dsvrg  # noqa: E402
from repro.data.synthetic import LeastSquaresStream as JStream  # noqa: E402
from repro_torch import kernels, prng  # noqa: E402
from repro_torch.core import Ledger, losses, prox, solvers, theory  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core.minibatch_prox import run_minibatch_prox  # noqa: E402
from repro_torch.core.mp_dane import _dane_round, run_mp_dane  # noqa: E402
from repro_torch.core.mp_dsvrg import _dsvrg_inner, run_mp_dsvrg  # noqa: E402
from repro_torch.data.synthetic import LeastSquaresStream  # noqa: E402

DIM, M, B = 16, 4, 64
ATOL = 1e-5
CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


class Replay:
    """A stream with `dim`, `sample` and `sample_distributed` that ignores
    its key or generator and returns the next pre-drawn (X, y)."""

    def __init__(self, dim, items, wrap):
        self.dim = dim
        self._items = iter(items)
        self._wrap = wrap

    def _next(self, shape):
        X, y = next(self._items)
        assert X.shape[:-1] == shape, (X.shape, shape)
        return self._wrap(X), self._wrap(y)

    def sample(self, key, n):
        return self._next((n,))

    def sample_distributed(self, key, m, b):
        return self._next((m, b))


def _jax_draws(T, shape, seed, logistic=False):
    """T batches from the JAX stream as numpy: (m, b, d) / (m, b) for
    shape (m, b), (n, d) / (n,) for shape (n,); with `logistic`, from the
    App. E benchmark's LogisticStream (labels +-1, 5% flipped)."""
    s = (JLogisticStream(dim=DIM, noise=0.0, seed=0) if logistic
         else JStream(dim=DIM, noise=0.1, seed=0))
    out = []
    for t in range(T):
        X, y = s.sample(jax.random.PRNGKey(seed + t), math.prod(shape))
        out.append((np.asarray(X).reshape(*shape, DIM),
                    np.asarray(y).reshape(shape)))
    return out


def _replays(items):
    return (Replay(DIM, items, jnp.asarray), Replay(DIM, items, np.array))


@pytest.fixture(scope="module")
def jspec():
    X, y = JStream(dim=DIM, noise=0.1, seed=0).sample(jax.random.PRNGKey(1),
                                                      4096)
    L, beta = jlosses.loss_constants(X, y, radius=1.0)
    return jtheory.ProblemSpec(L=L, beta=beta, B=1.0, dim=DIM)


def _tspec(s):
    """The port's ProblemSpec with the JAX spec's fields."""
    return theory.ProblemSpec(**dataclasses.asdict(s))


# ----------------------------------------------------------------------------
# theory and accounting
# ----------------------------------------------------------------------------

SPECS = [dict(L=2.3, beta=2.0, B=1.0, dim=16),
         dict(L=1.4, beta=1.2, B=2.0, lam=0.1, dim=64),
         dict(L=0.5, beta=4.0, B=0.5, dim=1 << 20)]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("n,m,b", [(2048, 4, 64), (8192, 8, 128),
                                   (10**6, 16, 1000), (512, 4, 2048)])
def test_theory_plans_equal_jax(spec, n, m, b):
    js, ts = jtheory.ProblemSpec(**spec), theory.ProblemSpec(**spec)
    assert (dataclasses.asdict(theory.mp_dsvrg_plan(ts, n, m, b))
            == dataclasses.asdict(jtheory.mp_dsvrg_plan(js, n, m, b)))
    assert (dataclasses.asdict(theory.mp_dane_plan(ts, n, m, b, ts.dim))
            == dataclasses.asdict(jtheory.mp_dane_plan(js, n, m, b, js.dim)))
    for method in ("ideal", "accelerated_gd", "acc_minibatch_sgd", "dane",
                   "disco", "aide", "dsvrg", "mp_dsvrg", "mp_dane"):
        assert (theory.table1_resources(method, ts, n, m, b)
                == jtheory.table1_resources(method, js, n, m, b))
    T = max(1, n // (b * m))
    assert theory.b_star(ts, n, m, ts.dim) == jtheory.b_star(js, n, m, js.dim)
    assert theory.n_eps(ts, 0.01) == jtheory.n_eps(js, 0.01)
    assert (theory.gamma_weakly_convex(ts, b, T)
            == jtheory.gamma_weakly_convex(js, b, T))
    for exact in (True, False):
        assert (theory.rate_bound_weakly_convex(ts, b, T, exact)
                == jtheory.rate_bound_weakly_convex(js, b, T, exact))
    for t in (1, 2, 7):
        assert (theory.gamma_strongly_convex(ts, t)
                == jtheory.gamma_strongly_convex(js, t))
        assert (theory.eta_schedule_weakly_convex(ts, b, T, t)
                == jtheory.eta_schedule_weakly_convex(js, b, T, t))
    if spec.get("lam"):
        assert (theory.rate_bound_strongly_convex(ts, b, T)
                == jtheory.rate_bound_strongly_convex(js, b, T))
        assert (theory.eta_schedule_strongly_convex(ts, b, T, 3)
                == jtheory.eta_schedule_strongly_convex(js, b, T, 3))


def test_ledger_matches_jax():
    from repro.core.accounting import Ledger as JLedger
    a, ja = Ledger(), JLedger()
    for led in (a, ja):
        led.communicate(3, 2)
        led.compute(17)
        led.hold(5)
        led.hold(2)
    b = a + Ledger(comm_rounds=1, vector_ops=4, peak_memory_vectors=9)
    jb = ja + JLedger(comm_rounds=1, vector_ops=4, peak_memory_vectors=9)
    assert a.as_dict() == ja.as_dict()
    assert b.as_dict() == jb.as_dict()


# ----------------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------------

LOSSES = {"least_squares": lambda mod: mod.least_squares(),
          "ridge_least_squares": lambda mod: mod.ridge_least_squares(0.3),
          "logistic": lambda mod: mod.logistic(),
          "logistic_ridge": lambda mod: mod.logistic_ridge(0.3)}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(len(name))
    X = rng.standard_normal((32, DIM)).astype(np.float32)
    w = rng.standard_normal(DIM).astype(np.float32)
    y = rng.standard_normal(32).astype(np.float32)
    if name.startswith("logistic"):
        y = np.sign(y).astype(np.float32)
        X *= 3.0                        # margins up to ~40: both tails
    jl, tl = LOSSES[name](jlosses), LOSSES[name](losses)
    assert (tl.name, tl.lam) == (jl.name, jl.lam)
    _close(tl.value(_t(w), _t(X), _t(y)), jl.value(w, X, y), atol=1e-5)
    _close(tl.grad(_t(w), _t(X), _t(y)), jl.grad(w, X, y), atol=1e-5)
    for i in (0, 7):
        _close(tl.per_example_grad(_t(w), _t(X[i]), _t(y[i])),
               jl.per_example_grad(w, X[i], y[i]), atol=1e-5)


def test_lsq_batch_forms_and_constants_match_jax():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((48, DIM)).astype(np.float32) / 4
    w = rng.standard_normal(DIM).astype(np.float32)
    y = rng.standard_normal(48).astype(np.float32)
    _close(losses.lsq_batch_value(_t(w), _t(X), _t(y)),
           jlosses.lsq_batch_value(w, X, y))
    _close(losses.lsq_batch_grad(_t(w), _t(X), _t(y)),
           jlosses.lsq_batch_grad(w, X, y))
    for kw in (dict(), dict(radius=2.0, lam=0.5)):
        for yy in (None, y):
            got = losses.loss_constants(_t(X), None if yy is None else _t(yy),
                                        **kw)
            want = jlosses.loss_constants(X, yy, **kw)
            np.testing.assert_allclose(got, want, rtol=1e-6)


# ----------------------------------------------------------------------------
# prox
# ----------------------------------------------------------------------------

def _prox_case(stacked, seed=0):
    rng = np.random.default_rng(seed)
    shape = (M, 16) if stacked else (64,)
    X = (rng.standard_normal((*shape, DIM)) / 4).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    w_prev = rng.standard_normal(DIM).astype(np.float32)
    w = rng.standard_normal(DIM).astype(np.float32)
    return X, y, w_prev, w


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("lam", [0.0, 0.4])
def test_prox_functions_match_jax(stacked, lam):
    X, y, w_prev, w = _prox_case(stacked)
    tX, ty, twp, tw = map(_t, (X, y, w_prev, w))
    for gamma in (0.1, 2.0):
        _close(prox.exact_lsq_prox(twp, tX, ty, gamma, lam),
               jprox.exact_lsq_prox(w_prev, X, y, gamma, lam))
        _close(prox.prox_subproblem_value(tw, twp, tX, ty, gamma, lam),
               jprox.prox_subproblem_value(w, w_prev, X, y, gamma, lam))
        _close(prox.prox_subproblem_grad(tw, twp, tX, ty, gamma, lam),
               jprox.prox_subproblem_grad(w, w_prev, X, y, gamma, lam))
        _close(prox.sgd_equivalence_residual(tw, twp, tX, ty, gamma, lam),
               jprox.sgd_equivalence_residual(w, w_prev, X, y, gamma, lam))


def test_project_l2_ball_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal(DIM).astype(np.float32)
    for radius in (0.5, 1e3, float("inf")):
        _close(prox.project_l2_ball(_t(w), radius),
               jprox.project_l2_ball(w, radius), atol=1e-6)
    _close(prox.project_l2_ball(torch.zeros(DIM), 1.0), np.zeros(DIM), 0)


# ----------------------------------------------------------------------------
# solvers
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("lam,with_c", [(0.0, False), (0.2, True)])
def test_svrg_pass_wr_matches_jax(lam, with_c):
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((24, DIM)) / 4).astype(np.float32)
    y = rng.standard_normal(24).astype(np.float32)
    x0, z, mu, w, c = (rng.standard_normal(DIM).astype(np.float32)
                       for _ in range(5))
    c = c if with_c else None
    kw = dict(lam=lam, linear_c=c)
    jz, jx = jsolvers.svrg_pass_wr(jlosses.least_squares().per_example_grad,
                                   x0, z, mu, X, y, 0.1, 0.7, w, **kw)
    kw["linear_c"] = None if c is None else _t(c)
    tz, tx = solvers.svrg_pass_wr(losses.least_squares().per_example_grad,
                                  _t(x0), _t(z), _t(mu), _t(X), _t(y), 0.1,
                                  0.7, _t(w), **kw)
    _close(tz, jz)
    _close(tx, jx)


def test_gd_matches_jax():
    X, y, w_prev, w = _prox_case(False, seed=4)

    def jgrad(v):
        return jprox.prox_subproblem_grad(v, w_prev, X, y, 1.0)

    def tgrad(v):
        return prox.prox_subproblem_grad(v, _t(w_prev), _t(X), _t(y), 1.0)

    _close(solvers.gd(tgrad, _t(w), 0.2, iters=50),
           jsolvers.gd(jgrad, jnp.asarray(w), 0.2, iters=50))


@pytest.mark.parametrize("stacked", [False, True])
def test_exact_quadratic_matches_jax(stacked):
    X, y, w_prev, w = _prox_case(stacked, seed=5)
    rng = np.random.default_rng(6)
    c, yv = (rng.standard_normal(DIM).astype(np.float32) for _ in range(2))
    for kw in (dict(), dict(lam=0.1, linear_c=c, kappa=3.0, yv=yv)):
        tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        _close(solvers.exact_quadratic(_t(w_prev), _t(X), _t(y), 0.8, **tkw),
               jsolvers.exact_quadratic(w_prev, X, y, 0.8, **kw))


def test_prox_step_is_quad_prox():
    """The solvers' two-op prox step against the reference's _quad_prox of
    the gradient step (float32 rounding apart)."""
    rng = np.random.default_rng(8)
    x, g, a, yv = (_t(rng.standard_normal((M, DIM))) for _ in range(4))
    for eta, gamma, kappa in ((0.05, 1.5, 0.0), (0.3, 0.2, 4.0)):
        _, shift, div, step, _ = solvers._setup(x[0], x[:, None], eta, gamma,
                                                a, kappa, yv)
        _close(solvers._prox_step(x, g, shift, div, step),
               solvers._quad_prox(x - eta * g, eta, gamma, a, kappa, yv),
               atol=1e-6)


LAM_LOSSES = {"least_squares": ("least_squares", None),
              "logistic": ("logistic", None),
              "ridge_least_squares": ("ridge_least_squares", 0.3)}


def _solver_case(stacked, extra, logistic=False, seed=9):
    """Inputs of a local solve: one machine's (n, d) rows or an (m, n, d)
    stack, and with `extra` a catalyst point, a correction c (one per
    machine in a stack) and lam > 0."""
    rng = np.random.default_rng(seed)
    shape = (M, 32) if stacked else (32,)
    X = (rng.standard_normal((*shape, DIM)) / 4).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    if logistic:
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    x0, a, yv = (rng.standard_normal(DIM).astype(np.float32) / 4
                 for _ in range(3))
    c = (rng.standard_normal((M, DIM) if stacked else DIM) / 4).astype(
        np.float32)
    kw = dict(kappa=2.0, yv=yv, linear_c=c, lam=0.1) if extra else {}
    return X, y, x0, a, kw


def _jax_solve(fn, X, y, x0, a, kw, **static):
    """The reference solver, under vmap over machines for a stack (its
    key and every vector but c unmapped, as mp_dane.py runs it)."""
    if X.ndim == 2:
        return fn(X, y, x0, a, **kw, **static)
    c = kw.pop("linear_c", None)
    if c is None:
        return jax.vmap(lambda Xl, yl: fn(Xl, yl, x0, a, **kw, **static))(
            X, y)
    return jax.vmap(lambda Xl, yl, cl: fn(Xl, yl, x0, a, linear_c=cl, **kw,
                                          **static))(X, y, c)


def _tkw(kw):
    return {k: _t(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


@pytest.mark.parametrize("loss", sorted(LAM_LOSSES))
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("extra", [False, True])
def test_prox_svrg_matches_jax(loss, stacked, extra):
    """Two epochs (one for a stack, with more steps than rows) from the
    same key: the port's host loop against the reference's scan."""
    X, y, x0, a, kw = _solver_case(stacked, extra, loss == "logistic")
    jl, tl = LOSSES[loss](jlosses), LOSSES[loss](losses)
    static = dict(epochs=1, steps=48) if stacked else dict(epochs=2)
    seed = 5
    want = _jax_solve(
        lambda *args, **k: jsolvers.prox_svrg(
            jl.per_example_grad, jax.random.PRNGKey(seed), args[2], args[0],
            args[1], 0.05, 1.5, args[3], **k),
        X, y, x0, a, dict(kw), **static)
    got = solvers.prox_svrg(tl.per_example_grad, prng.PRNGKey(seed), _t(x0),
                            _t(X), _t(y), 0.05, 1.5, _t(a), **_tkw(kw),
                            **static)
    assert got.shape == np.shape(want)
    _close(got, want)


SCALAR_GRADS = {
    "residual": (lambda w, x, y: jnp.dot(w, x) - y, solvers.lsq_residual),
    "logistic": (lambda w, x, y: -jax.nn.sigmoid(-y * jnp.dot(w, x)) * y,
                 lambda w, x, y: -torch.sigmoid(-y * losses.margin(w, x))
                 * y)}


@pytest.mark.parametrize("grad", sorted(SCALAR_GRADS))
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("extra", [False, True])
def test_saga_linear_matches_jax(grad, stacked, extra):
    X, y, x0, a, kw = _solver_case(stacked, extra, grad == "logistic")
    jg, tg = SCALAR_GRADS[grad]
    static = dict(steps=80) if stacked else {}
    seed = 2**32 + 5
    want = _jax_solve(
        lambda *args, **k: jsolvers.saga_linear(
            jg, jax.random.PRNGKey(seed), args[2], args[0], args[1], 0.05,
            1.5, args[3], **k),
        X, y, x0, a, dict(kw), **static)
    got = solvers.saga_linear(tg, prng.PRNGKey(seed), _t(x0), _t(X), _t(y),
                              0.05, 1.5, _t(a), **_tkw(kw), **static)
    assert got.shape == np.shape(want)
    _close(got, want)


# ----------------------------------------------------------------------------
# MP-DSVRG inner loop and whole runs through the replay stream
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("p,K,lam", [(4, 12, 0.0), (5, 7, 0.1)])
def test_dsvrg_inner_matches_jax_vmap(jspec, p, K, lam):
    """The port's m-machine loop against the reference's SPMD program
    under vmap; p = 5 drops the last 64 mod 5 rows, lam > 0 keeps the
    reference's pass without a lam * x term."""
    (Xm, ym), = _jax_draws(1, (M, B), seed=3)
    rng = np.random.default_rng(p)
    w_prev, x_init = (rng.standard_normal(DIM).astype(np.float32) / 4
                      for _ in range(2))
    gamma = 2.0
    eta = 0.3 / (jspec.beta + gamma)
    spmd = jax.vmap(
        lambda X, y: _dsvrg_inner_spmd(jlosses.least_squares(), w_prev,
                                       x_init, X, y, gamma, eta, p=p, K=K,
                                       m=M, lam=lam),
        axis_name="machines")
    jz, jx = spmd(Xm, ym)
    tz, tx = _dsvrg_inner(losses.least_squares(), _t(w_prev), _t(x_init),
                          _t(Xm), _t(ym), gamma, eta, p, K, lam)
    _close(tz, jz[0])
    _close(tx, jx[0])


@pytest.mark.parametrize("lam", [0.0, 0.1])
def test_run_mp_dsvrg_matches_jax(jspec, lam):
    T = 8
    jstream, tstream = _replays(_jax_draws(T, (M, B), seed=100))
    jr = jrun_dsvrg(jstream, jspec, M, B, T, lam=lam)
    before = kernels.launch_counts()
    tr = run_mp_dsvrg(tstream, _tspec(jspec), M, B, T, lam=lam, device=CPU)
    assert kernels.launch_counts() == before      # the CPU takes the twin
    assert dataclasses.asdict(tr.plan) == dataclasses.asdict(jr.plan)
    assert tr.ledger.as_dict() == jr.ledger.as_dict()
    assert tr.iterates.shape == (T, DIM)
    _close(tr.iterates, jr.iterates)
    _close(tr.w_avg, jr.w_avg)
    _close(tr.w_last, jr.w_last)


@pytest.mark.parametrize("correction", [True, False])
def test_run_mp_dane_exact_matches_jax(jspec, correction):
    T = 6
    jstream, tstream = _replays(_jax_draws(T, (M, B), seed=200))
    jr = jrun_dane(jstream, jspec, M, B, T, local_solver="exact",
                   correction=correction)
    tr = run_mp_dane(tstream, _tspec(jspec), M, B, T, local_solver="exact",
                     correction=correction, device=CPU)
    assert dataclasses.asdict(tr.plan) == dataclasses.asdict(jr.plan)
    assert tr.plan.R > 1 and tr.plan.kappa > 0     # the AIDE loop runs
    assert tr.ledger.as_dict() == jr.ledger.as_dict()
    _close(tr.iterates, jr.iterates)
    _close(tr.w_avg, jr.w_avg)


@pytest.mark.parametrize("loss", ["least_squares", "logistic"])
def test_dane_round_matches_jax(loss):
    """One DANE iteration with kappa > 0 and a catalyst point y_cat; a loss
    other than least squares takes its local gradients from
    per_example_grad, the exact solve stays the least-squares one."""
    from repro.core.mp_dane import _dane_round_spmd
    (Xm, ym), = _jax_draws(1, (M, B), seed=7)
    rng = np.random.default_rng(7)
    z, w, yc = (rng.standard_normal(DIM).astype(np.float32) / 4
                for _ in range(3))
    step = jax.vmap(
        lambda X, y: _dane_round_spmd(
            LOSSES[loss](jlosses), z, X, y, w, yc, 1.5, 4.0, 0.1, "exact",
            jax.random.PRNGKey(0), 0.1, True), axis_name="machines")
    got = _dane_round(LOSSES[loss](losses), _t(z), _t(Xm), _t(ym), _t(w),
                      _t(yc), 1.5, 4.0, 0.1, True)
    _close(got, step(Xm, ym)[0])


@pytest.mark.parametrize("solver,strong,radius,w0", [
    ("exact", False, float("inf"), False),
    ("gd", False, float("inf"), False),
    ("exact", True, float("inf"), False),
    ("gd", True, float("inf"), True),
    ("exact", False, 0.5, True),
    ("gd", False, 0.3, False),
])
def test_run_minibatch_prox_matches_jax(jspec, solver, strong, radius, w0):
    T, b = 8, 64
    lam = 0.5 if strong else 0.0
    jstream, tstream = _replays(_jax_draws(T, (b,), seed=300))
    w_init = (np.random.default_rng(0).standard_normal(DIM)
              .astype(np.float32) / 2) if w0 else None
    kw = dict(solver=solver, strongly_convex=strong, lam=lam, radius=radius,
              inner_steps=40)
    jr = jrun_mbp(jstream, jspec, b, T, w0=None if w_init is None
                  else jnp.asarray(w_init), **kw)
    tr = run_minibatch_prox(tstream, _tspec(jspec), b, T, w0=None
                            if w_init is None else _t(w_init), device=CPU,
                            **kw)
    assert tr.ledger.as_dict() == jr.ledger.as_dict()
    _close(tr.gammas, jr.gammas, atol=0)
    _close(tr.iterates, jr.iterates)
    _close(tr.w_avg, jr.w_avg)
    if radius != float("inf"):
        assert float(torch.linalg.vector_norm(tr.w_last)) <= radius * 1.0001


@pytest.mark.parametrize("solver,loss", [("saga", "least_squares"),
                                         ("prox_svrg", "least_squares"),
                                         ("prox_svrg", "logistic"),
                                         ("saga", "logistic")])
def test_run_mp_dane_inexact_matches_jax(jspec, solver, loss):
    """MP-DANE with a stochastic local solver, the AIDE loop running (R = 2,
    the plan's kappa > 0), the same threefry keys as the reference. On
    logistic data (the App. E benchmark's stream, replayed) 'saga' keeps
    the reference's quirk: its scalar gradient is the least-squares
    residual whatever the loss."""
    T, eta = 3, {"saga": 0.1, "prox_svrg": 0.05}[solver]
    logistic = loss == "logistic"
    jstream, tstream = _replays(_jax_draws(T, (M, B), seed=250,
                                           logistic=logistic))
    spec = (jtheory.ProblemSpec(L=2.0, beta=0.5, B=2.0, dim=DIM) if logistic
            else jspec)
    kw = dict(K=2, R=2, local_solver=solver, eta_scale=eta, seed=3)
    jr = jrun_dane(jstream, spec, M, B, T, loss=LOSSES[loss](jlosses), **kw)
    tr = run_mp_dane(tstream, _tspec(spec), M, B, T,
                     loss=LOSSES[loss](losses), device=CPU, **kw)
    assert dataclasses.asdict(tr.plan) == dataclasses.asdict(jr.plan)
    assert tr.plan.kappa > 0
    assert tr.ledger.as_dict() == jr.ledger.as_dict()
    _close(tr.iterates, jr.iterates)
    _close(tr.w_avg, jr.w_avg)


@pytest.mark.parametrize("solver,strong,inner_steps,inner_epochs", [
    ("saga", False, 0, 2), ("prox_svrg", False, 0, 2),
    ("saga", True, 40, 2), ("prox_svrg", True, 40, 3)])
def test_run_minibatch_prox_inexact_matches_jax(jspec, solver, strong,
                                                inner_steps, inner_epochs):
    """prox-SVRG (ridge loss and lam = 0 in the solver when lam > 0) and
    SAGA (lam in the solver) with the reference's step sizes, keys and
    ledger charges."""
    T, b = 3, 64
    jstream, tstream = _replays(_jax_draws(T, (b,), seed=350))
    kw = dict(solver=solver, strongly_convex=strong,
              lam=0.5 if strong else 0.0, inner_steps=inner_steps,
              inner_epochs=inner_epochs, seed=4)
    jr = jrun_mbp(jstream, jspec, b, T, **kw)
    tr = run_minibatch_prox(tstream, _tspec(jspec), b, T, device=CPU, **kw)
    assert tr.ledger.as_dict() == jr.ledger.as_dict()
    _close(tr.gammas, jr.gammas, atol=0)
    _close(tr.iterates, jr.iterates)
    _close(tr.w_avg, jr.w_avg)


# ----------------------------------------------------------------------------
# baselines through the replay stream
# ----------------------------------------------------------------------------

BASELINE_RUNS = {
    "minibatch_sgd": ("run_minibatch_sgd", (M, 16, 8), {}, False),
    "minibatch_sgd_radius": ("run_minibatch_sgd", (M, 16, 8),
                             dict(radius=0.3), False),
    "minibatch_sgd_logistic": ("run_minibatch_sgd", (M, 32, 4),
                               dict(loss="logistic"), True),
    "acc_minibatch_sgd": ("run_acc_minibatch_sgd", (M, 32, 8), {}, False),
    "acc_minibatch_sgd_radius": ("run_acc_minibatch_sgd", (M, 32, 8),
                                 dict(radius=0.3, step_scale=2.0), False),
    "single_sgd": ("run_single_sgd", (512,), {}, False),
    "single_sgd_radius": ("run_single_sgd", (512,), dict(radius=0.3),
                          False),
    "dsvrg_erm": ("run_dsvrg_erm", (M, 512), {}, False),
    "dsvrg_erm_K3": ("run_dsvrg_erm", (M, 1024), dict(K=3), False),
    "emso": ("run_emso", (M, B, 4), {}, False),
}


def _baseline_draws(name, args, logistic):
    """The data the run draws: T minibatches of (m, b) (one stored
    dataset of (m, n // m) for DSVRG-ERM, n rows for single SGD)."""
    if name == "run_single_sgd":
        return _jax_draws(1, (args[0],), seed=600)
    if name == "run_dsvrg_erm":
        return _jax_draws(1, (args[0], args[1] // args[0]), seed=700)
    return _jax_draws(args[-1], args[:2], seed=500, logistic=logistic)


@pytest.mark.parametrize("case", sorted(BASELINE_RUNS))
def test_baselines_match_jax(jspec, case):
    """Each baseline within ATOL of the reference on replayed data, with
    an equal ledger (and, for EMSO, an equal plan)."""
    name, args, kw, logistic = BASELINE_RUNS[case]
    jkw, tkw = dict(kw), dict(kw)
    if "loss" in kw:
        jkw["loss"], tkw["loss"] = (LOSSES[kw["loss"]](jlosses),
                                    LOSSES[kw["loss"]](losses))
    spec = (jtheory.ProblemSpec(L=2.0, beta=0.5, B=2.0, dim=DIM) if logistic
            else jspec)
    jstream, tstream = _replays(_baseline_draws(name, args, logistic))
    jr = getattr(jbaselines, name)(jstream, spec, *args, **jkw)
    before = kernels.launch_counts()
    tr = getattr(baselines, name)(tstream, _tspec(spec), *args, device=CPU,
                                  **tkw)
    assert kernels.launch_counts() == before      # the CPU takes the twin
    assert tr.ledger.as_dict() == jr.ledger.as_dict()
    if name == "run_emso":
        assert dataclasses.asdict(tr.plan) == dataclasses.asdict(jr.plan)
    _close(tr.w_avg, jr.w_avg)
    _close(tr.w_last, jr.w_last)


def test_dsvrg_erm_default_K_is_the_float32_log():
    """K = int(log(n)) with the log taken in float32, as the reference
    takes it (its ledger shows K)."""
    s = LeastSquaresStream(dim=DIM)
    spec = theory.ProblemSpec(L=2.0, beta=2.0, B=1.0, dim=DIM)
    for n in (8, 20, 148):
        r = baselines.run_dsvrg_erm(s, spec, 4, n, device=CPU)
        K = max(1, int(jnp.log(jnp.asarray(float(n)))))
        assert r.ledger.comm_rounds == 2 * K, (n, K)


# ----------------------------------------------------------------------------
# the port's own stream
# ----------------------------------------------------------------------------

def test_stream_scales_equal_jax_and_w_star_is_one_vector():
    for d in (16, 64, 1000):
        np.testing.assert_array_equal(
            LeastSquaresStream(dim=d)._spectrum().numpy(),
            np.asarray(JStream(dim=d)._spectrum()))
    s = LeastSquaresStream(dim=DIM, seed=3)
    w = s.w_star()
    np.testing.assert_allclose(float(torch.linalg.vector_norm(w)), 1.0,
                               rtol=1e-6)
    torch.testing.assert_close(s.w_star(CPU), w, atol=0, rtol=0)
    g = torch.Generator().manual_seed(0)
    X, y = s.sample_distributed(g, 3, 5)
    assert X.shape == (3, 5, DIM) and y.shape == (3, 5)


def test_stream_closed_form_matches_monte_carlo():
    """expected_suboptimality (the closed form) against the chunked
    population estimate, which draws 65536 rows (~0.4% relative error)."""
    s = LeastSquaresStream(dim=DIM, noise=0.1, seed=0)
    rng = np.random.default_rng(2)
    for scale in (0.1, 1.0):
        w = _t(rng.standard_normal(DIM) * scale)
        exact = float(s.expected_suboptimality(w))
        mc = float(s.population_suboptimality(w))
        assert abs(mc - exact) <= 0.03 * exact, (mc, exact)
    assert float(s.expected_suboptimality(s.w_star())) == 0.0
    # the same population objective whatever the chunk size
    obj = float(s.population_objective(w, n_eval=4096))
    from repro_torch.data import synthetic
    old = synthetic.EVAL_CHUNK_ELEMS
    try:
        synthetic.EVAL_CHUNK_ELEMS = 4096 * DIM
        assert float(s.population_objective(w, n_eval=4096)) == obj
    finally:
        synthetic.EVAL_CHUNK_ELEMS = old


# ----------------------------------------------------------------------------
# statistical checks on the port's own stream (tests/test_core_prox.py and
# tests/test_core_distributed.py)
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream():
    return LeastSquaresStream(dim=DIM, noise=0.1, seed=0)


@pytest.fixture(scope="module")
def spec(stream):
    X, y = stream.sample(torch.Generator().manual_seed(1), 4096)
    L, beta = losses.loss_constants(X, y, radius=1.0)
    return theory.ProblemSpec(L=L, beta=beta, B=1.0, dim=DIM)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_exact_prox_is_fixed_point_and_reduces_subproblem(stream):
    """Eq. (5): w_t = w_{t-1} - (1/gamma) grad phi_{I_t}(w_t); f_t(w_t) <=
    f_t(w_{t-1})."""
    X, y = stream.sample(_gen(0), 64)
    w_prev = torch.randn(DIM, generator=_gen(1))
    for gamma in [0.1, 1.0, 10.0]:
        w_t = prox.exact_lsq_prox(w_prev, X, y, gamma)
        res = prox.sgd_equivalence_residual(w_t, w_prev, X, y, gamma)
        _close(res, np.zeros(DIM), atol=1e-4)
        assert (float(prox.prox_subproblem_value(w_t, w_prev, X, y, gamma))
                <= float(prox.prox_subproblem_value(w_prev, w_prev, X, y,
                                                    gamma)) + 1e-6)


def test_lemma1_inequality(stream):
    X, y = stream.sample(_gen(4), 64)
    gamma = 2.0
    w_prev = torch.randn(DIM, generator=_gen(5))
    w_t = prox.exact_lsq_prox(w_prev, X, y, gamma)
    for i in range(5):
        w = torch.randn(DIM, generator=_gen(10 + i))
        lhs = torch.sum((w_t - w) ** 2)
        rhs = (torch.sum((w_prev - w) ** 2) - torch.sum((w_prev - w_t) ** 2)
               - (2.0 / gamma) * (losses.lsq_batch_value(w_t, X, y)
                                  - losses.lsq_batch_value(w, X, y)))
        assert float(lhs) <= float(rhs) + 1e-4


@pytest.mark.parametrize("b,T", [(32, 32), (128, 8)])
def test_theorem4_rate(stream, spec, b, T):
    res = run_minibatch_prox(stream, spec, b, T, solver="exact", device=CPU)
    sub = float(stream.population_suboptimality(res.w_avg))
    assert sub <= theory.rate_bound_weakly_convex(spec, b, T), sub


def test_theorem5_strongly_convex_rate(stream):
    lam = 0.5
    X, y = stream.sample(_gen(1), 4096)
    L, beta = losses.loss_constants(X, y, radius=1.0, lam=lam)
    spec_sc = theory.ProblemSpec(L=L, beta=beta, B=1.0, lam=lam, dim=DIM)
    b, T = 64, 16
    res = run_minibatch_prox(stream, spec_sc, b, T, solver="exact",
                             strongly_convex=True, lam=lam, device=CPU)
    Xe, ye = stream.sample(_gen(10**6), 65536)
    H = Xe.T @ Xe / Xe.shape[0] + lam * torch.eye(DIM)
    w_opt = torch.linalg.solve(H, Xe.T @ ye / Xe.shape[0])

    def phi(w):
        r = Xe @ w - ye
        return 0.5 * torch.mean(r * r) + 0.5 * lam * torch.dot(w, w)

    sub = float(phi(res.w_avg) - phi(w_opt))
    assert sub <= theory.rate_bound_strongly_convex(spec_sc, b, T) + 1e-5


def test_inexact_gd_matches_exact(stream, spec):
    exact = run_minibatch_prox(stream, spec, 64, 8, solver="exact", seed=3,
                               device=CPU)
    inexact = run_minibatch_prox(stream, spec, 64, 8, solver="gd",
                                 inner_steps=400, seed=3, device=CPU)
    _close(inexact.w_avg, exact.w_avg, atol=5e-3)


def test_mp_dsvrg_converges(stream, spec):
    res = run_mp_dsvrg(stream, spec, m=M, b=B, T=8, device=CPU)
    sub = float(stream.population_suboptimality(res.w_avg))
    bound = theory.rate_bound_weakly_convex(spec, B * M, 8, exact=False)
    assert sub <= bound, (sub, bound)


@pytest.mark.parametrize("lam", [0.0, 0.1])
def test_mp_dsvrg_inner_solves_subproblem(stream, spec, lam):
    """With many inner iterations the DSVRG loop approaches the exact
    solution of the union minibatch prox subproblem (eq. 12). With lam > 0
    too: the pass takes lam * z (in mu) for lam * x, which changes the
    steps but not the fixed point."""
    Xm, ym = stream.sample_distributed(_gen(3), M, B)
    gamma = 2.0
    w_prev = torch.zeros(DIM)
    exact = prox.exact_lsq_prox(w_prev, Xm, ym, gamma, lam)
    eta = 0.3 / (spec.beta + gamma + lam)
    z, _ = _dsvrg_inner(losses.least_squares(), w_prev, w_prev, Xm, ym,
                        gamma, eta, p=4, K=40, lam=lam)
    gap = float(prox.prox_subproblem_value(z, w_prev, Xm, ym, gamma, lam)
                - prox.prox_subproblem_value(exact, w_prev, Xm, ym, gamma,
                                             lam))
    assert gap < 1e-3, gap


# the two bounds chip_smoke.py holds on MP-DSVRG at d = 2^20
PROX_GAP_RATIO = 1e-2
EXACT_PATH_DIST = 0.1


def _exact_path_readings(d):
    """MP-DSVRG at the quickstart's m = 8, b = 128, T = 8 and the
    Theorem-10 plan, beside the exact minibatch-prox path on the same data.
    Returns the largest share of an outer step's prox-subproblem gap
    f_t(w) - f_t(w_t*) (from w_{t-1}) that the K inner iterations leave,
    and the distance of w_avg from the exact path's average, relative to
    the latter."""
    s = LeastSquaresStream(dim=d, noise=0.1, seed=0)
    X, y = s.sample(_gen(1), 8192)
    L, beta = losses.loss_constants(X, y, radius=1.0)
    spec = theory.ProblemSpec(L=L, beta=beta, B=1.0, dim=d)
    g = _gen(0)
    draws = [s.sample_distributed(g, 8, 128) for _ in range(8)]
    res = run_mp_dsvrg(Replay(d, draws, lambda a: a), spec, 8, 128, 8,
                       device=CPU)
    gamma = res.plan.gamma

    def gap(w, w_star, Xm):
        Xf = Xm.reshape(-1, d).double()
        e = w.double() - w_star
        return float(0.5 * ((Xf @ e).square().mean()
                            + gamma * e.square().sum()))

    w_prev = w_exact = torch.zeros(d, dtype=torch.float64)
    exact, ratios = [], []
    for t, (Xm, ym) in enumerate(draws):
        Xd, yd = Xm.double(), ym.double()
        star = prox.exact_lsq_prox(w_prev.double(), Xd, yd, gamma)
        ratios.append(gap(res.iterates[t], star, Xm) / gap(w_prev, star, Xm))
        w_prev = res.iterates[t]
        w_exact = prox.exact_lsq_prox(w_exact, Xd, yd, gamma)
        exact.append(w_exact)
    w_exact_avg = torch.stack(exact).mean(0)
    dist = float(torch.linalg.vector_norm(res.w_avg.double() - w_exact_avg)
                 / torch.linalg.vector_norm(w_exact_avg))
    return max(ratios), dist


@pytest.mark.parametrize("d", [DIM, 1024])
def test_mp_dsvrg_tracks_exact_prox_path(d):
    """The K inner iterations close each outer step's prox-subproblem gap
    to <= PROX_GAP_RATIO of its value at w_{t-1}, and w_avg lies within
    EXACT_PATH_DIST (relative) of the exact minibatch-prox path's average:
    the two bounds chip_smoke.py holds at d = 2^20."""
    ratio, dist = _exact_path_readings(d)
    assert ratio <= PROX_GAP_RATIO, ratio
    assert dist <= EXACT_PATH_DIST, dist


def _planted(fault):
    """svrg_update with one fault planted in the step it computes."""
    good = kernels.svrg_update

    def update(x, g_x, g_z, mu, w, eta, gamma):
        if fault == "no_gamma":
            gamma = 0.0
        elif fault == "no_mu":
            mu = torch.zeros_like(mu)
        elif fault == "no_g_z":
            g_z = torch.zeros_like(g_z)
        elif fault == "minus_g_z":
            g_z = -g_z
        elif fault == "anchor_0":
            w = torch.zeros_like(w)
        elif fault == "half_eta":
            eta = 0.5 * eta
        return good(x, g_x, g_z, mu, w, eta, gamma)
    return update


@pytest.mark.parametrize("fault", ["no_gamma", "no_mu", "no_g_z", "minus_g_z",
                                   "anchor_0", "half_eta"])
def test_exact_path_bounds_catch_a_faulty_update(fault, monkeypatch):
    """Both bounds of test_mp_dsvrg_tracks_exact_prox_path fail when the
    pass's update is wrong: a dropped term, a flipped sign, a wrong anchor,
    or half the step size (d = 1024)."""
    monkeypatch.setattr(kernels, "svrg_update", _planted(fault))
    ratio, dist = _exact_path_readings(1024)
    print(f"{fault}: gap ratio {ratio:.4g} (bound {PROX_GAP_RATIO}), "
          f"distance {dist:.4g} (bound {EXACT_PATH_DIST})")
    assert ratio > PROX_GAP_RATIO, ratio
    assert dist > EXACT_PATH_DIST, dist


def test_mp_dsvrg_accounting_matches_theory(stream, spec):
    m, b, T = M, B, 4
    res = run_mp_dsvrg(stream, spec, m, b, T, device=CPU)
    K = res.plan.K
    assert res.ledger.comm_rounds == 2 * K * T == res.plan.comm_rounds
    assert res.ledger.peak_memory_vectors == b == res.plan.memory_vectors(b)
    assert res.ledger.vector_ops == T * K * (b + b // res.plan.p)
    assert res.ledger.vector_ops == res.plan.computation_vector_ops(b)


def test_mp_dsvrg_communication_memory_tradeoff(stream, spec):
    """Fig. 1: doubling b halves communication and doubles memory."""
    small = run_mp_dsvrg(stream, spec, M, b=32, T=16, device=CPU)
    large = run_mp_dsvrg(stream, spec, M, b=128, T=4, device=CPU)
    assert small.ledger.peak_memory_vectors < large.ledger.peak_memory_vectors
    ratio = small.ledger.comm_rounds / large.ledger.comm_rounds
    assert ratio == pytest.approx(4.0, rel=0.3)


def test_mp_dane_exact_matches_union_prox(stream):
    """Exact local solves + correction converge to the exact union
    minibatch prox point (quadratic => DANE converges)."""
    Xm, ym = stream.sample_distributed(_gen(5), M, B)
    gamma = 2.0
    w_prev = torch.zeros(DIM)
    exact = prox.exact_lsq_prox(w_prev, Xm, ym, gamma)
    z = w_prev
    for _ in range(12):
        z = _dane_round(losses.least_squares(), z, Xm, ym, w_prev, w_prev,
                        gamma, 0.0, 0.0, True)
    _close(z, exact, atol=1e-3)


def test_mp_dane_converges_and_emso_accounting(stream, spec):
    res = run_mp_dane(stream, spec, m=M, b=B, T=8, local_solver="exact",
                      device=CPU)
    sub = float(stream.population_suboptimality(res.w_avg))
    assert sub <= theory.rate_bound_weakly_convex(spec, B * M, 8,
                                                  exact=False), sub
    emso = baselines.run_emso(stream, spec, M, B, 4, device=CPU)
    assert emso.ledger.comm_rounds == 4             # one round a step


@pytest.mark.parametrize("solver,eta", [("saga", 0.1), ("prox_svrg", 0.05)])
def test_mp_dane_converges_inexact_solvers(stream, spec, solver, eta):
    """MP-DANE with the plan's K, R and kappa and a stochastic local solver
    meets the Thm 7 inexact rate bound (tests/test_core_distributed.py::
    test_mp_dane_converges_all_solvers)."""
    res = run_mp_dane(stream, spec, m=M, b=B, T=8, local_solver=solver,
                      eta_scale=eta, device=CPU)
    sub = float(stream.population_suboptimality(res.w_avg))
    assert sub <= theory.rate_bound_weakly_convex(spec, B * M, 8,
                                                  exact=False), sub


def test_theorem7_inexact_rate(stream, spec):
    """Inexact minibatch-prox (prox-SVRG inner) still meets the Thm 7
    rate."""
    res = run_minibatch_prox(stream, spec, 64, 16, solver="prox_svrg",
                             inner_epochs=3, device=CPU)
    sub = float(stream.population_suboptimality(res.w_avg))
    assert sub <= theory.rate_bound_weakly_convex(spec, 64, 16,
                                                  exact=False), sub


def test_solvers_agree_on_quadratic(stream):
    """prox-SVRG and SAGA run long enough reach the exact prox point."""
    X, y = stream.sample(_gen(7), 128)
    w_prev = torch.zeros(DIM)
    exact = solvers.exact_quadratic(w_prev, X, y, 1.0)
    key = prng.PRNGKey(7)
    psvrg = solvers.prox_svrg(losses.least_squares().per_example_grad, key,
                              w_prev, X, y, 0.05, 1.0, w_prev, epochs=8)
    _close(psvrg, exact, atol=3e-2)
    saga = solvers.saga_linear(solvers.lsq_residual, key, w_prev, X, y,
                               0.05, 1.0, w_prev, steps=8 * 128)
    _close(saga, exact, atol=3e-2)


def test_minibatch_sgd_converges(stream, spec):
    res = baselines.run_minibatch_sgd(stream, spec, M, 16, 64, device=CPU)
    assert float(stream.population_suboptimality(res.w_avg)) < 0.1


def test_minibatch_sgd_degrades_with_huge_minibatch(stream, spec):
    """Figure 3 claim: at huge b (tiny T), MP beats minibatch SGD because
    minibatch SGD cannot exploit minibatch sizes beyond O(sqrt(n))."""
    sgd = baselines.run_minibatch_sgd(stream, spec, M, 2048, 2, device=CPU)
    mp = run_mp_dane(stream, spec, M, 2048, 2, local_solver="exact",
                     device=CPU)
    sub_sgd = float(stream.population_suboptimality(sgd.w_avg))
    sub_mp = float(stream.population_suboptimality(mp.w_avg))
    assert sub_mp < sub_sgd, (sub_mp, sub_sgd)


def test_acc_minibatch_sgd_converges(stream, spec):
    res = baselines.run_acc_minibatch_sgd(stream, spec, M, 32, 32,
                                          device=CPU)
    assert float(stream.population_suboptimality(res.w_avg)) < 0.15


def test_single_sgd_reference(stream, spec):
    res = baselines.run_single_sgd(stream, spec, 4096, device=CPU)
    assert float(stream.population_suboptimality(res.w_avg)) < 0.05


def test_dsvrg_erm_converges(stream, spec):
    res = baselines.run_dsvrg_erm(stream, spec, M, 4096, K=20, device=CPU)
    assert float(stream.population_suboptimality(res.w_avg)) < 0.05
    assert res.ledger.peak_memory_vectors == 4096 // M  # stores its shard


def test_mp_dane_logistic_beats_sgd_at_large_b():
    """App. E: on logistic loss the large-b advantage of MP-DANE holds, on
    the logistic stream chip_smoke.py's core phase draws (labels the signs
    of the teacher's margin, 5% flipped)."""
    from chip_smoke import LogisticStream
    ls = LogisticStream(DIM)
    lspec = theory.ProblemSpec(L=2.0, beta=0.5, B=2.0, dim=DIM)
    mp = run_mp_dane(ls, lspec, M, 512, 1, K=4, R=1, kappa=0.0,
                     local_solver="prox_svrg", eta_scale=0.3,
                     loss=losses.logistic(), device=CPU)
    sgd = baselines.run_minibatch_sgd(ls, lspec, M, 512, 1,
                                      loss=losses.logistic(), device=CPU)
    assert ls.population_logloss(mp.w_avg) < ls.population_logloss(sgd.w_avg)


def test_entry_points_default_to_cuda(stream, spec):
    """device=None means CUDA: without a GPU every entry point raises
    rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    for run in (lambda: run_mp_dsvrg(stream, spec, 2, 8, 1),
                lambda: run_mp_dane(stream, spec, 2, 8, 1),
                lambda: run_minibatch_prox(stream, spec, 8, 1),
                lambda: baselines.run_minibatch_sgd(stream, spec, 2, 8, 1),
                lambda: baselines.run_acc_minibatch_sgd(stream, spec, 2, 8,
                                                        1),
                lambda: baselines.run_single_sgd(stream, spec, 8),
                lambda: baselines.run_dsvrg_erm(stream, spec, 2, 8),
                lambda: baselines.run_emso(stream, spec, 2, 8, 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


# ----------------------------------------------------------------------------
# the port imports neither JAX nor the JAX package
# ----------------------------------------------------------------------------

def test_port_imports_no_jax():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.data.synthetic\n"
            "import repro_torch.prng, repro_torch.core.baselines\n"
            "import repro_torch.models.recurrent, repro_torch.kernels.rglru_scan\n"
            "import repro_torch.models.lm, repro_torch.launch.serve\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
