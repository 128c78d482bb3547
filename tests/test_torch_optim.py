"""repro_torch.optim held to repro.optim on the CPU: the reference's own
tests (tests/test_optim.py) on port trees, and the port against JAX on
the same inputs: sgd / AdamW updates (float32 within 1e-6, bf16 params
stay bf16), clip_by_global_norm, Schedule (within 1e-6 relative: numpy's
float32 cos and XLA's may differ in the last place), MBProx steps on the
reference's quadratic (1e-5), and compression: int8 payloads and scales
bit-equal, residuals within 1e-7, top-k indices equal (ties to the lowest
index) and values bit-equal. tests/test_data_pipeline.py's
test_compressed_pmean_single_device waits for the port's distributed
layer."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import mbprox as jmbprox  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.optim import compression as comp  # noqa: E402
from repro_torch.optim import mbprox  # noqa: E402
from repro_torch.optim.optimizers import (Schedule, adamw,  # noqa: E402
                                          clip_by_global_norm, sgd)
from repro_torch.tree import tree_leaves  # noqa: E402


def _np(x):
    return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _quad_problem(d=16, seed=0):
    """The reference test's quadratic, H = A A^T / d + 0.1 I, from numpy."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d)).astype(np.float32) / d ** 0.5
    H = A @ A.T + 0.1 * np.eye(d, dtype=np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    return H, b


def _torch_quad(H, b):
    Ht, bt = torch.from_numpy(H), torch.from_numpy(b)

    def loss(params):
        w = params["w"]
        return 0.5 * w @ Ht @ w - bt @ w

    return loss


# ----------------------------------------------------------------------------
# the reference's tests, on the port
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("make_opt", [
    lambda: sgd(momentum=0.0), lambda: sgd(momentum=0.9),
    lambda: sgd(momentum=0.9, nesterov=True), lambda: adamw()])
def test_optimizers_minimize_quadratic(make_opt):
    H, b = _quad_problem()
    loss = _torch_quad(H, b)
    opt = make_opt()
    params = {"w": torch.zeros(16)}
    state = opt.init(params)
    for _ in range(1500):
        w = params["w"].detach().requires_grad_()
        g = torch.autograd.grad(loss({"w": w}), w)[0]
        params, state = opt.update({"w": g}, state, params, 0.1)
    np.testing.assert_allclose(_np(params["w"]), np.linalg.solve(H, b),
                               atol=0.05)


def test_sgd_bf16_params_stay_bf16():
    opt = sgd(momentum=0.9)
    params = {"w": torch.ones(8, dtype=torch.bfloat16)}
    state = opt.init(params)
    params, state = opt.update({"w": torch.ones(8)}, state, params, 0.1)
    assert params["w"].dtype == torch.bfloat16


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0), "b": torch.full((4,), 10.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in tree_leaves(clipped)))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(gn), 800.0 ** 0.5, rtol=1e-5)


def test_schedule():
    s = Schedule(peak=1.0, warmup=10, total=100, floor=0.1)
    assert s(0) == 0.0 and isinstance(s(0), float)
    np.testing.assert_allclose(s(10), 1.0, rtol=1e-5)
    assert s(100) == pytest.approx(0.1, rel=1e-3)
    assert s(55) < s(20)


def test_mbprox_step_solves_prox_subproblem():
    """With many inner passes the local variant approaches the prox point
    (H + gamma I)^{-1} b of the quadratic (pmean is the identity)."""
    H, b = _quad_problem()
    quad = _torch_quad(H, b)

    def loss_fn(params, micro):
        return quad(params) * micro["scale"][0], {}

    gamma = 0.5
    mp = mbprox.MBProxConfig(gamma=gamma, inner_momentum=0.0,
                             inner_passes=50, dane_correction=False,
                             variant="local")
    step = mbprox.make_mbprox_step(loss_fn, mp)
    new_p, _, m = step({"w": torch.zeros(16)}, (),
                       {"scale": torch.ones(4, 1)}, 0.05)
    expect = np.linalg.solve(H + gamma * np.eye(16, dtype=np.float32), b)
    np.testing.assert_allclose(_np(new_p["w"]), expect, atol=0.05)
    assert m["loss"].shape == ()


def test_mbprox_sync_equals_local_on_one_shard():
    H, b = _quad_problem()
    quad = _torch_quad(H, b)

    def loss_fn(params, micro):
        return quad(params) + 0.0 * micro["x"].sum(), {}

    outs = {}
    for variant in ("local", "sync"):
        mp = mbprox.MBProxConfig(gamma=0.2, inner_momentum=0.9,
                                 inner_passes=2, dane_correction=False,
                                 variant=variant)
        step = mbprox.make_mbprox_step(loss_fn, mp)
        p, s, _ = step({"w": torch.ones(16)}, {"w": torch.zeros(16)},
                       {"x": torch.zeros(2, 4)}, 0.03)
        outs[variant] = p["w"]
    np.testing.assert_allclose(_np(outs["local"]), _np(outs["sync"]),
                               atol=1e-5)


def test_int8_roundtrip_error_feedback():
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal(1000).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(37).astype(
            np.float32))}
    ef = comp.init_ef(tree)
    compressed, ef = comp.quantize_int8(tree, ef)
    deq = comp.dequantize_int8(compressed)
    for a, b in zip(tree_leaves(tree), tree_leaves(deq)):
        assert float((a - b).abs().max()) <= float(a.abs().max()) / 127 * 1.01
    for r, a, b in zip(tree_leaves(ef.residual), tree_leaves(tree),
                       tree_leaves(deq)):
        np.testing.assert_allclose(_np(r), _np(a - b), atol=1e-6)
    raw = sum(x.numel() * 4 for x in tree_leaves(tree))
    assert comp.compressed_bytes_int8(tree) < raw / 3.5


def test_error_feedback_unbiased_over_rounds():
    true = torch.from_numpy(np.random.default_rng(3).standard_normal(
        512).astype(np.float32)) * 0.1
    ef = comp.init_ef({"g": true})
    sent = torch.zeros_like(true)
    for _ in range(30):
        compressed, ef = comp.quantize_int8({"g": true}, ef)
        sent = sent + comp.dequantize_int8(compressed)["g"]
    np.testing.assert_allclose(_np(sent / 30), _np(true), atol=2e-3)


def test_topk_roundtrip():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        2048).astype(np.float32))
    compressed, ef = comp.topk_sparsify({"w": x}, comp.init_ef({"w": x}),
                                        frac=0.1)
    dense = comp.topk_densify(compressed)["w"]
    assert int((dense != 0).sum()) == 204
    thresh = float(torch.sort(x.abs()).values[-204])
    assert float(dense[dense != 0].abs().min()) >= thresh - 1e-6


# ----------------------------------------------------------------------------
# against JAX on the same inputs
# ----------------------------------------------------------------------------

def _trees(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 8), "b": (8,), "s": ()}
    return {k: rng.standard_normal(s).astype(dtype) for k, s in
            shapes.items()}


@pytest.mark.parametrize("name,kw", [("sgd", dict(momentum=0.0)),
                                     ("sgd", dict(momentum=0.9)),
                                     ("sgd", dict(momentum=0.9,
                                                  nesterov=True)),
                                     ("adamw", dict()),
                                     ("adamw", dict(weight_decay=0.01))])
def test_optimizer_updates_match_jax(name, kw):
    """Four updates from the same params and gradients: params and state
    within 1e-6 of the JAX optimizer's (the bias corrections' pow may
    round differently in the last place)."""
    jo, to = getattr(jopt, name)(**kw), {"sgd": sgd, "adamw": adamw}[name](
        **kw)
    p0, lr = _trees(0), 0.05
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(4):
        g = _trees(10 + i)
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                           jp, jnp.float32(lr))
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp, lr)
    for k in p0:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=1e-6)
    for a, b in zip(jax.tree.leaves(js), _sorted_leaves(ts)):
        np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                   atol=1e-6)


def _sorted_leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _sorted_leaves(v)
    else:
        yield tree


def test_bf16_params_update_like_jax():
    """bf16 params stay bf16 and take JAX's values (f32 math, one cast)."""
    p0 = {k: v.astype(np.float32) for k, v in _trees(1).items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    g = _trees(2)
    for name in ("sgd", "adamw"):
        jo = getattr(jopt, name)(**({"momentum": 0.9} if name == "sgd"
                                    else {}))
        to = {"sgd": sgd, "adamw": adamw}[name](
            **({"momentum": 0.9} if name == "sgd" else {}))
        jn, _ = jo.update({k: jnp.asarray(v) for k, v in g.items()},
                          jo.init(jp), jp, jnp.float32(0.1))
        tn, _ = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                          to.init(tp), tp, 0.1)
        for k in p0:
            assert tn[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(tn[k]),
                                          np.asarray(jn[k], np.float32))


def test_clip_and_schedule_match_jax():
    g = _trees(4)
    jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in
                                       g.items()}, 1.0)
    tc, tn = clip_by_global_norm({k: torch.from_numpy(v) for k, v in
                                  g.items()}, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]), atol=1e-7)
    for kw in (dict(peak=3e-3, warmup=5, total=60),
               dict(peak=1.0, warmup=10, total=100, floor=0.1)):
        js, ts = jopt.Schedule(**kw), Schedule(**kw)
        for step in range(0, kw["total"] + 3):
            np.testing.assert_allclose(ts(step), float(js(step)),
                                       rtol=1e-6, atol=1e-12)


def test_mbprox_steps_match_jax_on_the_quadratic():
    """Two outer steps of each variant, DANE correction on, momentum 0.9,
    two inner passes over 3 microbatches: within 1e-5 of JAX's jitted
    step."""
    H, b = _quad_problem()
    Hj, bj = jnp.asarray(H), jnp.asarray(b)
    quad = _torch_quad(H, b)
    scale = np.array([[1.0], [0.5], [2.0]], np.float32)
    mesh = make_host_mesh()
    for variant in ("local", "sync"):
        kw = dict(gamma=0.3, inner_momentum=0.9, inner_passes=2,
                  dane_correction=True, variant=variant)

        def jloss(params, micro):
            w = params["w"]
            return (0.5 * w @ Hj @ w - bj @ w) * micro["s"][0], {}

        jstep = jax.jit(jmbprox.make_mbprox_step(
            jloss, jmbprox.MBProxConfig(**kw), mesh, ("data",)))
        tstep = mbprox.make_mbprox_step(
            lambda p, m: (quad(p) * m["s"][0], {}),
            mbprox.MBProxConfig(**kw))
        jp = {"w": jnp.zeros(16)}
        js = {"w": jnp.zeros(16)}
        tp, ts = {"w": torch.zeros(16)}, {"w": torch.zeros(16)}
        with compat.set_mesh(mesh):
            for _ in range(2):
                jp, js, jm = jstep(jp, js, {"s": jnp.asarray(scale)},
                                   jnp.float32(0.05))
                tp, ts, tm = tstep(tp, ts, {"s": torch.from_numpy(scale)},
                                   0.05)
                np.testing.assert_allclose(float(tm["loss"]),
                                           float(jm["loss"]), atol=1e-5)
        np.testing.assert_allclose(_np(tp["w"]), np.asarray(jp["w"]),
                                   atol=1e-5)
        np.testing.assert_allclose(_np(ts["w"]), np.asarray(js["w"]),
                                   atol=1e-5)


@pytest.mark.parametrize("n", [1000, 256, 37, 1])
def test_int8_payload_bit_equal_to_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32) * 3
    x[: min(n, 4)] = [2.5, -2.5, 0.5, 127.0][: min(n, 4)]   # ties, the max
    r = rng.standard_normal(n).astype(np.float32) * 1e-3
    (jq, js, _), jef = jcomp.quantize_int8({"g": jnp.asarray(x)},
                                           jcomp.EFState({"g": jnp.asarray(
                                               r)}))
    (tq, ts, shapes), tef = comp.quantize_int8(
        {"g": torch.from_numpy(x)}, comp.EFState({"g": torch.from_numpy(r)}))
    assert tq["g"].dtype == torch.int8 and shapes["g"] == (n,)
    np.testing.assert_array_equal(tq["g"].numpy(), np.asarray(jq["g"]))
    np.testing.assert_array_equal(ts["g"].numpy(), np.asarray(js["g"]))
    np.testing.assert_allclose(tef.residual["g"].numpy(),
                               np.asarray(jef.residual["g"]), atol=1e-7)
    assert comp.compressed_bytes_int8({"g": torch.from_numpy(x)}) == \
        jcomp.compressed_bytes_int8({"g": jnp.asarray(x)})


def test_topk_matches_jax_with_ties():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    x.reshape(-1)[::7] = 1.5            # many equal magnitudes
    x.reshape(-1)[3::11] = -1.5
    (jv, ji, _), jef = jcomp.topk_sparsify({"g": jnp.asarray(x)},
                                           jcomp.init_ef({"g": jnp.asarray(
                                               x)}), frac=0.2)
    (tv, ti, _), tef = comp.topk_sparsify({"g": torch.from_numpy(x)},
                                          comp.init_ef({"g": torch.from_numpy(
                                              x)}), frac=0.2)
    np.testing.assert_array_equal(ti["g"].numpy(), np.asarray(ji["g"]))
    np.testing.assert_array_equal(tv["g"].numpy(), np.asarray(jv["g"]))
    np.testing.assert_array_equal(tef.residual["g"].numpy(),
                                  np.asarray(jef.residual["g"]))
    dense = comp.topk_densify((tv, ti, {"g": (32, 16)}))["g"]
    want = jcomp.topk_densify((jv, ji, {"g": (32, 16)}))["g"]
    np.testing.assert_array_equal(dense.numpy(), np.asarray(want))
