"""repro_torch.models.layers held to repro.models.layers: the same numpy
inputs through both, float32 at 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 576)])
def test_rms_norm_matches_jax(shape):
    x = _rand(0, *shape, scale=3.0)
    scale = _rand(1, shape[-1], scale=0.1)
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm_bf16_keeps_dtype_and_matches():
    x = _rand(2, 4, 64, scale=2.0)
    scale = _rand(3, 64, scale=0.1)
    got = tl.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale))
    want = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
@pytest.mark.parametrize("hd", [16, 64])
def test_apply_rope_matches_jax(theta, hd):
    B, S, H = 2, 7, 3
    x = _rand(4, B, S, H, hd)
    pos = np.random.default_rng(5).integers(0, 4096, (B, S)).astype(np.int32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_rope_small_positions_match_to_1e5():
    x = _rand(6, 1, 16, 4, 64)
    pos = np.arange(16, dtype=np.int32)[None]
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(kind):
    D, F = 32, 48
    names = (["w_gate", "w_up", "w_down"] if kind != "gelu"
             else ["w_up", "w_down"])
    shapes = {"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}
    p = {n: _rand(10 + i, *shapes[n], scale=D ** -0.5)
         for i, n in enumerate(names)}
    x = _rand(20, 3, 5, D)
    got = tl.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), kind)
    want = jl.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_softmax_xent_matches_jax():
    logits = _rand(30, 4, 6, 50, scale=3.0)
    targets = np.random.default_rng(31).integers(0, 50, (4, 6))
    got = tl.softmax_xent(torch.from_numpy(logits), torch.from_numpy(targets),
                          z_loss=1e-4)
    want = jl.softmax_xent(jnp.asarray(logits), jnp.asarray(targets),
                           z_loss=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_shapes_and_scales():
    k1, k2 = prng.split(prng.PRNGKey(0))
    emb = tl.init_embed(k1, 256, 64, torch.float32)
    w = tl.init_dense(k2, 64, 128, torch.bfloat16)
    assert emb.shape == (256, 64) and abs(emb.std().item() - 0.02) < 2e-3
    assert w.dtype == torch.bfloat16
    assert abs(w.float().std().item() - 64 ** -0.5) < 0.01
