"""The port's kernel twins (repro_torch/kernels/ref.py) held to the JAX
package: each against its Pallas kernel run in interpret mode and against
its jnp oracle, in float32 at 2e-5 (the JAX kernels' own tolerance;
svrg_update at tests/test_kernels.py's 1e-6 in float32 and 2e-2 in bf16).
Inputs come from numpy seeds and reach both packages as numpy arrays.

The CUDA kernels themselves are held to these twins on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.paged_attention import paged_attention as jpaged  # noqa: E402
from repro.kernels.paged_prefill import \
    paged_prefill_attention as jprefill  # noqa: E402
from repro.kernels.svrg_update import svrg_update as jsvrg  # noqa: E402
from repro.models.attention import \
    streamed_paged_attention as jstreamed  # noqa: E402
from repro_torch.kernels import (flash_attention, paged_attention,  # noqa: E402
                                 paged_prefill_attention, ref, svrg_update)

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------------------------
# paged decode attention
# ----------------------------------------------------------------------------

def _decode_case(seed, B, H, KV, hd, bs, M, ctx):
    rng = np.random.default_rng(seed)
    N = B * M + 1
    q = _rand(rng, B, H, hd)
    kp = _rand(rng, N, bs, KV, hd)
    vp = _rand(rng, N, bs, KV, hd)
    bt = (1 + rng.permutation(B * M)).reshape(B, M).astype(np.int32)
    cl = np.asarray(ctx, np.int32)
    return q, kp, vp, bt, cl


@pytest.mark.parametrize("B,H,KV,hd,bs,M,ctx", [
    (3, 4, 4, 32, 8, 3, (0, 5, 24)),          # MHA, ctx 0 and full
    (4, 6, 2, 16, 4, 5, (1, 4, 13, 20)),      # GQA 3:1, ragged
    (2, 8, 1, 64, 16, 2, (17, 32)),           # MQA
])
def test_paged_attention_twin_matches_jax(B, H, KV, hd, bs, M, ctx):
    q, kp, vp, bt, cl = _decode_case(B * 7 + H, B, H, KV, hd, bs, M, ctx)
    got = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                  _t(cl)).numpy()
    oracle = np.asarray(jref.paged_attention_ref(q, kp, vp, bt, cl))
    pallas = np.asarray(jpaged(q, kp, vp, bt, cl, interpret=True))
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    assert np.all(got[cl == 0] == 0.0)


def test_paged_attention_twin_int8_scales_match_jax():
    rng = np.random.default_rng(5)
    B, H, KV, hd, bs, M = 3, 4, 2, 16, 4, 3
    N = B * M + 1
    q = _rand(rng, B, H, hd)
    kq = rng.integers(-127, 128, (N, bs, KV, hd)).astype(np.int8)
    vq = rng.integers(-127, 128, (N, bs, KV, hd)).astype(np.int8)
    ks = (rng.random((N, bs, KV)) / 127).astype(np.float32)
    vs = (rng.random((N, bs, KV)) / 127).astype(np.float32)
    bt = (1 + rng.permutation(B * M)).reshape(B, M).astype(np.int32)
    cl = np.asarray([0, 7, 12], np.int32)
    got = ref.paged_attention_ref(_t(q), _t(kq), _t(vq), _t(bt), _t(cl),
                                  _t(ks), _t(vs)).numpy()
    oracle = np.asarray(jref.paged_attention_ref(q, kq, vq, bt, cl, ks, vs))
    pallas = np.asarray(jpaged(q, kq, vq, bt, cl, k_scale=ks, v_scale=vs,
                               interpret=True))
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_paged_attention_masked_keys_add_nothing():
    """Non-finite K/V past ctx (a slot's stale partial block, the null
    block) must not reach the output: masked keys are selected out."""
    q, kp, vp, bt, cl = _decode_case(3, 2, 4, 2, 16, 4, 3, (5, 0))
    clean = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(bt), _t(cl))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[bt[0, 1], 1:] = np.nan                 # row 0 reads slots 0..4
    vp2[bt[0, 1], 1:] = np.inf
    kp2[0], vp2[0] = np.nan, np.nan            # the null block
    dirty = ref.paged_attention_ref(_t(q), _t(kp2), _t(vp2), _t(bt), _t(cl))
    assert torch.isfinite(dirty).all()
    torch.testing.assert_close(dirty, clean, rtol=0, atol=0)


def test_paged_attention_wrapper_takes_twin_on_cpu():
    q, kp, vp, bt, cl = _decode_case(4, 2, 4, 2, 16, 4, 3, (9, 3))
    args = (_t(q), _t(kp), _t(vp), _t(bt), _t(cl))
    before = paged_attention.launches
    torch.testing.assert_close(paged_attention(*args),
                               ref.paged_attention_ref(*args), rtol=0,
                               atol=0)
    assert paged_attention.launches == before    # no kernel on the CPU


# ----------------------------------------------------------------------------
# paged suffix prefill
# ----------------------------------------------------------------------------

def _prefill_case(seed, window, *, N=3, Ls=16, H=4, KV=2, hd=16, bs=4,
                  M=8, P=20, starts=(0, 7, 20), lengths=(10, 23, 0)):
    rng = np.random.default_rng(seed)
    q = _rand(rng, N, Ls, H, hd)
    k_suf = _rand(rng, N, Ls, KV, hd)
    v_suf = _rand(rng, N, Ls, KV, hd)
    k_pool = _rand(rng, P, bs, KV, hd)
    v_pool = _rand(rng, P, bs, KV, hd)
    bt = rng.integers(1, P, (N, M)).astype(np.int32)
    st = np.minimum(np.asarray(starts, np.int32), M * bs)
    ln = np.asarray(lengths, np.int32)
    pos = (st[:, None] + np.arange(Ls)[None, :]).astype(np.int32)
    got = ref.paged_prefill_ref(_t(q), _t(k_suf), _t(v_suf), _t(k_pool),
                                _t(v_pool), _t(bt), _t(st), _t(ln),
                                window=window).numpy()
    oracle = np.asarray(jstreamed(
        q, k_suf, v_suf, {"k": jnp.asarray(k_pool),
                          "v": jnp.asarray(v_pool)},
        jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(st), jnp.asarray(ln),
        scale=hd ** -0.5, attn_chunk=8, window=window))
    pallas = np.asarray(jprefill(q, k_suf, v_suf, k_pool, v_pool, bt, st, ln,
                                 window=window, bq=8, interpret=True))
    assert np.isfinite(got).all()
    for n in range(N):
        s = int(np.clip(ln[n] - st[n], 0, Ls))   # the row's real suffix
        if s == 0:
            if st[n] == 0:                       # no valid key: zeros
                assert np.all(got[n] == 0.0)
            continue
        np.testing.assert_allclose(got[n, :s], oracle[n, :s], **TOL)
        np.testing.assert_allclose(got[n, :s], pallas[n, :s], **TOL)


@pytest.mark.parametrize("window", [0, 6])
def test_paged_prefill_twin_matches_jax(window):
    _prefill_case(0, window)


@pytest.mark.parametrize("seed,window,kw", [
    (11, 0, dict(starts=(3, 0, 15), lengths=(19, 16, 31))),
    (12, 4, dict(H=4, KV=4, starts=(8, 1, 0), lengths=(24, 1, 8))),
    (13, 0, dict(Ls=8, bs=8, M=4, starts=(16, 2, 0),
                 lengths=(24, 10, 0))),
])
def test_paged_prefill_twin_ragged_sweep(seed, window, kw):
    _prefill_case(seed, window, **kw)


def test_paged_prefill_wrapper_takes_twin_on_cpu():
    rng = np.random.default_rng(2)
    q = _t(_rand(rng, 2, 8, 4, 16))
    ks, vs = _t(_rand(rng, 2, 8, 2, 16)), _t(_rand(rng, 2, 8, 2, 16))
    kp, vp = _t(_rand(rng, 6, 4, 2, 16)), _t(_rand(rng, 6, 4, 2, 16))
    bt = _t(np.asarray([[1, 2, 3], [4, 5, 0]], np.int32))
    st = _t(np.asarray([5, 0], np.int32))
    ln = _t(np.asarray([11, 8], np.int32))
    before = paged_prefill_attention.launches
    torch.testing.assert_close(
        paged_prefill_attention(q, ks, vs, kp, vp, bt, st, ln),
        ref.paged_prefill_ref(q, ks, vs, kp, vp, bt, st, ln), rtol=0, atol=0)
    assert paged_prefill_attention.launches == before


# ----------------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,S,hd", [(2, 4, 2, 24, 16), (1, 6, 3, 40, 32)])
def test_flash_twin_matches_jax(causal, B, H, KV, S, hd):
    rng = np.random.default_rng(S + H)
    q = _rand(rng, B, H, S, hd)
    k = _rand(rng, B, KV, S, hd)
    v = _rand(rng, B, KV, S, hd)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal).numpy()
    oracle = np.asarray(jref.flash_attention_ref(q, k, v, causal=causal))
    pallas = np.asarray(jflash(q, k, v, causal=causal, bq=8, bk=8,
                               interpret=True))
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_flash_wrapper_takes_twin_on_cpu():
    rng = np.random.default_rng(9)
    q, k, v = (_t(_rand(rng, 1, 4, 12, 16)), _t(_rand(rng, 1, 2, 12, 16)),
               _t(_rand(rng, 1, 2, 12, 16)))
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, k, v),
                               ref.flash_attention_ref(q, k, v), rtol=0,
                               atol=0)
    assert flash_attention.launches == before


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 4, 16, device="meta")
    with pytest.raises(ValueError):
        paged_attention(q, q, q, q, q)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    x = torch.zeros(16, device="meta")
    with pytest.raises(ValueError):
        svrg_update(x, x, x, x, x, 0.1, 0.5)


# ----------------------------------------------------------------------------
# fused variance-reduced prox step
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [17, 256, 4096, 100003])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_svrg_update_twin_matches_jax(n, dtype):
    """The twin (float32 math, one rounding) against the Pallas kernel
    (interpret mode) and the jnp oracle, which compute in the input dtype;
    bf16 inputs are the same bits in both packages."""
    rng = np.random.default_rng(n)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(rng.standard_normal(n), jd) for _ in range(5)]
    targs = [_t(np.array(a, np.float32)).to(td) for a in jargs]
    got = ref.svrg_update_ref(*targs, 0.1, 0.5)
    assert got.dtype == td and got.shape == (n,)
    pallas = jsvrg(*jargs, 0.1, 0.5)
    oracle = jref.svrg_update_ref(*jargs, jnp.asarray(0.1, jd),
                                  jnp.asarray(0.5, jd))
    tol = 1e-6 if dtype == "float32" else 2e-2
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)
    before = svrg_update.launches
    torch.testing.assert_close(svrg_update(*targs, 0.1, 0.5), got, rtol=0,
                               atol=0)
    assert svrg_update.launches == before
