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

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.paged_attention import paged_attention as jpaged  # noqa: E402
from repro.kernels.paged_prefill import \
    paged_prefill_attention as jprefill  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jrglru  # noqa: E402
from repro.kernels.svrg_update import svrg_update as jsvrg  # noqa: E402
from repro.models.attention import \
    chunked_causal_attention as jchunked  # noqa: E402
from repro.models.attention import \
    streamed_paged_attention as jstreamed  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.kernels import (flash_attention, paged_attention,  # noqa: E402
                                 paged_prefill_attention, ref, svrg_update)
from repro_torch.kernels import rglru_scan  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.build import FLASH_KEY_TILE, PAGED_CHUNK  # noqa: E402
from repro_torch.kernels.paged_prefill import \
    route as prefill_route  # noqa: E402
from repro_torch.kernels.rwkv6_scan import pad_head_dim  # noqa: E402
from repro_torch.kernels import rwkv6_scan  # noqa: E402

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


# The split the CUDA kernel runs (csrc/paged_attention.cu): each row's
# tokens in chunks of PAGED_CHUNK, merged in split order. Float32 within
# 1e-6 of the twin and 2e-5 of the JAX oracle, and a row's bits the same
# alone as in a batch of 8 with other contexts (the engine's greedy
# identity with generate() rests on that).
@pytest.mark.parametrize("bs,M,ctx", [
    # engine pools: ctx 0, 1, multiples of bs (16, 48), of CHUNK (128,
    # 256), the whole table (384) and past it (clamped)
    (16, 24, (0, 1, 16, 48, 128, 256, 384, 200)),
    # generate()'s dense decode: one 2048-slot block per row
    (2048, 1, (1, 0, 127, 128, 129, 1024, 2048, 700)),
])
def test_paged_attention_split_emulation(bs, M, ctx):
    B, H, KV, hd = len(ctx), 9, 3, 64
    q, kp, vp, bt, cl = _decode_case(bs + M, B, H, KV, hd, bs, M, ctx)
    if bs == 2048:          # generate(): pool row b is row b's block
        kp, vp, bt = kp[:B], vp[:B], np.arange(B, dtype=np.int32)[:, None]
    args = (_t(q), _t(kp), _t(vp), _t(bt), _t(cl))
    got = ref.paged_attention_split_ref(*args, chunk=PAGED_CHUNK)
    torch.testing.assert_close(got, ref.paged_attention_ref(*args),
                               atol=1e-6, rtol=1e-6)
    inside = cl <= M * bs
    oracle = np.asarray(jref.paged_attention_ref(q, kp, vp, bt, cl))
    np.testing.assert_allclose(got.numpy()[inside], oracle[inside], **TOL)
    assert np.all(got.numpy()[cl == 0] == 0.0)
    for b in range(B):
        alone = ref.paged_attention_split_ref(
            args[0][b:b + 1], args[1], args[2], args[3][b:b + 1],
            args[4][b:b + 1], chunk=PAGED_CHUNK)
        torch.testing.assert_close(alone[0], got[b], atol=0, rtol=0)


# The window (recurrentgemma-2b's attn_local layers decode through the paged
# pools, which keep every token): the kernel's split keeps its chunks
# aligned to token 0, leaves out those that end at or below ctx - window
# and starts the first live one at ctx - window. Float32 within 1e-6 of the
# windowed twin, a row's bits the same alone as in the batch, and with ctx
# <= window the unwindowed call's bits.
@pytest.mark.parametrize("bs,M,ctx,window", [
    (16, 24, (0, 1, 16, 47, 48, 49, 176, 200, 384), 48),
    (16, 24, (0, 1, 127, 128, 129, 255, 300, 384), 128),
    (2048, 1, (1, 0, 129, 700, 1024, 2048, 1500), 300),
])
def test_paged_attention_window_split_emulation(bs, M, ctx, window):
    B, H, KV, hd = len(ctx), 10, 1, 32
    q, kp, vp, bt, cl = _decode_case(bs + window, B, H, KV, hd, bs, M, ctx)
    if bs == 2048:
        kp, vp, bt = kp[:B], vp[:B], np.arange(B, dtype=np.int32)[:, None]
    args = (_t(q), _t(kp), _t(vp), _t(bt), _t(cl))
    got = ref.paged_attention_split_ref(*args, chunk=PAGED_CHUNK,
                                        window=window)
    torch.testing.assert_close(
        got, ref.paged_attention_ref(*args, window=window), atol=1e-6,
        rtol=1e-6)
    plain = ref.paged_attention_split_ref(*args, chunk=PAGED_CHUNK)
    inside = cl <= window
    torch.testing.assert_close(got[inside], plain[inside], atol=0, rtol=0)
    assert np.all(got.numpy()[cl == 0] == 0.0)
    for b in range(B):
        alone = ref.paged_attention_split_ref(
            args[0][b:b + 1], args[1], args[2], args[3][b:b + 1],
            args[4][b:b + 1], chunk=PAGED_CHUNK, window=window)
        torch.testing.assert_close(alone[0], got[b], atol=0, rtol=0)


@pytest.mark.parametrize("window", [0, 5, 16])
def test_paged_decode_block_window_matches_jax(window):
    """The port's paged decode block (the wrapper, so the twin, on the
    CPU) against the JAX oracle paged_decode_attention_block, windowed as
    recurrentgemma-2b's attn_local layers run it: 10 query heads over 1 KV
    head, ragged positions on both sides of the window, within 2e-5."""
    from repro import configs as jconfigs
    from repro.models import attention as jattn
    from repro_torch import configs as tconfigs
    from repro_torch.models import attention as tattn
    kw = dict(n_heads=10, n_kv_heads=1, head_dim=16)
    jcfg = jconfigs.get_config("recurrentgemma-2b").reduced(**kw)
    tcfg = tconfigs.get_config("recurrentgemma-2b").reduced(**kw)
    rng = np.random.default_rng(40 + window)
    D, H, hd = jcfg.d_model, 10, 16
    params = {n: _rand(rng, D, c) * D ** -0.5
              for n, c in (("wq", H * hd), ("wk", hd), ("wv", hd))}
    params["wo"] = _rand(rng, H * hd, D) * (H * hd) ** -0.5
    B, bs, M = 4, 4, 8
    N = B * M + 1
    pool = {"k": _rand(rng, N, bs, 1, hd), "v": _rand(rng, N, bs, 1, hd)}
    bt = (1 + rng.permutation(B * M)).reshape(B, M).astype(np.int32)
    pos = np.asarray([0, 4, 17, 31], np.int32)
    x = _rand(rng, B, 1, D)
    want, jcache = jattn.paged_decode_attention_block(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(pos),
        jnp.asarray(bt), jcfg, window=window)
    tcache = {k: _t(v.copy()) for k, v in pool.items()}
    got, tcache = tattn.paged_decode_attention_block(
        {k: _t(v) for k, v in params.items()}, _t(x), tcache, _t(pos),
        _t(bt), tcfg, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy()[1:],
                                   np.asarray(jcache[name])[1:], **TOL)


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


# The 16-bit flash kernel (csrc/flash_attention.cu) runs P.V on the tensor
# cores, so P is rounded to the input type first. At chip_smoke.py's bf16
# flash shapes, its emulation must stay within chip_smoke's gate against
# the float32 twin: TOL_ULPS = 2 bf16 ulps of max(|twin|, ULP_FLOOR = 2^-8).
# One bf16 rounding of P does not (tens of ulps where outputs cancel near
# 0), so the kernel splits P into hi + lo bf16 halves and runs two P.V
# products; with the split every shape is within 1 ulp.
_TOL_ULPS, _ULP_FLOOR = 2, 2.0 ** -8


def _bf16_ulps(got, want):
    diff = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float().abs().clamp_min(_ULP_FLOOR))
    return (diff / torch.ldexp(torch.ones_like(diff), e - 8)).max().item()


def _flash_bf16_case(seed, B, H, KV, S, hd):
    rng = np.random.default_rng(seed)
    return tuple(_t(_rand(rng, B, n, S, hd)).bfloat16() for n in (H, KV, KV))


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", [
    (2, 9, 3, 256, 64, True, 0),          # smollm lm.forward, 2 x 256
    (2, 9, 3, 512, 64, True, 0),          # the timed smollm arm
    (2, 9, 3, 512, 64, False, 0),
    (1, 10, 1, 2304, 256, True, 2048),    # recurrentgemma, 2304 tokens
    (1, 10, 1, 2304, 256, True, 0),
    (2, 4, 2, 200, 16, True, 0),          # the reduced configs' head dim
    (2, 4, 2, 200, 16, False, 0),
    (2, 4, 2, 200, 16, True, 48),
    (2, 32, 32, 200, 80, True, 0),        # stablelm-3b's head dim
    (2, 32, 32, 200, 80, False, 0),
    (2, 32, 32, 200, 80, True, 48),
])
def test_flash_hi_lo_p_stays_in_the_bf16_gate(B, H, KV, S, hd, causal,
                                             window):
    q, k, v = _flash_bf16_case(S + hd, B, H, KV, S, hd)
    got = ref.flash_attention_tiled_ref(q, k, v, causal=causal,
                                        window=window,
                                        key_tile=FLASH_KEY_TILE,
                                        p_split=True)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, want) <= _TOL_ULPS


def test_flash_single_bf16_p_breaks_the_bf16_gate():
    q, k, v = _flash_bf16_case(7, 2, 9, 3, 512, 64)
    want = ref.flash_attention_ref(q, k, v)
    once = ref.flash_attention_tiled_ref(q, k, v, key_tile=FLASH_KEY_TILE,
                                        p_split=False)
    split = ref.flash_attention_tiled_ref(q, k, v, key_tile=FLASH_KEY_TILE,
                                         p_split=True)
    assert _bf16_ulps(once, want) > 4 * _TOL_ULPS
    assert _bf16_ulps(split, want) <= _TOL_ULPS


# The 16-bit flash backward (csrc/flash_attention_bwd.cu) runs its five
# products on the tensor cores: Q, K, V and dO go in exact, but P (for dV =
# P^T dO) and dS (for dQ = dS K and dK = dS^T Q) are float32 on the
# accumulator fragment and must be rounded to the input type first. At
# the bf16 shapes of tests/test_torch_cuda_kernels.py::
# test_flash_backward_matches_twin and chip_smoke.py's backward arms the
# kernel's hi + lo halves stay within the 2-ulp gate of the float32 twin;
# one rounding of P and dS does not.
_BWD_TWIN_CASES = [(S, causal, window, hd, heads)
                   for S, causal, window in ((1, True, 0), (40, True, 0),
                                             (300, True, 0), (300, True, 96),
                                             (77, False, 0), (77, False, 24))
                   for hd, heads in ((16, (4, 2)), (64, (9, 3)),
                                     (80, (8, 8)), (128, (16, 4)),
                                     (256, (10, 1)))]
_BWD_SMOKE_CASES = ([(2, 9, 3, 512, 64, True, 0),
                     (1, 10, 1, 2304, 256, True, 2048)]
                    + [(2, h, kv, 200, hd, causal, w)
                       for hd, (h, kv) in ((16, (4, 2)), (80, (8, 8)),
                                           (128, (16, 4)))
                       for causal, w in ((True, 0), (False, 0), (True, 48))])


def _flash_bwd_case(seed, B, H, KV, S, hd, causal, window):
    rng = np.random.default_rng(seed)
    q, do = (_t(_rand(rng, B, H, S, hd)).bfloat16() for _ in "qd")
    k, v = (_t(_rand(rng, B, KV, S, hd)).bfloat16() for _ in "kv")
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return q, k, v, o, do


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", [
    (2, heads[0], heads[1], S, hd, causal, window)
    for S, causal, window, hd, heads in _BWD_TWIN_CASES] + _BWD_SMOKE_CASES)
def test_flash_bwd_hi_lo_stays_in_the_bf16_gate(B, H, KV, S, hd, causal,
                                               window):
    a = _flash_bwd_case(hd + S, B, H, KV, S, hd, causal, window)
    got = ref.flash_attention_bwd_split_ref(*a, causal=causal, window=window,
                                           p_split=True)
    want = ref.flash_attention_bwd_ref(*a, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert _bf16_ulps(g, w) <= _TOL_ULPS, name


def test_flash_bwd_single_bf16_rounding_breaks_the_bf16_gate():
    a = _flash_bwd_case(7, 2, 9, 3, 512, 64, True, 0)
    want = ref.flash_attention_bwd_ref(*a)
    once = ref.flash_attention_bwd_split_ref(*a, p_split=False)
    split = ref.flash_attention_bwd_split_ref(*a, p_split=True)
    for name, o, s_, w in zip(("dq", "dk", "dv"), once, split, want):
        assert _bf16_ulps(o, w) > 4 * _TOL_ULPS, name
        assert _bf16_ulps(s_, w) <= _TOL_ULPS, name


# The 16-bit paged_prefill kernel (csrc/paged_prefill.cu) runs Q.K^T and
# P.V on the tensor cores over 64-key tiles, the pool's first, then the
# suffix's, so P is rounded to the input type first, as in flash. Its
# emulation must stay within chip_smoke.py's 2-ulp gate against the float32
# twin at every bf16 shape of chip_smoke.py's phase 2 (the smollm
# admission, the Ls = 16 bucket, speculate=4's verify chains, the other
# head dims) and at the block sizes the engine and the tests take.
def _prefill_bf16_case(seed, starts, counts, Ls, *, H=9, KV=3, hd=64, bs=16,
                       M=32, lengths=None):
    rng = np.random.default_rng(seed)
    n = len(starts)
    P = n * M + 1
    q, ks, vs = (_t(_rand(rng, n, Ls, h, hd)).bfloat16()
                 for h in (H, KV, KV))
    kp, vp = (_t(_rand(rng, P, bs, KV, hd)).bfloat16() for _ in range(2))
    bt = _t((1 + rng.permutation(n * M)).reshape(n, M).astype(np.int32))
    st = _t(np.asarray(starts, np.int32))
    ln = (st + _t(np.asarray(counts, np.int32)) if lengths is None
          else _t(np.asarray(lengths, np.int32)))
    return q, ks, vs, kp, vp, bt, st, ln


_ADMISSION = ([0, 48, 200, 0], [128, 128, 100, 0], 128)
_VERIFY_STARTS = [0, 3, 17, 100, 250, 400, 500, 311]


def _verify(T):
    return (_VERIFY_STARTS, [0, 1, 2, T, T, min(3, T), T, 0], T)


_SMALL_HD = dict(starts=[0, 8, 0], counts=None, Ls=16, bs=16, M=8,
                 lengths=[16, 24, 9])


@pytest.mark.parametrize("case,kw,window", [
    ("admission", dict(), 0),            # smollm 4 x 128, cached 0/48/200
    ("admission", dict(), 64),
    ("bucket16", dict(), 0),              # the smallest suffix bucket
    ("verify2", dict(), 0),               # speculate=4's verify chains
    ("verify4", dict(), 0),
    ("verify5", dict(), 0),
    ("small", dict(H=4, KV=2, hd=16), 0),    # the reduced configs
    ("small", dict(H=4, KV=2, hd=16), 6),
    ("small", dict(H=32, KV=32, hd=80), 0),  # stablelm-3b
    ("small", dict(H=32, KV=32, hd=80), 6),
    ("small", dict(H=10, KV=1, hd=256), 0),  # recurrentgemma-2b
    ("small", dict(H=10, KV=1, hd=256), 6),
    ("admission", dict(bs=4, M=128), 0),  # the block sizes tests take
    ("admission", dict(bs=8, M=64), 64),
    ("admission", dict(bs=2048, M=1), 0),  # one block a row
])
def test_paged_prefill_hi_lo_p_stays_in_the_bf16_gate(case, kw, window):
    if case == "admission":
        starts, counts, Ls = _ADMISSION
    elif case == "bucket16":
        starts, counts, Ls = [160, 0, 33, 0], [10, 16, 12, 0], 16
    elif case.startswith("verify"):
        starts, counts, Ls = _verify(int(case[-1]))
    else:
        kw = {**kw, "bs": 16, "M": 8, "lengths": _SMALL_HD["lengths"]}
        starts, counts, Ls = _SMALL_HD["starts"], None, 16
    args = _prefill_bf16_case(len(case) + window, starts, counts, Ls, **kw)
    got = ref.paged_prefill_tiled_ref(*args, window=window,
                                      key_tile=FLASH_KEY_TILE, p_split=True)
    want = ref.paged_prefill_ref(*args, window=window)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, want) <= _TOL_ULPS


def test_paged_prefill_single_bf16_p_breaks_the_bf16_gate():
    args = _prefill_bf16_case(7, *_ADMISSION)
    want = ref.paged_prefill_ref(*args)
    once = ref.paged_prefill_tiled_ref(*args, key_tile=FLASH_KEY_TILE,
                                       p_split=False)
    split = ref.paged_prefill_tiled_ref(*args, key_tile=FLASH_KEY_TILE,
                                        p_split=True)
    assert _bf16_ulps(once, want) > 4 * _TOL_ULPS
    assert _bf16_ulps(split, want) <= _TOL_ULPS


@pytest.mark.parametrize("which", ["twin", "tiled"])
@pytest.mark.parametrize("bs,M", [(16, 32), (4, 128)])
def test_paged_prefill_nonfinite_masked_pool_adds_nothing(which, bs, M):
    """NaN / inf in every pool slot a row may not see (past its starts,
    the partial last block, the null block 0) leave the twin and the
    tensor-core emulation bit for bit the same."""
    args = _prefill_bf16_case(3, [20, 0, 61], [32, 32, 3], 32, bs=bs, M=M)
    q, ks, vs, kp, vp, bt, st, ln = args

    def run(kp_, vp_):
        a = (q, ks, vs, kp_, vp_, bt, st, ln)
        if which == "twin":
            return ref.paged_prefill_ref(*a)
        return ref.paged_prefill_tiled_ref(*a, key_tile=FLASH_KEY_TILE,
                                           p_split=True)

    used = torch.zeros(kp.shape[:2], dtype=torch.bool)
    for n, s in enumerate(st.tolist()):
        t = torch.arange(s)
        used[bt[n, t // bs].long(), t % bs] = True
    kd, vd = kp.clone(), vp.clone()
    kd[~used] = float("nan")
    vd[~used] = float("inf")
    clean, dirty = run(kp, vp), run(kd, vd)
    assert torch.isfinite(dirty.float()).all()
    torch.testing.assert_close(dirty, clean, atol=0, rtol=0)


# paged_prefill over int8 / fp8 pools. The twin with scales against JAX's
# Pallas kernel in interpret mode, each over pools quantized by its own
# package's quantize_kv; the tensor-core kernel's quantized order
# (ref.paged_prefill_tiled_ref with scales: codes exact in q's dtype, the
# k scale on S's columns, the v scale on P's columns before the hi + lo
# rounding) within chip_smoke.py's 2-ulp gate at every shape its quantized
# arms run; NaN codes and scales in masked slots adding nothing.
_QDT = {"int8": (torch.int8, jnp.int8),
        "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


@pytest.mark.parametrize("pool", ["int8", "fp8"])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("hd", [16, 64])
def test_paged_prefill_twin_quantized_scales_match_jax(pool, window, hd):
    rng = np.random.default_rng(hd + window + len(pool))
    N, Ls, H, KV, bs, M = 3, 16, 4, 2, 4, 24
    P = N * M + 1
    q = _rand(rng, N, Ls, H, hd)
    k_suf, v_suf = _rand(rng, N, Ls, KV, hd), _rand(rng, N, Ls, KV, hd)
    k_pool, v_pool = _rand(rng, P, bs, KV, hd), _rand(rng, P, bs, KV, hd)
    bt = (1 + rng.permutation(N * M)).reshape(N, M).astype(np.int32)
    st = np.asarray([5, 37, 80], np.int32)          # cached prefixes
    ln = np.asarray([21, 50, 96], np.int32)
    tdt, jdt = _QDT[pool]
    (tkq, tks), (tvq, tvs) = (tattn.quantize_kv(_t(p), tdt)
                              for p in (k_pool, v_pool))
    (jkq, jks), (jvq, jvs) = (jattn.quantize_kv(jnp.asarray(p), jdt)
                              for p in (k_pool, v_pool))
    got = ref.paged_prefill_ref(_t(q), _t(k_suf), _t(v_suf), tkq, tvq,
                                _t(bt), _t(st), _t(ln), tks, tvs,
                                window=window).numpy()
    pallas = np.asarray(jprefill(q, k_suf, v_suf, jkq, jvq, bt, st, ln,
                                 k_scale=jks, v_scale=jvs, window=window,
                                 bq=8, interpret=True))
    assert np.isfinite(got).all()
    for n in range(N):                        # each row's real suffix
        s = int(ln[n] - st[n])
        np.testing.assert_allclose(got[n, :s], pallas[n, :s], **TOL)


def _quantize_case(args, pool, engine=True):
    """The case's pools as int8 / fp8 codes with float32 scales: quantized
    as the engine lands them, or (engine=False) random codes with scales
    in [0, 1/64), as chip_smoke.py's first quantized arms draw them."""
    tdt = _QDT[pool][0]
    kp, vp = args[3:5]
    if engine:
        (kq, ks), (vq, vs) = (tattn.quantize_kv(p.float(), tdt)
                              for p in (kp, vp))
    else:
        g = torch.Generator().manual_seed(len(pool))
        if pool == "int8":
            kq, vq = (torch.randint(-127, 128, kp.shape, generator=g,
                                    dtype=torch.int8) for _ in range(2))
        else:
            kq, vq = ((torch.randn(kp.shape, generator=g) * 64).to(tdt)
                      for _ in range(2))
        ks, vs = (torch.rand(kp.shape[:3], generator=g) / 64
                  for _ in range(2))
    return (*args[:3], kq, vq, *args[5:]), ks, vs


@pytest.mark.parametrize("pool", ["int8", "fp8"])
@pytest.mark.parametrize("case,kw,window", [
    ("admission", dict(), 0),            # smollm 4 x 128, cached 0/48/200
    ("admission", dict(), 64),
    ("admission", dict(dt="f16"), 0),
    ("admission", dict(engine=False), 0),  # random codes and scales
    ("bucket16", dict(), 0),
    ("verify2", dict(), 0),               # speculate=4's verify chains
    ("verify4", dict(), 0),
    ("verify5", dict(), 0),
    ("verify5", dict(dt="f16"), 0),
    ("small", dict(H=4, KV=2, hd=16), 0),    # the reduced configs
    ("small", dict(H=32, KV=32, hd=80), 6),  # stablelm-3b
    ("small", dict(H=10, KV=1, hd=256), 0),  # recurrentgemma-2b
    ("small", dict(H=10, KV=1, hd=256), 6),
    ("admission", dict(bs=4, M=128), 0),  # block sizes 4 and 2048
    ("admission", dict(bs=2048, M=1), 64),
])
def test_paged_prefill_quantized_tiled_order_stays_in_the_bf16_gate(
        pool, case, kw, window):
    kw = dict(kw)
    dt = torch.float16 if kw.pop("dt", "bf16") == "f16" else torch.bfloat16
    engine = kw.pop("engine", True)
    if case == "admission":
        starts, counts, Ls = _ADMISSION
    elif case == "bucket16":
        starts, counts, Ls = [160, 0, 33, 0], [10, 16, 12, 0], 16
    elif case.startswith("verify"):
        starts, counts, Ls = _verify(int(case[-1]))
    else:
        kw = {**kw, "bs": 16, "M": 8, "lengths": _SMALL_HD["lengths"]}
        starts, counts, Ls = _SMALL_HD["starts"], None, 16
    args = _prefill_bf16_case(len(case) + window, starts, counts, Ls, **kw)
    if dt is torch.float16:
        args = (*(a.half() for a in args[:5]), *args[5:])
    args, ks, vs = _quantize_case(args, pool, engine)
    got = ref.paged_prefill_tiled_ref(*args, ks, vs, window=window,
                                      key_tile=FLASH_KEY_TILE, p_split=True)
    want = ref.paged_prefill_ref(*args, ks, vs, window=window)
    assert got.dtype == dt
    assert _bf16_ulps(got, want) <= _TOL_ULPS


def test_paged_prefill_quantized_single_rounding_breaks_the_bf16_gate():
    """The v scale on P's columns before the hi + lo split keeps the
    16-bit route's 2 ulps; one rounding of P t breaks it as it breaks the
    16-bit route's."""
    args, ks, vs = _quantize_case(_prefill_bf16_case(7, *_ADMISSION), "int8")
    want = ref.paged_prefill_ref(*args, ks, vs)
    kw = dict(key_tile=FLASH_KEY_TILE)
    once = ref.paged_prefill_tiled_ref(*args, ks, vs, p_split=False, **kw)
    split = ref.paged_prefill_tiled_ref(*args, ks, vs, p_split=True, **kw)
    assert _bf16_ulps(once, want) > 4 * _TOL_ULPS
    assert _bf16_ulps(split, want) <= _TOL_ULPS


@pytest.mark.parametrize("which", ["twin", "tiled"])
@pytest.mark.parametrize("pool", ["int8", "fp8"])
@pytest.mark.parametrize("bs,M", [(16, 32), (4, 128)])
def test_paged_prefill_quantized_nan_in_masked_slots_adds_nothing(
        which, pool, bs, M):
    """NaN scales, and in an fp8 pool NaN codes (0x7F, 0xFF), in every
    pool slot a row may not see leave the twin and the tensor-core
    emulation bit for bit the same."""
    args, ks, vs = _quantize_case(
        _prefill_bf16_case(3, [20, 0, 61], [32, 32, 3], 32, bs=bs, M=M),
        pool)
    q, k_suf, v_suf, kp, vp, bt, st, ln = args

    def run(kp_, vp_, ks_, vs_):
        a = (q, k_suf, v_suf, kp_, vp_, bt, st, ln, ks_, vs_)
        if which == "twin":
            return ref.paged_prefill_ref(*a)
        return ref.paged_prefill_tiled_ref(*a, key_tile=FLASH_KEY_TILE,
                                           p_split=True)

    used = torch.zeros(kp.shape[:2], dtype=torch.bool)
    for n, s in enumerate(st.tolist()):
        t = torch.arange(s)
        used[bt[n, t // bs].long(), t % bs] = True
    kd, vd, ksd, vsd = kp.clone(), vp.clone(), ks.clone(), vs.clone()
    ksd[~used] = float("nan")
    vsd[~used] = float("nan")
    if pool == "fp8":
        kd.view(torch.uint8)[~used] = 0x7F
        vd.view(torch.uint8)[~used] = 0xFF
        assert torch.isnan(kd.float()).any() and torch.isnan(vd.float()).any()
    clean, dirty = run(kp, vp, ks, vs), run(kd, vd, ksd, vsd)
    assert torch.isfinite(dirty.float()).all()
    torch.testing.assert_close(dirty, clean, atol=0, rtol=0)


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "wgmma"), (torch.float16, "wgmma"),
    (torch.float32, "cuda_cores")])
def test_paged_prefill_route(dtype, kernel):
    """The CUDA kernel a call takes is fixed by q's dtype alone: 16-bit q
    on the tensor cores over any pool (its own dtype, int8, fp8), float32
    q on CUDA cores."""
    assert prefill_route(dtype) == kernel


# The RWKV6 kernel (csrc/rwkv6_scan.cu) gives each value column's N key
# rows to 4 lanes of N / 4 rows and sums y_j in one serial chain over the
# rows, passed lane to lane: the order of ref.rwkv6_scan_split_ref. It
# keeps the state bit-equal to the twin (each state element is still
# updated by one multiply and one add, rounded on their own) and y within
# chip_smoke.py's tolerances: float32 1e-5 (1 + |twin|), bf16 2 ulps.
# chip_smoke.py's shapes, the time axis cut for the CPU.
@pytest.mark.parametrize("shape", [(4, 40, 1, 64), (2, 40, 24, 64),
                                   (1, 40, 33, 64), (2, 4, 40, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_split_emulation(shape, dtype, with_s0):
    B, H, T, N = shape
    rng = np.random.default_rng(T * N + with_s0)
    td = getattr(torch, dtype)
    r, k, v = (_t(_rand(rng, *shape) * 0.5).to(td) for _ in range(3))
    w = torch.exp(-torch.exp(_t(_rand(rng, *shape)) - 1))
    u = _t(_rand(rng, H, N)) * 0.1
    s0 = _t(_rand(rng, B, H, N, N)) if with_s0 else None
    got, got_s = ref.rwkv6_scan_split_ref(r, k, v, w, u, s0)
    want, want_s = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    assert got.dtype == td and got.shape == want.shape
    torch.testing.assert_close(got_s, want_s, atol=0, rtol=0)
    if dtype == "float32":
        diff = (got - want).abs()
        assert bool((diff <= 1e-5 * (1 + want.abs())).all())
    else:
        assert _bf16_ulps(got, want) <= _TOL_ULPS


# The speculative verify's rollback points: rwkv6_scan(return_states=True)
# also returns the state after each step. In the twin (and the kernel,
# tests/test_torch_cuda_kernels.py) S_steps[:, :, t] is exactly S_T of the
# call cut to t + 1 steps and of t + 1 single steps chained through s0,
# and the flag moves neither y nor S_T.
@pytest.mark.parametrize("shape", [(4, 40, 8, 64), (2, 4, 5, 12),
                                   (1, 3, 1, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_twin_states_equal_cut_runs(shape, dtype, with_s0):
    B, H, T, N = shape
    rng = np.random.default_rng(T * N + 3 * with_s0)
    td = getattr(torch, dtype)
    r, k, v = (_t(_rand(rng, *shape) * 0.5).to(td) for _ in range(3))
    w = torch.exp(-torch.exp(_t(_rand(rng, *shape)) - 1))
    u = _t(_rand(rng, H, N)) * 0.1
    s0 = _t(_rand(rng, B, H, N, N)) if with_s0 else None
    before = rwkv6_scan.launches
    y, s_fin, steps = rwkv6_scan(r, k, v, w, u, s0, return_states=True)
    assert rwkv6_scan.launches == before          # the twin on the CPU
    assert steps.shape == (B, H, T, N, N) and steps.dtype == torch.float32
    y0, s_fin0 = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y0, atol=0, rtol=0)
    torch.testing.assert_close(s_fin, s_fin0, atol=0, rtol=0)
    s = s0
    for t in range(T):
        cut = [x[:, :, :t + 1] for x in (r, k, v, w)]
        _, s_cut = ref.rwkv6_scan_ref(*cut, u, s0)
        torch.testing.assert_close(steps[:, :, t], s_cut, atol=0, rtol=0)
        _, s = ref.rwkv6_scan_ref(*(x[:, :, t:t + 1] for x in (r, k, v, w)),
                                  u, s)
        torch.testing.assert_close(steps[:, :, t], s, atol=0, rtol=0)
    empty = ref.rwkv6_scan_ref(*(x[:, :, :0] for x in (r, k, v, w)), u, s0,
                               return_states=True)
    assert empty[2].shape == (B, H, 0, N, N)


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_serial_emulation_is_one_chain(T, with_s0):
    """The emulation adds the terms r_i (S_ij + u_i k_i v_j) of a step one
    by one from 0 in float32, i = 0 .. N - 1: the kernel's chain, checked
    element by element in numpy, at a decode step and over a prompt, from
    zeros and from a carried state."""
    rng = np.random.default_rng(5 + T + 2 * with_s0)
    B, H, N = 1, 2, 8
    r, k, v = (_rand(rng, B, H, T, N) for _ in range(3))
    w = np.exp(-np.exp(_rand(rng, B, H, T, N) - 1)).astype(np.float32)
    u = _rand(rng, H, N) * np.float32(0.1)
    s0 = _rand(rng, B, H, N, N) if with_s0 else None
    got, _ = ref.rwkv6_scan_split_ref(
        *(_t(a) for a in (r, k, v, w, u)), None if s0 is None else _t(s0))
    S = s0.copy() if with_s0 else np.zeros((B, H, N, N), np.float32)
    for t in range(T):
        kv = k[0, :, t, :, None] * v[0, :, t, None, :]          # (H, N, N)
        term = r[0, :, t, :, None] * (S[0] + u[:, :, None] * kv)
        acc = np.zeros((H, N), np.float32)
        for i in range(N):
            acc = acc + term[:, i]
        np.testing.assert_array_equal(got[0, :, t].numpy(), acc)
        S = (w[0, :, t, :, None] * S[0] + kv)[None]


# A head dim that is not a multiple of 8 (or an input that is not 16-byte
# aligned) reaches the RWKV6 kernel through pad_head_dim: r, k, v, u and s0
# padded with zeros, w with ones, to the next multiple of 8, then y and S_T
# sliced back. The padded key rows add exact zeros at the end of y's
# serial chain and their state rows stay zero, so the kernel's order
# (rwkv6_scan_split_ref) and the state give the unpadded call's bits. The
# twin's y is an einsum, whose float32 sums are blocked by length, so
# padded it keeps only the kernel's tolerance: float32 1e-5 (1 + |twin|),
# bf16 2 ulps. The sliced result also matches the JAX oracle, which takes
# any N up to 64.
@pytest.mark.parametrize("N", [1, 12, 60])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_pad_head_dim_keeps_the_bits(N, dtype, with_s0):
    B, H, T = 2, 4, 40
    rng = np.random.default_rng(N + 100 * with_s0)
    td = getattr(torch, dtype)
    r, k, v = (_t(_rand(rng, B, H, T, N) * 0.5).to(td) for _ in range(3))
    w = torch.exp(-torch.exp(_t(_rand(rng, B, H, T, N)) - 1))
    u = _t(_rand(rng, H, N)) * 0.1
    s0 = _t(_rand(rng, B, H, N, N)) if with_s0 else None
    args = (r, k, v, w, u, s0)
    padded = pad_head_dim(*args)
    P = -(-N // 8) * 8
    assert padded[0].shape == (B, H, T, P) and padded[4].shape == (H, P)
    assert (padded[5] is None) == (s0 is None)
    assert bool((padded[3][..., N:] == 1).all())
    assert all(bool((t[..., N:] == 0).all()) for t in padded[:3] + padded[4:5])
    if s0 is not None:
        assert padded[5].shape == (B, H, P, P)
        assert not padded[5][..., N:, :].any() and not padded[5][..., N:].any()
    want, want_s = ref.rwkv6_scan_split_ref(*args)
    got, got_s = ref.rwkv6_scan_split_ref(*padded)
    torch.testing.assert_close(got[..., :N], want, atol=0, rtol=0)
    torch.testing.assert_close(got_s[..., :N, :N], want_s, atol=0, rtol=0)
    assert not got_s[..., N:, :].any()               # padded rows stay zero
    twin, twin_s = ref.rwkv6_scan_ref(*args)
    ptwin, ptwin_s = ref.rwkv6_scan_ref(*padded)
    torch.testing.assert_close(ptwin_s[..., :N, :N], twin_s, atol=0, rtol=0)
    if dtype == "float32":
        diff = (ptwin[..., :N] - twin).abs()
        assert bool((diff <= 1e-5 * (1 + twin.abs())).all())
        jy, js = jref.rwkv6_ref(
            *(jnp.asarray(a.numpy()) for a in (r, k, v, w, u)),
            None if s0 is None else jnp.asarray(s0.numpy()))
        np.testing.assert_allclose(got[..., :N].numpy(), np.asarray(jy),
                                   **TOL)
        np.testing.assert_allclose(got_s[..., :N, :N].numpy(),
                                   np.asarray(js), **TOL)
    else:
        assert _bf16_ulps(ptwin[..., :N], twin) <= _TOL_ULPS


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


# ----------------------------------------------------------------------------
# windowed flash attention (recurrentgemma's attn_local layers)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,S,hd,window", [
    (2, 4, 2, 40, 16, 16),       # the reduced config's window, S > window
    (1, 10, 1, 24, 256, 7),      # recurrentgemma's heads and head_dim
    (1, 4, 4, 12, 16, 64),       # a window wider than the sequence
])
def test_flash_twin_window_matches_jax_chunked(B, H, KV, S, hd, window):
    """The twin's window (key u visible to query i when i - window < u <=
    i) against the JAX model's chunked_causal_attention(window=...), which
    attn_local layers run; float32 at 2e-5."""
    rng = np.random.default_rng(S + hd + window)
    q = _rand(rng, B, S, H, hd)
    k = _rand(rng, B, S, KV, hd)
    v = _rand(rng, B, S, KV, hd)
    got = ref.flash_attention_ref(_t(q.transpose(0, 2, 1, 3)),
                                  _t(k.transpose(0, 2, 1, 3)),
                                  _t(v.transpose(0, 2, 1, 3)),
                                  window=window).numpy().transpose(0, 2, 1, 3)
    want = np.asarray(jchunked(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), chunk=8, window=window))
    np.testing.assert_allclose(got, want, **TOL)


# ----------------------------------------------------------------------------
# rg-lru scan
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,C", [(1, 64, 32), (2, 48, 160)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_twin_matches_jax(B, T, C, dtype, with_h0):
    """The twin against the Pallas kernel (interpret mode; T a multiple of
    its time chunk) and the jnp oracle: float32 at 1e-5, bf16 (the same bf16 bits in both packages)
    at 5e-2, the tolerances of tests/test_kernels.py's rglru tests."""
    rng = np.random.default_rng(T + C)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    a = jnp.asarray(1 / (1 + np.exp(-2 * _rand(rng, B, T, C))), jd)
    x = jnp.asarray(0.3 * _rand(rng, B, T, C), jd)
    h0 = _rand(rng, B, C) if with_h0 else None
    ta, tx = (_t(np.array(z, np.float32)).to(td) for z in (a, x))
    th0 = None if h0 is None else _t(h0)
    got, got_h = ref.rglru_scan_ref(ta, tx, th0)
    assert got.dtype == td and got_h.dtype == torch.float32
    jh0 = None if h0 is None else jnp.asarray(h0)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for want, want_h in (jrglru(a, x, jh0, tc=16, cb=32, interpret=True),
                         jref.rglru_ref(a, x, jh0)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                   atol=tol, rtol=tol)
    before = rglru_scan.launches
    wrapped, wrapped_h = rglru_scan(ta, tx, th0)
    assert rglru_scan.launches == before          # no kernel on the CPU
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
    torch.testing.assert_close(wrapped_h, got_h, rtol=0, atol=0)


def test_rglru_twin_rounds_each_step_like_the_kernel():
    """Each step is a float32 multiply then a float32 add, rounded on
    their own: the kernel's __fmul_rn / __fadd_rn, so kernel and twin can
    be held bit for bit on the card."""
    rng = np.random.default_rng(3)
    a, x = _t(_rand(rng, 2, 9, 5)), _t(_rand(rng, 2, 9, 5))
    h0 = _t(_rand(rng, 2, 5))
    got, h_T = ref.rglru_scan_ref(a, x, h0)
    h = h0.numpy()
    for t in range(9):
        h = np.float32(a[:, t].numpy() * h) + x[:, t].numpy()
        np.testing.assert_array_equal(got[:, t].numpy(), h)
    np.testing.assert_array_equal(h_T.numpy(), h)


def test_rglru_wrapper_refuses_other_devices():
    a = torch.zeros(1, 4, 16, device="meta")
    with pytest.raises(ValueError):
        rglru_scan(a, a)


# csrc/rglru_scan.cu has two kernels, one launch a call: the bulk kernel
# (32-channel tiles, time chunks of 64 staged by bulk copies, whose rows
# must be 16-byte multiples at 16-byte aligned addresses) and the direct
# kernel (a thread per channel). The wrapper picks one from the shape and
# the pointers before the launch; on the card both give the twin's bits
# (tests/test_torch_cuda_kernels.py::test_rglru_scan_bit_equal_to_twin).
@pytest.mark.parametrize("B,T,C,dtype,offset,kernel", [
    (1, 2304, 2560, "float32", 0, "bulk"),     # lm.forward, 80 blocks
    (2, 512, 2560, "bfloat16", 0, "bulk"),
    (4, 64, 2560, "float32", 0, "bulk"),       # generate()'s prefill
    (1, 65, 2560, "float16", 0, "bulk"),
    (1, 63, 2560, "float32", 0, "direct"),     # under one chunk
    (4, 1, 2560, "float32", 0, "direct"),      # a decode step
    (8, 1, 2560, "bfloat16", 0, "direct"),
    (1, 0, 2560, "float32", 0, "direct"),
    (1, 2304, 13, "float32", 0, "direct"),     # rows not 16-byte multiples
    (1, 2304, 2561, "float32", 0, "direct"),
    (1, 2304, 2564, "float32", 0, "bulk"),     # 10256-byte rows
    (1, 2304, 2564, "bfloat16", 0, "direct"),  # 5128-byte rows
    (1, 2304, 2568, "bfloat16", 0, "bulk"),
    (1, 2304, 2560, "float32", 4, "direct"),   # a view one element in
    (1, 2304, 2560, "bfloat16", 8, "direct"),
    (1, 2304, 2560, "bfloat16", 16, "bulk"),   # eight elements in
])
def test_rglru_scan_route(B, T, C, dtype, offset, kernel):
    td = getattr(torch, dtype)
    base = 1 << 20                                  # an aligned allocation
    assert rglru_scan.route(B, T, C, td, base + offset, base,
                            base) == kernel
    assert rglru_scan.route(B, T, C, td, base, base + offset,
                            base) == kernel
    tile = -(-C // 32)
    assert rglru_scan.blocks(B, C, kernel) == (
        B * tile if kernel == "bulk" else -(-B * C // 128))


def test_rglru_scan_route_of_a_view():
    """A view at an element offset of a contiguous buffer is contiguous
    but not 16-byte aligned: the direct kernel takes it."""
    buf = torch.zeros(1 + 2 * 64 * 32)
    view = buf[1:].view(2, 64, 32)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    whole = torch.zeros(2, 64, 32)
    assert rglru_scan.route(2, 64, 32, torch.float32, view.data_ptr(),
                            whole.data_ptr(), whole.data_ptr()) == "direct"
    assert rglru_scan.route(2, 64, 32, torch.float32, whole.data_ptr(),
                            whole.data_ptr(), whole.data_ptr()) == "bulk"
    assert rglru_scan.blocks(2, 32, "bulk") == 2


# flash_attention (bf16 / f16), paged_prefill's tensor-core path and
# paged_attention read their inputs with TMA, which needs 16-byte aligned
# addresses: the wrappers pass each such input through build.tma_ready,
# which copies one that is off a 16-byte boundary (a pure function of its
# pointer, build.tma_copies) and passes an aligned one through untouched.
# On the card the wrappers then give the aligned call's bits
# (tests/test_torch_cuda_kernels.py::
# test_unaligned_bf16_views_give_the_aligned_bits).
@pytest.mark.parametrize("offset,copied", [(0, False), (2, True),
                                           (8, True), (16, False),
                                           (17, True), (4096, False)])
def test_tma_copies_route(offset, copied):
    base = 1 << 20                                  # an aligned allocation
    assert build.tma_copies(base + offset) == (copied,)
    assert build.tma_copies(base, base + offset, base) == (False, copied,
                                                           False)


@pytest.mark.parametrize("dtype,offset", [("bfloat16", 1), ("float16", 3),
                                          ("bfloat16", 8),
                                          ("float32", 1), ("int8", 5)])
def test_tma_ready_copies_only_unaligned_views(dtype, offset):
    td = getattr(torch, dtype)
    shape = (3, 5, 16)
    whole = torch.arange(np.prod(shape)).reshape(shape).to(td)
    buf = torch.zeros(offset + whole.numel(), dtype=td)
    view = buf[offset:].view(shape)
    view.copy_(whole)
    assert view.is_contiguous()
    misaligned = (offset * whole.element_size()) % 16 != 0
    assert build.tma_copies(view.data_ptr()) == (misaligned,)
    got_whole, got_view = build.tma_ready(whole, view)
    assert got_whole is whole                       # aligned: untouched
    assert (got_view is view) == (not misaligned)
    assert got_view.data_ptr() % 16 == 0 and got_view.is_contiguous()
    assert got_view.dtype == td and got_view.shape == shape
    torch.testing.assert_close(got_view, whole, atol=0, rtol=0)
