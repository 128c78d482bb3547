"""Quantized KV pools and the host spill tier of the port held to the JAX
package on the CPU: the quantizer (int8 and fp8-e4m3, bit for bit, rows
whose largest element lands on fp8's 448 edge included), pool accounting,
copy_block and the gather / scatter payload round trip, the paged prefill
and decode attention blocks on quantized caches (outputs within 2e-5,
pools within one quantization step) and load_prefill's quantize on
landing. The engines on quantized pools and the host tier are in
tests/test_torch_kv_quant_engine.py (split from this file so that the
workers of a parallel run share its time)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402

import _torch_models  # noqa: E402

RG = "recurrentgemma-2b"
TDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


_models = _torch_models.reduced_models


def _raw(x):
    """Bytes of a torch tensor or a JAX / numpy array as a numpy array
    (fp8 and int8 as uint8), floats as they are."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint8) if x.element_size() == 1
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.itemsize == 1 else x


def _rows(seed, shape=(5, 8, 3, 16)):
    """Random K/V rows at a few magnitudes, plus all-zero rows and rows
    whose largest element is the only nonzero one or shares its
    magnitude with others (the fp8 448 edge: it divides to 448 within an
    ulp)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * np.float32(3.0)
    x[0, 0] = 0.0
    x[0, 1] = 0.0
    x[0, 1, :, 3] = np.float32(1e-3)
    x[0, 2, :, :4] = np.float32(2.75)
    x[0, 2, :, 4] = np.float32(-2.75)
    x[1] *= np.float32(1e4)
    x[2] *= np.float32(1e-4)
    return x


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_dequantize_bit_equal_to_jax(kv, seed):
    x = _rows(seed)
    q, s = tattn.quantize_kv(torch.from_numpy(x), TDT[kv])
    jq, js = jattn.quantize_kv(jnp.asarray(x), JDT[kv])
    assert q.dtype == TDT[kv] and s.dtype == torch.float32
    np.testing.assert_array_equal(_raw(q), _raw(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tattn.dequantize_kv(q, s).numpy(),
        np.asarray(jattn.dequantize_kv(jq, js)))
    assert not torch.isnan(q.float()).any()
    # the largest element of every nonzero row lands on qmax
    top = q.float().abs().amax(-1)
    nz = s > 0
    assert (top[nz] == tattn.pool_qmax(TDT[kv])).all()
    assert (q.float()[~nz] == 0).all()
    assert tattn.pool_qmax(TDT[kv]) == jattn.pool_qmax(JDT[kv])


def test_fp8_cast_matches_jax_on_the_quantizers_range():
    """torch's float8_e4m3fn cast and ml_dtypes' (JAX's) agree on every
    value quantize_kv can cast, |q| <= 448 (1 + eps): round to nearest
    even, 464 (halfway to the 480 e4m3fn lacks) to 448. Past 464 they
    part: torch saturates to 448, ml_dtypes gives NaN. The quantizer never
    gets there, since its largest element divides to 448 within an ulp
    (test_quantize_dequantize_bit_equal_to_jax)."""
    eps = np.finfo(np.float32).eps
    x = np.asarray([448 * (1 + eps), 448 * (1 - eps), 448, 456, 464, -464,
                    17.0, -3.3, 0.0019, 1e-9, 0.0], np.float32)
    got = torch.from_numpy(x).to(torch.float8_e4m3fn)
    want = jnp.asarray(x).astype(jnp.float8_e4m3fn)
    np.testing.assert_array_equal(_raw(got), _raw(want))
    assert got.float()[:6].abs().tolist() == [448.0] * 6
    past = np.asarray([465.0, -470.0], np.float32)
    assert torch.from_numpy(past).to(torch.float8_e4m3fn).float() \
        .tolist() == [448.0, -448.0]
    assert np.isnan(np.asarray(jnp.asarray(past).astype(jnp.float8_e4m3fn)
                               .astype(jnp.float32))).all()


@pytest.mark.parametrize("arch", ["smollm-135m", RG])
@pytest.mark.parametrize("kv", ["fp16", "int8", "fp8"])
def test_pool_bytes_match_jax(arch, kv):
    jcfg, _, tcfg, _ = _models(arch)
    assert tkv.paged_bytes(tcfg, 33, 4, kv) == jkv.paged_bytes(jcfg, 33, 4,
                                                               kv)
    assert tkv.block_bytes(tcfg, 16, kv) == jkv.block_bytes(jcfg, 16, kv)
    assert tkv.pool_dtype(tcfg, kv).itemsize == jkv.pool_dtype(jcfg,
                                                               kv).itemsize
    assert tkv.quantized(kv) == jkv.quantized(kv)
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.pool_dtype(tcfg, "int4")


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_init_state_scales_and_copy_block_carries_them(kv):
    _, _, tcfg, _ = _models()
    state = tkv.init_paged_state(tcfg, 1, 6, 4, kv_dtype=kv, device="cpu")
    for _, st in tlm._layers(state, tcfg):
        assert st["k"].dtype == TDT[kv] and (st["k"].float() == 0).all()
        assert st["k_scale"].shape == (6, 4, tcfg.n_kv_heads)
        q, s = tattn.quantize_kv(torch.randn(4, tcfg.n_kv_heads,
                                             tcfg.head_dim), TDT[kv])
        st["k"][2], st["k_scale"][2] = q, s
    tkv.copy_block(tcfg, state, 2, 4)
    for _, st in tlm._layers(state, tcfg):
        for name in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(_raw(st[name][4]),
                                          _raw(st[name][2]))
        assert (st["k_scale"][4] > 0).all()


def _filled(cfg, kv, seed, nb=8, bs=4):
    """A paged state whose every pool leaf holds random data."""
    state = tkv.init_paged_state(cfg, 1, nb, bs, kv_dtype=kv, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for _, st in tlm._layers(state, cfg):
        for name, a in st.items():
            if a.dtype.is_floating_point and a.element_size() > 1:
                a.copy_(torch.rand(a.shape, generator=g))
            else:
                a.view(torch.uint8).copy_(torch.randint(
                    0, 120, a.shape, generator=g, dtype=torch.uint8))
    return state


@pytest.mark.parametrize("kv", ["fp16", "int8", "fp8"])
def test_gather_scatter_blocks_exact_roundtrip(kv):
    """The host-tier payload path: gather to host tensors, scatter into a
    blank state, every pool leaf (scales included) restored bit for bit;
    the payload's layers hold what JAX's gather_blocks leaves hold."""
    _, _, tcfg, _ = _models()
    state = _filled(tcfg, kv, 3)
    ids = torch.tensor([2, 5, 1])
    payload = tkv.gather_blocks(tcfg, state, ids, device="cpu")
    blank = tkv.init_paged_state(tcfg, 1, 8, 4, kv_dtype=kv, device="cpu")
    tkv.scatter_blocks(tcfg, blank, ids, payload)
    for (kind, st), (_, rs), (_, pa) in zip(tlm._layers(state, tcfg),
                                            tlm._layers(blank, tcfg),
                                            tlm._layers(payload, tcfg)):
        want = {"k", "v"} | ({"k_scale", "v_scale"} if kv != "fp16"
                             else set())
        assert set(pa) == want
        for name in want:
            np.testing.assert_array_equal(_raw(pa[name]),
                                          _raw(st[name][ids]))
            for b in (2, 5, 1):
                np.testing.assert_array_equal(_raw(rs[name][b]),
                                              _raw(st[name][b]))
            assert (rs[name][3].float() == 0).all()    # untouched


def _jax_pool(cache, name):
    return np.asarray(cache[name]).astype(np.float32) \
        if cache[name].dtype.itemsize == 1 else np.asarray(cache[name])


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("window", [0, 6])
def test_paged_blocks_on_quantized_pools_match_jax(kv, window):
    """paged_prefill_attention_block (three rows: fresh, cached prefix,
    one token) then paged_decode_attention_block through int8 / fp8 pools:
    outputs within 2e-5 of JAX's; the pools' dequantized K/V within one
    quantization step (a K/V element 1e-7 from a rounding edge may land
    on the other side), the scales within 1e-6 relative."""
    _, jparams, tcfg, tparams = _models()
    jcfg = _models()[0]
    p_t, p_j = tparams["blocks"]["p0"][0]["attn"], jax.tree.map(
        lambda a: a[0], jparams["blocks"]["p0"]["attn"])
    N, Ls, bs, M, P = 3, 8, 4, 6, 20
    D = jcfg.d_model
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, Ls, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, P))[:N * M].reshape(N, M) \
        .astype(np.int32)
    cached = np.asarray([0, 9, 12], np.int32)
    lengths = np.asarray([7, 17, 13], np.int32)
    starts = np.minimum(cached, lengths - 1)
    pos = (starts[:, None] + np.arange(Ls)[None]).astype(np.int32)
    kvd = (P, bs, jcfg.n_kv_heads, jcfg.head_dim)
    pool = rng.standard_normal((2,) + kvd).astype(np.float32)
    jq = [jattn.quantize_kv(jnp.asarray(p), JDT[kv]) for p in pool]
    jcache = {"k": jq[0][0], "v": jq[1][0], "k_scale": jq[0][1],
              "v_scale": jq[1][1]}
    tq = [tattn.quantize_kv(torch.from_numpy(p), TDT[kv]) for p in pool]
    tcache = {"k": tq[0][0], "v": tq[1][0], "k_scale": tq[0][1],
              "v_scale": tq[1][1]}
    T = torch.from_numpy
    out, _ = tattn.paged_prefill_attention_block(
        p_t, T(x), tcache, T(pos), T(tables), T(starts), T(lengths),
        T(cached), tcfg, window=window)
    jout, jcache = jattn.paged_prefill_attention_block(
        p_j, jnp.asarray(x), jcache, jnp.asarray(pos), jnp.asarray(tables),
        jnp.asarray(starts), jnp.asarray(lengths), jnp.asarray(cached),
        jcfg, window=window)
    for n in range(N):
        s = int(lengths[n] - starts[n])
        np.testing.assert_allclose(out.numpy()[n, :s],
                                   np.asarray(jout)[n, :s], atol=2e-5,
                                   rtol=2e-5)
    xd = rng.standard_normal((N, 1, D)).astype(np.float32)
    dpos = lengths.copy()
    out, _ = tattn.paged_decode_attention_block(
        p_t, T(xd), tcache, T(dpos), T(tables), tcfg, window=window)
    jout, jcache = jattn.paged_decode_attention_block(
        p_j, jnp.asarray(xd), jcache, jnp.asarray(dpos),
        jnp.asarray(tables), jcfg, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=2e-5)
    for name in ("k", "v"):
        sc = np.asarray(jcache[f"{name}_scale"])
        np.testing.assert_allclose(tcache[f"{name}_scale"].numpy()[1:],
                                   sc[1:], rtol=1e-6, atol=0)
        got = tattn.dequantize_kv(tcache[name], tcache[f"{name}_scale"])
        want = np.asarray(jattn.dequantize_kv(jcache[name],
                                              jcache[f"{name}_scale"]))
        step = sc[..., None] * (1 + 1e-6) + 1e-7
        assert (np.abs(got.numpy() - want)[1:] <= step[1:]).all()


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_load_prefill_quantizes_on_landing_as_jax(kv):
    """kv_cache.load_prefill into a quantized state: the prompt's K/V land
    as (q, scale) pairs through the table row, as JAX's loader lands them
    (within one quantization step), and equal to what lm.prefill_paged
    leaves for the same prompt."""
    jcfg, jparams, tcfg, tparams = _models()
    bs, P = 4, 11
    table = np.asarray([5, 2, 7, 0, 0, 0], np.int32)
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, P) \
        .astype(np.int32)
    _, jcache = jlm.prefill(jparams, jcfg, {"tokens": prompt[None]})
    jstate = jkv.load_prefill(jcfg, jkv.init_paged_state(jcfg, 2, 9, bs, kv),
                              jcache, np.int32(0), table, bs)
    _, tcache = tlm.prefill(tparams, tcfg,
                            {"tokens": torch.from_numpy(prompt[None])})
    tstate = tkv.load_prefill(tcfg, tkv.init_paged_state(
        tcfg, 2, 9, bs, kv, device="cpu"), tcache, 0, table, bs)
    fused = tkv.init_paged_state(tcfg, 2, 9, bs, kv, device="cpu")
    i32 = torch.int32
    tlm.prefill_paged(tparams, tcfg, fused, torch.from_numpy(prompt[None]),
                      torch.tensor([P], dtype=i32), torch.zeros(1, dtype=i32),
                      torch.from_numpy(table[None]),
                      torch.tensor([0], dtype=i32))
    jl = [jstate["blocks"]["p0"]]
    for li, ((_, st), (_, fs)) in enumerate(zip(tlm._layers(tstate, tcfg),
                                                tlm._layers(fused, tcfg))):
        js = jax.tree.map(lambda a: a[li], jl[0])
        for name in ("k", "v"):
            sc = np.asarray(js[f"{name}_scale"])
            got = tattn.dequantize_kv(st[name], st[f"{name}_scale"]).numpy()
            want = np.asarray(jattn.dequantize_kv(js[name],
                                                  js[f"{name}_scale"]))
            assert (np.abs(got - want)[1:]
                    <= (sc[..., None] * (1 + 1e-6) + 1e-6)[1:]).all()
            for t in (name, f"{name}_scale"):
                np.testing.assert_array_equal(_raw(st[t])[1:],
                                              _raw(fs[t])[1:])
