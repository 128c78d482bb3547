"""The frontends slice held to the JAX package on the CPU, part 1: the
frontend functions (`models/frontends.py`), the JAX-order init of the
reduced paligemma-3b and musicgen-medium, the flash twins' bidirectional
prefix arm (the prefix-LM mask every attention layer of paligemma runs),
attention_block with a prefix, the naive CLI's audio prompts, and the
engine's refusal of both archs. The lm paths, generate() and the JAX
package's own frontend tests on the port are in test_torch_frontends_lm.py.

Tolerances: the frontend functions 1e-6 (float32 gathers; the
projection's sums 1e-6 of their scale, sum |x_i w_i|); init within 3 float32 ulps (test_torch_init.py's standard);
the twins' prefix arm 2e-5 against JAX's chunked_causal_attention and
jax.vjp of it (the JAX kernels' own float32 tolerance); the 16-bit
kernels' orders of work (ref.flash_attention_tiled_ref,
ref.flash_attention_bwd_split_ref) within chip_smoke.py's 2 bf16 ulps of
the twin at the prefix arms' shapes; prompts bit-equal."""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import flash_attention, ref  # noqa: E402
from repro_torch.kernels.build import FLASH_KEY_TILE  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import frontends as tfront  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

ARCHS = ["paligemma-3b", "musicgen-medium"]
TOL = dict(atol=2e-5, rtol=2e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ulps_ok(got, want, limit=3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    return ulps.max() <= limit, ulps.max()


# ----------------------------------------------------------------------------
# the frontend functions and the JAX-order init
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("vision_dim,d_model", [(32, 64), (1152, 96)])
def test_vision_frontend_matches_jax(vision_dim, d_model):
    key = jax.random.PRNGKey(5)
    want = jfront.init_vision_frontend(key, vision_dim, d_model, jnp.float32)
    got = tfront.init_vision_frontend(prng.PRNGKey(5), vision_dim, d_model,
                                      torch.float32)
    ok, worst = _ulps_ok(_np(got["proj"]), want["proj"])
    assert ok, worst
    # the projection on JAX's weights: within 1e-6 of the scale of each
    # output's sum, sum_i |x_i w_i| (the two take the vision_dim terms in
    # other orders)
    w = np.array(want["proj"])
    x = _rand(np.random.default_rng(vision_dim), 2, 8, vision_dim)
    got = _np(tfront.vision_embed({"proj": torch.from_numpy(w)},
                                  torch.from_numpy(x)))
    diff = np.abs(got - np.asarray(jfront.vision_embed(want, jnp.asarray(x))))
    assert (diff <= 1e-6 * np.maximum(1.0, np.abs(x) @ np.abs(w))).all()


@pytest.mark.parametrize("n_cb,vocab,d_model", [(4, 256, 64), (2, 2048, 32)])
def test_audio_embed_matches_jax(n_cb, vocab, d_model):
    key = jax.random.PRNGKey(n_cb)
    want = jfront.init_audio_embed(key, n_cb, vocab, d_model, jnp.float32)
    got = tfront.init_audio_embed(prng.PRNGKey(n_cb), n_cb, vocab, d_model,
                                  torch.float32)
    assert got.shape == (n_cb, vocab, d_model)
    ok, worst = _ulps_ok(_np(got), want)
    assert ok, worst
    toks = np.random.default_rng(vocab).integers(0, vocab, (3, 7, n_cb))
    np.testing.assert_allclose(
        _np(tfront.audio_embed(torch.from_numpy(np.array(want)),
                               torch.from_numpy(toks))),
        np.asarray(jfront.audio_embed(want, jnp.asarray(toks))),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_is_jaxs(arch, seed):
    """lm.init_params draws the frontends' leaves in JAX's key order:
    musicgen's codebook tables from keys[0] and its (D, n_cb * V) head
    from keys[4], paligemma's projection from keys[1]."""
    cfg = tget(arch).reduced()
    got = convert.to_jax(tlm.init_params(seed, cfg, device="cpu"), cfg)
    want = jlm.init_params(jax.random.PRNGKey(seed), jget(arch).reduced())
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        assert np.shape(g) == np.shape(w), path
        ok, worst = _ulps_ok(g, w)
        assert ok, (path, worst)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count(arch):
    cfg = tget(arch).reduced()
    params = tlm.init_params(0, cfg, device="cpu")
    assert convert.param_count(params) == cfg.param_count()


# ----------------------------------------------------------------------------
# the flash twins' bidirectional prefix arm
# ----------------------------------------------------------------------------

S_TWIN = 96
# (H, KV): a group of 2 and MHA; prefix 1, 70 (straddling the kernels'
# 64-row tiles) and the whole sequence
PREFIX_CASES = [(H, KV, hd, prefix, window)
                for H, KV in ((4, 2), (4, 4)) for hd in (16, 64)
                for prefix in (1, 70, S_TWIN) for window in (0, 16)]


def _twin_inputs(H, KV, hd, prefix, window, S=S_TWIN):
    rng = np.random.default_rng(H + KV + hd + prefix + window)
    return (_rand(rng, 2, S, H, hd), _rand(rng, 2, S, KV, hd),
            _rand(rng, 2, S, KV, hd), _rand(rng, 2, S, H, hd))


def _bhsd(x):
    """(B, S, H, hd) numpy -> (B, H, S, hd) tensor, the kernels' layout."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("H,KV,hd,prefix,window", PREFIX_CASES)
def test_flash_twin_prefix_matches_jax_chunked(H, KV, hd, prefix, window):
    """ref.flash_attention_ref(prefix_len=) against the JAX model's
    chunked_causal_attention(prefix_len=), which paligemma's attention
    layers run."""
    q, k, v, _ = _twin_inputs(H, KV, hd, prefix, window)
    got = ref.flash_attention_ref(_bhsd(q), _bhsd(k), _bhsd(v),
                                  window=window, prefix_len=prefix)
    want = jattn.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=32,
        window=window, prefix_len=prefix)
    np.testing.assert_allclose(_np(got).transpose(0, 2, 1, 3),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("H,KV,hd,prefix,window", PREFIX_CASES)
def test_flash_bwd_twin_prefix_matches_jax_grad(H, KV, hd, prefix, window):
    """ref.flash_attention_bwd_ref(prefix_len=) against jax.vjp of
    chunked_causal_attention(prefix_len=): what XLA differentiates when
    the JAX package trains paligemma."""
    q, k, v, do = _twin_inputs(H, KV, hd, prefix, window)
    o, vjp = jax.vjp(lambda a, b, c: jattn.chunked_causal_attention(
        a, b, c, chunk=32, window=window, prefix_len=prefix),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = ref.flash_attention_bwd_ref(
        _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(np.asarray(o)), _bhsd(do),
        window=window, prefix_len=prefix)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(g).transpose(0, 2, 1, 3),
                                   np.asarray(w), err_msg=f"d{name}", **TOL)


def test_flash_wrapper_prefix_takes_the_twin_on_cpu():
    """On CPU tensors flash_attention(prefix_len=) is the twin (no launch),
    and under autograd its gradient is the backward twin's."""
    q, k, v, do = (_bhsd(a) for a in _twin_inputs(4, 2, 16, 70, 0))
    before = flash_attention.launches
    plain = flash_attention(q, k, v, prefix_len=70)
    torch.testing.assert_close(
        plain, ref.flash_attention_ref(q, k, v, prefix_len=70), rtol=0,
        atol=0)
    assert flash_attention.launches == before
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    flash_attention(qs, ks, vs, prefix_len=70).backward(do)
    want = ref.flash_attention_bwd_ref(q, k, v, plain, do, prefix_len=70)
    for g, w in zip((qs.grad, ks.grad, vs.grad), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_prefix_0_is_the_causal_mask():
    q, k, v, do = (_bhsd(a) for a in _twin_inputs(4, 2, 16, 1, 16))
    for window in (0, 16):
        torch.testing.assert_close(
            ref.flash_attention_ref(q, k, v, window=window, prefix_len=0),
            ref.flash_attention_ref(q, k, v, window=window), rtol=0, atol=0)


# The 16-bit kernels' orders of work with the prefix arm, at chip_smoke.py's
# prefix shapes: paligemma's 8 / 1 heads at hd 256 (256 patches + 64 text
# tokens) and a prefix straddling a 64-row tile at hd 64, with and without
# a window; within the 2-ulp gate of the float32 twin.
_TOL_ULPS, _ULP_FLOOR = 2, 2.0 ** -8
PREFIX_SMOKE = [(2, 8, 1, 320, 256, 256, 0), (2, 4, 2, 200, 64, 100, 0),
                (2, 4, 2, 200, 64, 100, 48), (2, 4, 4, 200, 64, 200, 0)]


def _bf16_ulps(got, want):
    diff = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float().abs().clamp_min(_ULP_FLOOR))
    return (diff / torch.ldexp(torch.ones_like(diff), e - 8)).max().item()


@pytest.mark.parametrize("B,H,KV,S,hd,prefix,window", PREFIX_SMOKE)
def test_flash_prefix_hi_lo_stays_in_the_bf16_gate(B, H, KV, S, hd, prefix,
                                                   window):
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(_rand(rng, B, n, S, hd)).bfloat16()
               for n in (H, KV, KV))
    got = ref.flash_attention_tiled_ref(q, k, v, window=window,
                                        prefix_len=prefix,
                                        key_tile=FLASH_KEY_TILE,
                                        p_split=True)
    want = ref.flash_attention_ref(q, k, v, window=window, prefix_len=prefix)
    assert _bf16_ulps(got, want) <= _TOL_ULPS


@pytest.mark.parametrize("B,H,KV,S,hd,prefix,window", PREFIX_SMOKE)
def test_flash_bwd_prefix_hi_lo_stays_in_the_bf16_gate(B, H, KV, S, hd,
                                                       prefix, window):
    rng = np.random.default_rng(S + hd + 1)
    q, do = (torch.from_numpy(_rand(rng, B, H, S, hd)).bfloat16()
             for _ in "qd")
    k, v = (torch.from_numpy(_rand(rng, B, KV, S, hd)).bfloat16()
            for _ in "kv")
    o = ref.flash_attention_ref(q, k, v, window=window, prefix_len=prefix)
    a = (q, k, v, o, do)
    got = ref.flash_attention_bwd_split_ref(*a, window=window,
                                           prefix_len=prefix, p_split=True)
    want = ref.flash_attention_bwd_ref(*a, window=window, prefix_len=prefix)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _bf16_ulps(g, w) <= _TOL_ULPS, name


@pytest.mark.parametrize("prefix", [0, 5, 12])
def test_attention_block_prefix_matches_jax(prefix):
    """The port's attention_block (the flash wrapper, its twin on the CPU)
    against the JAX block (chunked_causal_attention) on paligemma's reduced
    heads (4 over 1, hd 16), with its K / V."""
    jcfg, tcfg = jget("paligemma-3b").reduced(), tget("paligemma-3b").reduced()
    jp = jattn.init_attention(jax.random.PRNGKey(1), jcfg.d_model,
                              jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim,
                              jnp.float32)
    tp = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
    x = _rand(np.random.default_rng(prefix), 2, 12, jcfg.d_model)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want, (jk, jv) = jattn.attention_block(
        jp, jnp.asarray(x), jnp.asarray(pos), jcfg, prefix_len=prefix,
        return_kv=True)
    got, (tk, tv) = tattn.attention_block(
        tp, torch.from_numpy(x), torch.from_numpy(pos.copy()), tcfg,
        prefix_len=prefix, return_kv=True)
    for g, w in ((got, want), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


# ----------------------------------------------------------------------------
# the naive CLI's audio prompts, and what refuses the frontends
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("seed,batch,plen", [(0, 4, 64), (3, 2, 16)])
def test_naive_cli_audio_prompts_are_jaxs(seed, batch, plen):
    """jax.random.randint(PRNGKey(seed + 1), (batch, prompt_len,
    n_codebooks), 0, vocab), as src/repro/launch/serve.py:_run_naive
    draws an audio arch's prompts."""
    cfg = tget("musicgen-medium").reduced()
    args = argparse.Namespace(seed=seed, batch=batch, prompt_len=[plen])
    got = tserve._naive_prompts(args, cfg)
    want = jax.random.randint(jax.random.PRNGKey(seed + 1),
                              (batch, plen, cfg.n_codebooks), 0,
                              cfg.vocab_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_frontends_as_the_jax_engine(arch):
    """Both engines refuse the frontends' archs with one message; so do the
    port's paged lm functions (the JAX engine never reaches its own) and
    the serve CLI's engine mode."""
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    with pytest.raises(NotImplementedError) as jerr:
        JEngine(None, jcfg, num_slots=2)
    with pytest.raises(NotImplementedError) as terr:
        TEngine(None, tcfg, num_slots=2, device="cpu")
    assert str(terr.value) == str(jerr.value)
    tok = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="text LMs only"):
        tlm.decode_step_paged({}, tcfg, {}, tok, tok, tok[:, None])
    with pytest.raises(NotImplementedError, match="text LMs only"):
        tlm.prefill_paged({}, tcfg, {}, tok[:, None], tok, tok, tok[:, None],
                          tok)
    with pytest.raises(NotImplementedError) as cli:
        tserve.main(["--arch", arch, "--device", "cpu", "--requests", "1"])
    assert str(cli.value) == str(jerr.value)
