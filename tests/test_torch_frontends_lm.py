"""The frontends slice held to the JAX package on the CPU, part 2: the
reduced paligemma-3b (a vision prefix of 8 patches, 4 heads over 1 KV
head) and musicgen-medium (4 codebooks) through every dense `lm` path and
generate() on converted params, and the JAX package's own frontend tests
(tests/test_archs_smoke.py's paligemma / musicgen cases,
tests/test_model_invariants.py's musicgen causality and decode cases and
test_vlm_prefix_sees_image) run on the port.

Tolerances: logits 1e-4 and caches 1e-5 (float32, other summation
orders); train_loss 1e-5 and each gradient leaf 1e-4 of max(1, max |g|)
(test_torch_train.py's standard); greedy tokens equal wherever JAX's top-2
logit margin exceeds 1e-4, generate()'s tokens equal (its margins are far
above the logits' 1e-4). Inputs come from numpy seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _torch_models import reduced_models  # noqa: E402

from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.launch.serve import generate as tgenerate  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim.mbprox import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

ARCHS = ["paligemma-3b", "musicgen-medium"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _batch(cfg, seed, B=2, S=12):
    """numpy inputs: S text tokens (and their targets) and, for vision,
    vision_tokens patch embeddings; (B, S, n_codebooks) for audio."""
    rng = np.random.default_rng(seed)
    tok_shape = (B, S, cfg.n_codebooks) if cfg.frontend == "audio" else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, tok_shape),
             "targets": rng.integers(0, cfg.vocab_size, tok_shape)}
    if cfg.frontend == "vision":
        batch["vision_emb"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ----------------------------------------------------------------------------
# every dense lm path against JAX
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(arch):
    """forward and prefill logits (the text's only for vision; (B, S,
    n_cb, V) for audio) within 1e-4; prefill's K / V caches, which cover
    the vision prefix too, within 1e-5."""
    jcfg, jp, tcfg, tp = reduced_models(arch)
    b = _batch(tcfg, 1)
    want, _ = jlm.forward(jp, jcfg, _j(b))
    got, aux = tlm.forward(tp, tcfg, _t(b))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jlog, jcache = jlm.prefill(jp, jcfg, _j(b))
    tlog, tcache = tlm.prefill(tp, tcfg, _t(b))
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    jcache = convert.from_jax(jax.device_get(jcache), tcfg)
    S_all = b["tokens"].shape[1] + (tcfg.vision_tokens
                                    if tcfg.frontend == "vision" else 0)
    for s in range(tcfg.n_super):
        for name in ("k", "v"):
            got_kv = tcache["blocks"]["p0"][s][name]
            assert got_kv.shape[1] == S_all
            np.testing.assert_allclose(
                _np(got_kv), _np(jcache["blocks"]["p0"][s][name]),
                atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """decode_step from an empty cache, token by token ((B, n_cb) audio
    tokens -> (B, n_cb, V) logits; paligemma decodes text), against JAX's
    jitted decode_step, within 1e-4 at every step."""
    jcfg, jp, tcfg, tp = reduced_models(arch)
    toks = _batch(tcfg, 2, S=6)["tokens"]
    jstate = jlm.init_decode_state(jcfg, 2, 8)
    tstate = tlm.init_decode_state(tcfg, 2, 8, device="cpu")
    step = jax.jit(jlm.decode_step, static_argnums=(1,))
    for pos in range(toks.shape[1]):
        want, jstate = step(jp, jcfg, jstate, jnp.asarray(toks[:, pos]),
                            jnp.int32(pos))
        got, tstate = tlm.decode_step(tp, tcfg, tstate,
                                      torch.from_numpy(toks[:, pos]), pos)
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch):
    """train_loss (vision: the text's targets; audio: (B, S, n_cb)) and
    every gradient leaf, the vision projection and the codebook tables
    included, against jax.value_and_grad; paligemma's gradient runs the
    backward twin's prefix arm."""
    jcfg, jp, tcfg, tp = reduced_models(arch)
    b = _batch(tcfg, 3)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, m: jlm.train_loss(p, jcfg, m), has_aux=True))(jp, _j(b))
    (tl, taux), tg = value_and_grad(
        lambda p, m: tlm.train_loss(p, tcfg, m), tp, _t(b))
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert abs(float(taux["xent"]) - float(jaux["xent"])) <= 1e-5
    jg = convert.from_jax(jax.device_get(jg), tcfg)
    for a, g in zip(tree_leaves(jg), tree_leaves(tg)):
        assert a.shape == g.shape
        tol = 1e-4 * max(1.0, float(a.abs().max()))
        assert float((a - g).abs().max()) <= tol


def test_paligemma_prefill_then_greedy_decode_matches_jax_forward():
    """lm.prefill over 8 patches + 10 text tokens, then 8 greedy
    decode_steps from its cache (positions 18 on): each token is the
    argmax of JAX's lm.forward over the vision prefix + prompt + the tokens
    before it, wherever JAX's top-2 margin there exceeds 1e-4."""
    jcfg, jp, tcfg, tp = reduced_models("paligemma-3b")
    b = _batch(tcfg, 4, S=10)
    n_new, P = 8, 10
    logits, cache = tlm.prefill(tp, tcfg, _t(b))
    state = tlm.decode_state_from_prefill(cfg=tcfg, cache=cache,
                                          max_len=tcfg.vision_tokens + P
                                          + n_new)
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    for i in range(n_new - 1):
        lg, state = tlm.decode_step(tp, tcfg, state, tok,
                                    tcfg.vision_tokens + P + i)
        tok = lg.argmax(-1)
        out.append(tok)
    gen = torch.stack(out, dim=1).numpy()
    full = np.concatenate([b["tokens"], gen], axis=1)
    want, _ = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(full),
                                     "vision_emb": jnp.asarray(
                                         b["vision_emb"])})
    want = np.asarray(want)[:, P - 1:P - 1 + n_new]
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(gen[clear], want.argmax(-1)[clear])


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_musicgen_generate_matches_jax(temperature):
    """generate() on (2, 6, 4) prompts, 6 new tokens a codebook: greedy and
    sampled (one key a step drawing over every codebook, as
    jax.random.categorical does) equal to the JAX generate()'s tokens;
    return_margins gives one margin a codebook."""
    jcfg, jp, tcfg, tp = reduced_models("musicgen-medium")
    prompts = _batch(tcfg, 5, S=6)["tokens"].astype(np.int32)
    want = jgenerate(jp, jcfg, jnp.asarray(prompts), 6,
                     temperature=temperature, seed=3)
    got, margins = tgenerate(tp, tcfg, prompts, 6, temperature=temperature,
                             seed=3, device="cpu", return_margins=True)
    assert got.shape == (2, 6, 4) == margins.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------------
# the JAX package's frontend tests, on the port
# ----------------------------------------------------------------------------

def _port(arch, **over):
    cfg = tget(arch).reduced(**over)
    return cfg, tlm.init_params(0, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """tests/test_archs_smoke.py::test_smoke_train_step: a finite loss,
    finite gradients of every leaf's shape, and a small SGD step that does
    not raise the loss."""
    cfg, params = _port(arch)
    batch = _t(_batch(cfg, 1, S=32 - (cfg.vision_tokens
                                      if cfg.frontend == "vision" else 0)))
    (loss, _), grads = value_and_grad(
        lambda p, m: tlm.train_loss(p, cfg, m), params, batch)
    assert loss.shape == () and torch.isfinite(loss)
    for g, p in zip(tree_leaves(grads), tree_leaves(params)):
        assert g.shape == p.shape and bool(torch.isfinite(g).all())
    stepped = [p - 0.05 * g for p, g in zip(tree_leaves(params),
                                            tree_leaves(grads))]
    loss2, _ = tlm.train_loss(tree_unflatten(params, stepped), cfg, batch)
    assert float(loss2) < float(loss) + 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_shapes(arch):
    """tests/test_archs_smoke.py::test_smoke_prefill_shapes: the text's
    logits for vision, (B, S, n_cb, V) for audio, all finite."""
    cfg, params = _port(arch)
    s_text = 32 - (cfg.vision_tokens if cfg.frontend == "vision" else 0)
    logits, _ = tlm.forward(params, cfg, _t(_batch(cfg, 1, S=s_text)))
    want = ((2, s_text, cfg.n_codebooks, cfg.vocab_size)
            if cfg.frontend == "audio" else (2, s_text, cfg.vocab_size))
    assert logits.shape == want and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_steps(arch):
    """tests/test_archs_smoke.py::test_smoke_decode_steps: three greedy
    decode steps from zeros, finite logits of the frontend's shape."""
    cfg, params = _port(arch)
    state = tlm.init_decode_state(cfg, 2, 64, device="cpu")
    audio = cfg.frontend == "audio"
    tok = torch.zeros((2, cfg.n_codebooks) if audio else (2,),
                      dtype=torch.int32)
    for pos in range(3):
        logits, state = tlm.decode_step(params, cfg, state, tok, pos)
        assert bool(torch.isfinite(logits).all())
        assert logits.shape == ((2, cfg.n_codebooks, cfg.vocab_size)
                                if audio else (2, cfg.vocab_size))
        tok = logits.argmax(-1).to(torch.int32)


def test_causality_musicgen():
    """tests/test_model_invariants.py::test_causality[musicgen-medium]:
    changing future codebook tokens leaves past logits as they were, and
    changes later ones."""
    cfg, params = _port("musicgen-medium")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 24, cfg.n_codebooks))
    toks2 = toks.copy()
    toks2[:, 13:] = rng.integers(0, cfg.vocab_size, (2, 11, cfg.n_codebooks))
    l1, _ = tlm.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    l2, _ = tlm.forward(params, cfg, {"tokens": torch.from_numpy(toks2)})
    np.testing.assert_allclose(_np(l1[:, :13]), _np(l2[:, :13]), **TOL)
    assert float((l1[:, 13:] - l2[:, 13:]).abs().max()) > 1e-4


def test_decode_matches_prefill_musicgen():
    """tests/test_model_invariants.py::
    test_decode_matches_prefill_attention_archs[musicgen-medium]: the
    KV-cache decode reproduces the parallel forward, here within 1e-4."""
    cfg, params = _port("musicgen-medium", capacity_factor=8.0)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8, cfg.n_codebooks)))
    seq, _ = tlm.forward(params, cfg, {"tokens": toks})
    state = tlm.init_decode_state(cfg, 2, 16, device="cpu")
    steps = []
    for pos in range(8):
        lg, state = tlm.decode_step(params, cfg, state, toks[:, pos], pos)
        steps.append(lg)
    np.testing.assert_allclose(_np(seq), _np(torch.stack(steps, 1)), **TOL)


def test_vlm_prefix_sees_image():
    """tests/test_model_invariants.py::test_vlm_prefix_sees_image: the text
    logits depend on the vision prefix, through the flash wrapper's prefix
    arm (its twin here: no launch)."""
    cfg, params = _port("paligemma-3b")
    b = _batch(cfg, 1, S=16)
    rng = np.random.default_rng(3)
    b2 = dict(b, vision_emb=rng.standard_normal(
        b["vision_emb"].shape).astype(np.float32))
    before = flash_attention.launches
    l1, _ = tlm.forward(params, cfg, _t(b))
    l2, _ = tlm.forward(params, cfg, _t(b2))
    assert flash_attention.launches == before
    assert float((l1 - l2).abs().max()) > 1e-4
