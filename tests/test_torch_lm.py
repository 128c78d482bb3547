"""repro_torch.models.lm held to repro.models.lm on the reduced (float32)
configs with converted params: forward logits to 1e-4, the paged prefill /
decode / verify paths (logits and pools on identical block tables), and
greedy generate() tokens over 32 steps; for the recurrent archs
(recurrentgemma-2b, rwkv6-3b) prefill with `lengths`, its states, decoding
on from them, and generate()."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.serve import generate as tgenerate  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _models(arch="smollm-135m", seed=0):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.from_jax(jax.device_get(jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("arch", ["smollm-135m", "codeqwen1.5-7b",
                                  "minitron-4b", "stablelm-3b",
                                  "recurrentgemma-2b", "rwkv6-3b"])
def test_forward_logits_match_jax(arch):
    jcfg, jparams, tcfg, tparams = _models(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24))
    want, _ = jlm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = tlm.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_prefill_logits_and_cache_match_jax():
    jcfg, jparams, tcfg, tparams = _models()
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 20))
    want, jcache = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, tcache = tlm.prefill(tparams, tcfg,
                              {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jcache = convert.from_jax(jax.device_get(jcache), tcfg)
    for s in range(tcfg.n_super):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _np(tcache["blocks"]["p0"][s][name]),
                _np(jcache["blocks"]["p0"][s][name]), **TOL)


def test_prefill_matches_stepwise_decode():
    _, _, tcfg, tparams = _models()
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 12)))
    logits_pf, _ = tlm.prefill(tparams, tcfg, {"tokens": toks})
    state = tlm.init_decode_state(tcfg, 2, 13, device="cpu")
    for pos in range(12):
        logits, state = tlm.decode_step(tparams, tcfg, state, toks[:, pos],
                                        pos)
    np.testing.assert_allclose(_np(logits_pf[:, -1]), _np(logits), **TOL)


def _paged_inputs(cfg):
    """Two real rows (one with a cached prefix) plus a batch-padding row,
    block size 4, disjoint tables."""
    rng = np.random.default_rng(4)
    bs, M, num_blocks = 4, 8, 40
    tables = np.zeros((3, M), np.int32)
    tables[0] = np.arange(1, 9)
    tables[1] = np.arange(9, 17)
    lengths = np.asarray([13, 21, 0], np.int32)
    cached = np.asarray([0, 8, 0], np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lengths]
    Ls = 16
    toks = np.zeros((3, Ls), np.int32)
    for i, p in enumerate(prompts):
        start = min(cached[i], max(lengths[i] - 1, 0))
        toks[i, :len(p) - start] = p[start:]
    slots = np.asarray([0, 1, 3], np.int32)
    return dict(bs=bs, num_blocks=num_blocks, tables=tables, lengths=lengths,
                cached=cached, toks=toks, slots=slots, prompts=prompts)


def _pools(state, cfg):
    """{(layer, name): pool numpy} in the port layout, the null block 0
    dropped (padding writes land there in an unspecified order)."""
    out = {}
    for i, (_, st) in enumerate(tlm._layers(state, cfg)):
        for name in ("k", "v"):
            out[(i, name)] = _np(st[name])[1:]
    return out


def test_paged_prefill_decode_verify_match_jax():
    jcfg, jparams, tcfg, tparams = _models()
    d = _paged_inputs(jcfg)
    jstate = jkv.init_paged_state(jcfg, 4, d["num_blocks"], d["bs"])
    tstate = tkv.init_paged_state(tcfg, 4, d["num_blocks"], d["bs"],
                                  device="cpu")
    # seed row 1's cached prefix (8 tokens) with a first prefill of it
    pre = dict(toks=np.asarray([d["prompts"][1][:8]], np.int32),
               lengths=np.asarray([8], np.int32),
               cached=np.zeros(1, np.int32), tables=d["tables"][1:2],
               slots=np.asarray([1], np.int32))
    steps = [pre, {k: d[k] for k in ("toks", "lengths", "cached", "tables",
                                      "slots")}]
    for s in steps:
        jlast, jstate = jlm.prefill_paged(
            jparams, jcfg, jstate, jnp.asarray(s["toks"]),
            jnp.asarray(s["lengths"]), jnp.asarray(s["cached"]),
            jnp.asarray(s["tables"]), jnp.asarray(s["slots"]))
        tlast, tstate = tlm.prefill_paged(
            tparams, tcfg, tstate, torch.from_numpy(s["toks"]),
            torch.from_numpy(s["lengths"]), torch.from_numpy(s["cached"]),
            torch.from_numpy(s["tables"]), torch.from_numpy(s["slots"]))
        real = s["lengths"] > 0
        np.testing.assert_allclose(_np(tlast)[real], _np(jlast)[real], **TOL)
    jpools = _pools(convert.from_jax(jax.device_get(jstate), tcfg), tcfg)
    for key, pool in _pools(tstate, tcfg).items():
        np.testing.assert_allclose(pool, jpools[key], **TOL)

    # one decode step for both rows, then a 3-token verify chain
    tables = d["tables"][:2]
    tokens = np.asarray([5, 7], np.int32)
    positions = d["lengths"][:2].copy()
    jlog, jstate = jlm.decode_step_paged(
        jparams, jcfg, jstate, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables))
    tlog, tstate = tlm.decode_step_paged(
        tparams, tcfg, tstate, torch.from_numpy(tokens),
        torch.from_numpy(positions), torch.from_numpy(tables))
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    chain = np.asarray([[3, 9, 11, 0], [2, 4, 0, 0]], np.int32)
    counts = np.asarray([3, 2], np.int32)
    vpos = positions + 1
    jv, jstate, _ = jlm.decode_verify_paged(
        jparams, jcfg, jstate, jnp.asarray(chain), jnp.asarray(vpos),
        jnp.asarray(counts), jnp.asarray(tables))
    tv, tstate, snaps = tlm.decode_verify_paged(
        tparams, tcfg, tstate, torch.from_numpy(chain),
        torch.from_numpy(vpos), torch.from_numpy(counts),
        torch.from_numpy(tables))
    for b in range(2):
        np.testing.assert_allclose(_np(tv)[b, :counts[b]],
                                   _np(jv)[b, :counts[b]], **TOL)
    assert tlm.commit_decode_state(tcfg, tstate, snaps, counts) is tstate
    jpools = _pools(convert.from_jax(jax.device_get(jstate), tcfg), tcfg)
    for key, pool in _pools(tstate, tcfg).items():
        np.testing.assert_allclose(pool, jpools[key], **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_tokens_match_jax(seed):
    jcfg, jparams, tcfg, tparams = _models(seed=seed)
    prompts = np.random.default_rng(seed + 10).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    want = np.asarray(jgenerate(jparams, jcfg, jnp.asarray(prompts), 32))
    got = _np(tgenerate(tparams, tcfg, prompts, 32, device="cpu"))
    np.testing.assert_array_equal(got, want)


def test_generate_margins_and_sampling_refusal():
    _, _, tcfg, tparams = _models()
    prompts = np.zeros((1, 4), np.int32)
    toks, margins = tgenerate(tparams, tcfg, prompts, 5, device="cpu",
                              return_margins=True)
    assert toks.shape == margins.shape == (1, 5)
    assert (margins >= 0).all()
    with pytest.raises(NotImplementedError):
        tgenerate(tparams, tcfg, prompts, 5, device="cpu", temperature=0.7)


# ----------------------------------------------------------------------------
# recurrentgemma-2b: RG-LRU layers and local attention (window 16 reduced)
# ----------------------------------------------------------------------------

RG = "recurrentgemma-2b"


def _layer_states(cache, cfg):
    """[(layer index, name, tensor)] over a prefill cache in the port's
    layout: h and conv of RG-LRU layers, K and V of attention layers."""
    out = []
    for i, (kind, st) in enumerate(tlm._layers(cache, cfg)):
        src = st["rec"] if kind == "rec" else st
        for name in ("h", "conv") if kind == "rec" else ("k", "v"):
            out.append((i, name, src[name]))
    return out


def test_recurrentgemma_prefill_logits_and_states_match_jax():
    """Right-padded rows (lengths 40 and 31, both past the window): logits
    at 1e-4; the first layer's h / conv at 1e-5 (the per-block tolerance);
    every layer's states at 1e-4, the model-level tolerance, since the
    packages' one-ulp exp differences (magnified near a = 1 by
    sqrt(1 - a^2)) add up through the residual stream (6.0e-5 at most on
    this input, in the last attn_local layer's V)."""
    jcfg, jparams, tcfg, tparams = _models(RG)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 40))
    lengths = np.asarray([40, 31], np.int32)
    want, jcache = jlm.prefill(jparams, jcfg, {
        "tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths)})
    got, tcache = tlm.prefill(tparams, tcfg, {
        "tokens": torch.from_numpy(toks),
        "lengths": torch.from_numpy(lengths)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jcache = convert.from_jax(jax.device_get(jcache), tcfg)
    pairs = list(zip(_layer_states(tcache, tcfg),
                     _layer_states(jcache, tcfg)))
    assert [(i, n) for (i, n, _), _ in pairs] == [
        (i, n) for _, (i, n, _) in pairs]
    assert {n for (_, n, _), _ in pairs} == {"h", "conv", "k", "v"}
    for (i, name, t), (_, _, j) in pairs:
        tol = dict(atol=1e-5, rtol=1e-5) if i == 0 else TOL
        np.testing.assert_allclose(_np(t), _np(j), err_msg=f"{i} {name}",
                                   **tol)
    assert tcache["prefix"][0]["rec"]["h"].dtype == torch.float32


def test_recurrentgemma_prefill_then_decode_matches_stepwise():
    """decode_state_from_prefill: decoding on from a 24-token prefill (the
    local layers' rolling buffers hold the last 16 positions) equals
    priming the same state token by token."""
    _, _, tcfg, tparams = _models(RG)
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 24)))
    logits_pf, cache = tlm.prefill(tparams, tcfg, {"tokens": toks})
    state = tlm.init_decode_state(tcfg, 2, 30, device="cpu")
    for pos in range(24):
        logits, state = tlm.decode_step(tparams, tcfg, state, toks[:, pos],
                                        pos)
    np.testing.assert_allclose(_np(logits_pf[:, -1]), _np(logits), **TOL)
    from_pf = tlm.decode_state_from_prefill(tcfg, cache, 30)
    nxt = torch.tensor([3, 7])
    for pos in range(24, 28):
        a, from_pf = tlm.decode_step(tparams, tcfg, from_pf, nxt, pos)
        b, state = tlm.decode_step(tparams, tcfg, state, nxt, pos)
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
        nxt = torch.argmax(b, -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recurrentgemma_generate_tokens_match_jax(seed):
    """Greedy generate() over 32 steps from 20-token prompts (past the
    reduced window of 16), token for token."""
    jcfg, jparams, tcfg, tparams = _models(RG, seed=seed)
    prompts = np.random.default_rng(seed + 20).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    want = np.asarray(jgenerate(jparams, jcfg, jnp.asarray(prompts), 32))
    got = _np(tgenerate(tparams, tcfg, prompts, 32, device="cpu"))
    np.testing.assert_array_equal(got, want)


def test_recurrentgemma_paged_paths_raise():
    """The engine (paged) path for rec blocks waits for its slice."""
    _, _, tcfg, tparams = _models(RG)
    with pytest.raises(NotImplementedError, match="hybrid engine"):
        tkv.init_paged_state(tcfg, 2, 8, 4, device="cpu")
    z = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="hybrid engine"):
        tlm.decode_step_paged(tparams, tcfg, {}, z[0], z[0], z)


# ----------------------------------------------------------------------------
# rwkv6-3b: RWKV6 layers (time mix + channel mix), reduced to 2 layers of
# d_model 64, 4 heads x 16
# ----------------------------------------------------------------------------

RW = "rwkv6-3b"


def test_rwkv_prefill_logits_and_states_match_jax():
    """Right-padded rows (lengths 24 and 17): logits at 1e-4, and every
    layer's final time-mix state (shift, float32 S) and channel-mix shift
    at 1e-5, gathered at each row's true length."""
    jcfg, jparams, tcfg, tparams = _models(RW)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 24))
    lengths = np.asarray([24, 17], np.int32)
    want, jcache = jlm.prefill(jparams, jcfg, {
        "tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths)})
    got, tcache = tlm.prefill(tparams, tcfg, {
        "tokens": torch.from_numpy(toks),
        "lengths": torch.from_numpy(lengths)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jcache = convert.from_jax(jax.device_get(jcache), tcfg)
    layers = list(zip(tlm._layers(tcache, tcfg), tlm._layers(jcache, tcfg)))
    assert [k for (k, _), _ in layers] == ["rwkv"] * tcfg.n_layers
    for i, ((_, t), (_, j)) in enumerate(layers):
        assert t["tmix"]["S"].dtype == torch.float32
        for got_t, want_t in ((t["tmix"]["shift"], j["tmix"]["shift"]),
                              (t["tmix"]["S"], j["tmix"]["S"]),
                              (t["cmix"], j["cmix"])):
            np.testing.assert_allclose(_np(got_t), _np(want_t), atol=1e-5,
                                       rtol=1e-5, err_msg=str(i))


def test_rwkv_prefill_then_decode_matches_stepwise():
    """decode_state_from_prefill: decoding on from a 16-token prefill
    equals priming the same state token by token."""
    _, _, tcfg, tparams = _models(RW)
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 16)))
    logits_pf, cache = tlm.prefill(tparams, tcfg, {"tokens": toks})
    state = tlm.init_decode_state(tcfg, 2, 24, device="cpu")
    for pos in range(16):
        logits, state = tlm.decode_step(tparams, tcfg, state, toks[:, pos],
                                        pos)
    np.testing.assert_allclose(_np(logits_pf[:, -1]), _np(logits), **TOL)
    from_pf = tlm.decode_state_from_prefill(tcfg, cache, 24)
    nxt = torch.tensor([3, 7])
    for pos in range(16, 20):
        a, from_pf = tlm.decode_step(tparams, tcfg, from_pf, nxt, pos)
        b, state = tlm.decode_step(tparams, tcfg, state, nxt, pos)
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
        nxt = torch.argmax(b, -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rwkv_generate_tokens_match_jax(seed):
    """Greedy generate() over 32 steps from 12-token prompts, token for
    token."""
    jcfg, jparams, tcfg, tparams = _models(RW, seed=seed)
    prompts = np.random.default_rng(seed + 30).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jgenerate(jparams, jcfg, jnp.asarray(prompts), 32))
    got = _np(tgenerate(tparams, tcfg, prompts, 32, device="cpu"))
    np.testing.assert_array_equal(got, want)


def test_rwkv_paged_paths_raise():
    """The engine (paged) path for rwkv blocks waits for its slice."""
    _, _, tcfg, tparams = _models(RW)
    with pytest.raises(NotImplementedError, match="hybrid engine"):
        tkv.init_paged_state(tcfg, 2, 8, 4, device="cpu")
    z = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="hybrid engine"):
        tlm.decode_step_paged(tparams, tcfg, {}, z[0], z[0], z)
