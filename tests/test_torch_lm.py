"""repro_torch.models.lm held to repro.models.lm on the reduced (float32)
configs with converted params: forward logits to 1e-4, the paged prefill /
decode / verify paths (logits and pools on identical block tables), and
greedy generate() tokens over 32 steps; for the recurrent archs
(recurrentgemma-2b, rwkv6-3b) prefill with `lengths`, its states, decoding
on from them, and generate()."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402

_torch_cpu.share_cores()
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
    """Margins of the greedy path; sampled generate() is no longer refused:
    it draws JAX generate()'s tokens (first token the argmax, then one
    key split a step)."""
    jcfg, jparams, tcfg, tparams = _models()
    prompts = np.zeros((1, 4), np.int32)
    toks, margins = tgenerate(tparams, tcfg, prompts, 5, device="cpu",
                              return_margins=True)
    assert toks.shape == margins.shape == (1, 5)
    assert (margins >= 0).all()
    got = tgenerate(tparams, tcfg, prompts, 5, device="cpu",
                    temperature=0.7, seed=2)
    want = jgenerate(jparams, jcfg, jnp.asarray(prompts), 5,
                     temperature=0.7, seed=2)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert int(got[0, 0]) == int(toks[0, 0])


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


def _quantized_state_matches_jax(arch, kv_dtype):
    """init_paged_state with a quantized kv_dtype: per layer the JAX
    state's leaves, shapes and dtypes (the port's tree is unstacked)."""
    jcfg, _, tcfg, _ = _models(arch)
    tst = tkv.init_paged_state(tcfg, 2, 8, 4, kv_dtype=kv_dtype,
                               device="cpu")
    jst = jkv.init_paged_state(jcfg, 2, 8, 4, kv_dtype=kv_dtype)
    jlayers = list(zip(jcfg.prefix_pattern, jst["prefix"]))
    for s in range(jcfg.n_super):
        for pi, kind in enumerate(jcfg.block_pattern):
            jlayers.append((kind, jax.tree.map(lambda x: x[s],
                                               jst["blocks"][f"p{pi}"])))
    tlayers = list(tlm._layers(tst, tcfg))
    assert [k for k, _ in tlayers] == [k for k, _ in jlayers]
    for (kind, t), (_, j) in zip(tlayers, jlayers):
        tl, jl = dict(_flat(t)), dict(_flat(j))
        assert sorted(tl) == sorted(jl), kind
        for key in tl:
            assert tuple(tl[key].shape) == tuple(jl[key].shape), key
            assert str(tl[key].dtype).split(".")[-1] == str(jl[key].dtype)
        assert ("k_scale" in t) == (kind in tkv.ATTN_KINDS)


def test_recurrentgemma_paged_paths_raise():
    """The engine (paged) path runs rec blocks (test_recurrent_paged_paths
    _match_jax), on quantized pools too: int8 paged state laid out as
    JAX's (scale tables on the attention layers only). The prefix cache
    is refused for a recurrent pattern, whose state is per slot, not per
    block."""
    _, _, tcfg, tparams = _models(RG)
    _quantized_state_matches_jax(RG, "int8")
    from repro_torch.serving.engine import ServingEngine
    with pytest.raises(ValueError, match="prefix caching"):
        ServingEngine(tparams, tcfg, num_slots=2, block_size=4,
                      max_seq_len=32, prefix_cache=True, device="cpu")


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
    """The engine (paged) path runs rwkv blocks (test_recurrent_paged_paths
    _match_jax); an fp8 paged state for this attention-free pattern holds
    no pool at all, as JAX's. The prefix cache is refused for a recurrent
    pattern, whose state is per slot, not per block."""
    _, _, tcfg, tparams = _models(RW)
    _quantized_state_matches_jax(RW, "fp8")
    from repro_torch.serving.engine import ServingEngine
    with pytest.raises(ValueError, match="prefix caching"):
        ServingEngine(tparams, tcfg, num_slots=2, block_size=4,
                      max_seq_len=32, prefix_cache=True, device="cpu")


# ----------------------------------------------------------------------------
# the paged entry points of the serving engine for both recurrent archs:
# slot-indexed recurrent state beside the block pools
# ----------------------------------------------------------------------------

def _flat(tree, path=()):
    """(key path, leaf) of a layer's state, whatever the dicts' key
    order (the JAX trees come back with sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _jsnaps(snaps, cfg):
    """JAX verify snapshots (scanned blocks stacked on n_super, None for
    attention layers) in the port's per-layer layout."""
    def conv(t, s=None):
        if isinstance(t, dict):
            return {k: conv(v, s) for k, v in t.items()}
        a = np.asarray(t)
        return torch.from_numpy(np.array(a if s is None else a[s]))

    return {"prefix": [None if t is None else conv(t)
                       for t in snaps["prefix"]],
            "blocks": {k: [None if t is None else conv(t, s)
                           for s in range(cfg.n_super)]
                       for k, t in snaps["blocks"].items()}}


def _states_close(tstate, jstate, cfg, tol):
    """Every layer of two paged states: recurrent leaves (all slots) at
    `tol`, pools at 1e-4 with the null block (a sink for padding writes)
    dropped."""
    jstate = convert.from_jax(jax.device_get(jstate), cfg)
    for i, ((kind, t), (_, j)) in enumerate(zip(tlm._layers(tstate, cfg),
                                                tlm._layers(jstate, cfg))):
        jl = dict(_flat(j))
        for path, leaf in _flat(t):
            want = _np(jl[path])
            got = _np(leaf)
            if kind in tkv.ATTN_KINDS:
                got, want, k = got[1:], want[1:], TOL
            else:
                k = tol
            np.testing.assert_allclose(got, want, err_msg=f"{i} {path}",
                                       **k)


@pytest.mark.parametrize("arch", [RG, RW])
def test_recurrent_paged_paths_match_jax(arch):
    """prefill_paged (fresh, with a padding row whose slot drops, and a
    20-token prompt in two chunks, the second with resume=True),
    decode_step_paged, decode_verify_paged and commit_decode_state at
    index 0, 1 and each lane's chain length, against the JAX package on
    the same converted params: logits within 1e-4, rwkv states within
    1e-5, recurrentgemma's within 1e-4 (the deviation the dense prefill
    test records), pools within 1e-4; the snapshots too, up to each lane's
    chain length."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    tol = dict(atol=1e-5, rtol=1e-5) if arch == RW else TOL
    rng = np.random.default_rng(50)
    S, bs, M, nb = 4, 4, 8, 40
    tables = np.zeros((S, M), np.int32)
    tables[0], tables[1], tables[2] = (np.arange(1, 9), np.arange(9, 17),
                                       np.arange(17, 25))
    jstate = jkv.init_paged_state(jcfg, S, nb, bs)
    tstate = tkv.init_paged_state(tcfg, S, nb, bs, device="cpu")
    long = rng.integers(0, jcfg.vocab_size, 20).astype(np.int32)

    def prefill(toks, lengths, cached, rows, slots, resume=False):
        nonlocal jstate
        args = [np.asarray(a, np.int32) for a in
                (toks, lengths, cached, tables[rows], slots)]
        jlast, jstate = jlm.prefill_paged(
            jparams, jcfg, jstate, *(jnp.asarray(a) for a in args),
            resume=resume)
        tlast, _ = tlm.prefill_paged(
            tparams, tcfg, tstate, *(torch.from_numpy(a) for a in args),
            resume=resume)
        real = args[1] > 0
        np.testing.assert_allclose(_np(tlast)[real], _np(jlast)[real], **TOL)
        _states_close(tstate, jstate, tcfg, tol)

    # fresh: slot 0 (13 tokens), slot 2 (9 tokens), a padding row
    p0, p2 = (rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
              for n in (13, 9))
    toks = np.zeros((3, 16), np.int32)
    toks[0, :13], toks[1, :9] = p0, p2
    prefill(toks, [13, 9, 0], [0, 0, 0], [0, 2, 3], [0, 2, S])
    # slot 1's 20-token prompt in two chunks of 8 and 12
    prefill(np.pad(long[:8], (0, 8))[None], [8], [0], [1], [1])
    prefill(np.pad(long[8:], (0, 4))[None], [20], [8], [1], [1],
            resume=True)

    # one decode step of every lane (slot 3 empty: null table, position 0)
    tokens = np.asarray([5, 7, 11, 0], np.int32)
    positions = np.asarray([13, 20, 9, 0], np.int32)
    dargs = [tokens, positions, tables]
    jlog, jstate = jlm.decode_step_paged(jparams, jcfg, jstate,
                                         *(jnp.asarray(a) for a in dargs))
    tlog, _ = tlm.decode_step_paged(tparams, tcfg, tstate,
                                    *(torch.from_numpy(a) for a in dargs))
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    _states_close(tstate, jstate, tcfg, tol)

    # a verify of chains of 3, 2, 4 and 0 tokens
    chain = rng.integers(0, jcfg.vocab_size, (S, 4)).astype(np.int32)
    counts = np.asarray([3, 2, 4, 0], np.int32)
    vargs = [chain, positions + 1, counts, tables]
    jv, jstate, jsn = jlm.decode_verify_paged(
        jparams, jcfg, jstate, *(jnp.asarray(a) for a in vargs))
    tv, _, tsn = tlm.decode_verify_paged(
        tparams, tcfg, tstate, *(torch.from_numpy(a) for a in vargs))
    for b in range(S):
        np.testing.assert_allclose(_np(tv)[b, :counts[b]],
                                   _np(jv)[b, :counts[b]], **TOL)
    _states_close(tstate, jstate, tcfg, tol)   # recurrent state not moved
    jsn_t = _jsnaps(jsn, tcfg)
    for (kind, t), (_, j) in zip(tlm._layers(tsn, tcfg),
                                 tlm._layers(jsn_t, tcfg)):
        assert (t is None) == (kind in tkv.ATTN_KINDS) == (j is None)
        if t is None:
            continue
        jl = dict(_flat(j))
        for path, leaf in _flat(t):
            assert leaf.shape[:2] == (5, S)
            for b in range(S):
                np.testing.assert_allclose(
                    _np(leaf)[:counts[b] + 1, b],
                    _np(jl[path])[:counts[b] + 1, b], err_msg=str(path),
                    **tol)

    for idx in ([0, 0, 0, 0], [1, 1, 1, 0], list(counts)):
        idx = np.asarray(idx, np.int32)
        tcopy = _clone_state(tstate)
        jc = jlm.commit_decode_state(jcfg, jstate, jsn, jnp.asarray(idx))
        tc = tlm.commit_decode_state(tcfg, tcopy, tsn, torch.from_numpy(idx))
        assert tc is tcopy
        _states_close(tc, jc, tcfg, tol)


def _clone_state(tree):
    if isinstance(tree, dict):
        return {k: _clone_state(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_state(v) for v in tree]
    return tree.clone()


@pytest.mark.parametrize("arch", [RG, RW])
def test_decode_step_paged_inactive_lanes_keep_state(arch):
    """active: a lane outside it keeps its recurrent state bit for bit
    (the chunked-prefill lane that sits a decode step out), and the lanes
    in it take exactly the state of a step with every lane active."""
    _, _, tcfg, tparams = _models(arch)
    S, bs, nb = 3, 4, 16
    state = tkv.init_paged_state(tcfg, S, nb, bs, device="cpu")
    g = torch.Generator().manual_seed(3)
    for _, st in tlm._layers(state, tcfg):
        for _, leaf in _flat(st):
            leaf.copy_(torch.randn(leaf.shape, generator=g).to(leaf.dtype)
                       * 0.1)
    tables = torch.zeros(S, 4, dtype=torch.int32)
    tables[0], tables[2] = torch.arange(1, 5), torch.arange(5, 9)
    tokens = torch.tensor([3, 0, 9], dtype=torch.int32)
    positions = torch.tensor([6, 0, 2], dtype=torch.int32)
    before = _clone_state(state)
    everyone = _clone_state(state)
    tlm.decode_step_paged(tparams, tcfg, everyone, tokens, positions, tables)
    active = torch.tensor([True, False, True])
    tlm.decode_step_paged(tparams, tcfg, state, tokens, positions, tables,
                          active=active)
    for (kind, st), (_, b4), (_, ev) in zip(tlm._layers(state, tcfg),
                                            tlm._layers(before, tcfg),
                                            tlm._layers(everyone, tcfg)):
        if kind in tkv.ATTN_KINDS:
            continue
        for (path, got), (_, old), (_, new) in zip(_flat(st), _flat(b4),
                                                   _flat(ev)):
            assert torch.equal(got[1], old[1]), path
            assert torch.equal(got[[0, 2]], new[[0, 2]]), path
            assert not torch.equal(new[1], old[1]), path
