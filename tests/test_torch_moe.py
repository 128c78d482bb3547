"""repro_torch.models.moe and the MoE arm of repro_torch.models.lm held to
the JAX package on the CPU, on the reduced grok-1-314b (4 experts, top-2,
GeGLU experts, which the reference runs with silu) and the reduced
llama4-maverick-400b-a17b with 16 experts (top-1, SwiGLU, MoE on every
second layer), float32, converted params.

Tolerances: init_moe within 2 float32 ulps (prng.normal's erf_inv);
routing slots and routed fractions equal, gates within 1e-6, on inputs
whose top-(k+1) router probabilities are apart by more than 1e-6 (no
near-tie a last-place difference could flip); moe_block's output within
1e-5, its aux and z-loss within 1e-6; lm logits within 1e-4; train_loss
within 1e-5 and every gradient leaf within 1e-5 of max(1, max|g|)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.data.synthetic import TokenStream as TStream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim.mbprox import value_and_grad  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

import _torch_models  # noqa: E402

GROK, LLAMA = "grok-1-314b", "llama4-maverick-400b-a17b"
# reduced grok as .reduced() has it; reduced llama4 with 16 experts
ARCHS = [(GROK, {}), (LLAMA, {"n_experts": 16})]
IDS = ["grok-1-314b", "llama4-16e"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _models(arch, over):
    return _torch_models.reduced_models(arch, **over)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _moe_layer(cfg, params, jax_layout=False):
    """The first MoE layer's params of a (port or JAX) tree."""
    pi = cfg.block_pattern.index("moe")
    blk = params["blocks"][f"p{pi}"]
    if jax_layout:
        return jax.tree.map(lambda a: a[0], blk["moe"])
    return blk[0]["moe"]


def _ulps(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(g - w) / np.spacing(np.abs(w))).max())


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("kind,E", [("geglu", 4), ("gelu", 8)])
def test_init_moe_is_jaxs(kind, E):
    """init_moe(key) draws JAX's weights: split(key, 4) = (router, gate,
    up, down), each stack normal * scale in float32, then cast."""
    got = tmoe.init_moe(prng.PRNGKey(3), 64, 128, E, torch.float32, kind)
    want = jmoe.init_moe(jax.random.PRNGKey(3), 64, 128, E, jnp.float32,
                         kind)
    assert set(got) == set(want) == ({"router", "w_up", "w_down"}
                                     | ({"w_gate"} if kind != "gelu"
                                        else set()))
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert _ulps(_np(got[name]), w) <= 2, name


def test_init_moe_bf16_casts_after_the_scale():
    """A bf16 stack is the float32 product rounded once: within one bf16
    ulp of JAX's (the float32 values differ by at most 2 ulps)."""
    got = tmoe.init_moe(prng.PRNGKey(5), 64, 128, 4, torch.bfloat16, "geglu")
    want = jmoe.init_moe(jax.random.PRNGKey(5), 64, 128, 4, jnp.bfloat16,
                         "geglu")
    assert got["router"].dtype == torch.float32
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[name].float().numpy()
        step = np.spacing(np.abs(w).astype(np.float32)) * 2 ** 16
        assert (np.abs(g - w) <= step).all(), name


@pytest.mark.parametrize("arch,over", ARCHS, ids=IDS)
def test_lm_init_params_is_jaxs(arch, over):
    """lm.init_params(seed) for the MoE archs within 3 float32 ulps of
    JAX's init_params(PRNGKey(seed)), tree structure equal."""
    jcfg, jp, tcfg, _ = _models(arch, over)
    got = convert.to_jax(tlm.init_params(0, tcfg, device="cpu"), tcfg)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jp))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(jp)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert _ulps(g, w) <= 3, path


# ----------------------------------------------------------------------------
# routing
# ----------------------------------------------------------------------------

def _probs(seed, G, N, E, k):
    """Softmax of seeded logits, (G, N, E) float32, tie-free: each row's
    top k + 1 probabilities are apart by more than 1e-6."""
    logits = np.random.default_rng(seed).standard_normal(
        (G, N, E)).astype(np.float32) * 2
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top = -np.sort(-p, axis=-1)[..., :k + 1]
    assert (top[..., :-1] - top[..., 1:]).min() > 1e-6
    return p


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 5), (2, 40)])
def test_route_topk_matches_jax(k, capacity):
    """Slots (overflow included) and routed fractions equal, gates within
    1e-6, per group against JAX's _route_topk and for three groups in one
    call; a small capacity overflows, a large one does not."""
    G, N, E = 3, 24, 4
    p = _probs(k * 10 + capacity, G, N, E, k)
    slots, gates, routed = tmoe._route_topk(torch.tensor(p), k, capacity)
    assert slots.shape == (G, k, N) and routed.shape == (G, E)
    for g in range(G):
        js, jg, jr = jmoe._route_topk(jnp.asarray(p[g]), k, capacity)
        np.testing.assert_array_equal(_np(slots[g]), np.asarray(js))
        np.testing.assert_array_equal(_np(routed[g]), np.asarray(jr))
        np.testing.assert_allclose(_np(gates[g]), np.asarray(jg), atol=1e-6,
                                   rtol=0)
    overflow = (slots == E * capacity)
    assert bool(overflow.any()) == (capacity * E < N * k)
    assert bool((gates[overflow] == 0).all())


def test_route_topk_is_causal():
    """A token's slots and gates depend only on the tokens before it: the
    first m tokens routed alone get the slots they get among all N (with
    the same capacity), for every m."""
    p = torch.tensor(_probs(7, 2, 20, 4, 2))
    slots, gates, _ = tmoe._route_topk(p, 2, 4)
    assert bool((slots == 4 * 4).any())
    for m in range(1, 21):
        s_m, g_m, _ = tmoe._route_topk(p[:, :m], 2, 4)
        assert torch.equal(s_m, slots[..., :m])
        assert torch.equal(g_m, gates[..., :m])


def test_route_topk_ties_take_the_first_expert():
    """Exact ties (a uniform row; two experts tied for first or second)
    route as JAX's argmax does: to the lowest expert index."""
    p = np.full((6, 4), 0.25, np.float32)
    p[1] = [0.1, 0.4, 0.4, 0.1]
    p[2] = [0.5, 0.1, 0.2, 0.2]
    p[3] = [0.2, 0.2, 0.2, 0.4]
    for k, cap in ((1, 6), (2, 6), (2, 2)):
        slots, gates, routed = tmoe._route_topk(torch.from_numpy(p), k, cap)
        js, jg, jr = jmoe._route_topk(jnp.asarray(p), k, cap)
        np.testing.assert_array_equal(_np(slots), np.asarray(js))
        np.testing.assert_array_equal(_np(gates), np.asarray(jg))
        np.testing.assert_array_equal(_np(routed), np.asarray(jr))


# ----------------------------------------------------------------------------
# moe_block
# ----------------------------------------------------------------------------

def _jax_drops(jlayer, x, cfg, n_valid):
    """(assigned, dropped) token-expert assignments of the real tokens,
    from JAX's own routing of x chunk by chunk."""
    B, S, _ = x.shape
    chunk = min(cfg.moe_chunk, S)
    n_chunks = -(-S // chunk)
    E, k = cfg.n_experts, cfg.experts_per_token
    cap = max(1, int(chunk * k * cfg.capacity_factor / E))
    xp = np.pad(x, ((0, 0), (0, n_chunks * chunk - S), (0, 0)))
    valid = np.arange(n_chunks * chunk)[None, :] < np.asarray(n_valid)[:, None]
    assigned = dropped = 0
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        probs = jax.nn.softmax(jnp.asarray(xp[:, sl]) @ jlayer["router"], -1)
        slots, _, _ = jax.vmap(jmoe._route_topk, in_axes=(0, None, None))(
            probs, k, cap)
        v = np.broadcast_to(valid[:, None, sl], slots.shape)
        assigned += int(v.sum())
        dropped += int(((np.asarray(slots) == E * cap) & v).sum())
    return assigned, dropped


@pytest.mark.parametrize("S", [16, 24])
@pytest.mark.parametrize("arch,over", ARCHS, ids=IDS)
def test_moe_block_matches_jax(arch, over, S):
    """The first MoE layer on seeded x (B = 3): output within 1e-5, aux and
    z-loss within 1e-6, at S a multiple of moe_chunk (16) and not a
    multiple (two chunks, the tail zero-padded). grok's GeGLU
    experts run silu, as the reference runs them. moe.tally() counts the
    assignments and drops of the real tokens (row 2 holds 3 of them) as
    JAX's routing gives them."""
    jcfg, jp, tcfg, tp = _models(arch, over)
    x = np.random.default_rng(S).standard_normal((3, S, tcfg.d_model)) \
        .astype(np.float32)
    jl = _moe_layer(jcfg, jp, jax_layout=True)
    want, jaux = jmoe.moe_block(jl, jnp.asarray(x), jcfg,
                                kind=jcfg.mlp_kind)
    n_valid = torch.tensor([S, S, 3])
    with tmoe.tally() as t:
        got, taux = tmoe.moe_block(_moe_layer(tcfg, tp), torch.from_numpy(x),
                                   tcfg, kind=tcfg.mlp_kind, n_valid=n_valid)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=0)
    for name in ("moe_aux", "moe_zloss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   atol=1e-6, rtol=1e-6)
    assigned, dropped = t.read()
    assert (assigned, dropped) == _jax_drops(jl, x, jcfg, n_valid.numpy())
    assert assigned == (2 * S + 3) * tcfg.experts_per_token
    if arch == GROK and S == 24:
        assert dropped > 0          # the reduced grok overflows here


def test_moe_block_tally_is_off_by_default():
    """Without an active tally nothing is counted, and a tally ends with
    its `with` block."""
    jcfg, jp, tcfg, tp = _models(GROK, {})
    x = torch.ones(1, 4, tcfg.d_model)
    assert tmoe._TALLY is None
    with tmoe.tally() as t:
        tmoe.moe_block(_moe_layer(tcfg, tp), x, tcfg)
    tmoe.moe_block(_moe_layer(tcfg, tp), x, tcfg)
    assert tmoe._TALLY is None and t.read()[0] == 4 * 2


def test_tally_margins_are_each_rows_smallest_routing_gap():
    """tally(margins=True) keeps, per call (a chunk), each row's smallest
    k-th minus (k+1)-th router probability over its valid tokens, +inf
    for a row with none: here S = 20 in chunks of 16 (the second padded),
    rows with 20, 5 and 0 valid tokens."""
    _, _, tcfg, tp = _models(GROK, {})
    layer = _moe_layer(tcfg, tp)
    x = torch.randn(3, 20, tcfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    with tmoe.tally(margins=True) as t:
        tmoe.moe_block(layer, x, tcfg, n_valid=torch.tensor([20, 5, 0]))
    top = torch.softmax(x @ layer["router"], -1).topk(3, dim=-1).values
    gap = top[..., 1] - top[..., 2]                 # k = 2
    inf = float("inf")
    want = [[float(gap[0, :16].min()), float(gap[1, :5].min()), inf],
            [float(gap[0, 16:].min()), inf, inf]]
    assert len(t.row_margins) == 2
    for got, w in zip(t.row_margins, want):
        np.testing.assert_allclose(_np(got), w, rtol=1e-6)


# ----------------------------------------------------------------------------
# lm: forward, prefill / decode, the paged paths, training
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", ARCHS, ids=IDS)
def test_forward_logits_and_aux_match_jax(arch, over):
    jcfg, jp, tcfg, tp = _models(arch, over)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24))
    want, jaux = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, taux = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for name in ("moe_aux", "moe_zloss"):
        assert float(taux[name]) > 0
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("arch,over", ARCHS, ids=IDS)
def test_forward_is_causal(arch, over):
    """Changing the tokens from position 13 on (inside the first 16-token
    MoE chunk) leaves the logits before it unchanged (the slot assignment
    is causal), and changes those after it."""
    _, _, tcfg, tp = _models(arch, over)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 24)))
    toks2 = toks.clone()
    toks2[:, 13:] = torch.from_numpy(rng.integers(0, tcfg.vocab_size,
                                                  (2, 11)))
    l1, _ = tlm.forward(tp, tcfg, {"tokens": toks})
    l2, _ = tlm.forward(tp, tcfg, {"tokens": toks2})
    np.testing.assert_allclose(_np(l1[:, :13]), _np(l2[:, :13]), atol=1e-5,
                               rtol=0)
    assert float((l1[:, 13:] - l2[:, 13:]).abs().max()) > 1e-4


@pytest.mark.parametrize("arch,over", ARCHS, ids=IDS)
def test_prefill_and_decode_step_match_jax(arch, over):
    """prefill's logits and K/V cache, then 4 decode_steps from
    decode_state_from_prefill against JAX's decode_step from the same state
    built from JAX's prefill cache (the prefill routes its 20 tokens with
    capacity at 20 and may drop some; each decode routes one token alone,
    capacity 1)."""
    jcfg, jp, tcfg, tp = _models(arch, over)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 20))
    want, jcache = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, tcache = tlm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jc = convert.from_jax(jax.device_get(jcache), tcfg)
    for (_, t), (_, j) in zip(tlm._layers(tcache, tcfg),
                              tlm._layers(jc, tcfg)):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(t[name]), _np(j[name]), **TOL)
    jstate = jax.tree.map(jnp.asarray, convert.to_jax(
        tlm.decode_state_from_prefill(tcfg, jc, 25), tcfg))
    tstate = tlm.decode_state_from_prefill(tcfg, tcache, 25)
    for i, tok in enumerate(rng.integers(0, jcfg.vocab_size, (4, 2))):
        jlog, jstate = jlm.decode_step(jp, jcfg, jstate, jnp.asarray(tok),
                                       jnp.int32(20 + i))
        tlog, tstate = tlm.decode_step(tp, tcfg, tstate,
                                       torch.from_numpy(tok), 20 + i)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)


def _pools(state, cfg):
    """{(layer, name): pool numpy}, the null block 0 dropped (padding
    writes land there in an unspecified order)."""
    return {(i, name): _np(st[name])[1:]
            for i, (_, st) in enumerate(tlm._layers(state, cfg))
            for name in ("k", "v")}


@pytest.mark.parametrize("arch,over", ARCHS, ids=IDS)
def test_paged_paths_match_jax(arch, over):
    """prefill_paged (a first prefill of row 1's 8-token prefix, then a
    bucket of 16 with a fresh 13-token row, row 1's 13-token suffix after
    its cached prefix and a batch-padding row), decode_step_paged and a
    verify of 3- and 2-token chains, against JAX on identical block
    tables: logits within 1e-4, pools within 1e-4. The bucket's MoE
    routes each row's 16 positions with capacity at 16, so reduced grok
    drops assignments there (counted by moe.tally)."""
    jcfg, jp, tcfg, tp = _models(arch, over)
    rng = np.random.default_rng(4)
    bs, M, nb = 4, 8, 40
    tables = np.zeros((3, M), np.int32)
    tables[0], tables[1] = np.arange(1, 9), np.arange(9, 17)
    lengths = np.asarray([13, 21, 0], np.int32)
    cached = np.asarray([0, 8, 0], np.int32)
    prompts = [rng.integers(0, jcfg.vocab_size, int(n)) for n in lengths]
    toks = np.zeros((3, 16), np.int32)
    for i, p in enumerate(prompts):
        start = min(cached[i], max(lengths[i] - 1, 0))
        toks[i, :len(p) - start] = p[start:]
    jstate = jkv.init_paged_state(jcfg, 4, nb, bs)
    tstate = tkv.init_paged_state(tcfg, 4, nb, bs, device="cpu")
    steps = [(np.asarray([prompts[1][:8]], np.int32), [8], [0],
              tables[1:2], [1]),
             (toks, lengths, cached, tables, [0, 1, 3])]
    with tmoe.tally() as t:
        for s in steps:
            args = [np.asarray(a, np.int32) for a in s]
            jlast, jstate = jlm.prefill_paged(
                jp, jcfg, jstate, *(jnp.asarray(a) for a in args))
            tlast, tstate = tlm.prefill_paged(
                tp, tcfg, tstate, *(torch.from_numpy(a) for a in args))
            real = args[1] > 0
            np.testing.assert_allclose(_np(tlast)[real], _np(jlast)[real],
                                       **TOL)
    n_moe = tlm.layer_kinds(tcfg).count("moe")
    assigned, dropped = t.read()
    assert assigned == n_moe * tcfg.experts_per_token * (8 + 13 + 13)
    if arch == GROK:
        assert dropped > 0
    jpools = _pools(convert.from_jax(jax.device_get(jstate), tcfg), tcfg)
    for key, pool in _pools(tstate, tcfg).items():
        np.testing.assert_allclose(pool, jpools[key], **TOL)

    tables = tables[:2]
    tokens = np.asarray([5, 7], np.int32)
    positions = lengths[:2].copy()
    jlog, jstate = jlm.decode_step_paged(
        jp, jcfg, jstate, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables))
    tlog, tstate = tlm.decode_step_paged(
        tp, tcfg, tstate, torch.from_numpy(tokens),
        torch.from_numpy(positions), torch.from_numpy(tables))
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    chain = np.asarray([[3, 9, 11, 0], [2, 4, 0, 0]], np.int32)
    counts = np.asarray([3, 2], np.int32)
    vargs = (chain, positions + 1, counts, tables)
    jv, jstate, _ = jlm.decode_verify_paged(
        jp, jcfg, jstate, *(jnp.asarray(a) for a in vargs))
    tv, tstate, snaps = tlm.decode_verify_paged(
        tp, tcfg, tstate, *(torch.from_numpy(a) for a in vargs))
    for b in range(2):
        np.testing.assert_allclose(_np(tv)[b, :counts[b]],
                                   _np(jv)[b, :counts[b]], **TOL)
    assert all(s is None for _, s in tlm._layers(snaps, tcfg))
    jpools = _pools(convert.from_jax(jax.device_get(jstate), tcfg), tcfg)
    for key, pool in _pools(tstate, tcfg).items():
        np.testing.assert_allclose(pool, jpools[key], **TOL)


@pytest.mark.parametrize("arch,over", ARCHS, ids=IDS)
def test_train_loss_and_grads_match_jax(arch, over):
    """train_loss = xent + 0.01 moe_aux + 1e-4 moe_zloss, nonzero MoE
    terms, each within 1e-5 of jax.value_and_grad's; every gradient leaf
    (the router and the expert stacks included) within 1e-5 of max(1,
    max|g|); remat on and off give the same gradients."""
    jcfg, jp, tcfg, tp = _models(arch, over)
    toks, targets = TStream(tcfg.vocab_size, 24).batch(prng.PRNGKey(3), 4)
    micro = {"tokens": toks, "targets": targets}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.train_loss(p, jcfg, b), has_aux=True))(
            jp, {k: jnp.asarray(_np(v)) for k, v in micro.items()})
    outs = [value_and_grad(lambda p, m: tlm.train_loss(p, tcfg, m,
                                                       remat=r), tp, micro)
            for r in (True, False)]
    (tl, taux), tg = outs[0]
    assert abs(float(tl) - float(jl)) <= 1e-5
    for name in ("xent", "moe_aux", "moe_zloss"):
        assert abs(float(taux[name]) - float(jaux[name])) <= 1e-5, name
    assert float(taux["moe_aux"]) > 0 and float(taux["moe_zloss"]) > 0
    want = float(taux["xent"] + 0.01 * taux["moe_aux"]
                 + 1e-4 * taux["moe_zloss"])
    assert abs(float(tl) - want) <= 1e-6
    jg = convert.from_jax(jax.device_get(jg), tcfg)
    errs = []
    tree_map(lambda a, b: errs.append(
        float((a - b).abs().max()) / max(1.0, float(b.abs().max()))), tg, jg)
    assert max(errs) <= 1e-5
    assert float(tg["blocks"][f"p{tcfg.block_pattern.index('moe')}"][0]
                 ["moe"]["router"].abs().max()) > 0
    tree_map(lambda a, b: np.testing.assert_array_equal(_np(a), _np(b)),
             tg, outs[1][1])


def test_train_steps_and_cli_log_the_moe_terms(capsys):
    """The AdamW step's metrics carry xent and the MoE terms averaged over
    its microbatches (each from train_loss at the step's params); the
    MBProx step's carry them too; the train CLI prints them each logged
    step for an MoE arch."""
    _, _, tcfg, tp = _models(GROK, {})
    batch = ttrain.make_batch(tcfg, TStream(tcfg.vocab_size, 16),
                              prng.PRNGKey(1), 4, 2)
    step, opt = tsteps.make_baseline_train_step(tcfg)
    _, _, m = step(tp, opt.init(tp), batch, 1e-3)
    with torch.no_grad():
        want = [tlm.train_loss(tp, tcfg, {k: v[i] for k, v in batch.items()})
                for i in range(2)]
    for name in ("xent", "moe_aux", "moe_zloss"):
        mean = np.mean([float(w[1][name]) for w in want])
        assert abs(float(m[name]) - mean) <= 1e-5, name
    assert abs(float(m["loss"]) - np.mean([float(w[0]) for w in want])) \
        <= 1e-5
    step, inner, _ = tsteps.make_mbprox_train_step(tcfg)
    _, _, m = step(tp, inner.init(tp), batch, 1e-3)
    assert float(m["moe_aux"]) > 0 and float(m["moe_zloss"]) > 0
    ttrain.main(["--arch", GROK, "--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert out.count("moe_aux") == 2 and out.count("moe_zloss") == 2
