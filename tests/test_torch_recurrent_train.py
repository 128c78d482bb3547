"""The recurrent scans' gradients on the port, held to the JAX package on
the CPU, float32: the backward twins (ref.rglru_scan_bwd_ref,
ref.rwkv6_scan_bwd_ref) against jax.vjp of the JAX oracles
(repro.kernels.ref.rglru_ref / rwkv6_ref) with and without a carried
state and with a nonzero gradient of the final state; each scan's
autograd Function on the CPU against its twin; the two mixers'
gradients (rglru_block_seq, rwkv_seq) against jax.vjp of the JAX
modules'. Tolerance: 1e-5 of max(1, max |g|) (both sum in float32, in
other orders). The whole models' gradients and training steps:
tests/test_torch_recurrent_train_lm.py and _steps.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ref, rglru_scan, rwkv6_scan  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, (what, err, tol)


def _t(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


# ----------------------------------------------------------------------------
# the backward twins against jax.vjp of the JAX oracles
# ----------------------------------------------------------------------------

def _rglru_case(seed, B=2, T=37, C=24, with_h0=True):
    a = 1 / (1 + np.exp(-_x(seed, B, T, C) * 2)).astype(np.float32)
    x = _x(seed + 1, B, T, C, scale=0.3)
    h0 = _x(seed + 2, B, C) if with_h0 else None
    dh = _x(seed + 3, B, T, C)
    return a, x, h0, dh


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_dh_T", [False, True])
def test_rglru_scan_bwd_ref_matches_jax_vjp(with_h0, with_dh_T):
    a, x, h0, dh = _rglru_case(1, with_h0=with_h0)
    dh_T = _x(9, *h0.shape if h0 is not None else (2, 24)) \
        if with_dh_T else None
    prim = (a, x) + ((h0,) if with_h0 else ())
    (hs, hT), vjp = jax.vjp(lambda *p: jref.rglru_ref(*p), *map(jnp.asarray,
                                                                prim))
    want = vjp((jnp.asarray(dh), jnp.zeros_like(hT) if dh_T is None
                else jnp.asarray(dh_T)))
    ta, th0, tdh, tdhT = _t(a, h0, dh, dh_T)
    th = torch.from_numpy(np.array(hs))
    got = ref.rglru_scan_bwd_ref(ta, th, th0, tdh, tdhT)
    for g, w, n in zip(got, want, ("da", "dx", "dh0")):
        _close(g, w, n)
    if not with_h0:     # dh0 is still returned: a_0 g_0
        assert got[2].shape == (2, 24)


def test_rglru_scan_bwd_ref_at_no_steps():
    """T = 0: empty da / dx, dh0 = dh_T."""
    a = torch.zeros(2, 0, 5)
    dh_T = torch.from_numpy(_x(3, 2, 5))
    da, dx, dh0 = ref.rglru_scan_bwd_ref(a, a, None, a, dh_T)
    assert da.shape == dx.shape == (2, 0, 5) and torch.equal(dh0, dh_T)


def _rwkv_case(seed, B=2, H=3, T=21, N=8, with_s0=True):
    r, k, v = (_x(seed + i, B, H, T, N, scale=0.5) for i in range(3))
    w = np.exp(-np.exp(_x(seed + 3, B, H, T, N) - 1)).astype(np.float32)
    u = _x(seed + 4, H, N, scale=0.1)
    s0 = _x(seed + 5, B, H, N, N) if with_s0 else None
    dy = _x(seed + 6, B, H, T, N)
    return r, k, v, w, u, s0, dy


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("with_dS_T", [False, True])
def test_rwkv6_scan_bwd_ref_matches_jax_vjp(with_s0, with_dS_T):
    r, k, v, w, u, s0, dy = _rwkv_case(11, with_s0=with_s0)
    dS_T = _x(19, 2, 3, 8, 8) if with_dS_T else None
    prim = (r, k, v, w, u) + ((s0,) if with_s0 else ())
    (y, sT), vjp = jax.vjp(lambda *p: jref.rwkv6_ref(*p),
                           *map(jnp.asarray, prim))
    want = vjp((jnp.asarray(dy), jnp.zeros_like(sT) if dS_T is None
                else jnp.asarray(dS_T)))
    # jax.vjp sums du over the batch too: (H, N)
    got = ref.rwkv6_scan_bwd_ref(*_t(r, k, v, w, u, s0, dy, dS_T))
    for g, wt, n in zip(got, want, ("dr", "dk", "dv", "dw", "du", "ds0")):
        _close(g, wt, n)
    if not with_s0:
        assert got[5].shape == (2, 3, 8, 8)


# ----------------------------------------------------------------------------
# the autograd Functions on the CPU
# ----------------------------------------------------------------------------

def test_rglru_scan_autograd_on_cpu():
    """Under autograd rglru_scan is its Function: the forward's bits are
    the twin's and the gradients are ref.rglru_scan_bwd_ref's on the
    forward's h_seq; under no_grad, or without an input that requires
    grad, it records nothing. An unused h_T adds nothing."""
    a, x, h0, dh = _t(*_rglru_case(5))
    plain = rglru_scan(a, x, h0)
    assert plain[0].grad_fn is None
    assert all(torch.equal(p, q) for p, q in
               zip(plain, ref.rglru_scan_ref(a, x, h0)))
    ag, xg, h0g = (t.clone().requires_grad_() for t in (a, x, h0))
    with torch.no_grad():
        assert rglru_scan(ag, xg, h0g)[0].grad_fn is None
    hs, hT = rglru_scan(ag, xg, h0g)
    assert hs.grad_fn is not None and torch.equal(hs, plain[0])
    dh_T = torch.from_numpy(_x(7, *h0.shape))
    torch.autograd.backward((hs, hT), (dh, dh_T))
    want = ref.rglru_scan_bwd_ref(a, plain[0], h0, dh, dh_T)
    for g, w in zip((ag.grad, xg.grad, h0g.grad), want):
        assert torch.equal(g, w)
    ag.grad = None
    rglru_scan(ag, x, None)[0].backward(dh)
    assert torch.equal(ag.grad, ref.rglru_scan_bwd_ref(
        a, ref.rglru_scan_ref(a, x)[0], None, dh, None)[0])


def test_rwkv6_scan_autograd_on_cpu():
    """Under autograd rwkv6_scan is its Function: the twin's forward bits,
    ref.rwkv6_scan_bwd_ref's gradients (dS_T and s0 included, and an
    unused S_T adding nothing); return_states and no_grad record
    nothing through it."""
    args = _t(*_rwkv_case(3)[:6])
    dy = torch.from_numpy(_rwkv_case(3)[6])
    plain = rwkv6_scan(*args)
    assert plain[0].grad_fn is None
    leaves = tuple(t.clone().requires_grad_() for t in args)
    with torch.no_grad():
        assert rwkv6_scan(*leaves)[0].grad_fn is None
    y, sT = rwkv6_scan(*leaves)
    assert y.grad_fn is not None
    assert torch.equal(y, plain[0]) and torch.equal(sT, plain[1])
    dS_T = torch.from_numpy(_x(4, *sT.shape))
    torch.autograd.backward((y, sT), (dy, dS_T))
    want = ref.rwkv6_scan_bwd_ref(*args, dy, dS_T)
    for g, w in zip((t.grad for t in leaves), want):
        assert torch.equal(g, w)
    for t in leaves:
        t.grad = None
    rwkv6_scan(*leaves[:5])[0].backward(dy)
    want = ref.rwkv6_scan_bwd_ref(*args[:5], None, dy, None)
    for g, w in zip((t.grad for t in leaves[:5]), want):
        assert torch.equal(g, w)
    # the per-step states take the twin's own autograd, not the Function
    out = rwkv6_scan(*leaves, return_states=True)
    assert len(out) == 3 and out[0].grad_fn is not None


# ----------------------------------------------------------------------------
# the mixers' gradients against jax.vjp of the JAX modules
# ----------------------------------------------------------------------------

def _leaves_close(got, want, keys):
    for key in keys:
        _close(got[key], want[key], key)


@pytest.mark.parametrize("carry", [False, True])
def test_rglru_block_seq_grads_match_jax(carry):
    """d out / d (params, x, h0) of the RG-LRU block through rglru_scan's
    Function, against jax.vjp of repro.models.recurrent.rglru_block_seq;
    with a carried state, the gradient of the incoming h too."""
    jcfg = jconfigs.get_config("recurrentgemma-2b").reduced()
    tcfg = tconfigs.get_config("recurrentgemma-2b").reduced()
    jp = jax.device_get(jrec.init_rglru_block(
        jax.random.PRNGKey(2), jcfg.d_model, jcfg.rnn_width,
        jcfg.conv_width, jnp.float32))
    x = _x(21, 2, 9, jcfg.d_model)
    dout = _x(22, 2, 9, jcfg.d_model)
    h0 = _x(23, 2, jcfg.rnn_width) if carry else None

    def jfn(p, x_, h):
        st = None if h is None else {
            "h": h, "conv": jnp.zeros((2, jcfg.conv_width - 1,
                                       jcfg.rnn_width))}
        return jrec.rglru_block_seq(p, x_, jcfg, state=st)[0]

    _, vjp = jax.vjp(jfn, jp, jnp.asarray(x),
                     None if h0 is None else jnp.asarray(h0))
    jg_p, jg_x, jg_h = vjp(jnp.asarray(dout))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    th = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    st = None if th is None else {
        "h": th, "conv": torch.zeros(2, tcfg.conv_width - 1,
                                     tcfg.rnn_width)}
    out, _ = trec.rglru_block_seq(tp, tx, tcfg, state=st)
    out.backward(torch.from_numpy(dout))
    _leaves_close({k: v.grad for k, v in tp.items()}, jg_p, jp.keys())
    _close(tx.grad, jg_x, "x")
    if th is not None:
        _close(th.grad, jg_h, "h0")


@pytest.mark.parametrize("carry", [False, True])
def test_rwkv_seq_grads_match_jax(carry):
    """d out / d (params, x, S) of the RWKV6 time mix through rwkv6_scan's
    Function (the bonus u through bonus_u.float(), the state through
    .contiguous()), against jax.vjp of repro.models.recurrent.rwkv_seq."""
    jcfg = jconfigs.get_config("rwkv6-3b").reduced()
    tcfg = tconfigs.get_config("rwkv6-3b").reduced()
    H, hd = jcfg.n_heads, jcfg.head_dim
    jp = jax.device_get(jrec.init_rwkv(jax.random.PRNGKey(4), jcfg.d_model,
                                       H, hd, jnp.float32))
    # a nonzero bonus and decay, so that their gradients are exercised
    jp["bonus_u"] = _x(30, H, hd, scale=0.3)
    jp["decay_base"] = _x(31, H * hd, scale=0.5)
    x = _x(32, 2, 11, jcfg.d_model)
    dout = _x(33, 2, 11, jcfg.d_model)
    S0 = _x(34, 2, H, hd, hd, scale=0.2) if carry else None

    def jfn(p, x_, S):
        st = None if S is None else {"shift": jnp.zeros((2, jcfg.d_model)),
                                     "S": S}
        return jrec.rwkv_seq(p, x_, jcfg, state=st)[0]

    _, vjp = jax.vjp(jfn, jp, jnp.asarray(x),
                     None if S0 is None else jnp.asarray(S0))
    jg_p, jg_x, jg_S = vjp(jnp.asarray(dout))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tS = None if S0 is None else torch.from_numpy(S0).requires_grad_()
    st = None if tS is None else {"shift": torch.zeros(2, tcfg.d_model),
                                  "S": tS}
    out, _ = trec.rwkv_seq(tp, tx, tcfg, state=st)
    out.backward(torch.from_numpy(dout))
    _leaves_close({k: v.grad for k, v in tp.items()}, jg_p, jp.keys())
    _close(tx.grad, jg_x, "x")
    if tS is not None:
        _close(tS.grad, jg_S, "S")
