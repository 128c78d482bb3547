"""repro_torch.models.recurrent held to repro.models.recurrent on reduced
widths, float32 unless stated. RG-LRU (recurrentgemma-2b): the gates, the
causal conv with carried state and `lengths`, the whole block with and
without `lengths` and a carried state (1e-5), and decode at S = 1 repeated
against the sequence form. RWKV6 (rwkv6-3b): the rwkv6_scan twin against
the JAX oracle and the Pallas kernel (interpret mode), the time mix and
the channel mix with `lengths` and a carried state (1e-5), decode at S = 1
against the sequence form, and one bf16 test of where each cast lands.
Params come from the JAX initialisers and reach both packages as numpy
arrays."""
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
from repro.kernels.rwkv6_scan import rwkv6_scan as jrwkv6_scan  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rglru_scan, rwkv6_scan  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "recurrentgemma-2b"


def _cfgs():
    return (jconfigs.get_config(ARCH).reduced(),
            tconfigs.get_config(ARCH).reduced())


def _params(seed=0, dtype=jnp.float32):
    jcfg, _ = _cfgs()
    jp = jrec.init_rglru_block(jax.random.PRNGKey(seed), jcfg.d_model,
                               jcfg.rnn_width, jcfg.conv_width, dtype)
    jp = jax.device_get(jp)
    tp = {k: _t(v) for k, v in jp.items()}
    return jp, tp


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_rglru_gates_match_jax(dtype, tol):
    """f32 at 1e-5: the two packages' exp may differ by an ulp of a, and
    sqrt(1 - a^2) magnifies it ~1 / (2 (1 - a)) times for a near 1 (about
    4e-5 relative at a = 0.9995). bf16 (params cast as cast_params casts
    them, log_lambda included): the projections round to bf16 in both
    packages at different places, so a and gated_x are held at 1e-2,
    under one bf16 ulp of values <= 2."""
    jdt = jnp.dtype(dtype)
    jp, _ = _params(1)
    jp = {k: np.asarray(jnp.asarray(v).astype(jdt)) for k, v in jp.items()}
    tp = {k: _t(v) for k, v in jp.items()}
    x = _x(2, 2, 12, 64)
    ja, jg = jrec._rglru_gates(jp, jnp.asarray(x, jdt))
    ta, tg = trec._rglru_gates(tp, _t(np.asarray(jnp.asarray(x, jdt))))
    assert ta.dtype == tg.dtype == torch.float32
    np.testing.assert_allclose(_np(ta), _np(ja), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(tg), _np(jg), atol=tol, rtol=tol)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("lengths", [None, (9, 3)])
def test_causal_conv1d_matches_jax(with_state, lengths):
    x = _x(3, 2, 9, 64)
    w, b = _x(4, 4, 64), _x(5, 64)
    state = _x(6, 2, 3, 64) if with_state else None
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    jo, js, jxp = jrec._causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if state is None else jnp.asarray(state),
        lengths=None if ln is None else jnp.asarray(ln),
        return_history=True)
    to, ts, txp = trec._causal_conv1d(
        _t(x), _t(w), _t(b), None if state is None else _t(state),
        lengths=None if ln is None else _t(ln), return_history=True)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_array_equal(_np(ts), _np(js))
    np.testing.assert_array_equal(_np(txp), _np(jxp))


@pytest.mark.parametrize("lengths", [None, (12, 5)])
@pytest.mark.parametrize("carry", [False, True])
def test_rglru_block_seq_matches_jax(lengths, carry):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(2)
    x = _x(7, 2, 12, jcfg.d_model)
    state = None
    if carry:
        state = {"h": _x(8, 2, jcfg.rnn_width),
                 "conv": _x(9, 2, jcfg.conv_width - 1, jcfg.rnn_width)}
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    jo, js = jrec.rglru_block_seq(
        jp, jnp.asarray(x), jcfg,
        None if state is None else {k: jnp.asarray(v)
                                    for k, v in state.items()},
        lengths=None if ln is None else jnp.asarray(ln))
    to, ts = trec.rglru_block_seq(
        tp, _t(x), tcfg,
        None if state is None else {k: _t(v) for k, v in state.items()},
        lengths=None if ln is None else _t(ln))
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    assert ts["h"].dtype == torch.float32
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(ts[name]), _np(js[name]), **TOL)


def test_rglru_decode_steps_match_sequence_form():
    """S = 1 repeated from the carried state (the decode path, one
    rglru_scan call per step) equals the sequence form's outputs and
    final state."""
    _, tcfg = _cfgs()
    _, tp = _params(3)
    x = _t(_x(10, 2, 10, tcfg.d_model))
    want, want_st = trec.rglru_block_seq(tp, x, tcfg)
    st, outs = None, []
    for t in range(x.shape[1]):
        o, st = trec.rglru_block_seq(tp, x[:, t:t + 1], tcfg, st)
        outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(want), **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(st[name]), _np(want_st[name]), **TOL)


def test_rglru_block_runs_its_scan_through_the_wrapper(monkeypatch):
    """The block's recurrence is one rglru_scan call (the wrapper that
    launches the CUDA kernel on CUDA tensors), with float32 inputs."""
    _, tcfg = _cfgs()
    _, tp = _params(4)
    calls = []

    def spy(a, x, h0=None):
        calls.append((a.dtype, tuple(a.shape), h0 is not None))
        return rglru_scan(a, x, h0)

    monkeypatch.setattr(trec, "rglru_scan", spy)
    trec.rglru_block_seq(tp, _t(_x(11, 2, 7, tcfg.d_model)), tcfg)
    assert calls == [(torch.float32, (2, 7, tcfg.rnn_width), True)]


def test_unported_recurrent_paths_raise():
    """No recurrent path is left unported: the per-step snapshots run
    (test_*_snapshots_match_jax hold them to the JAX package). What still
    raises is a tensor on a device the scan wrappers have no route for:
    they refuse it rather than fall back to the twin, with and without
    the snapshots. The RWKV6 time mix equals the JAX package's."""
    _, tcfg = _cfgs()
    _, tp = _params(5)
    x = _x(12, 1, 3, tcfg.d_model)
    meta = {k: v.to("meta") for k, v in tp.items()}
    for snaps in (False, True):
        with pytest.raises(ValueError, match="unsupported device"):
            trec.rglru_block_seq(meta, _t(x).to("meta"), tcfg,
                                 return_states=snaps)
    jcfg, tcfg = _rwkv_cfgs()
    jp, tp = _rwkv_params(5)
    x = _x(12, 1, 3, tcfg.d_model)
    meta = {k: v.to("meta") for k, v in tp["tmix"].items()}
    for snaps in (False, True):
        with pytest.raises(ValueError, match="unsupported device"):
            trec.rwkv_seq(meta, _t(x).to("meta"), tcfg, return_states=snaps)
    want, _ = jrec.rwkv_seq(jp["tmix"], jnp.asarray(x), jcfg)
    got, _ = trec.rwkv_seq(tp["tmix"], _t(x), tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# The speculative verify's snapshots: (S+1, B, ...) stacks, index t the
# state after t tokens (0: the input state), against the JAX module's
# return_states=True, with and without `lengths` and a carried state,
# within 1e-5. Entries past a row's length are junk in the JAX package
# (the verify never gathers them) and are compared only up to it.

def _snap_close(got, want, lengths, B):
    """got / want: (S+1, B, ...) stacks; rows compared at t <= length."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    for b in range(B):
        n = got.shape[0] if lengths is None else lengths[b] + 1
        np.testing.assert_allclose(got[:n, b], want[:n, b], **TOL)


@pytest.mark.parametrize("lengths", [None, (8, 3)])
@pytest.mark.parametrize("carry", [False, True])
def test_rglru_snapshots_match_jax(lengths, carry):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(3)
    x = _x(17, 2, 8, jcfg.d_model)
    state = None
    if carry:
        state = {"h": _x(18, 2, jcfg.rnn_width),
                 "conv": _x(19, 2, jcfg.conv_width - 1, jcfg.rnn_width)}
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    jo, js, jsn = jrec.rglru_block_seq(
        jp, jnp.asarray(x), jcfg,
        None if state is None else {k: jnp.asarray(v)
                                    for k, v in state.items()},
        lengths=None if ln is None else jnp.asarray(ln), return_states=True)
    to, ts, tsn = trec.rglru_block_seq(
        tp, _t(x), tcfg,
        None if state is None else {k: _t(v) for k, v in state.items()},
        lengths=None if ln is None else _t(ln), return_states=True)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    assert tsn["h"].dtype == torch.float32
    assert tsn["h"].shape == (9, 2, jcfg.rnn_width)
    assert tsn["conv"].shape == (9, 2, jcfg.conv_width - 1, jcfg.rnn_width)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(ts[name]), _np(js[name]), **TOL)
        _snap_close(tsn[name], jsn[name], lengths, 2)
    # the state at a row's length is the final state
    for b in range(2):
        n = 8 if lengths is None else lengths[b]
        for name in ("h", "conv"):
            torch.testing.assert_close(tsn[name][n, b], ts[name][b],
                                       atol=0, rtol=0)


@pytest.mark.parametrize("lengths", [None, (8, 3)])
@pytest.mark.parametrize("carry", [False, True])
def test_rwkv_snapshots_match_jax(lengths, carry):
    """The time mix's {"shift", "S"} and the channel mix's shift."""
    jcfg, tcfg = _rwkv_cfgs()
    jp, tp = _rwkv_params(3)
    x = _x(21, 2, 8, jcfg.d_model)
    state = _rwkv_state(22, jcfg) if carry else None
    shift = _x(23, 2, jcfg.d_model) if carry else None
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    jl = None if ln is None else jnp.asarray(ln)
    tl = None if ln is None else _t(ln)
    jo, js, jsn = jrec.rwkv_seq(
        jp["tmix"], jnp.asarray(x), jcfg,
        None if state is None else {k: jnp.asarray(v)
                                    for k, v in state.items()},
        lengths=jl, return_states=True)
    to, ts, tsn = trec.rwkv_seq(
        tp["tmix"], _t(x), tcfg,
        None if state is None else {k: _t(v) for k, v in state.items()},
        lengths=tl, return_states=True)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    assert tsn["S"].dtype == torch.float32
    assert tsn["S"].shape == (9, 2, jcfg.n_heads, jcfg.head_dim,
                              jcfg.head_dim)
    for name in ("shift", "S"):
        np.testing.assert_allclose(_np(ts[name]), _np(js[name]), **TOL)
        _snap_close(tsn[name], jsn[name], lengths, 2)
    for b in range(2):
        n = 8 if lengths is None else lengths[b]
        for name in ("shift", "S"):
            torch.testing.assert_close(tsn[name][n, b], ts[name][b],
                                       atol=0, rtol=0)
    jo, js, jsn = jrec.rwkv_channel_mix(
        jp["cmix"], jnp.asarray(x),
        None if shift is None else jnp.asarray(shift), lengths=jl,
        return_states=True)
    to, ts, tsn = trec.rwkv_channel_mix(
        tp["cmix"], _t(x), None if shift is None else _t(shift), lengths=tl,
        return_states=True)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_array_equal(_np(ts), _np(js))
    _snap_close(tsn, jsn, lengths, 2)


def test_rwkv_snapshots_come_from_one_scan_launch(monkeypatch):
    """The S snapshots are the scan's per-step output, one call with
    return_states=True, not a second pass."""
    _, tcfg = _rwkv_cfgs()
    _, tp = _rwkv_params(4)
    calls = []
    real = trec.rwkv6_scan

    def spy(*a, **kw):
        calls.append(kw.get("return_states", False))
        return real(*a, **kw)

    monkeypatch.setattr(trec, "rwkv6_scan", spy)
    trec.rwkv_seq(tp["tmix"], _t(_x(24, 2, 5, tcfg.d_model)), tcfg,
                  return_states=True)
    assert calls == [True]


# ----------------------------------------------------------------------------
# RWKV6 (rwkv6-3b reduced: d_model 64, 4 heads x 16, d_ff 128)
# ----------------------------------------------------------------------------

RW = "rwkv6-3b"


def _rwkv_cfgs():
    return (jconfigs.get_config(RW).reduced(),
            tconfigs.get_config(RW).reduced())


def _rwkv_params(seed=0, dtype=jnp.float32):
    """{"tmix", "cmix"} from the JAX initialisers, as numpy (JAX side) and
    torch (port side) trees."""
    jcfg, _ = _rwkv_cfgs()
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jp = jax.device_get({
        "tmix": jrec.init_rwkv(k1, jcfg.d_model, jcfg.n_heads,
                               jcfg.head_dim, dtype),
        "cmix": jrec.init_rwkv_channel_mix(k2, jcfg.d_model, jcfg.d_ff,
                                           dtype)})
    return jp, {m: {k: _t(v) for k, v in sub.items()}
                for m, sub in jp.items()}


def _scan_inputs(seed, B=2, H=3, T=128, N=16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, N)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, H, T, N)) - 1)).astype(
        np.float32)
    u = (rng.standard_normal((H, N)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_scan_twin_matches_jax(with_s0):
    """The twin against repro.kernels.ref.rwkv6_ref (which takes s0) and,
    from a zero state, against the Pallas kernel in interpret mode over two
    64-step chunks (its state resident across them): y and S_T within
    1e-5."""
    r, k, v, w, u, s0 = _scan_inputs(20 + with_s0)
    s0 = s0 if with_s0 else None
    got, got_s = tref.rwkv6_scan_ref(*(_t(a) for a in (r, k, v, w, u)),
                                     None if s0 is None else _t(s0))
    assert got.dtype == got_s.dtype == torch.float32
    want, want_s = jref.rwkv6_ref(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                  None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got_s), _np(want_s), **TOL)
    if not with_s0:
        want, want_s = jrwkv6_scan(*(jnp.asarray(a)
                                     for a in (r, k, v, w, u)))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        np.testing.assert_allclose(_np(got_s), _np(want_s), **TOL)


def test_rwkv6_scan_twin_chains_through_s0():
    """Two halves, the second from the first's S_T, equal one pass (the
    carried state of decode and resumed prefill)."""
    r, k, v, w, u, s0 = (_t(a) for a in _scan_inputs(22, T=20))
    y, s = tref.rwkv6_scan_ref(r, k, v, w, u, s0)
    y1, s1 = tref.rwkv6_scan_ref(*(a[:, :, :7] for a in (r, k, v, w)), u,
                                 s0)
    y2, s2 = tref.rwkv6_scan_ref(*(a[:, :, 7:] for a in (r, k, v, w)), u,
                                 s1)
    torch.testing.assert_close(torch.cat([y1, y2], 2), y, atol=0, rtol=0)
    torch.testing.assert_close(s2, s, atol=0, rtol=0)


def _rwkv_state(seed, cfg, B=2):
    rng = np.random.default_rng(seed)
    return {"shift": rng.standard_normal((B, cfg.d_model)).astype(np.float32),
            "S": (rng.standard_normal((B, cfg.n_heads, cfg.head_dim,
                                       cfg.head_dim)) * 0.1).astype(
                                           np.float32)}


@pytest.mark.parametrize("lengths", [None, (12, 5)])
@pytest.mark.parametrize("carry", [False, True])
def test_rwkv_seq_matches_jax(lengths, carry):
    jcfg, tcfg = _rwkv_cfgs()
    jp, tp = _rwkv_params(1)
    x = _x(13, 2, 12, jcfg.d_model)
    state = _rwkv_state(14, jcfg) if carry else None
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    jo, js = jrec.rwkv_seq(
        jp["tmix"], jnp.asarray(x), jcfg,
        None if state is None else {k: jnp.asarray(v)
                                    for k, v in state.items()},
        lengths=None if ln is None else jnp.asarray(ln))
    to, ts = trec.rwkv_seq(
        tp["tmix"], _t(x), tcfg,
        None if state is None else {k: _t(v) for k, v in state.items()},
        lengths=None if ln is None else _t(ln))
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    assert ts["S"].dtype == torch.float32
    for name in ("shift", "S"):
        np.testing.assert_allclose(_np(ts[name]), _np(js[name]), **TOL)


@pytest.mark.parametrize("lengths", [None, (12, 5)])
@pytest.mark.parametrize("carry", [False, True])
def test_rwkv_channel_mix_matches_jax(lengths, carry):
    jcfg, _ = _rwkv_cfgs()
    jp, tp = _rwkv_params(2)
    x = _x(15, 2, 12, jcfg.d_model)
    shift = _x(16, 2, jcfg.d_model) if carry else None
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    jo, js = jrec.rwkv_channel_mix(
        jp["cmix"], jnp.asarray(x),
        None if shift is None else jnp.asarray(shift),
        lengths=None if ln is None else jnp.asarray(ln))
    to, ts = trec.rwkv_channel_mix(
        tp["cmix"], _t(x), None if shift is None else _t(shift),
        lengths=None if ln is None else _t(ln))
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_array_equal(_np(ts), _np(js))


def test_rwkv_decode_steps_match_sequence_form():
    """S = 1 repeated from the carried state (the decode path, one
    rwkv6_scan call per step) equals the sequence form's outputs and final
    state."""
    _, tcfg = _rwkv_cfgs()
    _, tp = _rwkv_params(3)
    x = _t(_x(17, 2, 10, tcfg.d_model))
    want, want_st = trec.rwkv_seq(tp["tmix"], x, tcfg)
    H, hd = tcfg.n_heads, tcfg.head_dim
    st = {"shift": torch.zeros(2, tcfg.d_model),
          "S": torch.zeros(2, H, hd, hd)}
    outs = []
    for t in range(x.shape[1]):
        o, st = trec.rwkv_step(tp["tmix"], x[:, t:t + 1], tcfg, st)
        outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(want), **TOL)
    for name in ("shift", "S"):
        np.testing.assert_allclose(_np(st[name]), _np(want_st[name]), **TOL)


def test_rwkv_seq_runs_its_scan_through_the_wrapper(monkeypatch):
    """The time mix's recurrence is one rwkv6_scan call (the wrapper that
    launches the CUDA kernel on CUDA tensors): r / k / v in the activation
    dtype, w, u and the carried state in float32, (B, H, S, hd)."""
    _, tcfg = _rwkv_cfgs()
    _, tp = _rwkv_params(4)
    calls = []

    def spy(r, k, v, w, u, s0=None):
        calls.append((r.dtype, tuple(r.shape), w.dtype, u.dtype, s0.dtype))
        return rwkv6_scan(r, k, v, w, u, s0)

    monkeypatch.setattr(trec, "rwkv6_scan", spy)
    H, hd = tcfg.n_heads, tcfg.head_dim
    for dt in (torch.float32, torch.bfloat16):
        p = {k: v.to(dt) for k, v in tp["tmix"].items()}
        trec.rwkv_seq(p, _t(_x(18, 2, 7, tcfg.d_model)).to(dt), tcfg)
    f32 = torch.float32
    assert calls == [(dt, (2, H, 7, hd), f32, f32, f32)
                     for dt in (f32, torch.bfloat16)]


def _bf16_ulps(got, want, of_scale=False):
    """max |got - want| in bf16 ulps of max(|want|, 2^-8) element by
    element, or with of_scale of the largest |want| (for the end of a chain
    of bf16 roundings, where an element near 0 carries its neighbours'
    absolute error); both float32 numpy."""
    ref = np.abs(want).max() if of_scale else np.abs(want)
    _, e = np.frexp(np.maximum(ref, 2.0 ** -8))
    return float((np.abs(got - want) / np.ldexp(1.0, e - 8)).max())


def test_rwkv_bf16_casts_land_where_jax_puts_them():
    """bf16 params (as cast_params casts them) and activations: every
    intermediate has JAX's dtype (r / k / v / g bf16, w float32, the
    state float32, the group norm back in bf16) and, from the same bf16
    inputs, each stage is within 2 bf16 ulps of JAX's, element by element
    (the float32 decay w within 1e-4 relative: a bf16 sum of its decay
    base and LoRA would be ~5% off);
    the whole time mix and channel mix within 4 bf16 ulps of their largest
    output (an element of the group norm, of g times it or of the relu^2
    can round the other way in each package, and the last matmul sums 64
    such inputs), and the float32 state within 1 bf16 ulp per element."""
    jcfg, tcfg = _rwkv_cfgs()
    jp, _ = _rwkv_params(6)
    # a decay base away from its zero init, so that where d = base + lora
    # is added (float32, not bf16) shows in w
    jp["tmix"]["decay_base"] = _x(23, jcfg.n_heads * jcfg.head_dim)
    bf = jnp.bfloat16
    jp = {m: {k: jnp.asarray(v).astype(bf) for k, v in sub.items()}
          for m, sub in jp.items()}
    tp = {m: {k: _t(np.asarray(v)) for k, v in sub.items()}
          for m, sub in jp.items()}
    x = jnp.asarray(_x(19, 2, 9, jcfg.d_model)).astype(bf)
    xp = jnp.asarray(_x(20, 2, 9, jcfg.d_model)).astype(bf)
    tx, txp = _t(np.asarray(x)), _t(np.asarray(xp))
    H, hd = jcfg.n_heads, jcfg.head_dim
    want = jrec._rwkv_projections(jp["tmix"], x, xp, H, hd)
    got = trec._rwkv_projections(tp["tmix"], tx, txp, H, hd)
    for name, g_, w_ in zip("rkvgw", got, want):
        assert str(g_.dtype).removeprefix("torch.") == w_.dtype.name, name
        if name == "w":      # float32 from a float32 sum: 1e-4 relative
            np.testing.assert_allclose(_np(g_), _np(w_), rtol=1e-4, atol=0)
        else:
            assert _bf16_ulps(_np(g_), _np(w_)) <= 2, name
    y = jnp.asarray(_x(21, 2, 9, H * hd)).astype(bf)
    gn_j = jrec._rwkv_group_norm(y, jp["tmix"]["ln_scale"], H, hd)
    gn_t = trec._rwkv_group_norm(_t(np.asarray(y)), tp["tmix"]["ln_scale"],
                                 H, hd)
    assert gn_t.dtype == torch.bfloat16 and gn_j.dtype == bf
    assert _bf16_ulps(_np(gn_t), _np(gn_j)) <= 2
    state = {k: jnp.asarray(v) for k, v in _rwkv_state(22, jcfg).items()}
    state["shift"] = state["shift"].astype(bf)
    jo, js = jrec.rwkv_seq(jp["tmix"], x, jcfg, state)
    to, ts = trec.rwkv_seq(tp["tmix"], tx, tcfg,
                           {k: _t(np.asarray(v)) for k, v in state.items()})
    assert (to.dtype, ts["shift"].dtype, ts["S"].dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32)
    assert _bf16_ulps(_np(to), _np(jo), of_scale=True) <= 4
    assert _bf16_ulps(_np(ts["S"]), _np(js["S"])) <= 1
    jo, _ = jrec.rwkv_channel_mix(jp["cmix"], x, xp[:, 0])
    to, _ = trec.rwkv_channel_mix(tp["cmix"], tx, txp[:, 0])
    assert to.dtype == torch.bfloat16
    assert _bf16_ulps(_np(to), _np(jo), of_scale=True) <= 4
