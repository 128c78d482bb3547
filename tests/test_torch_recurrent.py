"""repro_torch.models.recurrent (the RG-LRU half) held to
repro.models.recurrent on reduced recurrentgemma-2b widths, float32 unless
stated: the gates, the causal conv with carried state and `lengths`, the
whole block with and without `lengths` and a carried state (1e-5), and
decode at S = 1 repeated against the sequence form. Params come from the
JAX initialiser and reach both packages as numpy arrays."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import rglru_scan  # noqa: E402
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
    _, tcfg = _cfgs()
    _, tp = _params(5)
    x = _t(_x(12, 1, 3, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="hybrid engine"):
        trec.rglru_block_seq(tp, x, tcfg, return_states=True)
    with pytest.raises(NotImplementedError, match="rwkv6_scan"):
        trec.rwkv_seq({}, x, tcfg)
