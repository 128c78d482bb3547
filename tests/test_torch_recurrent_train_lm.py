"""Training the recurrent archs on the port, held to the JAX package on the
CPU: lm.train_loss and every gradient leaf of the reduced rwkv6-3b (RWKV6
time mix through rwkv6_scan's autograd Function) and recurrentgemma-2b
(RG-LRU through rglru_scan's, its local attention through the flash
kernel's), remat's bits, the JAX package's smoke train step on the port,
and the train CLI's loss drop, the recurrent counterpart of
tests/test_system.py's (tests/test_torch_recurrent_train_steps.py: the
MBProx steps against JAX's).

Tolerances: the loss 1e-5 relative; each gradient leaf 1e-4 of max(1,
max |g|), the tolerance at which the recurrentgemma forward is already
held (ROADMAP deviations)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_models import reduced_models  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.data.synthetic import TokenStream as TStream  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim.mbprox import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ("rwkv6-3b", "recurrentgemma-2b")
# the backward wrapper each arch's scan calls: (its module, its name)
SCANS = {"rwkv6-3b": (importlib.import_module(
    "repro_torch.kernels.rwkv6_scan"), "rwkv6_scan_bwd"),
    "recurrentgemma-2b": (importlib.import_module(
        "repro_torch.kernels.rglru_scan"), "rglru_scan_bwd")}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _grads_close(jg, tg, tcfg):
    jg = convert.from_jax(jax.device_get(jg), tcfg)
    for a, b in zip(tree_leaves(jg), tree_leaves(tg)):
        assert a.shape == b.shape
        tol = 1e-4 * max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch, monkeypatch):
    """train_loss (remat on, as the train steps run it) and every gradient
    leaf against jax.value_and_grad of the JAX train_loss; the backward
    went through the scan's backward wrapper (its twin on the CPU) once a
    recurrent layer."""
    jcfg, jp, tcfg, tp = reduced_models(arch)
    mod, name = SCANS[arch]
    calls = []

    def spy(*a):
        calls.append(a[0].shape)
        return bwd(*a)

    bwd = getattr(mod, name)
    monkeypatch.setattr(mod, name, spy)
    toks, targets = TStream(tcfg.vocab_size, 24).batch(prng.PRNGKey(3), 4)
    micro = {"tokens": toks, "targets": targets}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.train_loss(p, jcfg, b), has_aux=True))(
            jp, {k: jnp.asarray(_np(v)) for k, v in micro.items()})
    (tl, taux), tg = value_and_grad(
        lambda p, m: tlm.train_loss(p, tcfg, m), tp, micro)
    assert len(calls) == sum(k in ("rec", "rwkv")
                             for k in tlm.layer_kinds(tcfg))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(taux["xent"]) - float(jaux["xent"])) \
        <= 1e-5 * abs(float(jaux["xent"]))
    _grads_close(jg, tg, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    """remat recomputes each superblock (the scans' Functions run their
    forward twice): the gradients are the un-rematerialised ones bit for
    bit."""
    *_, tcfg, tp = reduced_models(arch)
    toks, targets = TStream(tcfg.vocab_size, 16).batch(prng.PRNGKey(4), 2)
    micro = {"tokens": toks, "targets": targets}
    outs = [value_and_grad(lambda p, m: tlm.train_loss(p, tcfg, m,
                                                       remat=r), tp, micro)
            for r in (True, False)]
    assert torch.equal(outs[0][0][0], outs[1][0][0])
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """tests/test_archs_smoke.py::test_smoke_train_step on the port: a
    finite loss, finite gradients of every param's shape, and one SGD step
    of 0.05 that does not raise the loss on the same batch."""
    *_, tcfg, tp = reduced_models(arch)
    toks, targets = TStream(tcfg.vocab_size, 32).batch(prng.PRNGKey(1), 2)
    batch = {"tokens": toks, "targets": targets}
    (loss, _), grads = value_and_grad(
        lambda p, b: tlm.train_loss(p, tcfg, b), tp, batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    for g, p in zip(tree_leaves(grads), tree_leaves(tp)):
        assert g.shape == p.shape and bool(torch.isfinite(g).all())
    stepped = tree_map(lambda p, g: p - 0.05 * g.to(p.dtype), tp,
                       grads)
    with torch.no_grad():
        loss2, _ = tlm.train_loss(stepped, tcfg, batch)
    assert float(loss2) < float(loss) + 1e-4


# The loss-drop run's MBProx lr: tests/test_system.py's 5e-2 for rwkv6;
# the reduced recurrentgemma-2b's loss moves 0.10 in 30 steps at 5e-2 and
# 0.36 at 1e-1.
DROP_LRS = {"rwkv6-3b": 5e-2, "recurrentgemma-2b": 1e-1}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_reduces_loss(arch):
    """tests/test_system.py's MBProx loss-drop run (8 x 32) on the
    recurrent archs, through the train CLI's train() on the CPU, cut to 30
    steps: the loss drops by more than 0.2."""
    _, losses = ttrain.train(arch, 30, optimizer="mbprox",
                             lr=DROP_LRS[arch], batch_size=8, seq_len=32,
                             log_every=1000, device="cpu")
    assert min(losses) < losses[0] - 0.2, (losses[0], min(losses))
