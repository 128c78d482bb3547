"""The port's training path held to the JAX package on the CPU: the flash
backward twin (against jax.vjp of the JAX flash reference), lm.train_loss
and its gradients, three outer steps of MBProx (local and sync) and of the
AdamW baseline from converted params on TokenStream batches, and the
train CLI (the loss drops as the JAX system tests require; resume).

Tolerances: the backward twin 2e-5 in float32 (both take float32 sums in
other orders); the loss 1e-5 and each gradient leaf 1e-4 of
max(1, max|g|); MBProx params and losses 1e-5. AdamW losses 1e-5, its
params within 0.05 lr a step: its first update is g / (|g| + eps), so a
gradient element near eps = 1e-8 turns the two packages' last-place
differences into a few percent of lr, while all but 1% of the elements
sit within 1e-6."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data.synthetic import TokenStream as JStream  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.synthetic import TokenStream as TStream  # noqa: E402
from repro_torch.kernels import build, flash_attention, ref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim.mbprox import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-135m"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------------------------
# the flash backward twin
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV", [(9, 3), (4, 2)])
@pytest.mark.parametrize("hd", [16, 64])
def test_flash_bwd_ref_matches_jax_vjp(H, KV, hd):
    """ref.flash_attention_bwd_ref against jax.vjp of the JAX package's
    flash reference (causal) and against torch autograd of the port's
    forward twin: within 2e-5 in float32."""
    rng = np.random.default_rng(hd + H)
    q, do = _rand(rng, 2, H, 37, hd), _rand(rng, 2, H, 37, hd)
    k, v = _rand(rng, 2, KV, 37, hd), _rand(rng, 2, KV, 37, hd)
    o_j, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ref.flash_attention_ref(tq, tk, tv)
    np.testing.assert_allclose(_np(o), _np(o_j), atol=2e-5)
    got = ref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      o.detach(), torch.from_numpy(do))
    auto = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w, a in zip(got, want, auto):
        np.testing.assert_allclose(_np(g), _np(w), atol=2e-5)
        np.testing.assert_allclose(_np(g), _np(a), atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 8), (False, 6),
                                           (True, 64)])
def test_flash_bwd_ref_window_matches_autograd(causal, window):
    """The JAX reference has no window: the windowed twin's gradient is
    held to torch autograd of the port's windowed forward twin."""
    rng = np.random.default_rng(window)
    q, do = (torch.from_numpy(_rand(rng, 2, 4, 29, 16)) for _ in range(2))
    k, v = (torch.from_numpy(_rand(rng, 2, 2, 29, 16)) for _ in range(2))
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    o = ref.flash_attention_ref(qs, ks, vs, causal=causal, window=window)
    auto = torch.autograd.grad(o, (qs, ks, vs), do)
    got = ref.flash_attention_bwd_ref(q, k, v, o.detach(), do, causal=causal,
                                      window=window, chunk=8)
    for g, a in zip(got, auto):
        np.testing.assert_allclose(_np(g), _np(a), atol=2e-5)


def test_flash_attention_autograd_on_cpu():
    """Under autograd flash_attention is the autograd Function, whose CPU
    forward is the twin's bits and whose backward is the backward twin;
    without a tensor that requires grad (or under no_grad) it is the plain
    twin and records nothing."""
    rng = np.random.default_rng(0)
    q, do = (torch.from_numpy(_rand(rng, 1, 4, 20, 16)) for _ in range(2))
    k, v = (torch.from_numpy(_rand(rng, 1, 2, 20, 16)) for _ in range(2))
    plain = flash_attention(q, k, v)
    assert plain.grad_fn is None
    assert torch.equal(plain, ref.flash_attention_ref(q, k, v))
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    with torch.no_grad():
        assert flash_attention(qs, ks, vs).grad_fn is None
    o = flash_attention(qs, ks, vs)
    assert o.grad_fn is not None and torch.equal(o, plain)
    o.backward(do)
    want = ref.flash_attention_bwd_ref(q, k, v, plain, do)
    for g, w in zip((qs.grad, ks.grad, vs.grad), want):
        assert torch.equal(g, w)


def test_refuse_grad_helper():
    """build.refuse_grad (every CUDA wrapper but flash_attention calls it
    before a launch; its CUDA branch cannot run here): raises under grad
    mode when an input requires grad, naming the kernel, and checks
    nothing under no_grad / inference_mode or without such an input."""
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    with pytest.raises(RuntimeError, match="rwkv6_scan"):
        build.refuse_grad("rwkv6_scan", y, None, x)
    build.refuse_grad("rwkv6_scan", y, None, y)
    with torch.no_grad():
        build.refuse_grad("paged_attention", x, y)
    with torch.inference_mode():
        build.refuse_grad("paged_attention", x, y)


# ----------------------------------------------------------------------------
# train_loss and the train steps against JAX
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, convert.from_jax(jax.device_get(jp), tcfg)


def test_train_loss_and_grads_match_jax(models):
    jcfg, jp, tcfg, tp = models
    toks, targets = TStream(tcfg.vocab_size, 24).batch(prng.PRNGKey(3), 4)
    micro = {"tokens": toks, "targets": targets}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.train_loss(p, jcfg, b), has_aux=True))(
            jp, {k: jnp.asarray(_np(v)) for k, v in micro.items()})
    (tl, taux), tg = value_and_grad(
        lambda p, m: tlm.train_loss(p, tcfg, m), tp, micro)
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert abs(float(taux["xent"]) - float(jaux["xent"])) <= 1e-5
    assert float(taux["moe_aux"]) == 0.0 == float(taux["moe_zloss"])
    jg = convert.from_jax(jax.device_get(jg), tcfg)
    for a, b in zip(tree_leaves(jg), tree_leaves(tg)):
        assert a.shape == b.shape
        tol = 1e-4 * max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= tol


def test_remat_gives_the_same_gradients(models):
    *_, tcfg, tp = models
    toks, targets = TStream(tcfg.vocab_size, 16).batch(prng.PRNGKey(4), 2)
    micro = {"tokens": toks, "targets": targets}
    outs = [value_and_grad(lambda p, m: tlm.train_loss(p, tcfg, m,
                                                       remat=r), tp, micro)
            for r in (True, False)]
    assert torch.equal(outs[0][0][0], outs[1][0][0])
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,what", [("rwkv6-3b", "Recurrent training"),
                                       ("recurrentgemma-2b",
                                        "Recurrent training"),
                                       ("grok-1-314b", "MoE")])
def test_untrainable_archs_raise(arch, what):
    cfg = tget(arch).reduced()
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long),
             "targets": torch.zeros(1, 4, dtype=torch.long)}
    with pytest.raises(NotImplementedError, match=what):
        tlm.train_loss({}, cfg, batch)


LRS = {"local": 5e-2, "sync": 5e-2, "baseline": 3e-3}


@pytest.fixture(scope="module")
def jax_steps(models):
    """Three outer steps of each JAX step function (jitted once each) from
    the converted params, on TokenStream batches of 8 x 16 in 2
    microbatches: {variant: (losses, final params in the port layout)}."""
    jcfg, jp, tcfg, _ = models
    mesh = make_host_mesh()
    stream = JStream(jcfg.vocab_size, 16)
    out = {}
    for name, lr in LRS.items():
        if name == "baseline":
            step, opt = jsteps.make_baseline_train_step(jcfg, mesh)
        else:
            step, opt, _ = jsteps.make_mbprox_train_step(
                jcfg, mesh, jsteps.default_mbprox_config(jcfg,
                                                         variant=name))
        step, p, s, losses = jax.jit(step), jp, opt.init(jp), []
        with compat.set_mesh(mesh):
            for i in range(3):
                batch = jtrain.make_batch(
                    jcfg, stream, jax.random.fold_in(jax.random.PRNGKey(1),
                                                     i), 8, 2)
                p, s, m = step(p, s, batch, jnp.float32(lr))
                losses.append(float(m["loss"]))
        out[name] = (losses, convert.from_jax(jax.device_get(p), tcfg))
    return out


@pytest.mark.parametrize("variant", ["local", "sync", "baseline"])
def test_train_steps_match_jax(models, jax_steps, variant):
    *_, tcfg, tp = models
    lr = LRS[variant]
    if variant == "baseline":
        step, opt = tsteps.make_baseline_train_step(tcfg)
    else:
        step, opt, _ = tsteps.make_mbprox_train_step(
            tcfg, tsteps.default_mbprox_config(tcfg, variant=variant))
    stream = TStream(tcfg.vocab_size, 16)
    p, s, losses = tp, opt.init(tp), []
    for i in range(3):
        batch = ttrain.make_batch(tcfg, stream,
                                  prng.fold_in(prng.PRNGKey(1), i), 8, 2)
        p, s, m = step(p, s, batch, lr)
        losses.append(float(m["loss"]))
    want_losses, want_p = jax_steps[variant]
    np.testing.assert_allclose(losses, want_losses, atol=1e-5, rtol=0)
    tol = 1e-5 if variant != "baseline" else 0.05 * lr * 3
    for a, b in zip(tree_leaves(want_p), tree_leaves(p)):
        assert float((a - b).abs().max()) <= tol
    if variant == "baseline":
        # all but the eps-amplified elements within 1e-6
        diff = torch.cat([(a - b).abs().reshape(-1) for a, b in
                          zip(tree_leaves(want_p), tree_leaves(p))])
        assert float((diff > 1e-6).float().mean()) < 0.01


def test_local_and_sync_differ_only_by_a_zero_correction(models):
    """On one process pmean is the identity, so the DANE correction is
    exactly zero and the local variant's step gives the sync variant's
    bits (the local one pays a gradient for the correction)."""
    *_, tcfg, tp = models
    batch = ttrain.make_batch(tcfg, TStream(tcfg.vocab_size, 8),
                              prng.PRNGKey(5), 4, 2)
    outs = []
    for variant in ("local", "sync"):
        step, opt, _ = tsteps.make_mbprox_train_step(
            tcfg, tsteps.default_mbprox_config(tcfg, variant=variant))
        outs.append(step(tp, opt.init(tp), batch, 0.05))
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------------
# the train CLI
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer,lr,drop", [("mbprox", 5e-2, 0.2),
                                               ("baseline", 2e-2, 0.3)])
def test_train_reduces_loss(optimizer, lr, drop):
    """tests/test_system.py's loss-drop runs, on the port (CPU)."""
    _, losses = ttrain.train(ARCH, 60, optimizer=optimizer, lr=lr,
                             batch_size=8, seq_len=32, log_every=1000,
                             device="cpu")
    assert min(losses) < losses[0] - drop, (losses[0], min(losses))


def test_train_driver_resume(tmp_path):
    """train --resume continues at the step after the checkpoint, and the
    resumed run's losses are the uninterrupted run's."""
    d = str(tmp_path / "run")
    kw = dict(optimizer="baseline", batch_size=4, n_micro=2, seq_len=16,
              log_every=100, device="cpu")
    _, first = ttrain.train(ARCH, 4, ckpt_dir=d, **kw)
    _, resumed = ttrain.train(ARCH, 6, ckpt_dir=d, resume=True, **kw)
    assert len(first) == 4 and len(resumed) == 2
    # the warm-up covers steps 0-4 whatever the total, so the 4-step run's
    # lrs are the 6-step run's, and resuming gives its last two losses
    _, whole = ttrain.train(ARCH, 6, **kw)
    assert resumed == whole[4:]


def test_train_cli_main(capsys):
    ttrain.main(["--device", "cpu", "--steps", "3", "--seq-len", "8",
                 "--batch-size", "4"])
    out = capsys.readouterr().out
    assert "final loss" in out and "step     2" in out


def test_training_modules_import_no_jax_msgpack_or_zstandard():
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.launch.steps\n"
            "import repro_torch.optim.compression, repro_torch.data.pipeline\n"
            "import repro_torch.runtime.fault_tolerance\n"
            "import repro_torch.runtime.elastic\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack', 'zstandard', "
            "'ml_dtypes')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
