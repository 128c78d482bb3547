"""The port starts where the JAX package starts under the same seed:
`lm.init_params(seed, cfg)` draws JAX's weights from JAX's threefry key
stream in JAX's key order (`repro/models/lm.py:init_params`), the naive
serve CLI draws JAX's prompts, and the train CLI's first losses are the
JAX CLI's.

Tolerances: every weight within 3 float32 ulps of JAX's (`prng.normal`'s
erf_inv differs from XLA's on ~1e-4 of its inputs by at most 2 ulps, and
the scale's rounding may add one; the share of bit-equal weights is
printed); prompts bit-equal; the train CLI's first 3 losses within 1e-5
of the JAX CLI's (its MBProx steps, batches from JAX's TokenStream keys)."""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

# the reduced configs of every arch the port's lm takes: dense, the hybrid
# (RG-LRU + local attention), RWKV6
ARCHS = ["smollm-135m", "recurrentgemma-2b", "rwkv6-3b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_is_jaxs(arch, seed):
    cfg = tget(arch).reduced()
    got = convert.to_jax(tlm.init_params(seed, cfg, device="cpu"), cfg)
    want = jlm.init_params(jax.random.PRNGKey(seed), jget(arch).reduced())
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    equal = total = 0
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        g, w = g.astype(np.float32), w.astype(np.float32)
        ulps = np.abs(g - w) / np.spacing(np.abs(w))
        assert ulps.max() <= 3, (path, ulps.max())
        equal += int((g == w).sum())
        total += g.size
    print(f"{arch} seed {seed}: {equal / total:.4f} of {total} weights "
          f"bit-equal")


@pytest.mark.parametrize("seed,batch,plen", [(0, 4, 64), (5, 2, 17)])
def test_naive_cli_prompts_are_jaxs(seed, batch, plen):
    """The naive CLI's prompts: jax.random.randint(PRNGKey(seed + 1),
    (batch, prompt_len), 0, vocab), as src/repro/launch/serve.py draws
    them."""
    cfg = tget("smollm-135m").reduced()
    args = argparse.Namespace(seed=seed, batch=batch, prompt_len=[plen])
    got = tserve._naive_prompts(args, cfg)
    want = jax.random.randint(jax.random.PRNGKey(seed + 1), (batch, plen),
                              0, cfg.vocab_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_cli_first_losses_are_jaxs():
    """`launch/train.py --seed 0` on both packages (the reduced smollm,
    MBProx, the CLI's defaults): the same model and batches, so the first
    3 losses agree within 1e-5."""
    _, got = ttrain.train("smollm-135m", 3, log_every=100, device="cpu")
    _, want = jtrain.train("smollm-135m", 3, log_every=100)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
