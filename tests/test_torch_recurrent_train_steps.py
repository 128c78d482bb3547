"""The recurrent archs' training steps on the port, held to the JAX
package on the CPU: three outer MBProx steps of the reduced rwkv6-3b and
recurrentgemma-2b from converted params against JAX's jitted steps
(losses 1e-5 relative, params 1e-5 for rwkv6 and 1e-4 for
recurrentgemma)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_models import reduced_models  # noqa: E402
from repro import compat  # noqa: E402
from repro.data.synthetic import TokenStream as JStream  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.data.synthetic import TokenStream as TStream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ("rwkv6-3b", "recurrentgemma-2b")
PARAM_TOL = {"rwkv6-3b": 1e-5, "recurrentgemma-2b": 1e-4}

# The outer lr of the three MBProx steps. At lr 5e-2 (smollm's test, 8 x
# 16 tokens) the reduced rwkv6-3b's trajectory is ill-conditioned in JAX
# itself: one ulp on every JAX param moves JAX's own params by 0.029 after
# three steps (5.4e-5 at lr 3e-3; smollm: 1.2e-7 at 5e-2), so no second
# float32 implementation can follow it to 1e-5 there. At 1e-3 the port
# follows JAX to 1.9e-6 (3.1e-6 at 4 x 16). recurrentgemma-2b: one ulp
# moves JAX by 3.1e-5 at 5e-2 and 2.8e-6 at 1e-2.
LRS = {"rwkv6-3b": 1e-3, "recurrentgemma-2b": 1e-2}


@pytest.mark.parametrize("arch", ARCHS)
def test_mbprox_steps_match_jax(arch):
    """Three outer MBProx steps (the default local variant) of the reduced
    model from the converted params on TokenStream batches of 4 x 16 in 2
    micro-batches, against the JAX step jitted once: losses 1e-5
    relative, params PARAM_TOL."""
    jcfg, jp, tcfg, tp = reduced_models(arch)
    lr = LRS[arch]
    mesh = make_host_mesh()
    jstep, jopt, _ = jsteps.make_mbprox_train_step(jcfg, mesh)
    jstep = jax.jit(jstep)
    tstep, topt, _ = tsteps.make_mbprox_train_step(tcfg)
    jstream, tstream = JStream(jcfg.vocab_size, 16), TStream(tcfg.vocab_size,
                                                            16)
    p_j, s_j, p_t, s_t = jp, jopt.init(jp), tp, topt.init(tp)
    jl, tl = [], []
    with compat.set_mesh(mesh):
        for i in range(3):
            jb = jtrain.make_batch(jcfg, jstream, jax.random.fold_in(
                jax.random.PRNGKey(1), i), 4, 2)
            p_j, s_j, m = jstep(p_j, s_j, jb, jnp.float32(lr))
            jl.append(float(m["loss"]))
            tb = ttrain.make_batch(tcfg, tstream,
                                   prng.fold_in(prng.PRNGKey(1), i), 4, 2)
            p_t, s_t, m = tstep(p_t, s_t, tb, lr)
            tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    want = convert.from_jax(jax.device_get(p_j), tcfg)
    for a, b in zip(tree_leaves(want), tree_leaves(p_t)):
        assert float((a - b).abs().max()) <= PARAM_TOL[arch]
